"""The port's fused cross-scan against the JAX package's.

``cross_scan_fused`` of the port (on the CPU: the plain forward, with the
plain backward as its gradient) against the JAX ``cross_scan_fused`` with
the Pallas kernel pair in interpret mode, as ``tests/test_cross_scan.py``
runs it: the same numpy-seeded inputs, both traversal orientations, the
forward to 1e-4 * max|y| and the gradients of the streams and of the five
weights to 1e-4 of each one's max (fp32 on both sides, other orders of the
same sums). The CUDA kernels themselves are tested in
``test_torch_cross_scan_kernel.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.ops import cross_scan as jcs  # noqa: E402
from nnuzoo_tpu_torch.ops import cross_scan as tcs  # noqa: E402

NAMES = ("streams", "x_proj_weight", "dt_weight", "dt_bias", "A", "Ds")

# (B, L, G, Dh, N, R)
CASES = {
    "test_cross_scan_shape": (2, 128, 2, 8, 4, 2),
    "ragged_length": (2, 150, 2, 8, 4, 2),
    "batch3_dh24": (3, 64, 2, 24, 4, 2),
    "three_axis_orders": (2, 64, 3, 8, 4, 2),
    "m2netp_widths": (2, 40, 2, 32, 16, 1),
}


def _inputs(seed, B, L, G, Dh, N, R):
    """As ``tests/test_cross_scan.py`` makes them, plus an output gradient."""
    rng = np.random.RandomState(seed)
    f = np.float32
    streams = [(0.5 * rng.randn(B, L, Dh)).astype(f) for _ in range(G)]
    wx = (0.2 * rng.randn(G, R + 2 * N, Dh)).astype(f)
    wdt = (0.2 * rng.randn(G, Dh, R)).astype(f)
    dtb = (0.1 * rng.randn(G, Dh)).astype(f)
    A = (-np.exp(rng.rand(G * Dh, N))).astype(f)
    Ds = rng.rand(G * Dh).astype(f)
    dy = rng.randn(B, L, G * Dh).astype(f)
    return streams, [wx, wdt, dtb, A, Ds], dy


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_cross_scan_matches_jax_pallas_pair(case, reverse):
    streams, weights, dy = _inputs(len(case), *CASES[case])
    G = len(streams)

    def fj(streams, *weights):
        return jcs.cross_scan_fused(streams, *weights, reverse, backend="pallas",
                                    interpret=True)

    y_j, vjp = jax.vjp(fj, tuple(jnp.asarray(s) for s in streams),
                       *(jnp.asarray(w) for w in weights))
    (ds_j, *dw_j) = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (*streams, *weights)]
    y = tcs.cross_scan_fused(leaves[:G], *leaves[G:], reverse)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))

    _assert_close(y.detach(), y_j, 1e-4, "y")
    _assert_close(torch.cat(grads[:G], -1), np.concatenate(ds_j, -1), 1e-4,
                  "streams")
    for name, g, w in zip(NAMES[1:], grads[G:], dw_j):
        _assert_close(g, w, 1e-4, name)


@pytest.mark.parametrize("backend", ["plain", "plain_pair"])
def test_plain_backends_match_jax_oracle(backend):
    """The two plain backends (autograd through the plain forward, and the
    plain forward with the plain backward) against ``jax.grad`` of the JAX
    oracle ``cross_scan_ref``, reverse orientation, M2NetP's widths."""
    streams, weights, dy = _inputs(3, 1, 30, 2, 32, 16, 1)

    def fj(streams, *weights):
        return jnp.sum(jcs.cross_scan_ref(streams, *weights, True) * dy)

    want = jax.grad(fj, argnums=tuple(range(6)))(
        tuple(jnp.asarray(s) for s in streams), *(jnp.asarray(w) for w in weights))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (*streams, *weights)]
    y = tcs.cross_scan_fused(leaves[:2], *leaves[2:], True, backend=backend)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _assert_close(torch.cat(got[:2], -1), np.concatenate(want[0], -1), 1e-4,
                  "streams")
    for name, g, w in zip(NAMES[1:], got[2:], want[1:]):
        _assert_close(g, w, 1e-4, name)
