"""The port's selective-scan gradients against the JAX package's.

``scan_core_bwd_plain`` (what ``scan_core_bwd`` runs on CPU tensors) and the
differentiable ``scan_core_grad`` are held against ``jax.grad`` of the Pallas
kernel pair ``_scan_core_pallas`` in interpret mode, as
``tests/test_selective_scan.py`` runs it, and against autograd through the
port's per-step reference in fp64. Everything else is fp32 with other orders
of the same sums, so each gradient is held to 1e-4 of its max magnitude.
The CUDA kernel itself is tested in ``test_torch_scan_kernel.py``.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

# nnuzoo_tpu.ops re-exports a function named selective_scan over the module
jscan = importlib.import_module("nnuzoo_tpu.ops.selective_scan")
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402

NAMES = ("du", "ddelta", "dA", "dbc")


def _inputs(seed, B, L, K, Dh, N):
    """(u, softplus'ed delta, A_t, bc, dy) of the kernel contract, delta in
    [0.001, 0.1] and A in [-N, 0) as the model gives them."""
    rng = np.random.RandomState(seed)
    f = np.float32
    u = rng.randn(B, L, K * Dh).astype(f)
    delta = (0.001 + 0.099 * rng.rand(B, L, K * Dh)).astype(f)
    A_t = (-N * rng.rand(N, K * Dh) - 1e-3).astype(f)
    bc = rng.randn(B, L, K * 2 * N).astype(f)
    dy = rng.randn(B, L, K * Dh).astype(f)
    return u, delta, A_t, bc, dy


def _assert_grads(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (what, name, err, np.abs(w).max())


def _torch_grads(u, delta, A_t, bc, dy, chunk):
    """(plain backward, autograd function), each as (du, ddelta, dA, dbc)."""
    t = [torch.from_numpy(x) for x in (u, delta, A_t, bc, dy)]
    du, dd, dbc, dA = tscan.scan_core_bwd_plain(*t, chunk=chunk)
    leaves = [x.clone().requires_grad_() for x in t[:4]]
    via_function = torch.autograd.grad(tscan.scan_core_grad(*leaves), leaves, t[4])
    return (du, dd, dA, dbc), via_function


def _reference_grads(u, delta, A_t, bc, dy, K, N):
    """Autograd through the per-step reference, fp64."""
    B, L, KD = u.shape
    leaves = [torch.from_numpy(x).double().requires_grad_()
              for x in (u, delta, A_t, bc)]
    tu, td, tA, tbc = leaves
    bc5 = tbc.reshape(B, L, K, 2, N)
    y = tscan.selective_scan_ref(
        tu.transpose(1, 2), td.transpose(1, 2), tA.t(),
        bc5[:, :, :, 0].permute(0, 2, 3, 1), bc5[:, :, :, 1].permute(0, 2, 3, 1))
    return torch.autograd.grad(y.transpose(1, 2), leaves,
                               torch.from_numpy(dy).double())


# (B, L, K, Dh, N, chunk of the plain backward, chunk of the Pallas kernel)
CASES = {
    "one_chunk": (2, 12, 1, 8, 4, 256, None),
    "several_chunks": (2, 64, 1, 8, 4, 16, "16"),
    "ragged_last_chunk": (1, 37, 1, 8, 4, 16, None),   # the Pallas core takes whole chunks
    "grouped_bc": (2, 40, 4, 4, 4, 16, "8"),
    "grouped_bc_n16": (1, 24, 2, 8, 16, 7, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_per_step_reference(case):
    B, L, K, Dh, N, chunk, _ = CASES[case]
    u, delta, A_t, bc, dy = _inputs(len(case), B, L, K, Dh, N)
    want = _reference_grads(u, delta, A_t, bc, dy, K, N)
    plain, via_function = _torch_grads(u, delta, A_t, bc, dy, chunk)
    _assert_grads(plain, want, "scan_core_bwd_plain")
    _assert_grads(via_function, want, "scan_core_grad")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_grad(case, monkeypatch):
    B, L, K, Dh, N, chunk, pallas_chunk = CASES[case]
    if pallas_chunk is not None:
        monkeypatch.setenv("NNUZOO_SCAN_CHUNK", pallas_chunk)
    u, delta, A_t, bc, dy = _inputs(len(case), B, L, K, Dh, N)

    def f(u, delta, A_t, bc):
        return jnp.sum(jscan._scan_core_pallas(u, delta, A_t, bc, True)
                       * jnp.asarray(dy))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(x)
                                                 for x in (u, delta, A_t, bc)))
    plain, via_function = _torch_grads(u, delta, A_t, bc, dy, chunk)
    _assert_grads(plain, want, "scan_core_bwd_plain")
    _assert_grads(via_function, want, "scan_core_grad")


def test_blkd_gradients_match_jax_blkd():
    """The entry SS2D calls: gradients of every argument through
    ``selective_scan_blkd`` (softplus, bias and D included) against ``jax.grad``
    of the JAX package's function of the same name, kernel in interpret mode."""
    rng = np.random.RandomState(11)
    f = np.float32
    B, L, K, Dh, N = 2, 30, 4, 4, 4
    u = rng.randn(B, L, K, Dh).astype(f)
    delta = (0.5 * rng.randn(B, L, K, Dh)).astype(f)
    A = -np.exp(0.5 * rng.randn(K * Dh, N)).astype(f)
    Bm, Cm = rng.randn(2, B, L, K, N).astype(f)
    D = (1 + 0.1 * rng.randn(K * Dh)).astype(f)
    bias = (0.1 * rng.randn(K * Dh)).astype(f)
    dy = rng.randn(B, L, K, Dh).astype(f)

    def fj(u, delta, A, Bm, Cm, D, bias):
        y = jscan.selective_scan_blkd(u, delta, A, Bm, Cm, D, delta_bias=bias,
                                      delta_softplus=True, interpret=True)
        return jnp.sum(y * jnp.asarray(dy))

    want = jax.grad(fj, argnums=tuple(range(7)))(
        *(jnp.asarray(x) for x in (u, delta, A, Bm, Cm, D, bias)))
    # None: the differentiable kernel contract (its plain pair on the CPU);
    # "plain": autograd through the plain scan; "plain_pair": the plain
    # forward with the plain backward
    for backend in (None, "plain", "plain_pair"):
        leaves = [torch.from_numpy(x).requires_grad_()
                  for x in (u, delta, A, Bm, Cm, D, bias)]
        y = tscan.selective_scan_blkd(*leaves[:6], delta_bias=leaves[6],
                                      backend=backend)
        got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
        for name, g, w in zip("u delta A B C D bias".split(), got, want):
            w = np.asarray(w)
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (backend, name, err)
