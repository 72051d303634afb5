"""The port's selective scan against the JAX package's.

The plain PyTorch scan (what ``scan_core`` runs on a CPU tensor) is held
against ``selective_scan_ref_jax`` and against the Pallas kernel in interpret
mode, as ``tests/test_selective_scan.py`` runs it. Both sides compute in fp32
but associate the products differently (Hillis-Steele inside chunks against a
per-step scan), so the tolerance is atol 1e-4 * max|y| with rtol 1e-4.
The kernel's wrapper and the CUDA kernel itself are tested in
``test_torch_scan_kernel.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import importlib  # noqa: E402

# nnuzoo_tpu.ops re-exports a function named selective_scan over the module
jscan = importlib.import_module("nnuzoo_tpu.ops.selective_scan")
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402

K, DH, BATCH = 4, 3, 2


def _inputs(seed, L, N, with_bias_d):
    rng = np.random.RandomState(seed)
    f = np.float32
    u = rng.randn(BATCH, L, K, DH).astype(f)
    delta = (0.5 * rng.randn(BATCH, L, K, DH)).astype(f)
    A = -np.exp(0.5 * rng.randn(K * DH, N)).astype(f)
    Bm = rng.randn(BATCH, L, K, N).astype(f)
    Cm = rng.randn(BATCH, L, K, N).astype(f)
    D = (1 + 0.1 * rng.randn(K * DH)).astype(f) if with_bias_d else None
    bias = (0.1 * rng.randn(K * DH)).astype(f) if with_bias_d else None
    return u, delta, A, Bm, Cm, D, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("with_bias_d", [False, True])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("L", [12, 56, 128, 200])
def test_blkd_plain_matches_ref_jax(L, N, with_bias_d):
    u, delta, A, Bm, Cm, D, bias = _inputs(L + N, L, N, with_bias_d)
    got = tscan.selective_scan_blkd(_t(u), _t(delta), _t(A), _t(Bm), _t(Cm),
                                    D=_t(D), delta_bias=_t(bias))
    # the same problem in mamba convention: (B, K*Dh, L), grouped B/C
    to_m = lambda x: _j(x.transpose(0, 2, 3, 1).reshape(BATCH, K * DH, L))
    want = jscan.selective_scan_ref_jax(
        to_m(u), to_m(delta), _j(A), _j(Bm.transpose(0, 2, 3, 1)),
        _j(Cm.transpose(0, 2, 3, 1)), D=_j(D), delta_bias=_j(bias),
        delta_softplus=True)
    want = np.asarray(want).reshape(BATCH, K, DH, L).transpose(0, 3, 1, 2)
    _close(got, want)


@pytest.mark.parametrize("with_bias_d", [False, True])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("L", [12, 56, 128, 200])
def test_blkd_plain_matches_pallas_interpret(L, N, with_bias_d):
    u, delta, A, Bm, Cm, D, bias = _inputs(2 * L + N, L, N, with_bias_d)
    got = tscan.selective_scan_blkd(_t(u), _t(delta), _t(A), _t(Bm), _t(Cm),
                                    D=_t(D), delta_bias=_t(bias))
    want = jscan.selective_scan_blkd(
        _j(u), _j(delta), _j(A), _j(Bm), _j(Cm), D=_j(D), delta_bias=_j(bias),
        backend="pallas", interpret=True)
    _close(got, want)


@pytest.mark.parametrize("grouped,with_z", [(False, False), (True, True)])
def test_ref_and_chunked_match_ref_jax(grouped, with_z):
    rng = np.random.RandomState(7)
    f = np.float32
    dim, N, L = 8, 4, 37
    u = rng.randn(BATCH, dim, L).astype(f)
    delta = rng.randn(BATCH, dim, L).astype(f)
    A = -np.exp(0.5 * rng.randn(dim, N)).astype(f)
    bshape = (BATCH, 2, N, L) if grouped else (BATCH, N, L)
    Bm, Cm = rng.randn(*bshape).astype(f), rng.randn(*bshape).astype(f)
    D = rng.randn(dim).astype(f)
    z = rng.randn(BATCH, dim, L).astype(f) if with_z else None
    bias = (0.1 * rng.randn(dim)).astype(f)
    args = (u, delta, A, Bm, Cm, D, z, bias)
    want = jscan.selective_scan_ref_jax(*[_j(a) for a in args],
                                        delta_softplus=True)
    got_ref = tscan.selective_scan_ref(*[_t(a) for a in args],
                                       delta_softplus=True)
    _close(got_ref, want)
    for chunk in (8, 16, 64):     # ragged last chunk at 8 and 16
        got = tscan.selective_scan_chunked(*[_t(a) for a in args],
                                           delta_softplus=True, chunk=chunk)
        _close(got, want)


@pytest.mark.parametrize("chunk", ["16", "32"])
def test_plain_carries_match_pallas_forward_carries(chunk, monkeypatch):
    """The forward kernel's second output, the state entering each chunk
    (what the backward kernel starts from): ``scan_core_plain(...,
    return_carries=True)`` at the Pallas kernel's chunk against
    ``_scan_core_pallas_fwd`` in interpret mode (its per-chunk body at 16,
    the MXU body at 32), with y; fp32 with another association, so 1e-4 of
    the max."""
    monkeypatch.setenv("NNUZOO_SCAN_CHUNK", chunk)
    rng = np.random.RandomState(int(chunk))
    f = np.float32
    B, L, K, Dh, N = 2, 96, 4, 8, 16
    u = rng.randn(B, L, K * Dh).astype(f)
    delta = (0.001 + 0.099 * rng.rand(B, L, K * Dh)).astype(f)
    A_t = (-N * rng.rand(N, K * Dh) - 1e-3).astype(f)
    bc = rng.randn(B, L, K * 2 * N).astype(f)
    want_y, residuals = jscan._scan_core_pallas_fwd(
        *(jnp.asarray(x) for x in (u, delta, A_t, bc)), True)
    want_carries = np.asarray(residuals[-1])
    assert want_carries.shape == (B, L // int(chunk), N, K * Dh)
    y, carries = tscan.scan_core_plain(
        *(torch.from_numpy(x) for x in (u, delta, A_t, bc)), chunk=int(chunk),
        return_carries=True)
    _close(y, want_y)
    _close(carries, want_carries)
