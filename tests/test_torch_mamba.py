"""The port's Mamba-convention selective scan and Mamba blocks against the JAX
package's.

``selective_scan`` (u/delta (batch, dim, L), plain or grouped B/C, ``z``,
``D``, ``delta_bias`` with softplus) on its default route, which on a CPU
tensor runs the kernels' plain versions forwards and backwards, against
JAX's ``selective_scan(backend="xla")`` and ``selective_scan_ref_jax``: the
output and the gradient of every input to 1e-4 of their largest magnitude
(fp32 on both sides, other association orders). ``_causal_conv1d``,
MambaBlock of each ``bimamba_type`` (v3 with its slice-major reordering) and
RMSNorm against their flax twins with converted parameters: rtol 1e-4, atol
1e-4 times the output's largest magnitude; MambaBlock's gradients of the
input and of every parameter to 1e-4 of each one's largest magnitude.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import mamba as jmamba  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.models import mamba as tmamba  # noqa: E402
from nnuzoo_tpu_torch.models.ss2d import set_scan_backend  # noqa: E402
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402

# nnuzoo_tpu.ops re-exports a function named selective_scan over the module
jscan = importlib.import_module("nnuzoo_tpu.ops.selective_scan")

TOL = 1e-4
ARGS = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")


def _close(got, want, what="", tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _scan_inputs(seed, L, groups, dim=8, N=16, batch=2):
    """Seeded Mamba-convention inputs in the scan's regime (delta + bias
    around softplus^-1(0.05), A = -(1..N) jittered); B/C grouped by
    ``groups`` (None: plain)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    bc_shape = (batch, N, L) if groups is None else (batch, groups, N, L)
    return dict(
        u=rng.randn(batch, dim, L).astype(f),
        delta=(0.5 * rng.randn(batch, dim, L)).astype(f),
        A=-np.exp(np.log(np.arange(1, N + 1)) + 0.1 * rng.randn(dim, N)).astype(f),
        B=rng.randn(*bc_shape).astype(f), C=rng.randn(*bc_shape).astype(f),
        D=(1 + 0.1 * rng.randn(dim)).astype(f),
        z=rng.randn(batch, dim, L).astype(f),
        delta_bias=(-3 + 0.5 * rng.randn(dim)).astype(f))


@pytest.mark.parametrize("groups,with_z,L", [(None, False, 300), (None, True, 37),
                                             (2, True, 300), (4, False, 37)])
def test_selective_scan_and_its_gradients_match_jax(groups, with_z, L):
    """300 crosses the plain scan's chunk of 256, 37 is ragged."""
    x = _scan_inputs(L + (groups or 0), L, groups)
    if not with_z:
        x["z"] = None
    names = [n for n in ARGS if x[n] is not None]
    dy = np.random.RandomState(7).randn(*x["u"].shape).astype(np.float32)

    def jax_fn(*vals):
        kw = dict(zip(names, vals))
        return jscan.selective_scan(delta_softplus=True, backend="xla", **kw)

    jvals = [jnp.asarray(x[n]) for n in names]
    want = jax_fn(*jvals)
    _close(want, jscan.selective_scan_ref_jax(
        delta_softplus=True, **dict(zip(names, jvals))), "xla vs ref")
    jgrads = jax.jit(jax.grad(lambda *v: jnp.sum(jax_fn(*v) * dy),
                              argnums=tuple(range(len(names)))))(*jvals)

    tvals = [torch.from_numpy(x[n]).requires_grad_() for n in names]
    got = tscan.selective_scan(delta_softplus=True, **dict(zip(names, tvals)))
    _close(got, want, "y")
    tgrads = torch.autograd.grad(got, tvals, torch.from_numpy(dy))
    for n, g, w in zip(names, tgrads, jgrads):
        _close(g, w, f"d{n}")
    ref = tscan.selective_scan(delta_softplus=True, backend="ref",
                               **{n: torch.from_numpy(x[n]) for n in names})
    _close(ref, want, "port ref")


def test_packed_entry_and_plain_backends_agree():
    """``selective_scan_packed`` on operands already in the kernel layout,
    and the "plain"/"plain_pair" routes, give the default route's y."""
    x = _scan_inputs(3, 40, 2)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = tscan.selective_scan(delta_softplus=True, **t)
    for backend in ("plain", "plain_pair"):
        _close(tscan.selective_scan(delta_softplus=True, backend=backend, **t),
               want.numpy(), backend)
    u, delta, bc = tscan._mamba_to_packed(t["u"], t["delta"], t["B"], t["C"])
    y = tscan.selective_scan_packed(u, delta, t["A"].t(), bc, D=t["D"],
                                    delta_bias=t["delta_bias"])
    _close(y.transpose(1, 2) * torch.nn.functional.silu(t["z"]), want.numpy(),
           "packed")


def test_last_state_only_on_the_reference_route():
    x = {k: torch.from_numpy(v) for k, v in _scan_inputs(4, 20, None).items()}
    with pytest.raises(ValueError, match="last state"):
        tscan.selective_scan(return_last_state=True, **x)
    with pytest.raises(ValueError, match="unknown scan backend"):
        tscan.selective_scan(backend="xla", **x)
    y, last = tscan.selective_scan(return_last_state=True, backend="ref",
                                   delta_softplus=True, **x)
    jy, jlast = jscan.selective_scan_ref_jax(
        return_last_state=True, delta_softplus=True,
        **{k: jnp.asarray(v.numpy()) for k, v in x.items()})
    _close(y, jy, "y")
    _close(last, jlast, "last state")


def test_causal_conv1d_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 11, 6).astype(np.float32)
    k = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want = jmamba._causal_conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = tmamba._causal_conv1d(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(b))
    _close(got, want)
    # causal: a later input moves no earlier output
    x2 = x.copy()
    x2[:, 7] += 1.0
    got2 = tmamba._causal_conv1d(torch.from_numpy(x2), torch.from_numpy(k))
    got1 = tmamba._causal_conv1d(torch.from_numpy(x), torch.from_numpy(k))
    assert torch.equal(got1[:, :7], got2[:, :7])
    assert not torch.equal(got1[:, 7:], got2[:, 7:])


def _block_grads(jmod, tmod, x, dy, **fwd):
    """Output, input gradient and parameter gradients (flax names) of the
    flax module and its converted twin."""
    params = random_flax_params(jmod, jnp.asarray(x), seed=1)

    @jax.jit
    def jax_vjp(p, v, g):
        out, vjp = jax.vjp(lambda p, v: jmod.apply(p, v), p, v)
        return (out,) + vjp(g)

    out, jparams, jx = jax_vjp(params, jnp.asarray(x), jnp.asarray(dy))
    tmod = load_converted(tmod, params).train()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tmod(tx, **fwd)
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(tout, [tx] + list(tmod.parameters()),
                                torch.from_numpy(dy))
    tflat = flatten_params(params_from_state_dict(dict(zip(names, grads[1:])), tmod))
    jflat = flatten_params(jax.tree.map(np.asarray, jparams)["params"])
    return (tout, out), (grads[0], jx), (tflat, jflat)


@pytest.mark.parametrize("bimamba,nslices", [(None, None), ("v1", None),
                                             ("v2", None), ("v3", 4), ("v3", 3)])
def test_mamba_block_and_gradients_match_jax(bimamba, nslices):
    """v3 with 4 and 3 slices of a 24-token sequence (slice-major
    reordering of 6 and 8 tokens a slice)."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 24, 8).astype(np.float32)
    dy = rng.randn(2, 24, 8).astype(np.float32)
    jmod = jmamba.MambaBlock(d_model=8, bimamba_type=bimamba, nslices=nslices)
    tmod = tmamba.MambaBlock(8, bimamba_type=bimamba, nslices=nslices)
    (got, want), (gx, jx), (tflat, jflat) = _block_grads(jmod, tmod, x, dy)
    _close(got, want, "out")
    _close(gx, jx, "dx")
    assert sorted(tflat) == sorted(jflat)
    for k, w in jflat.items():
        _close(tflat[k], w, k)
    expected = {None: {"fwd"}, "v1": {"fwd", "bwd"}, "v2": {"fwd", "bwd"},
                "v3": {"fwd", "bwd", "spatial"}}[bimamba]
    assert {k.split(".")[0] for k in tflat} - {"in_proj", "out_proj"} == expected


def test_mamba_block_nslices_from_forward_and_validation():
    x = torch.randn(1, 12, 8)
    m = tmamba.MambaBlock(8, bimamba_type="v3")
    with pytest.raises(ValueError, match="nslices"):
        m(x)
    assert m(x, nslices=3).shape == x.shape
    with pytest.raises(ValueError, match="bimamba_type"):
        tmamba.MambaBlock(8, bimamba_type="v4")


def test_rms_norm_matches_jax_and_converts_both_ways():
    x = np.random.RandomState(2).randn(3, 5, 8).astype(np.float32)
    jmod = jmamba.RMSNorm()
    params = random_flax_params(jmod, jnp.asarray(x), seed=4)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = load_converted(tmamba.RMSNorm(8), params)
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)
    back = params_from_state_dict(tmod.state_dict(), tmod)
    np.testing.assert_array_equal(back["weight"], np.asarray(params["params"]["weight"]))
    # without the model a 1-d weight is a norm's scale
    assert "scale" in params_from_state_dict(tmod.state_dict())


def test_scan_branch_parameters_convert_both_ways():
    x = jnp.zeros((1, 6, 8))
    jmod = jmamba.MambaBlock(d_model=8, bimamba_type="v2")
    params = random_flax_params(jmod, x, seed=3)
    tmod = tmamba.MambaBlock(8, bimamba_type="v2")
    state = convert_params(params, tmod)
    assert state["fwd.conv1d_weight"].shape == (4, 16)
    assert state["fwd.dt_proj_weight"].shape == (16, 1)
    assert state["bwd.A_log"].shape == (16, 16)
    back = flatten_params(params_from_state_dict(state, tmod))
    want = flatten_params(params["params"])
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_set_scan_backend_switches_every_mamba_branch(monkeypatch):
    """After ``set_scan_backend(model, "plain")`` no scan of a v3 MambaBlock
    goes through the kernel route, and its output is the kernel route's."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(tmamba.MambaBlock(8, bimamba_type="v3",
                                                  nslices=2))
    x = torch.randn(2, 10, 8)
    calls = []
    grad_route = tscan.scan_core_grad
    monkeypatch.setattr(tscan, "scan_core_grad",
                        lambda *a: calls.append(1) or grad_route(*a))
    with torch.no_grad():
        want = model(x)
        assert len(calls) == 3
        set_scan_backend(model, "plain")
        got = model(x)
    assert len(calls) == 3
    branches = [m for m in model.modules() if isinstance(m, tmamba._ScanBranch)]
    assert len(branches) == 3 and all(b.scan_backend == "plain" for b in branches)
    _close(got, want.numpy())


def test_scan_forward_and_backward_take_meta_tensors():
    """On the meta device (shapes only, as a FLOP count runs a model) the
    scan's forward operator and its backward give shapes without running
    the plain scan."""
    with torch.device("meta"):
        model = tmamba.MambaBlock(8, bimamba_type="v2")
        x = torch.empty(2, 5000, 8, requires_grad=True)
    out = model(x)
    grads = torch.autograd.grad(out.sum(), [x] + list(model.parameters()))
    assert out.shape == x.shape and grads[0].shape == x.shape
    assert all(g.device.type == "meta" for g in grads)
