"""The port's SSND (the N-d cross scan) against the JAX package's, 2d and 3d,
on both glues.

Seeded numpy input and output gradient, converted parameters (which convert
back to the flax tree exactly), d_model 16 (d_inner 32, dt rank 1, as every
SSND of SSND2NetP has) and d_state 16. The forward and the gradients of the
input and of every parameter are compared in fp64 on both sides: the JAX
SSND through ``jax.vjp`` under 64-bit types (its selective scans, and the
fused glue's Pallas kernels in interpret mode, compute in fp32 whatever
their inputs), the port's on its plain scan in fp64. The output agrees to
1e-4 of its largest magnitude and each gradient to 1e-3 of its own largest
magnitude (sums over the batch and the map taken in other orders, around
fp32 scans). The port's fp32 output on its kernel path (on the CPU: the
plain versions the wrappers fall back to) is held to its own fp64 output
to 1e-4 of the largest magnitude. The fused glue's width limits raise:
SSND2Net's bottleneck SSND (d_model 256: Dh 512, dt rank 16) cannot take
it, whether built with ``NNUZOO_SS2D_FUSED=1`` or set to it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import ssnd as jssnd  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.models import ss2d as tss2d  # noqa: E402
from nnuzoo_tpu_torch.models import ssnd as tssnd  # noqa: E402

from .torch_port_helpers import (fp64_twin, load_converted,  # noqa: E402
                                 one_torch_thread, random_flax_params, to_fp64)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SHAPES = {2: (2, 7, 6, 16), 3: (1, 4, 6, 5, 16)}


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_vjp_fp64(module, params, x, dy):
    """The JAX module's output and the gradients of its parameters and of
    its input for the output gradient ``dy``, all under 64-bit types."""
    with jax.enable_x64(True):
        p64, x64, dy64 = to_fp64(params), *to_fp64([x, dy])

        @jax.jit
        def run(p, v, d):
            out, vjp = jax.vjp(lambda q, w: module.apply(q, w, train=False), p, v)
            return (out, *vjp(d))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), run(p64, x64, dy64))


@pytest.mark.parametrize("glue", ["default", "fused"])
@pytest.mark.parametrize("dim", [2, 3])
def test_ssnd_matches_jax(dim, glue, monkeypatch):
    monkeypatch.setenv("NNUZOO_SS2D_FUSED",
                       "interpret" if glue == "fused" else "0")
    x, dy = _x(1, SHAPES[dim]), _x(2, SHAPES[dim])
    jmod = jssnd.SSND(16, spatial_dims=dim, d_state=16)
    params = random_flax_params(jmod, jnp.asarray(x), train=False)
    want, want_p, want_x = jax_vjp_fp64(jmod, params, x, dy)
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "0")
    tmod = load_converted(tssnd.SSND(16, dim, 16), params)
    tss2d.set_ss2d_glue(tmod, glue)
    assert tmod.glue == glue
    # the converter both ways
    back = flatten_params(params_from_state_dict(tmod.state_dict(), tmod))
    flat = flatten_params(params["params"])
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    twin = fp64_twin(tmod)
    xt = torch.from_numpy(x).double().requires_grad_()
    got = twin(xt)
    names = [n for n, _ in twin.named_parameters()]
    grads = torch.autograd.grad(got, [xt] + list(twin.parameters()),
                                torch.from_numpy(dy).double())
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * scale)
    want_p = {k: v.double().numpy()
              for k, v in convert_params(want_p, twin).items()}
    for name, g, w in zip(["input"] + names, grads,
                          [want_x] + [want_p[n] for n in names]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=name)
    with torch.no_grad():
        fp32 = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(fp32.double().numpy(), got.detach().numpy(),
                               rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dim", [2, 3])
def test_axis_orders_and_merge(dim):
    """Each axis order's stream walks the conv output in that order, and the
    merge puts each position's output back where it came from: with the
    scan standing in as the identity on each stream, the merged map is dim
    times the conv output."""
    mod = tssnd.SSND(16, dim, 16)
    x = torch.from_numpy(_x(3, SHAPES[dim]))
    seen = []

    def identity_scan(streams):
        seen.extend(streams)
        return list(streams)

    mod.scan_streams = identity_scan
    with torch.no_grad():
        got = mod(x)
        xpart, z = mod.in_proj(x).chunk(2, -1)
        xc = torch.nn.functional.silu(tssnd.conv_cl(mod.conv, xpart))
        want = mod.out_proj(mod.out_norm(dim * xc) * torch.nn.functional.silu(z))
    B, D = x.shape[0], mod.d_inner
    assert len(seen) == dim
    for stream, order in zip(seen, tssnd.AXIS_ORDERS[dim]):
        perm = (0,) + tuple(o + 1 for o in order) + (dim + 1,)
        torch.testing.assert_close(stream, xc.permute(perm).reshape(B, -1, D))
    torch.testing.assert_close(got, want)


def test_fused_glue_raises_at_ssnd2net_bottleneck_width(monkeypatch):
    """d_model 256 (SSND2Net's bottleneck minis): Dh 512, dt rank 16."""
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "1")
    with pytest.raises(ValueError, match="Dh=512, R=16"):
        with torch.device("meta"):
            tssnd.SSND(256, 3)
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "0")
    with torch.device("meta"):
        wide = torch.nn.Sequential(tssnd.SSND(16, 3), tssnd.SSND(256, 3))
    with pytest.raises(ValueError, match="SSND has Dh=512"):
        tss2d.set_ss2d_glue(wide, "fused")
    assert {m.glue for m in wide} == {"default"}
    # the widest SSND the kernels take: d_model 128 (Dh 256, R 8)
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "1")
    with torch.device("meta"):
        assert tssnd.SSND(128, 2).glue == "fused"


def test_scan_backend_reaches_ssnd():
    with torch.device("meta"):
        mod = tssnd.SSND(16, 2)
    tss2d.set_scan_backend(mod, "plain")
    assert mod.scan_backend == "plain"
