"""The port's LightMUNet and LightSS2DMambaUNet against the JAX package's.

Seeded numpy inputs and converted parameters. Blocks (DWConv, GSC,
ResUpBlock, MambaLayer in each axis order) agree in fp32 to rtol 1e-4 with
atol 1e-4 times the output's largest magnitude. The whole model at
``init_filters=4`` and three stages, 2d (32x32) and 3d (8x16x12), with either
mixer: at these widths and random weights the model can be ill-conditioned
in fp32 (each package's fp32 output reads up to 2e-3 of its range from the
same model in fp64, the JAX package's further than the port's), so it is
compared in fp64 on both sides (``jax_apply_fp64``: the JAX scans stay fp32)
to rtol 1e-3 with atol 1e-4 of the output's largest magnitude, and the port's fp32 output is
held to its own fp64 output within 5e-3. The scan shapes of one forward at
full width (256x224 and zoo_sweep's 3d patch 48x192x192) are fixed on the
meta device.
"""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import light_munet as jl  # noqa: E402
from nnuzoo_tpu_torch.models import light_munet as tl  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .torch_port_helpers import (assert_model_matches_jax,  # noqa: E402
                                 load_converted, random_flax_params)

NC = 3


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare(jmod, tmod, x, seed=0, **kw):
    params = random_flax_params(jmod, jnp.asarray(x), seed=seed, **kw)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), **kw))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("dim", [2, 3])
def test_dwconv_gsc_and_res_up_block(dim):
    shape = (2,) + (6,) * dim + (5,)
    _compare(jl.DWConv(7, dim, 3, use_bias=True), tl.DWConv(5, 7, dim, 3, True),
             _x(1, *shape))
    _compare(jl.GSC(dim), tl.GSC(5, dim), _x(2, *shape))
    _compare(jl.ResUpBlock(dim), tl.ResUpBlock(5, dim), _x(3, *shape))


@pytest.mark.parametrize("shape,order", [((2, 6, 5, 8), (0, 1)), ((2, 6, 5, 8), (1, 0)),
                                         ((1, 4, 5, 3, 8), (0, 2, 1)),
                                         ((1, 4, 5, 3, 8), (2, 1, 0))])
def test_mamba_layer_in_each_axis_order(shape, order):
    """The axis permutation and its inverse wrap the flatten; the one
    LayerNorm is applied twice with shared parameters."""
    _compare(jl.MambaLayer(12), tl.MambaLayer(8, 12), _x(4, *shape), order=order)


def test_ss2d_mixer_layer():
    _compare(jl.MambaLayer(12, use_ss2d=True), tl.MambaLayer(8, 12, use_ss2d=True),
             _x(5, 2, 6, 5, 8))


def _whole(dim, use_ss2d, shape, **kw):
    got = assert_model_matches_jax(
        jl.LightMUNet(NC, dim, init_filters=4, use_ss2d=use_ss2d, **kw),
        tl.LightMUNet(1, NC, dim, init_filters=4, use_ss2d=use_ss2d, **kw),
        _x(6, *shape))
    assert got[0].shape == shape[:-1] + (NC,)


@pytest.mark.parametrize("use_ss2d", [False, True])
def test_light_munet_2d_matches_jax(use_ss2d):
    _whole(2, use_ss2d, (2, 32, 32, 1), blocks_down=(1, 1, 1), blocks_up=(1, 1))


def test_light_munet_3d_matches_jax():
    _whole(3, False, (1, 8, 16, 12, 1), blocks_down=(1, 1, 1), blocks_up=(1, 1))


def test_orders_and_head_dim_rule_match_jax():
    assert tl._ORDERS_2D == jl._ORDERS_2D and tl._ORDERS_3D == jl._ORDERS_3D
    for c in (4, 8, 24, 32, 48, 64, 96, 128, 256):
        assert tl.mamba2_headdim(c) == jl.mamba2_headdim(c), c
    m = tl.LightMUNet(1, NC, 3, init_filters=4)
    assert m.orders == [(0, 1, 2), (0, 2, 1), (2, 1, 0), (0, 1, 2)]
    x = torch.randn(1, 2, 3, 4, 5)
    for order in tl._ORDERS_3D:
        perm = tl._permutation(order, 3)
        if perm is None:
            continue
        assert torch.equal(x.permute(perm[0]).permute(perm[1]), x)
        assert x.permute(perm[0]).shape[1:4] == tuple(x.shape[1 + o] for o in order)


def test_mamba2_raises_and_names_the_slice(monkeypatch):
    """MambaLayer(use_mamba2=True) builds a Mamba2Block (d_state 16, the
    head width rule) on the route that NNUZOO_SCAN_BACKEND names, and
    raises on a value it does not know, naming the variable."""
    from nnuzoo_tpu_torch.models.mamba import Mamba2Block
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "mamba1")
    layer = tl.MambaLayer(8, 8, use_mamba2=True)
    assert isinstance(layer.mamba, Mamba2Block) and layer.mamba.route == "mamba1"
    assert (layer.mamba.d_state, layer.mamba.headdim) == (16, tl.mamba2_headdim(8))
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "mamba3")
    with pytest.raises(ValueError, match="NNUZOO_SCAN_BACKEND"):
        tl.MambaLayer(8, 8, use_mamba2=True)
    with pytest.raises(ValueError, match="2D-only"):
        tl.LightMUNet(1, NC, 3, use_ss2d=True)


def scan_shapes(monkeypatch, model, x_shape):
    """{(L, K*Dh, K): calls} of one forward of ``model`` on the meta device
    (shapes only), as the scan kernels would see them."""
    shapes = []
    monkeypatch.setattr(tscan, "scan_core_grad", lambda u, d, A_t, bc: (
        shapes.append((u.shape[1], u.shape[2], bc.shape[2] // (2 * A_t.shape[0])))
        or torch.empty_like(u)))
    with torch.no_grad():
        model(torch.empty(x_shape, device="meta"))
    return collections.Counter(shapes)


# one forward at 256x224 (batch 12) and at 48x192x192 (batch 2): (L, K*Dh, K)
LIGHT_MUNET_2D = {(57344, 64, 1): 3, (14336, 128, 1): 5, (3584, 256, 1): 5,
                  (896, 512, 1): 8}
LIGHT_MUNET_3D = {(1769472, 64, 1): 3, (221184, 128, 1): 5, (27648, 256, 1): 5,
                  (3456, 512, 1): 8}
LIGHT_SS2D_2D = {(57344, 256, 4): 3, (14336, 512, 4): 5, (3584, 1024, 4): 5,
                 (896, 2048, 4): 8}


@pytest.mark.parametrize("dim,use_ss2d,x_shape,want", [
    (2, False, (12, 256, 224, 1), LIGHT_MUNET_2D),
    (3, False, (2, 48, 192, 192, 1), LIGHT_MUNET_3D),
    (2, True, (12, 256, 224, 1), LIGHT_SS2D_2D)])
def test_full_width_forward_scan_shapes(monkeypatch, dim, use_ss2d, x_shape, want):
    with torch.device("meta"):
        model = tl.LightMUNet(1, NC, dim, use_ss2d=use_ss2d)
    assert scan_shapes(monkeypatch, model, x_shape) == want
    assert sum(want.values()) == 21


def test_builders_follow_the_plan_s_dimension():
    dj = {"labels": {"background": 0, "a": 1, "b": 2}}
    pm = PlansManager({"configurations": {"2d": {"patch_size": [32, 32]},
                                          "3d_fullres": {"patch_size": [8, 16, 16]}}})
    for name, use_ss2d in (("nnUNetTrainerLightMUNet", False),
                           ("nnUNetTrainerLightSS2DMambaUNet", True),
                           ("nnUNetTrainerLightMUNet_25Percent", False)):
        m = get_model_builder(name)(pm, dj, pm.get_configuration("2d"), 1,
                                    device="cpu", init_filters=4)
        assert isinstance(m, tl.LightMUNet) and m.dim == 2 and m.use_ss2d == use_ss2d
    m = get_model_builder("nnUNetTrainerLightMUNet")(
        pm, dj, pm.get_configuration("3d_fullres"), 1, device="cpu", init_filters=4)
    assert m.dim == 3
    with torch.no_grad():
        assert m(torch.zeros(1, 8, 16, 16, 1))[0].shape == (1, 8, 16, 16, NC)
    with pytest.raises(ValueError, match="2D-only"):
        get_model_builder("nnUNetTrainerLightSS2DMambaUNet")(
            pm, dj, pm.get_configuration("3d_fullres"), 1, device="cpu")

