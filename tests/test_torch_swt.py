"""The port's Swin-Transformer U-Nets and N-d patch merging against the JAX
package's (``nnuzoo_tpu/models/swt.py``, ``x2net.py:PatchMergingND``).

Seeded numpy inputs and converted parameters, fp32 on the CPU on both
sides. PatchMergingND (odd extents truncated, 2d and 3d, anisotropic
scales) to rtol 1e-4 with atol 1e-4 of the output's largest magnitude;
each whole model small to rtol 1e-3 with atol 5e-4 of its largest magnitude:
SwinTransformerUnet (embed 8) at 64x56, whose stages see 16x14, 8x7 (window
7 kept with its shift, padded), 4x3 and 2x1 (windows clamped, no shift) and
whose decoder crops and pads back the floored extents; SwinUNETR (feature
size 4) at 2d (64x48, its blocks under ``block2d``) and at 3d (16x32x32:
windows (7, 7, 7) padded, then (4, 7, 7) with the first axis unshifted). The
converter carries each both ways exactly. At full width the parameter
counts equal the JAX models'; SwT at 3d raises on both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import swt as js  # noqa: E402
from nnuzoo_tpu.models import x2net as jx  # noqa: E402
from nnuzoo_tpu_torch.models import swt as ts  # noqa: E402
from nnuzoo_tpu_torch.models import x2net as tx  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .test_torch_unetr import assert_round_trip, compare_model, param_counts  # noqa: E402

NC = 3
SWT_SMALL = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
SWIN_UNETR_SMALL = dict(feature_size=4, num_heads=(1, 1, 2, 2))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,scales,out", [
    ((2, 7, 9, 6), (2, 2), None), ((1, 5, 8, 6, 4), (2, 2, 2), 12),
    ((2, 3, 8, 10, 4), (1, 2, 2), 6)])
def test_patch_merging_nd(shape, scales, out):
    compare_model(jx.PatchMergingND(shape[-1], scales, out),
                  tx.PatchMergingND(shape[-1], scales, out), _x(1, *shape),
                  rtol=1e-4, atol=1e-4)


def test_swin_transformer_unet_matches_jax_and_converts_both_ways():
    shape = (2, 64, 56, 1)
    tmod = ts.SwinTransformerUnet(1, NC, shape[1:3], **SWT_SMALL)
    params = compare_model(js.SwinTransformerUnet(NC, **SWT_SMALL), tmod,
                           _x(2, *shape), train=False)
    assert_round_trip(tmod, params)
    # the stages' windows: 7 with shift, 7 with shift (8x7 padded), 3 and 1
    # clamped without
    blocks = [getattr(tmod, f"enc{i}").block1 for i in range(4)]
    assert [b.attn.window for b in blocks] == [(7, 7), (7, 7), (3, 3), (1, 1)]
    assert [b.window_and_shift(s)[1] for b, s in
            zip(blocks, [(16, 14), (8, 7), (4, 3), (2, 1)])] == \
        [(3, 3), (3, 3), (0, 0), (0, 0)]


@pytest.mark.parametrize("dim,shape", [(2, (2, 64, 48, 1)), (3, (1, 16, 32, 32, 1))])
def test_swin_unetr_matches_jax_and_converts_both_ways(dim, shape):
    tmod = ts.SwinUNETR(1, NC, shape[1:-1], **SWIN_UNETR_SMALL)
    params = compare_model(js.SwinUNETR(NC, dim, **SWIN_UNETR_SMALL), tmod,
                           _x(3, *shape), train=False)
    assert_round_trip(tmod, params)
    stage0 = params["params"]["swin0"]["block1"]
    if dim == 2:
        assert set(stage0) == {"block2d"}
    else:
        assert tmod.swin1.block1.window_and_shift((4, 8, 8)) == ((4, 7, 7), (0, 3, 3))


@pytest.mark.parametrize("name,shape,count", [
    ("swt", (1, 256, 224, 1), 52_034_604),
    ("swin_unetr_2d", (1, 256, 224, 1), 10_545_501),
    ("swin_unetr_3d", (1, 48, 192, 192, 1), 21_270_981)])
def test_full_width_parameter_count_equals_jax(name, shape, count):
    spatial = shape[1:-1]
    if name == "swt":
        jmod = js.SwinTransformerUnet(NC, depths=(2, 2, 9, 2))
        factory = lambda: ts.SwinTransformerUnet(1, NC, spatial,  # noqa: E731
                                                 depths=(2, 2, 9, 2))
    else:
        jmod = js.SwinUNETR(NC, len(spatial))
        factory = lambda: ts.SwinUNETR(1, NC, spatial)  # noqa: E731
    assert param_counts(jmod, factory, shape, train=False) == (count, count)


def _plans():
    return PlansManager({"configurations": {
        "2d": {"patch_size": [64, 48]},
        "3d_fullres": {"patch_size": [16, 32, 32]}}})


DJ = {"labels": {"background": 0, "a": 1, "b": 2}}


def test_builders_follow_the_plan_and_swt_refuses_3d():
    pm = _plans()
    swin_unetr = get_model_builder("nnUNetTrainerSwUNETR")
    for name, shape in (("2d", (1, 64, 48, 1)), ("3d_fullres", (1, 16, 32, 32, 1))):
        m = swin_unetr(pm, DJ, pm.get_configuration(name), 1, device="cpu",
                       **SWIN_UNETR_SMALL)
        with torch.no_grad():
            assert m(torch.zeros(shape))[0].shape == shape[:-1] + (NC,)
    swt = get_model_builder("nnUNetTrainerSwinTransformerUnet")
    m = swt(pm, DJ, pm.get_configuration("2d"), 1, device="cpu", **SWT_SMALL)
    with torch.no_grad():
        assert m(torch.zeros(1, 64, 48, 1))[0].shape == (1, 64, 48, NC)
    # the production depths unless overridden, drop path rising to 0.1
    rates = [b.drop_path.rate for i in range(4) for b in getattr(m, f"enc{i}").children()]
    assert rates == pytest.approx([0.1 * j / 7 for j in range(8)])
    with pytest.raises(ValueError, match="2D-only"):
        swt(pm, DJ, pm.get_configuration("3d_fullres"), 1, device="cpu")
    with pytest.raises(AssertionError, match="2D-only"):
        js.get_swt_from_plans(pm, DJ, pm.get_configuration("3d_fullres"), 1)
    for suffix in ("_05Percent", "_10Percent"):
        assert get_model_builder("nnUNetTrainerSwUNETR" + suffix) is swin_unetr
        assert get_model_builder("nnUNetTrainerSwinTransformerUnet" + suffix) is swt
