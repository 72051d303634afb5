"""The port's SegMamba against the JAX package's.

Seeded numpy inputs and converted parameters. MambaLayer3Way (its slice
count halved until it divides the length) and MlpChannel agree in fp32 to
rtol 1e-4 with atol 1e-4 times the output's largest magnitude. The whole
model at ``feat_size=(4, 8, 16, 32)`` (hidden size 32), 2d (32x32) and 3d
(16x32x32), in fp64 on both sides (``jax_apply_fp64``; the JAX scans stay
fp32) to rtol 1e-3 with atol 1e-4 of the output's largest magnitude, the port's fp32 output to
its own fp64 output within 5e-3 (``assert_model_matches_jax``). The scan
shapes of one forward at full width (256x224 and zoo_sweep's 3d patch
48x192x192) are fixed on the meta device.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import seg_mamba as js  # noqa: E402
from nnuzoo_tpu_torch.models import seg_mamba as ts  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .test_torch_light_munet import scan_shapes  # noqa: E402
from .torch_port_helpers import (assert_model_matches_jax,  # noqa: E402
                                 load_converted, random_flax_params)

NC = 3
SMALL = dict(feat_size=(4, 8, 16, 32), hidden_size=32)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare(jmod, tmod, x):
    params = random_flax_params(jmod, jnp.asarray(x), seed=1)
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape,num_slices", [((2, 4, 6, 8), 64), ((1, 2, 3, 4, 8), 16)])
def test_mamba_layer_3way(shape, num_slices):
    """24 tokens: 64 slices halve to 8; 24 tokens, 16 slices to 8."""
    _compare(js.MambaLayer3Way(8, num_slices), ts.MambaLayer3Way(8, num_slices),
             _x(1, *shape))


def test_mlp_channel_exact_gelu():
    _compare(js.MlpChannel(12), ts.MlpChannel(6, 12, 2), _x(2, 2, 5, 4, 6))


@pytest.mark.parametrize("dim,shape", [(2, (2, 32, 32, 1)), (3, (1, 16, 32, 32, 1))])
def test_segmamba_matches_jax(dim, shape):
    got = assert_model_matches_jax(js.SegMamba(NC, dim, **SMALL),
                                   ts.SegMamba(1, NC, dim, **SMALL), _x(3, *shape))
    assert len(got) == 1 and got[0].shape == shape[:-1] + (NC,)


# one forward at 256x224 (batch 12) and at 48x192x192 (batch 2): (L, K*Dh, K)
SEG_MAMBA_2D = {(14336, 96, 1): 6, (3584, 192, 1): 6, (896, 384, 1): 6,
                (224, 768, 1): 6}
SEG_MAMBA_3D = {(221184, 96, 1): 6, (27648, 192, 1): 6, (3456, 384, 1): 6,
                (432, 768, 1): 6}


@pytest.mark.parametrize("dim,x_shape,want", [(2, (12, 256, 224, 1), SEG_MAMBA_2D),
                                              (3, (2, 48, 192, 192, 1), SEG_MAMBA_3D)])
def test_full_width_forward_scan_shapes(monkeypatch, dim, x_shape, want):
    with torch.device("meta"):
        model = ts.SegMamba(1, NC, dim)
    assert scan_shapes(monkeypatch, model, x_shape) == want


def test_builder_follows_the_plan_s_dimension():
    dj = {"labels": {"background": 0, "a": 1, "b": 2}}
    pm = PlansManager({"configurations": {"2d": {"patch_size": [32, 32]},
                                          "3d_fullres": {"patch_size": [16, 32, 32]}}})
    build = get_model_builder("nnUNetTrainerSegMamba")
    for name, shape in (("2d", (1, 32, 32, 1)), ("3d_fullres", (1, 16, 32, 32, 1))):
        m = build(pm, dj, pm.get_configuration(name), 1, device="cpu", **SMALL)
        with torch.no_grad():
            assert m(torch.zeros(shape))[0].shape == shape[:-1] + (NC,)
    assert get_model_builder("nnUNetTrainerSegMamba_10Percent") is build
