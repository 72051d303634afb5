"""The nnU-Net CNN units and the plan-driven U-Nets of the port against the
JAX package's, with converted parameters, 2d and 3d.

Inputs and parameters are seeded numpy (``torch_port_helpers``); both sides
compute in fp32 on the CPU and differ in summation order and in how the
norms compute their variance. Blocks agree to rtol 1e-4 with atol 1e-4
times the output's largest magnitude; whole models, whose errors grow
through a dozen convs and norms, to rtol 1e-3 with atol 5e-4 times it.
Two of flax's conventions differ from torch's and are checked where they
bite: "SAME" padding with stride 2 on an even size (one more voxel at the
high end), and the transposed conv's kernel, which the converter flips.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import dynamic_unet as jdyn  # noqa: E402
from nnuzoo_tpu.models import layers as jlayers  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.models import dynamic_unet as tdyn  # noqa: E402
from nnuzoo_tpu_torch.models import layers as tlayers  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402

BLOCK_TOL = 1e-4
MODEL_RTOL, MODEL_ATOL = 1e-3, 5e-4

ARCH_3D = {"n_stages": 3, "features_per_stage": [4, 8, 16],
           "kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3]],
           "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2]],
           "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 1]}
ARCH_2D = {"n_stages": 3, "features_per_stage": [4, 8, 16],
           "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 2]],
           "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [1, 2]}


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_pair(jmod, tmod, x, seed=0):
    params = random_flax_params(jmod, jnp.asarray(x), seed=seed)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    return got, want, params


def _close(got, want, rtol, atol_rel, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("size", [5, 6, 7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3])
def test_same_padding_matches_flax(size, stride, kernel):
    """``conv_same`` against flax's ``Conv(padding="SAME")`` on every axis of
    a 3d map, at even and odd sizes and strides 1 and 2; the pads agree with
    XLA's."""
    x = _x(size, 2, size, size + 1, 4, 3)
    jconv = fnn.Conv(5, (kernel, kernel, 3), strides=(stride, stride, 1),
                     padding="SAME")
    tconv = torch.nn.Conv3d(3, 5, (kernel, kernel, 3), stride=(stride, stride, 1))
    params = random_flax_params(jconv, jnp.asarray(x), seed=1)
    want = jconv.apply(params, jnp.asarray(x))
    tconv.load_state_dict(convert_params(params, tconv))
    with torch.no_grad():
        got = tlayers.conv_same(tconv, torch.from_numpy(x))
    _close(got, want, BLOCK_TOL, BLOCK_TOL)
    xla = jax.lax.padtype_to_pads(x.shape[1:4], (kernel, kernel, 3),
                                  (stride, stride, 1), "SAME")
    assert tlayers.same_pads(x.shape[1:4], (kernel, kernel, 3), (stride, stride, 1),
                             (1, 1, 1)) == [tuple(p) for p in xla]


def test_same_padding_stride_2_even_size_pads_the_high_end():
    """The trap: on 6 samples flax's k=3, s=2 conv starts at x[0] (pad 0
    low, 1 high), where torch's ``padding=1`` starts at x[-1]."""
    assert tlayers.same_pads((6,), (3,), (2,), (1,)) == [(0, 1)]
    assert tlayers.same_pads((7,), (3,), (2,), (1,)) == [(1, 1)]
    conv = torch.nn.Conv1d(1, 1, 3, stride=2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor([[[1.0, 10.0, 100.0]]]))
        y = tlayers.conv_same(conv, torch.arange(6.0).reshape(1, 6, 1))
    assert y.flatten().tolist() == [210.0, 432.0, 54.0]


@pytest.mark.parametrize("dim,strides", [(2, (2, 2)), (3, (2, 2, 2)),
                                         (3, (1, 2, 2))])
def test_transposed_conv_up(dim, strides):
    """flax's ``ConvTranspose`` is the spatial flip of torch's: the
    converted kernel gives flax's output only because the converter flips
    it."""
    shape = (2, 3, 4, 5)[:dim]
    x = _x(dim, 2, *shape, 6)
    got, want, params = _run_pair(jlayers.TransposedConvUp(4, strides, dim=dim),
                                  tlayers.TransposedConvUp(6, 4, strides, dim), x)
    _close(got, want, BLOCK_TOL, BLOCK_TOL)
    # and without the flip the numbers differ (the shapes do not)
    tmod = tlayers.TransposedConvUp(6, 4, strides, dim)
    flat = convert_params(params, tmod)
    flat["transpconv.weight"] = flat["transpconv.weight"].flip(
        list(range(2, 2 + dim)))
    tmod.load_state_dict(flat)
    with torch.no_grad():
        unflipped = tmod(torch.from_numpy(x)).numpy()
    assert np.abs(unflipped - np.asarray(want)).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_norm_act(dim, stride):
    shape = (6, 7, 8)[3 - dim:]
    x = _x(10 + dim, 2, *shape, 3)
    got, want, _ = _run_pair(jlayers.ConvNormAct(5, 3, stride, dim=dim),
                             tlayers.ConvNormAct(3, 5, 3, stride, dim), x)
    _close(got, want, BLOCK_TOL, BLOCK_TOL)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("stride,in_ch", [(1, 5), (1, 3), (2, 3)])
def test_residual_block(dim, stride, in_ch):
    """Without the skip conv (same width, stride 1), with it for a new
    width, and for stride 2 on even sizes."""
    shape = (4, 6, 8)[3 - dim:]
    x = _x(20 + dim + stride, 2, *shape, in_ch)
    got, want, params = _run_pair(jlayers.ResidualBlock(5, 3, stride, dim=dim),
                                  tlayers.ResidualBlock(in_ch, 5, 3, stride, dim), x)
    assert ("skip" in params["params"]) == (stride != 1 or in_ch != 5)
    _close(got, want, BLOCK_TOL, BLOCK_TOL)


@pytest.mark.parametrize("arch,patch", [(ARCH_2D, (16, 12)),
                                        (ARCH_3D, (8, 16, 16))],
                         ids=["2d", "3d_anisotropic"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("deep_supervision", [True, False])
def test_unet_matches_jax(arch, patch, residual, deep_supervision):
    jcls = jdyn.ResidualEncoderUNet if residual else jdyn.PlainConvUNet
    tcls = tdyn.ResidualEncoderUNet if residual else tdyn.PlainConvUNet
    x = _x(31, 2, *patch, 2)
    # weights of the model trained with deep supervision, as the Predictor
    # loads them (the JAX module without it ignores the deeper heads)
    params = random_flax_params(jcls(arch, 3), jnp.asarray(x), seed=4)
    want = jcls(arch, 3, deep_supervision=deep_supervision).apply(
        params, jnp.asarray(x))
    tmod = load_converted(tcls(2, arch, 3, deep_supervision), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert len(got) == len(want) == (2 if deep_supervision else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, MODEL_RTOL, MODEL_ATOL, f"output {i}")


def test_residual_unet_reads_n_blocks_per_stage():
    arch = dict(ARCH_3D, n_blocks_per_stage=[1, 2, 1])
    model = tdyn.ResidualEncoderUNet(1, arch, 2)
    names = [n for n, _ in model.encoder.named_children()]
    assert names == ["stage0_block0", "stage1_block0", "stage1_block1",
                     "stage2_block0"]
    outs = model(torch.zeros(1, 8, 16, 16, 1))
    assert [tuple(o.shape) for o in outs] == [(1, 8, 16, 16, 2), (1, 8, 8, 8, 2)]


def test_converter_round_trip_at_5d():
    """JAX params -> state_dict -> JAX params gives back every array bit for
    bit, the 5-d conv kernels and the flipped transposed-conv kernels among
    them."""
    jmod = jdyn.PlainConvUNet(ARCH_3D, 3)
    params = random_flax_params(jmod, jnp.zeros((1, 8, 16, 16, 1)), seed=7)
    model = tdyn.PlainConvUNet(1, ARCH_3D, 3)
    state = convert_params(params, model)
    assert state["decoder.up0.transpconv.weight"].shape == (16, 8, 2, 2, 2)
    assert state["encoder.stage1.conv0.conv.weight"].shape == (8, 4, 3, 3, 3)
    back = flatten_params(params_from_state_dict(state))
    want = flatten_params(params["params"])
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_init_parameters_follows_flax_scales():
    """The seeded initialisation draws conv kernels at 1/sqrt(fan_in), a
    transposed conv's fan-in being its input channels times its kernel, with
    zero biases and unit norm scales."""
    model = tlayers.build_seeded(lambda: tdyn.PlainConvUNet(1, ARCH_3D, 3), "cpu", 0)
    up = model.decoder.up0.transpconv.weight          # (16, 8, 2, 2, 2)
    conv = model.encoder.stage2.conv1.conv.weight     # (16, 16, 3, 3, 3)
    assert abs(up.std().item() * np.sqrt(16 * 8) - 1) < 0.1
    assert abs(conv.std().item() * np.sqrt(16 * 27) - 1) < 0.1
    assert model.encoder.stage2.conv1.conv.bias.abs().max() == 0
    assert (model.encoder.stage2.conv1.norm.weight == 1).all()
