"""Each block of the port against its flax twin, with converted parameters.

Inputs and parameters are seeded numpy (``torch_port_helpers``). Both sides
compute in fp32 on the CPU; they differ in summation order and in how the
norms compute their variance, so outputs agree to rtol 1e-4 with atol 1e-4
times the output's largest magnitude (tighter where noted).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import layers as jlayers  # noqa: E402
from nnuzoo_tpu.models import m2net as jm2net  # noqa: E402
from nnuzoo_tpu.models import ss2d as jss2d  # noqa: E402
from nnuzoo_tpu.models import u2net as ju2net  # noqa: E402
from nnuzoo_tpu.models import vssm as jvssm  # noqa: E402
from nnuzoo_tpu_torch.models import layers as tlayers  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import ss2d as tss2d  # noqa: E402
from nnuzoo_tpu_torch.models import u2net as tu2net  # noqa: E402
from nnuzoo_tpu_torch.models import vssm as tvssm  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare(jmod, tmod, x, seed=0, rel=1e-4, **jkw):
    """Run the flax module and its converted torch twin on the same input."""
    params = random_flax_params(jmod, jnp.asarray(x), seed=seed, **jkw)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), **jkw))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("dirate", [1, 2])
def test_rebnconv(dirate):
    _compare(ju2net.REBNCONV(6, dirate), tu2net.REBNCONV(3, 6, dirate),
             _x(1, 2, 9, 7, 3))


def test_rsu4f():
    # 10x9 keeps the dilation-8 conv's window partly inside the map
    _compare(ju2net.RSU4F(4, 6), tu2net.RSU4F(5, 4, 6), _x(2, 2, 10, 9, 5))


def test_rebnconv_single_pixel_map():
    """A 1x1 map normalises to zero per channel, leaving the bias (the
    /32 level of a small patch)."""
    _compare(ju2net.REBNCONV(4), tu2net.REBNCONV(3, 4), _x(3, 2, 1, 1, 3))


@pytest.mark.parametrize("hw", [(8, 6), (7, 5)])
def test_patch_merging_even_and_odd(hw):
    _compare(jvssm.PatchMerging2D(4, 2, 6), tvssm.PatchMerging2D(4, 2, 6),
             _x(4, 2, *hw, 4))


@pytest.mark.parametrize("output_dim", [None, 8])
def test_patch_expand_both_modes(output_dim):
    _compare(jvssm.PatchExpand(8, 2, output_dim),
             tvssm.PatchExpand(8, 2, output_dim), _x(5, 2, 3, 4, 8))


def test_patch_embed():
    _compare(jvssm.PatchEmbed2D(2, 8), tvssm.PatchEmbed2D(3, 2, 8),
             _x(6, 2, 6, 4, 3))


def test_ss2d():
    # d_model 16 -> d_inner 32, the width every MU of M2NetP uses
    _compare(jss2d.SS2D(16), tss2d.SS2D(16), _x(7, 2, 6, 5, 16), train=False)


def test_ss2d_fused_glue_matches_jax_fused_glue(monkeypatch):
    """The fused cross-scan glue against the JAX SS2D with its fused glue
    (the Pallas kernels in interpret mode), d_model 16 and d_state 16: the
    output to 1e-4 of its max; the gradients of the input and of every
    parameter, sums over the batch and the map in other orders, to 1e-3 of
    each one's max."""
    from nnuzoo_tpu_torch.convert import convert_params
    x, dy = _x(13, 2, 6, 5, 16), _x(14, 2, 6, 5, 16)
    jmod = jss2d.SS2D(16, d_state=16)
    params = random_flax_params(jmod, jnp.asarray(x), train=False)
    tmod = load_converted(tss2d.SS2D(16, d_state=16), params)
    tss2d.set_ss2d_glue(tmod, "fused")
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "interpret")
    want, vjp = jax.vjp(lambda p, x: jmod.apply(p, x, train=False), params,
                        jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dy))
    want_p = convert_params(want_p, tmod)

    xt = torch.from_numpy(x).requires_grad_()
    names = [n for n, _ in tmod.named_parameters()]
    got = tmod(xt)
    grads = torch.autograd.grad(got, [xt] + list(tmod.parameters()),
                                torch.from_numpy(dy))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    for name, g, w in zip(["input"] + names, grads,
                          [np.asarray(want_x)] + [want_p[n].numpy() for n in names]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=name)


def test_vss_block():
    _compare(jss2d.VSSBlock(16), tss2d.VSSBlock(16), _x(8, 2, 5, 7, 16),
             train=False)


def test_mu():
    """A 3-layer MU at M2NetP's mid width: encoder with REBNCONV input,
    PatchMerging (to 8x6, then none before the last layer), decoder with
    PatchExpand, concat-back Linear, VSS stages and the seg conv."""
    _compare(jvssm.MU(3, 16, 8, 3), tvssm.MU(3, 16, 8, 3), _x(9, 1, 16, 12, 3),
             train=False)


def test_scan_backends_agree_in_ss2d():
    """The plain backend (``set_scan_backend``) is the same function as the
    default path; on the CPU both run the plain scan."""
    x = _x(10, 1, 4, 6, 16)
    jmod = jss2d.SS2D(16)
    tmod = load_converted(tss2d.SS2D(16), random_flax_params(
        jmod, jnp.asarray(x), train=False))
    with torch.no_grad():
        y_default = tmod(torch.from_numpy(x))
        tss2d.set_scan_backend(tmod, "plain")
        y_plain = tmod(torch.from_numpy(x))
    assert torch.equal(y_default, y_plain)


@pytest.mark.parametrize("src,dst", [((2, 2), (4, 4)), ((4, 3), (7, 5)),
                                     ((3, 4), (3, 9))])
def test_resize_linear_upsampling_matches_jax(src, dst):
    """Integer and non-integer factors (an odd /16 level gives 4 -> 7 through
    the ceil-mode pool); exact up to fp32 rounding."""
    x = _x(11, 2, *src, 3)
    want = np.asarray(jlayers.resize_linear(jnp.asarray(x), dst, 2))
    got = tlayers.resize_linear(torch.from_numpy(x), dst, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tlayers.resize_linear(torch.from_numpy(x), (1, 1), 2)


@pytest.mark.parametrize("hw", [(8, 6), (7, 5), (1, 1)])
def test_pools_and_pad_to_match(hw):
    x = _x(12, 2, *hw, 3)
    want = np.asarray(jm2net._maxpool2_ceil(jnp.asarray(x)))
    np.testing.assert_array_equal(tm2net._maxpool2_ceil(torch.from_numpy(x)).numpy(),
                                  want)
    if min(hw) >= 2:
        np.testing.assert_array_equal(
            tlayers.max_pool(torch.from_numpy(x), 2, 2).numpy(),
            np.asarray(jlayers.max_pool(jnp.asarray(x), 2, 2)))
    target = (hw[0] + 1, hw[1] + 2)
    np.testing.assert_array_equal(
        tlayers.pad_to_match(torch.from_numpy(x), target).numpy(),
        np.asarray(jlayers.pad_to_match(jnp.asarray(x), target)))


def test_drop_path_identity_in_eval_and_seeded_in_training():
    dp = tlayers.DropPath(0.5, torch.Generator().manual_seed(0))
    x = torch.ones(64, 3)
    assert torch.equal(dp.eval()(x), x)
    y = dp.train()(x)
    kept = (y[:, 0] != 0)
    assert 0 < int(kept.sum()) < 64
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
