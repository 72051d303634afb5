"""The port's LM2Net-family blocks (``models/lm2net.py``, ``x2net.py``'s
PatchExpandND, ``layers.py``'s pools and nearest resize) against the JAX
package's.

The scale plans (``ref_get_scales``, ``ref_scale_value``), the nearest
resize against ``jax.image.resize(..., "nearest")`` and the pools against
flax's (the ceil pool against the JAX package's -inf pad and pool) are
exact. DWRSU4F and PatchExpandND (with ``output_dim``, the Dense after the
depth-to-space, and without it, the Dense before) in fp32 to rtol 1e-4 with
atol 1e-4 of the output's largest magnitude. MiniLightMUNet with Mamba and
with Mamba2 at 2d, and at 3d, in fp64 on both sides (``jax_apply_fp64``;
the JAX scans and SSD stay fp32 inside, so the Mamba2 mini is held to 1e-3
of its largest magnitude, the others to rtol 1e-3 with atol 1e-4 of it);
one mini whose plan does not fit its map (odd extents) reaches the nearest
resize at a non-integer ratio.
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import lm2net as jl  # noqa: E402
from nnuzoo_tpu.models import m2net as jm2  # noqa: E402
from nnuzoo_tpu.models import x2net as jx  # noqa: E402
from nnuzoo_tpu_torch.models import layers as tlayers  # noqa: E402
from nnuzoo_tpu_torch.models import lm2net as tl  # noqa: E402
from nnuzoo_tpu_torch.models import x2net as tx  # noqa: E402

from .torch_port_helpers import (fp64_twin, jax_apply_fp64,  # noqa: E402
                                 load_converted, random_flax_params)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare(jmod, tmod, x, **kw):
    params = random_flax_params(jmod, jnp.asarray(x), **kw)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), **kw))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


SIZES = [(256, 224), (224, 224), (32, 48), (33, 47), (48, 192, 192),
         (80, 256, 224), (7, 9, 12), (17.5, 8.0), (64.0, 12.25, 6)]


def test_scale_plans_match_jax_exactly():
    for sizes, n, min_size in itertools.product(SIZES, range(7), (1, 4, 8)):
        got = tl.ref_get_scales(sizes, n, min_size)
        want = jl.ref_get_scales(sizes, n, min_size)
        assert got == want, (sizes, n, min_size)
        for i in range(n + 1):
            value = tl.ref_scale_value(sizes, got[:i])
            assert value == jl.ref_scale_value(sizes, want[:i])
            assert all(type(v) is float for v in value)
    for v in (7, 8, 7.0, 3.5, 12.25, 1):
        assert tl._get_scale(v) == jl._get_scale(v)


def test_nearest_resize_matches_jax_exactly():
    """Every pair of extents from 1 to 12 on each axis of a 2d map, and a 3d
    one; ``F.interpolate``'s "nearest" reads other voxels (7 -> 4)."""
    x = _x(1, 1, 12, 12, 2)
    for n, m in itertools.product(range(1, 13), repeat=2):
        src = x[:, :n, :m]
        for shape in ((m, n), (2 * n + 1, m), (max(1, n // 2), 3)):
            want = np.asarray(jax.image.resize(
                jnp.asarray(src), (1, *shape, 2), "nearest"))
            got = tlayers.resize_nearest(torch.from_numpy(src), shape).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{n}x{m} -> {shape}")
    x3 = _x(2, 2, 5, 7, 3, 4)
    want = np.asarray(jax.image.resize(jnp.asarray(x3), (2, 9, 4, 7, 4), "nearest"))
    got = tlayers.resize_nearest(torch.from_numpy(x3), (9, 4, 7)).numpy()
    np.testing.assert_array_equal(got, want)
    idx = torch.arange(7.0).reshape(1, 1, 7)
    assert torch.nn.functional.interpolate(idx, size=4).flatten().tolist() == \
        [0, 1, 3, 5]
    assert tlayers.resize_nearest(idx.reshape(1, 7, 1), (4,)).flatten().tolist() \
        == [0, 2, 4, 6]


def test_pools_match_flax():
    """Per-axis windows, floor at odd edges; the ceil pool at 2d against
    M2Net's and at 3d against the -inf pad LM2Net's bottleneck uses."""
    x2, x3 = _x(3, 2, 7, 9, 3), _x(4, 1, 5, 7, 9, 2)
    for window in ((2, 1), (1, 2), (2, 2), (3, 2)):
        want = np.asarray(fnn.max_pool(jnp.asarray(x2), window, strides=window))
        got = tlayers.max_pool(torch.from_numpy(x2), window, 2).numpy()
        np.testing.assert_array_equal(got, want)
    for window in ((2, 2, 1), (1, 2, 2), 2):
        w = window if isinstance(window, tuple) else (window,) * 3
        want = np.asarray(fnn.max_pool(jnp.asarray(x3), w, strides=w))
        got = tlayers.max_pool(torch.from_numpy(x3), window, 3).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jm2._maxpool2_ceil(jnp.asarray(x2)))
    np.testing.assert_array_equal(
        tlayers.max_pool_ceil(torch.from_numpy(x2), 2, 2).numpy(), want)
    padded = jnp.pad(jnp.asarray(x3), [(0, 0)] + [(0, s % 2) for s in x3.shape[1:-1]]
                     + [(0, 0)], constant_values=-np.inf)
    want = np.asarray(fnn.max_pool(padded, (2, 2, 2), strides=(2, 2, 2)))
    np.testing.assert_array_equal(
        tlayers.max_pool_ceil(torch.from_numpy(x3), 2, 3).numpy(), want)


@pytest.mark.parametrize("dim", [2, 3])
def test_dwrsu4f_matches_jax(dim):
    shape = (2,) + (7, 6, 5)[:dim] + (6,)
    _compare(jl.DWRSU4F(4, 8, dim), tl.DWRSU4F(6, 4, 8, dim), _x(5, *shape))
    _compare(jl.DWREBNCONV(5, dim), tl.DWREBNCONV(6, 5, dim), _x(6, *shape))


@pytest.mark.parametrize("scales,output_dim,shape", [
    ((2, 2), 12, (2, 3, 4, 16)), ((2, 1), 16, (2, 3, 4, 16)),
    ((2, 2), None, (2, 3, 4, 16)), ((1, 2), None, (1, 3, 2, 8)),
    ((2, 2, 2), 8, (1, 2, 3, 2, 16)), ((1, 2, 2), None, (1, 2, 3, 2, 8))])
def test_patch_expand_matches_jax(scales, output_dim, shape):
    _compare(jx.PatchExpandND(shape[-1], scales, output_dim=output_dim),
             tx.PatchExpandND(shape[-1], scales, output_dim=output_dim),
             _x(7, *shape))


def test_patch_expand_refuses_what_the_scales_do_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        tx.PatchExpandND(6, (2, 2), output_dim=8)


def _mini_matches(jmod, tmod, x, atol):
    params = random_flax_params(jmod, jnp.asarray(x))
    want = jax_apply_fp64(jmod, params, x)
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = fp64_twin(tmod)(torch.from_numpy(x).double()).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3 if atol < 1e-3 else 0,
                               atol=atol * scale)
    return got


@pytest.mark.parametrize("use_mamba2", [False, True])
def test_mini_light_munet_matches_jax(use_mamba2):
    """Three levels at 16x12 (pools of 2 and 2), add_last on (ignored with
    Mamba2, which also takes two blocks a level below the first)."""
    jmod = jl.MiniLightMUNet(8, 12, 3, 2, (16, 12), add_last=True,
                             use_mamba2=use_mamba2)
    tmod = tl.MiniLightMUNet(5, 8, 12, 3, 2, (16, 12), add_last=True,
                             use_mamba2=use_mamba2)
    assert hasattr(tmod, "rebnconvin") != use_mamba2
    assert hasattr(tmod, "down1_1") == use_mamba2
    got = _mini_matches(jmod, tmod, _x(8, 2, 16, 12, 5),
                        1e-3 if use_mamba2 else 1e-4)
    assert got.shape == (2, 16, 12, 12)


def test_mini_light_munet_3d_matches_jax():
    jmod = jl.MiniLightMUNet(8, 6, 3, 3, None, add_last=True)
    tmod = tl.MiniLightMUNet(3, 8, 6, 3, 3, None, add_last=True)
    assert tmod.scales((16, 12, 8)) == [(1, 1, 1), (2, 2, 2), (2, 1, 1)]
    _mini_matches(jmod, tmod, _x(9, 1, 16, 12, 8, 3), 1e-4)


def test_mini_whose_plan_does_not_fit_its_map(monkeypatch):
    """A plan of (16, 16) on a 13x10 map pools 13x10 -> 6x5 -> 3x2; the up
    path brings 3x2 to 6x5 and 6x5 to 13x10 by the nearest resize, 5 -> 10
    and 6 -> 13 at non-integer ratios, as LM2NetP's decoder stages with the
    reference's plan do at odd extents."""
    calls = []
    resize = tlayers.resize_nearest
    monkeypatch.setattr(tl, "resize_nearest", lambda x, shape: calls.append(
        (tuple(x.shape[1:-1]), tuple(shape))) or resize(x, shape))
    jmod = jl.MiniLightMUNet(8, 6, 3, 2, (16, 16), add_last=True)
    tmod = tl.MiniLightMUNet(4, 8, 6, 3, 2, (16, 16), add_last=True)
    _mini_matches(jmod, tmod, _x(10, 1, 13, 10, 4), 1e-4)
    assert calls == [((3, 2), (6, 5)), ((6, 5), (13, 10))]
