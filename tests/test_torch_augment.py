"""The port's device-side augmentation against the JAX package's.

The two packages' random streams cannot be replayed, so every transform is
compared with its sampled parameters fixed: the port's "apply" functions take
them as arguments, the JAX functions are fed the same numbers. Inputs come
from numpy with a seed. fp32 on both sides: 1e-5 unless stated. The sampling
entry point ``augment_train_batch`` is checked for shapes, dtypes, label sets
and determinism under a seeded generator.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu_torch.data import augment as ta  # noqa: E402


def _cfg(mod, **over):
    kwargs = dict(patch_size=(20, 16), initial_patch_size=(28, 24),
                  rotation=float(np.pi), mirror_axes=(0, 1),
                  use_mask_for_norm=(False, True),
                  deep_supervision_scales=((1.0, 1.0), (1.0, 1.0), (0.5, 0.5),
                                           (0.25, 0.25)))
    kwargs.update(over)
    return mod.AugmentConfig(**kwargs)


@pytest.mark.parametrize("final,rot", [((256, 224), np.pi), ((40, 56, 48), 0.5),
                                       ((64, 64), np.pi * 15 / 180)])
def test_get_patch_size(final, rot):
    args = (final, (-rot, rot), (-rot, rot), (-rot, rot), (0.85, 1.25))
    np.testing.assert_array_equal(ta.get_patch_size(*args), ja.get_patch_size(*args))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("order,fill", [(1, 0.0), (0, -1.0)])
def test_affine_sample(dim, order, fill):
    """Rotation and scale, with coordinates that leave the volume, against
    ``map_coordinates``: linear with fill 0 for data, nearest with fill -1
    for labels. 1e-4 for the linear weights (coordinates of a few tens in
    fp32); the nearest samples must be equal."""
    rng = np.random.RandomState(dim * 10 + order)
    in_shape, out_shape = ((14, 12), (10, 9)) if dim == 2 else ((8, 9, 7), (6, 5, 6))
    B, C = 3, 2
    if order == 0:
        vol = rng.randint(0, 4, (B, C, *in_shape)).astype(np.float32)
    else:
        vol = rng.randn(B, C, *in_shape).astype(np.float32)
    mats = []
    for b in range(B):
        q, _ = np.linalg.qr(rng.randn(dim, dim))
        mats.append(q * rng.uniform(1.3, 1.9))      # reaches past the volume
    # the last sample lands on exact halves: an axis-aligned shift of 0.5
    mats[-1] = np.eye(dim)
    mats = np.stack(mats).astype(np.float32)
    got = ta._affine_sample(torch.from_numpy(vol), torch.from_numpy(mats),
                            in_shape, out_shape, order, fill)
    want = np.stack([np.asarray(ja._affine_sample(
        jnp.asarray(vol[b]), jnp.asarray(mats[b]), in_shape, out_shape, order, fill))
        for b in range(B)])
    assert got.shape == (B, C, *out_shape) and got.dtype == torch.float32
    if order == 0:
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == fill).any()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_blur_with_fixed_sigmas():
    rng = np.random.RandomState(1)
    B, C = 2, 2
    data = rng.randn(B, C, 12, 10).astype(np.float32)
    sigma = rng.uniform(0.5, 1.0, (B, C, 2)).astype(np.float32)
    got = ta._blur(torch.from_numpy(data), torch.from_numpy(sigma))
    for b in range(B):
        for c in range(C):
            want = jnp.asarray(data[b, c])
            for ax in range(2):
                want = ja._blur_axis(
                    want, ja._gaussian_kernel1d(jnp.float32(sigma[b, c, ax]), 3), ax)
            np.testing.assert_allclose(got[b, c].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_gamma_and_contrast_with_fixed_parameters():
    """The per-channel statistics transforms, parameters fixed; the JAX side
    is the arithmetic of ``_gamma`` and of the contrast step of
    ``_intensity_chain`` written out for one channel."""
    rng = np.random.RandomState(2)
    data = rng.randn(2, 2, 9, 8).astype(np.float32)
    g = rng.uniform(0.7, 1.5, (2, 2)).astype(np.float32)
    for invert in (False, True):
        got = ta._gamma_apply(torch.from_numpy(data), torch.from_numpy(g), invert)
        for b in range(2):
            for c in range(2):
                x = jnp.asarray(-data[b, c] if invert else data[b, c])
                mean, std, mn = x.mean(), x.std(), x.min()
                rng_ = x.max() - mn
                y = jnp.power((x - mn) / jnp.maximum(rng_, 1e-7), g[b, c]) * rng_ + mn
                y = (y - y.mean()) / jnp.maximum(y.std(), 1e-8) * std + mean
                y = -y if invert else y
                np.testing.assert_allclose(got[b, c].numpy(), np.asarray(y),
                                           rtol=1e-4, atol=1e-5)
    got = ta._contrast_apply(torch.from_numpy(data), torch.from_numpy(g))
    d = jnp.asarray(data[1, 0])
    want = jnp.clip((d - d.mean()) * g[1, 0] + d.mean(), d.min(), d.max())
    np.testing.assert_allclose(got[1, 0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_lowres_with_fixed_scale():
    """Nearest down, linear up at a fixed scale, against the same index
    arithmetic in numpy (the JAX function draws its scale inside)."""
    rng = np.random.RandomState(3)
    data = rng.randn(1, 1, 11, 8).astype(np.float32)
    scale = 0.6
    got = ta._lowres(torch.from_numpy(data), torch.full((1, 1), scale))[0, 0].numpy()
    want = data[0, 0].astype(np.float64)
    for ax in range(2):
        n = want.shape[ax]
        m = max(np.round(n * np.float32(scale)), 1.0)
        v = (np.arange(n) + 0.5) * m / n - 0.5
        j0 = np.clip(np.floor(v), 0, m - 1)
        j1 = np.clip(j0 + 1, 0, m - 1)
        w = np.clip(v - j0, 0.0, 1.0)
        s0 = np.clip(np.floor((j0 + 0.5) * n / m), 0, n - 1).astype(int)
        s1 = np.clip(np.floor((j1 + 0.5) * n / m), 0, n - 1).astype(int)
        shape = [1, 1]
        shape[ax] = n
        w = w.reshape(shape)
        want = np.take(want, s0, axis=ax) * (1 - w) + np.take(want, s1, axis=ax) * w
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # an identity scale changes nothing
    same = ta._lowres(torch.from_numpy(data), torch.ones(1, 1))
    np.testing.assert_allclose(same.numpy(), data, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_shape", [(10, 8), (5, 4), (3, 3)])
def test_nearest_downsample(out_shape):
    seg = np.random.RandomState(4).randint(0, 5, (2, 1, 20, 16)).astype(np.float32)
    got = ta._nearest_downsample(torch.from_numpy(seg), out_shape)
    want = np.stack([np.asarray(ja._nearest_downsample(jnp.asarray(s), out_shape))
                     for s in seg])
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_seg_to_regions():
    seg = np.random.RandomState(5).randint(0, 4, (2, 1, 9, 7)).astype(np.float32)
    regions = ((1, 2, 3), (2, 3), (3,), 1)
    got = ta.convert_seg_to_regions(torch.from_numpy(seg), regions)
    want = np.stack([np.asarray(ja.convert_seg_to_regions(jnp.asarray(s), regions,
                                                          None)) for s in seg])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("regions", [None, ((1, 2), (2,))])
def test_make_seg_targets(regions):
    rng = np.random.RandomState(6)
    seg = rng.randint(-1, 3, (2, 1, 20, 16)).astype(np.float32)
    got = ta.make_seg_targets(_cfg(ta, regions=regions), torch.from_numpy(seg))
    jcfg = _cfg(ja, regions=regions)
    want = [ja.make_seg_targets(jcfg, jnp.asarray(s)) for s in seg]
    assert len(got) == 4
    for i, g in enumerate(got):
        w = np.stack([np.asarray(per_sample[i]) for per_sample in want])
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[2].shape[2:] == (10, 8) and got[3].shape[2:] == (5, 4)
    assert float(got[0].min()) == 0.0                    # -1 became 0


def test_prepare_val_batch_matches_jax():
    rng = np.random.RandomState(7)
    data = rng.randn(2, 2, 20, 16).astype(np.float32)
    seg = rng.randint(-1, 3, (2, 1, 20, 16)).astype(np.int16)
    cfg = _cfg(ta, initial_patch_size=(20, 16))
    d, targets = ta.prepare_val_batch(cfg, torch.from_numpy(data),
                                      torch.from_numpy(seg))
    jd, jt = ja.prepare_val_batch(_cfg(ja, initial_patch_size=(20, 16)),
                                  jnp.asarray(data), jnp.asarray(seg))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    for g, w in zip(targets, jt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_spatial_matrix_is_rotation_times_scale():
    cfg = _cfg(ta, p_rotation=1.0, p_scaling=1.0)
    m = ta._spatial_matrix(cfg, torch.Generator().manual_seed(0), 64)
    scale = torch.linalg.det(m).abs().sqrt()
    assert ((scale >= 0.7 - 1e-5) & (scale <= 1.4 + 1e-5)).all()
    rot = m / scale[:, None, None]
    eye = torch.eye(2).expand(64, 2, 2)
    assert torch.allclose(rot @ rot.transpose(1, 2), eye, atol=1e-5)
    assert (torch.linalg.det(rot) > 0).all()
    # and the identity when neither gate fires
    cfg = _cfg(ta, p_rotation=0.0, p_scaling=0.0)
    m = ta._spatial_matrix(cfg, torch.Generator().manual_seed(0), 8)
    assert torch.equal(m, torch.eye(2).expand(8, 2, 2))


@pytest.mark.parametrize("dummy_2d", [False, True])
def test_rotation_matrix_3d_matches_jax_composition(dummy_2d):
    """The 3d matrices are proper rotations; with the dummy-2d option they
    leave axis 0 alone."""
    cfg = ta.AugmentConfig(patch_size=(8, 8, 8), initial_patch_size=(10, 10, 10),
                           rotation=0.5, do_dummy_2d=dummy_2d)
    m = ta._rotation_matrix(cfg, torch.Generator().manual_seed(1), 16)
    eye = torch.eye(3).expand(16, 3, 3)
    assert torch.allclose(m @ m.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(m), torch.ones(16), atol=1e-5)
    if dummy_2d:
        assert torch.equal(m[:, 0], eye[:, 0]) and torch.equal(m[:, :, 0], eye[:, :, 0])


def test_augment_train_batch_shapes_dtypes_labels_and_seed():
    rng = np.random.RandomState(8)
    B = 6
    data = rng.randn(B, 2, 28, 24).astype(np.float32)
    seg = rng.randint(0, 3, (B, 1, 28, 24)).astype(np.int16)
    cfg = _cfg(ta)
    out = [ta.augment_train_batch(cfg, torch.Generator().manual_seed(s),
                                  torch.from_numpy(data), torch.from_numpy(seg))
           for s in (0, 0, 1)]
    d, targets = out[0]
    assert d.shape == (B, 2, 20, 16) and d.dtype == torch.float32
    assert torch.isfinite(d).all()
    assert [tuple(t.shape) for t in targets] == [
        (B, 1, 20, 16), (B, 1, 20, 16), (B, 1, 10, 8), (B, 1, 5, 4)]
    for t in targets:
        assert t.dtype == torch.float32
        assert set(np.unique(t.numpy())) <= {0.0, 1.0, 2.0}
    # the same seed gives the same batch, another seed another one
    assert torch.equal(d, out[1][0]) and torch.equal(targets[0], out[1][1][0])
    assert not torch.equal(d, out[2][0])
    # without a segmentation only the data comes back
    d_only, none = ta.augment_train_batch(cfg, torch.Generator().manual_seed(0),
                                          torch.from_numpy(data), None)
    assert none is None and d_only.shape == d.shape


def test_use_mask_for_norm_zeroes_outside_the_segmentation():
    """With the spatial gates and the mirroring off the crop is the centre of
    the sampled patch, so the voxels whose seg is -1 are known: there channel
    1 (masked) is zero and channel 0 (not masked) is not, whatever the
    intensity transforms drew."""
    rng = np.random.RandomState(9)
    data = (5 + rng.rand(4, 2, 28, 24)).astype(np.float32)
    seg = rng.randint(0, 3, (4, 1, 28, 24)).astype(np.int16)
    seg[:, :, :, :12] = -1
    cfg = _cfg(ta, p_rotation=0.0, p_scaling=0.0, mirror_axes=())
    d, targets = ta.augment_train_batch(cfg, torch.Generator().manual_seed(3),
                                        torch.from_numpy(data), torch.from_numpy(seg))
    outside = torch.from_numpy(seg[:, 0, 4:24, 4:20] < 0)
    assert outside.any() and not outside.all()
    assert (d[:, 1][outside] == 0).all() and (d[:, 1][~outside] != 0).all()
    assert (d[:, 0][outside] != 0).all()
    assert (targets[0][:, 0][outside] == 0).all()        # RemoveLabel


@pytest.mark.parametrize("kwargs", [dict(is_cascaded=True),
                                    dict(target_type="translation")])
def test_what_is_not_ported_raises(kwargs):
    """The two configurations that the port used to refuse, the cascade and
    the translation target, now build and run on both paths (the name is
    kept from then; ``tests/test_torch_cascade.py`` and
    ``tests/test_torch_translation.py`` hold them to the JAX package)."""
    cascaded = kwargs.get("is_cascaded", False)
    cfg = _cfg(ta, foreground_labels=(1, 2) if cascaded else (), **kwargs)
    seg_channels = 2 if cascaded else 1
    seg = torch.ones(1, seg_channels, 28, 24, dtype=torch.int16)
    if not cascaded:
        seg = seg.float() * 3.5
    d, targets = ta.augment_train_batch(cfg, torch.Generator().manual_seed(0),
                                        torch.ones(1, 2, 28, 24), seg)
    assert d.shape == (1, 4 if cascaded else 2, 20, 16)
    assert [t.shape[1] for t in targets] == [1] * 4
    assert targets[0].dtype == torch.float32
    d, targets = ta.prepare_val_batch(cfg, torch.ones(1, 2, 20, 16),
                                      seg[..., :20, :16])
    assert d.shape == (1, 4 if cascaded else 2, 20, 16)
    if cascaded:
        assert (d[:, 2] == 1).all() and (d[:, 3] == 0).all()
    else:
        assert all((t == 3.5).all() for t in targets)
