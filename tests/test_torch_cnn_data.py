"""The port's 3d data path against the JAX package's: the augmentation's 3d
pieces, the 3d patch sampler with foreground oversampling, and the 3d
sliding-window Predictor of a PlainConvUNet.

The two packages' random streams differ, so each random transform is
compared with its draws fixed: the JAX function gets a range of one value
and a probability of 1 (blur, low resolution), or a key found whose draws
are the port's (mirroring); the spatial transform's matrix is drawn by the
port and applied by both. The sampler is a copy and must give the same
batches bit for bit from the same seed. fp32 on the CPU: the resampling
to 1e-5, the blur and low resolution to 1e-5, the Predictor's logits to
1e-3 of their range (a PlainConvUNet forward on each side, summed over
tiles and eight mirrorings).
"""

import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.data.dataset import DatasetNumpy as JaxDataset  # noqa: E402
from nnuzoo_tpu.data.patch_sampler import PatchSampler as JaxSampler  # noqa: E402
from nnuzoo_tpu.inference.predictor import Predictor as JaxPredictor  # noqa: E402
from nnuzoo_tpu.models import dynamic_unet as jdyn  # noqa: E402
from nnuzoo_tpu.plans.plans_handler import PlansManager as JaxPlans  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.data import augment as ta  # noqa: E402
from nnuzoo_tpu_torch.data.dataset import DatasetNumpy  # noqa: E402
from nnuzoo_tpu_torch.data.patch_sampler import PatchSampler  # noqa: E402
from nnuzoo_tpu_torch.inference.predictor import Predictor  # noqa: E402
from nnuzoo_tpu_torch.models import dynamic_unet as tdyn  # noqa: E402
from nnuzoo_tpu_torch.plans.label_handling import LabelManager  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .test_torch_cnn_trainer import DATASET, _plans  # noqa: E402
from .test_torch_dynamic_unet import ARCH_3D  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

PATCH = (4, 16, 16)            # anisotropic: max / first > 3, so dummy 2d
INITIAL = (4, 23, 23)
SCALES = ((1.0, 1.0, 1.0), (1.0, 0.5, 0.5), (0.5, 0.25, 0.25))


def _cfg(mod, **over):
    kwargs = dict(patch_size=PATCH, initial_patch_size=INITIAL, rotation=np.pi,
                  mirror_axes=(0, 1, 2), do_dummy_2d=True,
                  deep_supervision_scales=SCALES, p_rotation=1.0, p_scaling=1.0)
    kwargs.update(over)
    return mod.AugmentConfig(**kwargs)


def _data(seed, B=3, C=2, shape=INITIAL):
    rng = np.random.RandomState(seed)
    data = rng.randn(B, C, *shape).astype(np.float32)
    seg = rng.randint(0, 3, (B, 1, *shape)).astype(np.int16)
    return data, seg


def test_dummy_2d_spatial_transform_matches_jax_resampling():
    """With the dummy-2d option the port's matrices leave axis 0 alone (no
    rotation out of the plane, no scaling along it) and rotate and scale
    the plane; the data (linear, fill 0) and labels (nearest, fill -1) it
    resamples with them are what the JAX function gives for the same
    matrices."""
    cfg = _cfg(ta)
    data, seg = _data(1)
    got_d, got_s = ta._spatial_transform(cfg, torch.Generator().manual_seed(5),
                                         torch.from_numpy(data),
                                         torch.from_numpy(seg))
    m = ta._spatial_matrix(cfg, torch.Generator().manual_seed(5), 3).numpy()
    e0 = np.eye(3)[0]
    assert np.allclose(m[:, 0], e0) and np.allclose(m[:, :, 0], e0)
    plane = m[:, 1:, 1:]
    scale = np.sqrt(np.abs(np.linalg.det(plane)))
    assert ((scale > 0.7 - 1e-5) & (scale < 1.4 + 1e-5)).all()
    rot = plane / scale[:, None, None]
    assert np.allclose(rot @ rot.transpose(0, 2, 1), np.eye(2), atol=1e-5)
    for b in range(3):
        want_d = ja._affine_sample(jnp.asarray(data[b]), jnp.asarray(m[b]),
                                   INITIAL, PATCH, 1, 0.0)
        want_s = ja._affine_sample(jnp.asarray(seg[b].astype(np.float32)),
                                   jnp.asarray(m[b]), INITIAL, PATCH, 0, -1.0)
        np.testing.assert_allclose(got_d[b].numpy(), np.asarray(want_d),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_s[b].numpy(), np.asarray(want_s))


def test_mirroring_over_three_axes_matches_jax():
    """Each sample flipped over the axes the port drew is the JAX function's
    output under a key whose draws are the same flips."""
    cfg = _cfg(ta, patch_size=PATCH, initial_patch_size=PATCH)
    data, seg = _data(2, B=6, shape=PATCH)
    got_d, got_s = ta._mirror(cfg, torch.Generator().manual_seed(3),
                              torch.from_numpy(data), torch.from_numpy(seg))
    replay = torch.Generator().manual_seed(3)
    flips = np.stack([ta._bernoulli(replay, (6,)).numpy() for _ in range(3)], 1)
    assert 0 < flips.sum() < flips.size
    jcfg = _cfg(ja, patch_size=PATCH, initial_patch_size=PATCH)
    for b in range(6):
        key = next(k for k in map(jax.random.PRNGKey, range(1000)) if [
            bool(jax.random.bernoulli(jax.random.fold_in(k, i))) for i in range(3)]
            == flips[b].tolist())
        want_d, want_s = ja._mirror(jcfg, key, jnp.asarray(data[b]),
                                    jnp.asarray(seg[b]))
        np.testing.assert_array_equal(got_d[b].numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_s[b].numpy(), np.asarray(want_s))


def test_anisotropic_deep_supervision_targets_match_jax():
    cfg = _cfg(ta)
    _, seg = _data(3, shape=PATCH)
    seg[0, 0, 0, :3] = -1
    got = ta.make_seg_targets(cfg, torch.from_numpy(seg))
    assert [tuple(t.shape[2:]) for t in got] == [(4, 16, 16), (4, 8, 8), (2, 4, 4)]
    for b in range(3):
        want = ja.make_seg_targets(_cfg(ja), jnp.asarray(seg[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("ignore_axes", [(0,), ()])
def test_lowres_in_plane_matches_jax(ignore_axes):
    """Simulated low resolution at 3d: with the dummy-2d option axis 0 keeps
    its resolution."""
    data, _ = _data(4, B=1, shape=(4, 15, 12))
    scale = np.float32(0.6)
    got = ta._lowres(torch.from_numpy(data), torch.full((1, 2), float(scale)),
                     ignore_axes)
    want = ja._simulate_lowres(jax.random.PRNGKey(0), jnp.asarray(data[0]),
                               ignore_axes, p_channel=1.0, scale_range=(scale, scale))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    other = ta._lowres(torch.from_numpy(data), torch.full((1, 2), float(scale)),
                       () if ignore_axes else (0,))
    assert not torch.allclose(got, other)


def test_blur_3d_matches_jax():
    data, _ = _data(5, B=1, shape=(5, 9, 8))
    sigma = np.float32(0.8)
    got = ta._blur(torch.from_numpy(data), torch.full((1, 2, 3), float(sigma)))
    want = ja._gaussian_blur(jax.random.PRNGKey(0), jnp.asarray(data[0]),
                             p_channel=1.0, sigma_range=(sigma, sigma))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_augment_train_batch_3d_dummy_2d():
    data, seg = _data(6)
    cfg = _cfg(ta, p_rotation=0.2, p_scaling=0.2)
    out = [ta.augment_train_batch(cfg, torch.Generator().manual_seed(s),
                                  torch.from_numpy(data), torch.from_numpy(seg))
           for s in (0, 0, 1)]
    d, targets = out[0]
    assert d.shape == (3, 2, *PATCH) and d.dtype == torch.float32
    assert torch.isfinite(d).all()
    assert [tuple(t.shape) for t in targets] == [(3, 1, 4, 16, 16), (3, 1, 4, 8, 8),
                                                 (3, 1, 2, 4, 4)]
    assert set(np.unique(targets[0].numpy())) <= {0.0, 1.0, 2.0}
    assert torch.equal(d, out[1][0]) and not torch.equal(d, out[2][0])


def _write_cases(folder, shapes, seed=0):
    """Preprocessed 3d cases as both packages' ``DatasetNumpy`` read them."""
    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    for i, shape in enumerate(shapes):
        seg = np.zeros((1, *shape), np.int16)
        seg[0, 1:3, 4:9, 5:10] = 1
        seg[0, -2:, -6:-2, 2:5] = 2
        data = (seg + rng.randn(1, *shape)).astype(np.float32)
        locations = {label: np.argwhere(seg == label) for label in (1, 2)}
        np.savez(os.path.join(folder, f"case_{i}.npz"), data=data, seg=seg)
        with open(os.path.join(folder, f"case_{i}.pkl"), "wb") as f:
            pickle.dump({"class_locations": locations}, f)


def test_3d_sampler_with_foreground_oversampling_matches_jax(tmp_path):
    """The same seed draws the same 3d batches: cases smaller than the
    initial patch along some axes (padded, data with 0 and labels with -1),
    the last third of each batch centred on a stored foreground voxel."""
    folder = str(tmp_path / "nnUNetPlans_3d_fullres")
    _write_cases(folder, [(6, 30, 28), (9, 20, 26), (5, 24, 24)])
    lm = LabelManager({"background": 0, "a": 1, "b": 2}, None)
    from nnuzoo_tpu.plans.label_handling import LabelManager as JaxLabels
    jlm = JaxLabels({"background": 0, "a": 1, "b": 2}, None)
    port = PatchSampler(DatasetNumpy(folder), 3, INITIAL, PATCH, lm, seed=4)
    ref = JaxSampler(JaxDataset(folder), 3, INITIAL, PATCH, jlm, seed=4)
    fg = 0
    for _ in range(4):
        got, want = next(port), next(ref)
        assert got["keys"] == want["keys"]
        np.testing.assert_array_equal(got["data"], want["data"])
        np.testing.assert_array_equal(got["target"], want["target"])
        assert got["data"].shape == (3, 1, *INITIAL)
        fg += int((got["target"][2] > 0).any())
    assert fg == 4                    # the forced-foreground sample has it


@pytest.fixture(scope="module")
def predictors():
    plans = _plans(3, (8, 16, 16))
    jmodel = jdyn.PlainConvUNet(ARCH_3D, 3, deep_supervision=False)
    # weights of the model with deep supervision, as a trained fold holds them
    params = random_flax_params(jdyn.PlainConvUNet(ARCH_3D, 3),
                                jnp.zeros((1, 8, 16, 16, 1)), seed=6)
    jpm = JaxPlans(plans)
    jp = JaxPredictor(tile_batch_size=3)
    jp.manual_initialization(jmodel, [params], jpm, jpm.get_configuration("3d_fullres"),
                             DATASET, "nnUNetTrainer", (0, 1, 2))
    pm = PlansManager(plans)
    tmodel = tdyn.PlainConvUNet(1, ARCH_3D, 3, deep_supervision=False)
    tp = Predictor(tile_batch_size=3, device="cpu")
    tp.manual_initialization(tmodel, [convert_params(params, tmodel)], pm,
                             pm.get_configuration("3d_fullres"), DATASET,
                             "nnUNetTrainer", (0, 1, 2))
    return jp, tp


def test_3d_predictor_logits_match_jax(predictors):
    """A 10x20x18 volume takes 2x2x2 tiles of 8x16x16 (3 tile batches of 3,
    the last short), each with mirror TTA over the three axes."""
    jp, tp = predictors
    data = np.random.RandomState(7).randn(1, 10, 20, 18).astype(np.float32)
    want = jp.predict_logits_from_preprocessed_data(data)
    before = tp.forward_count
    got = tp.predict_logits_from_preprocessed_data(data)
    assert got.shape == want.shape == (3, 10, 20, 18)
    assert tp.forward_count - before == 3 * 8
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * span)


def test_3d_segmentation_matches_jax(predictors):
    """A raw (1, 12, 18, 17) volume through preprocessing, the sliding
    window and the export: the same segmentation (the probabilities, softmax
    of logits that agree to 1e-3 of their range, to 1e-3)."""
    jp, tp = predictors
    vol = (100 * np.random.RandomState(8).rand(1, 12, 18, 17)).astype(np.float32)
    props = {"spacing": [1.0, 1.0, 1.0]}
    want, want_p = jp.predict_single_npy_array(vol, dict(props),
                                               save_or_return_probabilities=True)
    got, got_p = tp.predict_single_npy_array(vol, dict(props),
                                             save_or_return_probabilities=True)
    assert got.shape == want.shape == (12, 18, 17)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got, want)
