"""The translation target (a float image to regress) in the port against the
JAX package, on the CPU.

The augmentation: the antialiased linear resize of the deep-supervision
targets against ``jax.image.resize(..., "linear")`` at 2d and 3d, at the
halving and ``ds_mode="arch"`` scales (1e-5 of the max), the linear sampling
of the target with fill 0, ``make_seg_targets`` and ``prepare_val_batch``
(1e-5), and float32 kept from the sampler through the loader (the Trainer's
step is in ``tests/test_torch_translation_step.py``). The regression metrics (``structural_similarity``, ``compute_metrics_reg``,
``compute_metrics_on_folder_reg``) against the JAX package's (1e-6
relative), then a raw translation dataset through the command line:
``plan_and_preprocess``, ``train`` with its final validation, and
``evaluate_folder``, scored as the JAX package scores the same folders.
"""

import functools
import os
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.evaluation import metrics as jm  # noqa: E402
from nnuzoo_tpu.imageio.nifti import NiftiIO as JaxNiftiIO  # noqa: E402
from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.data import augment as ta  # noqa: E402
from nnuzoo_tpu_torch.evaluation import metrics as tm  # noqa: E402
from nnuzoo_tpu_torch.imageio.nifti import NiftiIO, write_nifti  # noqa: E402
from nnuzoo_tpu_torch.planning import api as torch_api  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, save_json  # noqa: E402

from .helpers import set_paths  # noqa: E402

TRANSLATION = {"channel_names": {"0": "MRI"}, "labels": {"background": 0, "out": 1},
               "file_ending": ".nii.gz", "target_type": "translation"}


def _assert_rel(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(),
                               err_msg=what)


# ------------------------------------------------------------- augmentation
@pytest.mark.parametrize("shape,out", [
    ((1, 1, 16), (1, 1, 4)),                        # the ramp below
    ((2, 1, 64, 64), (2, 1, 32, 32)),               # halving, 2d
    ((2, 1, 64, 64), (2, 1, 8, 8)),
    ((2, 1, 20, 24), (2, 1, 5, 6)),
    ((2, 1, 8, 16, 16), (2, 1, 8, 8, 8)),           # arch (1, 2, 2), 3d
    ((2, 1, 8, 16, 16), (2, 1, 4, 4, 4)),           # then (2, 2, 2)
    ((1, 2, 16, 16, 16), (1, 2, 8, 8, 8)),          # halving, 3d
    ((1, 1, 6, 10), (1, 1, 12, 15))])               # growing: no antialiasing
def test_linear_resize_matches_jax_image_resize(shape, out):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    if shape == (1, 1, 16):
        x = (np.arange(16.0) ** 2).astype(np.float32).reshape(shape)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear"))
    got = ta.linear_resize(torch.from_numpy(x), out[2:])
    _assert_rel(got, want, 1e-5)
    if shape == (1, 1, 16):
        # JAX antialiases when it shrinks; torch's interpolate does not
        np.testing.assert_allclose(got.flatten().numpy(), [5.464286, 33.0, 93.0,
                                                           173.67857], rtol=1e-6)
        plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=4,
                                                mode="linear")
        assert np.abs(plain.flatten().numpy() - want.flatten()).max() > 2


def _configs(dim, **kwargs):
    patch = (32, 32) if dim == 2 else (8, 16, 16)
    scales = (((1.0, 1.0), (0.5, 0.5), (0.25, 0.25)) if dim == 2 else
              ((1.0, 1.0, 1.0), (1.0, 0.5, 0.5), (0.5, 0.25, 0.25)))
    common = dict(patch_size=patch, initial_patch_size=patch, rotation=0.0,
                  deep_supervision_scales=scales, target_type="translation",
                  **kwargs)
    return ja.AugmentConfig(**common), ta.AugmentConfig(**common), patch


@pytest.mark.parametrize("dim", [2, 3])
def test_translation_targets_and_val_batch_match_jax(dim):
    """``make_seg_targets`` leaves the float target as it is (no RemoveLabel,
    no regions) and resizes it linearly; ``prepare_val_batch`` too."""
    jcfg, tcfg, patch = _configs(dim, regions=((1,), (2,)))
    rng = np.random.RandomState(dim)
    data = rng.randn(2, 1, *patch).astype(np.float32)
    target = (rng.randn(2, 1, *patch) * 3 - 1).astype(np.float32)
    want = ja.make_seg_targets(jcfg, jnp.asarray(target[0]))
    got = ta.make_seg_targets(tcfg, torch.from_numpy(target))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _assert_rel(g[0], w, 1e-5)
    np.testing.assert_array_equal(got[0].numpy(), target)
    jd, jt = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(target))
    td, tt = ta.prepare_val_batch(tcfg, torch.from_numpy(data),
                                  torch.from_numpy(target))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for g, w in zip(tt, jt):
        _assert_rel(g, w, 1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_spatial_transform_samples_the_target_linearly_with_fill_0(dim):
    """The training path's spatial transform of a translation target is the
    JAX package's order-1 sampling with fill 0 at the same matrices."""
    patch = (20, 16) if dim == 2 else (8, 12, 12)
    initial = tuple(p + 8 for p in patch)
    _, tcfg, _ = _configs(dim, p_rotation=1.0, p_scaling=1.0)
    tcfg = replace(tcfg, patch_size=patch, initial_patch_size=initial,
                   rotation=0.6, deep_supervision_scales=None)
    rng = np.random.RandomState(5)
    data = rng.randn(2, 1, *initial).astype(np.float32)
    target = (rng.rand(2, 1, *initial) * 10).astype(np.float32)
    matrix = ta._spatial_matrix(tcfg, torch.Generator().manual_seed(4), 2)
    _, got = ta._spatial_transform(tcfg, torch.Generator().manual_seed(4),
                                   torch.from_numpy(data), torch.from_numpy(target))
    for b in range(2):
        want = ja._affine_sample(jnp.asarray(target[b]), jnp.asarray(matrix[b].numpy()),
                                 initial, patch, order=1, fill=0.0)
        _assert_rel(got[b], want, 1e-5)
    assert got.dtype == torch.float32
    # zoomed out 2x, the corners fall outside the sampled patch: fill 0
    zoom = 2 * torch.eye(dim)[None].repeat(2, 1, 1)
    got = ta._affine_sample(torch.from_numpy(target), zoom, initial, patch,
                            order=1, fill=0.0)
    want = ja._affine_sample(jnp.asarray(target[0]), 2 * jnp.eye(dim), initial,
                             patch, order=1, fill=0.0)
    _assert_rel(got[0], want, 1e-5)
    assert (got == 0).any() and (got >= 0).all()


def test_sampler_loader_and_augmentation_keep_float32(tmp_path):
    """A float target: the sampler pads it with 0 and keeps float32, the
    loader's pinned copy keeps it, the augmentation returns float32."""
    from nnuzoo_tpu_torch.data.dataset import DatasetNumpy
    from nnuzoo_tpu_torch.data.loader import DevicePrefetcher
    from nnuzoo_tpu_torch.data.patch_sampler import PatchSampler
    from nnuzoo_tpu_torch.plans.label_handling import LabelManager

    rng = np.random.RandomState(0)
    folder = str(tmp_path)
    for i in range(2):
        target = (rng.rand(1, 1, 20, 20) * 7.25).astype(np.float32)
        DatasetNumpy.save_case(rng.randn(1, 1, 20, 20).astype(np.float32), target,
                               {"class_locations": {}}, os.path.join(folder, f"c{i}"))
    sampler = PatchSampler(DatasetNumpy(folder), 2, seed=0,
                           initial_patch_size=(28, 28), final_patch_size=(24, 24),
                           label_manager=LabelManager({"background": 0, "out": 1},
                                                      None, target_type="translation"),
                           oversample_foreground_percent=0.0,
                           target_type="translation")
    loader = DevicePrefetcher(sampler, device="cpu")
    batch = next(loader)
    loader.stop()
    target = batch["target"]
    assert target.dtype == torch.float32 and target.shape == (2, 1, 28, 28)
    assert (target == 0).any() and target.max() > 1 and \
        not torch.equal(target, target.round())
    _, cfg, _ = _configs(2)
    cfg = replace(cfg, patch_size=(24, 24), initial_patch_size=(28, 28))
    _, targets = ta.augment_train_batch(cfg, torch.Generator().manual_seed(0),
                                        batch["data"], target)
    assert all(t.dtype == torch.float32 for t in targets)


# ------------------------------------------------------------- metrics
@pytest.mark.parametrize("shape", [(20, 18), (12, 14, 16), (4, 40, 3)])
def test_structural_similarity_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    ref = rng.rand(*shape)
    pred = np.clip(ref + 0.1 * rng.randn(*shape), 0, 1)
    want = jm.structural_similarity(pred, ref)
    assert tm.structural_similarity(pred, ref) == pytest.approx(want, rel=1e-6)
    assert tm._reg_spatial_dims(ref[None]) == jm._reg_spatial_dims(ref[None])
    np.testing.assert_allclose(tm._gaussian_kernel1d(1.5, 5),
                               jm._gaussian_kernel1d(1.5, 5), rtol=1e-12)


def _write_pairs(folder_ref, folder_pred, cases=3, seed=1):
    rng = np.random.RandomState(seed)
    os.makedirs(folder_ref, exist_ok=True)
    os.makedirs(folder_pred, exist_ok=True)
    for i in range(cases):
        ref = (rng.rand(16, 12, 6) + 0.02 * i).astype(np.float32)
        ref[:2] = 0.01                           # below the 0.05 clip of APE/PE
        pred = (ref + 0.05 * rng.randn(16, 12, 6)).astype(np.float32)
        write_nifti(os.path.join(folder_ref, f"c{i}.nii.gz"), ref, (1.0, 1.0, 2.0))
        write_nifti(os.path.join(folder_pred, f"c{i}.nii.gz"), pred, (1.0, 1.0, 2.0))


def _close_metrics(got, want):
    assert sorted(got) == sorted(want) == ["APE", "MAE", "MSE", "PE", "PSNR", "SSIM"]
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-6), k


def test_regression_metrics_match_jax(tmp_path):
    ref, pred = str(tmp_path / "ref"), str(tmp_path / "pred")
    _write_pairs(ref, pred)
    one = [os.path.join(f, "c0.nii.gz") for f in (ref, pred)]
    _close_metrics(tm.compute_metrics_reg(*one, NiftiIO())["metrics"],
                   jm.compute_metrics_reg(*one, JaxNiftiIO())["metrics"])
    out = str(tmp_path / "summary.json")
    got = tm.compute_metrics_on_folder_reg(ref, pred, out, NiftiIO(), ".nii.gz", 2)
    want = jm.compute_metrics_on_folder_reg(ref, pred, None, JaxNiftiIO(), ".nii.gz", 2)
    _close_metrics(got["mean"], want["mean"])
    assert got["foreground_mean"] == got["mean"]
    assert len(got["metric_per_case"]) == 3
    assert load_json(out)["mean"] == pytest.approx(got["mean"])


# ------------------------------------------------------------- command line
def _write_raw_translation(root, cases=4):
    rng = np.random.RandomState(0)
    ds = os.path.join(root, "Dataset994_Translate")
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub))
    for i in range(cases):
        vol = (rng.rand(40, 40, 3) * 50 + 10).astype(np.float32)
        target = (vol * 2 + 5).astype(np.float32)
        write_nifti(os.path.join(ds, "imagesTr", f"c{i:02d}_0000.nii.gz"), vol,
                    spacing_xyz=(1.0, 1.0, 1.0))
        write_nifti(os.path.join(ds, "labelsTr", f"c{i:02d}.nii.gz"), target,
                    spacing_xyz=(1.0, 1.0, 1.0))
    save_json(dict(TRANSLATION, numTraining=cases), os.path.join(ds, "dataset.json"))
    return ds


def test_cli_trains_validates_and_scores_a_translation_dataset(tmp_path, monkeypatch):
    """``plan_and_preprocess`` (the JAX package's preprocessor casts the
    target to an integer type), ``train 994 2d 0`` (one step an epoch) with
    its final validation scored by the regression metrics (its export is an
    argmax, so all zeros: the JAX package's behaviour), and
    ``evaluate_folder`` on that folder, each as the JAX package's
    ``compute_metrics_on_folder_reg`` scores the same folders."""
    from nnuzoo_tpu_torch.data.dataset import DatasetNumpy

    for var in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    raw, pp, res = set_paths(tmp_path)
    _write_raw_translation(raw)

    class Extractor(torch_api.DatasetFingerprintExtractor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = 1e5

    monkeypatch.setattr(torch_api, "DatasetFingerprintExtractor", Extractor)
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    monkeypatch.setattr(ttrainer, "get_trainer_config",
                        lambda n: short(get_config(n)))
    main(["plan_and_preprocess", "-d", "994", "-c", "2d", "-npfp", "2", "-np", "2"])
    base = os.path.join(pp, "Dataset994_Translate")
    plans = load_json(os.path.join(base, "nnUNetPlans.json"))
    seg = DatasetNumpy(os.path.join(base, plans["configurations"]["2d"][
        "data_identifier"])).load_case("c00")[1]
    assert np.issubdtype(seg.dtype, np.integer)
    main(["train", "994", "2d", "0", "-num_epochs", "1", "-device", "cpu"])
    folder = os.path.join(res, "Dataset994_Translate", "nnUNetTrainer__nnUNetPlans__2d")
    validation = os.path.join(folder, "fold_0", "validation")
    summary = load_json(os.path.join(validation, "summary.json"))
    gt = os.path.join(base, "gt_segmentations")
    want = jm.compute_metrics_on_folder_reg(gt, validation, None, JaxNiftiIO(),
                                            ".nii.gz", 1)
    _close_metrics(summary["mean"], want["mean"])
    case = summary["metric_per_case"][0]["prediction_file"]
    assert (NiftiIO().read_images([case])[0] == 0).all()
    got = main(["evaluate_folder", gt, validation, "-djfile",
                os.path.join(folder, "dataset.json"), "-pfile",
                os.path.join(folder, "plans.json"), "-o",
                str(tmp_path / "summary.json"), "-np", "1"])
    _close_metrics(got["mean"], want["mean"])
