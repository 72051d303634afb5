"""The port's command line from a raw dataset to a score, on folders that it
wrote itself, on the CPU (``-device cpu``).

``plan_and_preprocess`` plans and preprocesses a raw Dataset999 (four cases
of three 64x64 slices, ``.nii``, written with the port's NIfTI writer: the
simple evaluation takes its file ending from ``os.path.splitext`` and, in
both packages, refuses ``.nii.gz``); the plans' 2d patch and batch are cut as
``tests/test_integration.py`` cuts them, and M2NetP is built at stage layers
(1, 1, 1, 1) with one step an epoch, as ``tests/test_torch_validation.py``
does. Then ``train`` (one epoch and the final validation, with the sampler
drawing its foreground patches from the written ``class_locations``),
``predict_from_modelfolder`` on two raw cases and ``evaluate_simple`` against
their labels. The same fold written in the JAX package's checkpoint format
validates again with ``train --val``. A plans file whose 2d configuration has
a next stage makes the port's ``Trainer`` raise.
"""

import functools
import json
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.data import patch_sampler  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.planning import api as torch_api  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, save_json  # noqa: E402

from .helpers import set_paths  # noqa: E402

NAME = "nnUNetTrainerM2NetP"
DATASET = "Dataset999_Synth"


def _write_raw_dataset(root, num_cases=4, shape=(64, 64, 3), seed=0):
    """Blob labels 1 and 2 in noise, zero borders: ``tests/helpers.py``'s
    synthetic dataset, written as ``.nii``."""
    from nnuzoo_tpu_torch.imageio.nifti import write_nifti
    rng = np.random.RandomState(seed)
    ds = os.path.join(root, DATASET)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    xx, yy, zz = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for i in range(num_cases):
        vol = rng.rand(*shape).astype(np.float32) * 80 + 10
        vol[:2] = 0
        vol[-2:] = 0
        cx, cy, cz = (rng.randint(s // 4, 3 * s // 4) for s in shape)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2
        seg = np.zeros(shape, dtype=np.uint8)
        seg[r2 < 25] = 1
        seg[r2 < 6] = 2
        seg[vol == 0] = 0
        write_nifti(os.path.join(ds, "imagesTr", f"case_{i:03d}_0000.nii"), vol,
                    spacing_xyz=(1.0, 1.0, 1.0))
        write_nifti(os.path.join(ds, "labelsTr", f"case_{i:03d}.nii"), seg,
                    spacing_xyz=(1.0, 1.0, 1.0))
    save_json({"channel_names": {"0": "MRI"},
               "labels": {"background": 0, "organ": 1, "tumor": 2},
               "numTraining": num_cases, "file_ending": ".nii"},
              os.path.join(ds, "dataset.json"))


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """Dataset999 planned and preprocessed by the port's command line (the
    fingerprint samples 1e6 foreground intensities in all, not 1e8), its 2d
    patch cut to 64x64 at batch 2; M2NetP at one layer a stage and trainers
    of one step an epoch."""
    mp = pytest.MonkeyPatch()
    raw, pp, res = set_paths(tmp_path_factory.mktemp("plan_cli"))
    _write_raw_dataset(raw)

    class Extractor(torch_api.DatasetFingerprintExtractor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = 1e6

    mp.setattr(torch_api, "DatasetFingerprintExtractor", Extractor)
    main(["plan_and_preprocess", "-d", "999", "-c", "2d", "-npfp", "2", "-np", "2",
          "--verify_dataset_integrity"])
    plans_file = os.path.join(pp, DATASET, "nnUNetPlans.json")
    plans = load_json(plans_file)
    plans["configurations"]["2d"]["patch_size"] = [64, 64]
    plans["configurations"]["2d"]["batch_size"] = 2
    save_json(plans, plans_file, sort_keys=False)
    mp.setitem(registry.MODEL_BUILDERS, NAME,
               functools.partial(tm2net.get_m2net_from_plans, small=True,
                                 stage_layers=(1, 1, 1, 1)))
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    mp.setattr(ttrainer, "get_trainer_config", lambda n: short(get_config(n)))
    yield raw, pp, res
    mp.undo()


def test_plan_and_preprocess_writes_what_training_reads(planned):
    _, pp, _ = planned
    folder = os.path.join(pp, DATASET)
    for f in ("dataset.json", "dataset_fingerprint.json", "nnUNetPlans.json"):
        assert os.path.isfile(os.path.join(folder, f)), f
    cases = sorted(f for f in os.listdir(os.path.join(folder, "nnUNetPlans_2d"))
                   if f.endswith(".pkl"))
    assert len(cases) == 4
    assert len(os.listdir(os.path.join(folder, "gt_segmentations"))) == 4
    from nnuzoo_tpu_torch.utilities.io import load_pickle
    for f in cases:
        locs = load_pickle(os.path.join(folder, "nnUNetPlans_2d", f))["class_locations"]
        assert list(locs) == [1, 2] and all(len(v) > 0 for v in locs.values())


def test_the_cli_plans_trains_predicts_and_scores(planned, tmp_path, monkeypatch):
    raw, pp, res = planned
    drawn = []
    get_bbox = patch_sampler.PatchSampler.get_bbox

    def recording_get_bbox(self, data_shape, force_fg, class_locations, *args, **kw):
        if force_fg:
            drawn.append(class_locations)
        return get_bbox(self, data_shape, force_fg, class_locations, *args, **kw)

    monkeypatch.setattr(patch_sampler.PatchSampler, "get_bbox", recording_get_bbox)
    main(["train", "999", "2d", "0", "-tr", NAME, "-num_epochs", "1",
          "-device", "cpu"])
    # the forced-foreground patches were drawn from the written locations
    assert drawn and all(list(c) == [1, 2] and len(c[1]) > 0 for c in drawn)
    model_folder = os.path.join(res, DATASET, f"{NAME}__nnUNetPlans__2d")
    fold = os.path.join(model_folder, "fold_0")
    assert os.path.isfile(os.path.join(fold, "checkpoint_final.pth"))
    summary = load_json(os.path.join(fold, "validation", "summary.json"))
    assert np.isfinite(summary["foreground_mean"]["Dice"])

    images, labels = tmp_path / "imagesTs", tmp_path / "labelsTs"
    images.mkdir()
    labels.mkdir()
    for case in ("case_001", "case_002"):
        shutil.copy(os.path.join(raw, DATASET, "imagesTr", f"{case}_0000.nii"),
                    images)
        shutil.copy(os.path.join(raw, DATASET, "labelsTr", f"{case}.nii"), labels)
    out = tmp_path / "predicted"
    main(["predict_from_modelfolder", "-i", str(images), "-o", str(out),
          "-m", model_folder, "-f", "0", "-device", "cpu"])
    assert sorted(f for f in os.listdir(out) if f.endswith(".nii")) == \
        ["case_001.nii", "case_002.nii"]
    scores = main(["evaluate_simple", str(labels), str(out), "-l", "1", "2",
                   "-o", str(tmp_path / "summary.json"), "-np", "1"])
    written = json.load(open(tmp_path / "summary.json"))
    assert scores["foreground_mean"] == written["foreground_mean"]
    assert sorted(written["mean"]) == ["1", "2"]
    assert np.isfinite(written["foreground_mean"]["Dice"])
    assert len(written["metric_per_case"]) == 2


def test_train_val_reads_a_fold_in_the_jax_format(planned):
    """The trained fold's final checkpoint rewritten as the JAX ``Trainer``
    writes it (flax msgpack of the params and of optax's AdamW state):
    ``train --val`` validates it and scores what the port's own checkpoint
    scored."""
    import optax
    from flax import serialization

    from nnuzoo_tpu_torch.convert import params_from_state_dict
    from nnuzoo_tpu_torch.utilities.io import load_pickle, save_pickle

    _, _, res = planned
    fold = os.path.join(res, DATASET, f"{NAME}__nnUNetPlans__2d", "fold_0")
    ckpt_file = os.path.join(fold, "checkpoint_final.pth")
    if not os.path.isfile(ckpt_file):
        main(["train", "999", "2d", "0", "-tr", NAME, "-num_epochs", "1",
              "-device", "cpu"])
    want = load_json(os.path.join(fold, "validation", "summary.json"))
    ckpt = load_pickle(ckpt_file)
    params = {"params": params_from_state_dict(ckpt["network_weights"])}
    tx = optax.chain(optax.clip_by_global_norm(12.0),
                     optax.adamw(learning_rate=lambda c: 1e-4))
    ckpt["network_weights"] = serialization.to_bytes(params)
    ckpt["optimizer_state"] = serialization.to_bytes(tx.init(params))
    save_pickle(ckpt, ckpt_file)
    shutil.rmtree(os.path.join(fold, "validation"))
    main(["train", "999", "2d", "0", "-tr", NAME, "--val", "-device", "cpu"])
    assert load_json(os.path.join(fold, "validation", "summary.json")) == want


def test_a_next_stage_configuration_raises(planned):
    """A configuration with a next stage builds, and its final validation
    writes the next stage's inputs (the name is kept from when the port
    refused such a configuration): with a next stage ``2d_next`` that
    inherits the 2d configuration, each validation case gets
    ``predicted_next_stage/2d_next/<case>.npz``, a uint8 label map at its
    preprocessed 2d shape."""
    from nnuzoo_tpu_torch.data.dataset import DatasetNumpy

    _, pp, _ = planned
    plans = load_json(os.path.join(pp, DATASET, "nnUNetPlans.json"))
    dataset_json = load_json(os.path.join(pp, DATASET, "dataset.json"))
    plans["configurations"]["2d"]["next_stage"] = "2d_next"
    plans["configurations"]["2d_next"] = {"inherits_from": "2d"}
    t = ttrainer.Trainer(plans, "2d", 0, dataset_json, device="cpu",
                         trainer_name=NAME, seed=0)
    assert t.configuration_manager.next_stage_names == ["2d_next"]
    t.initialize()
    t.perform_actual_validation()
    _, val_keys = t.do_split()
    folder = os.path.join(pp, DATASET, "predicted_next_stage", "2d_next")
    assert sorted(os.listdir(folder)) == sorted(k + ".npz" for k in val_keys)
    data = DatasetNumpy(os.path.join(pp, DATASET, "nnUNetPlans_2d"))
    for k in val_keys:
        seg = np.load(os.path.join(folder, k + ".npz"))["seg"]
        assert seg.dtype == np.uint8 and seg.shape == data.load_case(k)[0].shape[1:]
        assert set(np.unique(seg)) <= {0, 1, 2}
