"""The port's command line on a 3d configuration with the default trainer,
on the CPU (``-device cpu``).

A raw Dataset995 (four cases of 24x20x16 voxels with spherical labels 1 and
2, ``.nii``, written with the port's NIfTI writer) is planned and
preprocessed for ``3d_fullres`` by ``plan_and_preprocess``, once with the
default planner (PlainConvUNet) and once with ``-pl ResEncUNetPlanner``
(ResidualEncoderUNet). ``train 995 3d_fullres 0`` without ``-tr`` trains
``nnUNetTrainer`` (one step an epoch, as ``tests/test_torch_plan_cli.py``
cuts its trainers) and its final validation writes a 3d segmentation of the
fold's validation case, scored in ``validation/summary.json``; the same with
``-tr nnUNetTrainerResEncUNet -p nnUNetResEncUNetPlans``. Then
``predict_from_modelfolder`` predicts two raw cases and ``evaluate_simple``
scores them.
"""

import functools
import os
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.imageio.nifti import NiftiIO, write_nifti  # noqa: E402
from nnuzoo_tpu_torch.planning import api as torch_api  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import (load_json, load_pickle,  # noqa: E402
                                           save_json)

from .helpers import set_paths  # noqa: E402

DATASET = "Dataset995_Cnn3d"
SHAPE_XYZ = (24, 20, 16)


def _write_raw_dataset(root, num_cases=4, seed=0):
    rng = np.random.RandomState(seed)
    ds = os.path.join(root, DATASET)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub))
    xx, yy, zz = np.meshgrid(*[np.arange(s) for s in SHAPE_XYZ], indexing="ij")
    for i in range(num_cases):
        cx, cy, cz = (rng.randint(s // 3, 2 * s // 3) for s in SHAPE_XYZ)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2
        seg = np.zeros(SHAPE_XYZ, dtype=np.uint8)
        seg[r2 < 30] = 1
        seg[r2 < 8] = 2
        vol = (20 * seg + 10 * rng.rand(*SHAPE_XYZ) + 5).astype(np.float32)
        write_nifti(os.path.join(ds, "imagesTr", f"case_{i:03d}_0000.nii"), vol,
                    spacing_xyz=(1.0, 1.0, 1.0))
        write_nifti(os.path.join(ds, "labelsTr", f"case_{i:03d}.nii"), seg,
                    spacing_xyz=(1.0, 1.0, 1.0))
    save_json({"channel_names": {"0": "MRI"},
               "labels": {"background": 0, "organ": 1, "tumor": 2},
               "numTraining": num_cases, "file_ending": ".nii"},
              os.path.join(ds, "dataset.json"))
    return ds


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """Dataset995 planned for 3d_fullres by both planners (the fingerprint
    samples 1e6 foreground intensities in all, not 1e8), trainers of one
    step an epoch."""
    mp = pytest.MonkeyPatch()
    raw, pp, res = set_paths(tmp_path_factory.mktemp("cnn_cli"))
    ds = _write_raw_dataset(raw)

    class Extractor(torch_api.DatasetFingerprintExtractor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = 1e6

    mp.setattr(torch_api, "DatasetFingerprintExtractor", Extractor)
    for planner in ("ExperimentPlanner", "ResEncUNetPlanner"):
        main(["plan_and_preprocess", "-d", "995", "-c", "3d_fullres", "-npfp", "2",
              "-np", "2", "-pl", planner])
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    mp.setattr(ttrainer, "get_trainer_config", lambda n: short(get_config(n)))
    yield ds, pp, res
    mp.undo()


@pytest.mark.parametrize("plans,trainer,arch", [
    ("nnUNetPlans", None, "PlainConvUNet"),
    ("nnUNetResEncUNetPlans", "nnUNetTrainerResEncUNet", "ResidualEncoderUNet")])
def test_train_3d_fullres_validates_and_predicts(planned, plans, trainer, arch):
    ds, pp, res = planned
    config = load_json(os.path.join(pp, DATASET, plans + ".json"))[
        "configurations"]["3d_fullres"]
    assert config["architecture"]["network_class_name"] == arch
    assert len(config["patch_size"]) == 3
    argv = ["train", "995", "3d_fullres", "0", "-p", plans, "-num_epochs", "1",
            "-device", "cpu"]
    main(argv + (["-tr", trainer] if trainer else []))
    trainer = trainer or "nnUNetTrainer"
    model_folder = os.path.join(res, DATASET, f"{trainer}__{plans}__3d_fullres")
    fold = os.path.join(model_folder, "fold_0")
    ckpt = load_pickle(os.path.join(fold, "checkpoint_final.pth"))
    assert ckpt["trainer_name"] == trainer
    assert ckpt["inference_allowed_mirroring_axes"] == (0, 1, 2)
    assert "momentum_buffer" in next(iter(ckpt["optimizer_state"]["state"].values()))
    summary = load_json(os.path.join(fold, "validation", "summary.json"))
    assert len(summary["metric_per_case"]) == 1
    assert np.isfinite(summary["foreground_mean"]["Dice"])
    case = os.path.basename(summary["metric_per_case"][0]["prediction_file"])
    seg, _ = NiftiIO().read_seg(os.path.join(fold, "validation", case))
    label, _ = NiftiIO().read_seg(os.path.join(pp, DATASET, "gt_segmentations", case))
    assert seg.shape == label.shape == (1, *SHAPE_XYZ[::-1])
    assert set(np.unique(seg)) <= {0, 1, 2}

    out = os.path.join(res, f"predicted_{plans}")
    predictor = main(["predict_from_modelfolder", "-i", os.path.join(ds, "imagesTr"),
                      "-o", out, "-m", model_folder, "-f", "0", "-device", "cpu"])
    assert predictor.forward_count > 0
    scores = main(["evaluate_simple", os.path.join(ds, "labelsTr"), out,
                   "-l", "1", "2", "-o", os.path.join(out, "summary.json"),
                   "-np", "1"])
    assert len(scores["metric_per_case"]) == 4
    assert np.isfinite(scores["foreground_mean"]["Dice"])
