"""The port's command line with the Transformer baselines, on the CPU
(``-device cpu``), at full width.

A raw Dataset994 (four cases of (z, y, x) 4x32x48 with spherical labels 1
and 2, ``.nii``) is planned and preprocessed for ``2d`` by
``plan_and_preprocess`` (patch [32, 48]: UNETR's 16-voxel patches and
SwinUNETR's four halvings divide it). For each of ``nnUNetTrainerUNETR``,
``nnUNetTrainerSwinTransformerUnet`` and ``nnUNetTrainerSwUNETR``:
``train 994 2d 0 -tr <name>`` (one step an epoch) with its final
validation scored in ``validation/summary.json``, then
``predict_from_modelfolder`` on the raw images and ``evaluate_simple``.
"""

import functools
import os
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.imageio.nifti import write_nifti  # noqa: E402
from nnuzoo_tpu_torch.models.swt import SwinTransformerUnet, SwinUNETR  # noqa: E402
from nnuzoo_tpu_torch.models.unetr import UNETR  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, load_pickle, save_json  # noqa: E402

from .helpers import set_paths  # noqa: E402

DATASET = "Dataset994_Transformer"
SHAPE_XYZ = (48, 32, 4)
MODELS = {"nnUNetTrainerUNETR": UNETR,
          "nnUNetTrainerSwinTransformerUnet": SwinTransformerUnet,
          "nnUNetTrainerSwUNETR": SwinUNETR}


def _write_raw_dataset(root, num_cases=4, seed=0):
    rng = np.random.RandomState(seed)
    ds = os.path.join(root, DATASET)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub))
    xx, yy, zz = np.meshgrid(*[np.arange(s) for s in SHAPE_XYZ], indexing="ij")
    for i in range(num_cases):
        cx, cy = rng.randint(16, 32), rng.randint(10, 22)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + 4 * (zz - 2) ** 2
        seg = np.zeros(SHAPE_XYZ, dtype=np.uint8)
        seg[r2 < 60] = 1
        seg[r2 < 16] = 2
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
    """Dataset994 planned for 2d, trainers of one step an epoch."""
    mp = pytest.MonkeyPatch()
    raw, pp, res = set_paths(tmp_path_factory.mktemp("transformer_cli"))
    ds = _write_raw_dataset(raw)
    main(["plan_and_preprocess", "-d", "994", "-c", "2d", "-npfp", "2", "-np", "2"])
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    mp.setattr(ttrainer, "get_trainer_config", lambda n: short(get_config(n)))
    yield ds, pp, res
    mp.undo()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_validate_and_predict_2d(planned, name):
    ds, pp, res = planned
    plan = load_json(os.path.join(pp, DATASET, "nnUNetPlans.json"))[
        "configurations"]["2d"]
    assert plan["patch_size"] == [32, 48]
    main(["train", "994", "2d", "0", "-tr", name, "-num_epochs", "1",
          "-device", "cpu"])
    model_folder = os.path.join(res, DATASET, f"{name}__nnUNetPlans__2d")
    fold = os.path.join(model_folder, "fold_0")
    ckpt = load_pickle(os.path.join(fold, "checkpoint_final.pth"))
    assert ckpt["trainer_name"] == name
    assert "exp_avg" in next(iter(ckpt["optimizer_state"]["state"].values()))
    summary = load_json(os.path.join(fold, "validation", "summary.json"))
    assert len(summary["metric_per_case"]) == 1
    assert np.isfinite(summary["foreground_mean"]["Dice"])

    out = os.path.join(res, f"predicted_{name}")
    predictor = main(["predict_from_modelfolder", "-i", os.path.join(ds, "imagesTr"),
                      "-o", out, "-m", model_folder, "-f", "0", "-device", "cpu"])
    assert isinstance(predictor.model, MODELS[name])
    assert predictor.forward_count > 0
    scores = main(["evaluate_simple", os.path.join(ds, "labelsTr"), out,
                   "-l", "1", "2", "-o", os.path.join(out, "summary.json"),
                   "-np", "1"])
    assert len(scores["metric_per_case"]) == 4
    assert np.isfinite(scores["foreground_mean"]["Dice"])
