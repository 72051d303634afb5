"""The port's command line with a Mamba baseline, on the CPU (``-device
cpu``): ``train 995 3d_fullres 0 -tr nnUNetTrainerLightMUNet`` at full width
on ``test_torch_cnn_cli.py``'s raw Dataset995 (planned by the default
planner, one step an epoch), its final validation scored in
``validation/summary.json``, then ``predict_from_modelfolder`` on the raw
images and ``evaluate_simple``; and ``train ... -tr nnUNetTrainerSwinUMamba``
on that 3d configuration refused (SwinUMamba is 2d only)."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.models.light_munet import LightMUNet  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, load_pickle  # noqa: E402

from .test_torch_cnn_cli import DATASET, planned  # noqa: E402,F401

NAME = "nnUNetTrainerLightMUNet"


def test_train_validate_and_predict_light_munet_3d(planned):  # noqa: F811
    ds, pp, res = planned
    main(["train", "995", "3d_fullres", "0", "-tr", NAME, "-num_epochs", "1",
          "-device", "cpu"])
    model_folder = os.path.join(res, DATASET, f"{NAME}__nnUNetPlans__3d_fullres")
    fold = os.path.join(model_folder, "fold_0")
    ckpt = load_pickle(os.path.join(fold, "checkpoint_final.pth"))
    assert ckpt["trainer_name"] == NAME
    assert "exp_avg" in next(iter(ckpt["optimizer_state"]["state"].values()))
    summary = load_json(os.path.join(fold, "validation", "summary.json"))
    assert len(summary["metric_per_case"]) == 1
    assert np.isfinite(summary["foreground_mean"]["Dice"])

    out = os.path.join(res, "predicted_light_munet")
    predictor = main(["predict_from_modelfolder", "-i", os.path.join(ds, "imagesTr"),
                      "-o", out, "-m", model_folder, "-f", "0", "-device", "cpu"])
    assert isinstance(predictor.model, LightMUNet) and predictor.model.dim == 3
    assert predictor.forward_count > 0
    scores = main(["evaluate_simple", os.path.join(ds, "labelsTr"), out,
                   "-l", "1", "2", "-o", os.path.join(out, "summary.json"),
                   "-np", "1"])
    assert len(scores["metric_per_case"]) == 4
    assert np.isfinite(scores["foreground_mean"]["Dice"])


def test_swin_umamba_refuses_a_3d_configuration(planned):  # noqa: F811
    with pytest.raises(ValueError, match="2D-only"):
        main(["train", "995", "3d_fullres", "0", "-tr", "nnUNetTrainerSwinUMamba",
              "-num_epochs", "1", "-device", "cpu"])
