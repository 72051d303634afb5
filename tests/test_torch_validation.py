"""The port's final validation and its command line against the JAX package.

The JAX package's planning and preprocessing write a tiny 2d dataset (four
cases of three 64x64 slices; patch 64x64). The port's ``Trainer`` runs one
epoch of one step on the CPU and ``perform_actual_validation``: its
segmentations equal those of the JAX ``Predictor`` plus
``export_prediction_from_logits`` on the same weights (mirror TTA on), its
probabilities agree to 1e-3, and its ``summary.json`` equals JAX
``compute_metrics_on_folder`` on them. Then ``python -m
nnuzoo_tpu_torch.cli`` trains (``train``), predicts a raw folder
(``predict``) and scores it (``evaluate_folder``) with ``-device cpu``.
M2NetP is built at stage layers (1, 1, 1, 1) to keep the file fast.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnuzoo_tpu.data.dataset import DatasetNumpy as JaxDataset  # noqa: E402
from nnuzoo_tpu.evaluation.metrics import compute_metrics_on_folder  # noqa: E402
from nnuzoo_tpu.imageio.nifti import NiftiIO as JaxNiftiIO  # noqa: E402
from nnuzoo_tpu.inference.export import \
    export_prediction_from_logits  # noqa: E402
from nnuzoo_tpu.inference.predictor import Predictor as JaxPredictor  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.plans.plans_handler import PlansManager as JaxPlans  # noqa: E402
from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.convert import params_from_state_dict  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.run.run_training import get_trainer_from_args  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402

from .helpers import make_synthetic_dataset, set_paths  # noqa: E402

NAME = "nnUNetTrainerM2NetP"
STAGES = (1, 1, 1, 1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Raw and preprocessed Dataset999, the port's model registry cut to one
    layer a stage, and trainers of one step an epoch."""
    mp = pytest.MonkeyPatch()
    raw, pp, res = set_paths(tmp_path_factory.mktemp("validation"))
    make_synthetic_dataset(raw, num_cases=4, shape=(64, 64, 3))
    from nnuzoo_tpu.planning.api import (extract_fingerprints, plan_experiments,
                                         preprocess)
    from nnuzoo_tpu.utilities.io import join, load_json, save_json
    extract_fingerprints([999], num_processes=1)
    plan_experiments([999])
    plans_file = join(pp, "Dataset999_Synth", "nnUNetPlans.json")
    plans = load_json(plans_file)
    plans["configurations"]["2d"]["patch_size"] = [64, 64]
    plans["configurations"]["2d"]["batch_size"] = 2
    save_json(plans, plans_file, sort_keys=False)
    preprocess([999], configurations=("2d",), num_processes=(1,))
    mp.setitem(registry.MODEL_BUILDERS, NAME,
               functools.partial(tm2net.get_m2net_from_plans, small=True,
                                 stage_layers=STAGES))
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    mp.setattr(ttrainer, "get_trainer_config", lambda n: short(get_config(n)))
    yield raw, pp, res
    mp.undo()


def test_final_validation_matches_jax(dataset):
    _, pp, _ = dataset
    trainer = get_trainer_from_args(999, "2d", 0, NAME, num_epochs=1,
                                    device="cpu", seed=0)
    trainer.run_training()
    metrics = trainer.perform_actual_validation(save_probabilities=True)
    val = os.path.join(trainer.output_folder, "validation")
    _, val_keys = trainer.do_split()
    assert len(val_keys) == 1 and set(trainer.validation_case_times) == set(val_keys)

    jpm = JaxPlans(trainer.plans_manager.plans)
    jcm = jpm.get_configuration("2d")
    jp = JaxPredictor()
    jp.manual_initialization(
        JaxM2NetP(num_classes=3, deep_supervision=False, stage_layers=STAGES),
        [{"params": params_from_state_dict(trainer.model.state_dict())}], jpm, jcm,
        trainer.dataset_json, NAME, trainer.inference_allowed_mirroring_axes)
    jax_out = os.path.join(trainer.output_folder_base, "jax_validation")
    os.makedirs(jax_out)
    ds = JaxDataset(trainer.preprocessed_dataset_folder, val_keys)
    for k in val_keys:
        data, _, _, props = ds.load_case(k)
        logits = jp.predict_sliding_window_return_logits(np.asarray(data, np.float32))
        export_prediction_from_logits(logits, props, jcm, jpm, trainer.dataset_json,
                                      os.path.join(jax_out, k), True)
        got = JaxNiftiIO().read_seg(os.path.join(val, k + ".nii.gz"))[0]
        want = JaxNiftiIO().read_seg(os.path.join(jax_out, k + ".nii.gz"))[0]
        assert got.shape == (1, 3, 64, 64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(np.load(os.path.join(val, k + ".npz"))["probabilities"],
                                   np.load(os.path.join(jax_out, k + ".npz"))["probabilities"],
                                   rtol=0, atol=1e-3)

    lm = jpm.get_label_manager(trainer.dataset_json)
    summary = os.path.join(jax_out, "summary_of_port_validation.json")
    want = compute_metrics_on_folder(
        os.path.join(pp, "Dataset999_Synth", "gt_segmentations"), val, summary,
        JaxNiftiIO(), ".nii.gz", lm.foreground_labels, lm.ignore_label,
        num_processes=1)
    assert open(os.path.join(val, "summary.json")).read() == open(summary).read()
    assert metrics["foreground_mean"] == want["foreground_mean"]
    assert np.isfinite(metrics["foreground_mean"]["Dice"])


def test_the_cli_trains_predicts_and_evaluates(dataset, tmp_path):
    raw, pp, res = dataset
    ds_raw = os.path.join(raw, "Dataset999_Synth")
    main(["train", "999", "2d", "1", "-tr", NAME, "-num_epochs", "1",
          "-device", "cpu"])
    model_folder = os.path.join(res, "Dataset999_Synth", f"{NAME}__nnUNetPlans__2d")
    fold = os.path.join(model_folder, "fold_1")
    assert os.path.isfile(os.path.join(fold, "checkpoint_final.pth"))
    assert os.path.isfile(os.path.join(fold, "validation", "summary.json"))

    # two raw cases with their labels, predicted from the trained folder
    images, labels = tmp_path / "imagesTs", tmp_path / "labelsTs"
    images.mkdir()
    labels.mkdir()
    for case in ("case_000", "case_003"):
        shutil.copy(os.path.join(ds_raw, "imagesTr", f"{case}_0000.nii.gz"), images)
        shutil.copy(os.path.join(ds_raw, "labelsTr", f"{case}.nii.gz"), labels)
    out = tmp_path / "predicted"
    main(["predict", "-i", str(images), "-o", str(out), "-d", "999", "-c", "2d",
          "-tr", NAME, "-f", "1", "-device", "cpu"])
    assert sorted(os.listdir(out)) == ["case_000.nii.gz", "case_003.nii.gz",
                                       "predict_from_raw_data_args.json"]
    for case in ("case_000", "case_003"):
        seg, props = JaxNiftiIO().read_seg(str(out / f"{case}.nii.gz"))
        ref, ref_props = JaxNiftiIO().read_seg(str(labels / f"{case}.nii.gz"))
        assert seg.shape == ref.shape and props["spacing"] == ref_props["spacing"]

    # scored by a separate process through the module's own entry
    args = ["evaluate_folder", str(labels), str(out),
            "-djfile", os.path.join(model_folder, "dataset.json"),
            "-pfile", os.path.join(model_folder, "plans.json"),
            "-o", str(tmp_path / "summary_port.json"), "-np", "1"]
    run = subprocess.run([sys.executable, "-m", "nnuzoo_tpu_torch.cli", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    from nnuzoo_tpu.cli.entry_points import evaluate_folder_entry
    jargs = args[1:-4] + ["-o", str(tmp_path / "summary_jax.json"), "-np", "1"]
    evaluate_folder_entry(jargs)
    got = json.load(open(tmp_path / "summary_port.json"))
    want = json.load(open(tmp_path / "summary_jax.json"))
    assert got == want and np.isfinite(got["foreground_mean"]["Dice"])
