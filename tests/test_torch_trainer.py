"""The port's ``Trainer`` end to end on the CPU.

The JAX package's planning and preprocessing write a tiny 2d dataset (as
``tests/test_trainer_m2net.py`` does); the port's trainer, found through
``run.run_training.get_trainer_from_args``, runs one epoch of one step and one
validation step with ``device="cpu"``, writes its checkpoints, resumes from
them for a second epoch, and the port's ``Predictor`` loads the folder and
predicts. M2NetP is built at stage layers (1, 1, 1, 1) here to keep the file
fast; the widths, the seven outputs and every code path are the full model's.
"""

import functools
import os
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.inference.predictor import Predictor  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.run.run_training import (get_trainer_from_args,  # noqa: E402
                                               maybe_load_checkpoint, run_training)
from nnuzoo_tpu_torch.training.trainer import (Trainer,  # noqa: E402
                                               load_trainer_from_checkpoint)
from nnuzoo_tpu_torch.utilities.io import load_pickle  # noqa: E402

from .helpers import make_synthetic_dataset, set_paths  # noqa: E402

NAME = "nnUNetTrainerM2NetP"


@pytest.fixture
def dataset(tmp_path, monkeypatch):
    """A planned and preprocessed Dataset999 with a 64x64 2d configuration."""
    raw, pp, res = set_paths(tmp_path)
    make_synthetic_dataset(raw, num_cases=4, shape=(72, 72, 8))
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
    monkeypatch.setitem(registry.MODEL_BUILDERS, NAME,
                        functools.partial(tm2net.get_m2net_from_plans,
                                          small=True, stage_layers=(1, 1, 1, 1)))
    return pp


def _short(trainer, epochs):
    trainer.config = replace(trainer.config, num_epochs=epochs,
                             num_iterations_per_epoch=1,
                             num_val_iterations_per_epoch=1)
    return trainer


def test_train_checkpoint_resume_predict(dataset):
    trainer = _short(get_trainer_from_args(999, "2d", 0, NAME, device="cpu",
                                           seed=0), epochs=1)
    assert trainer.config.optimizer == "adamw" and trainer.config.ds_mode == "x2net"
    trainer.run_training()
    log = trainer.logger.my_fantastic_logging
    assert len(log["train_losses"]) == 1
    assert np.isfinite(log["train_losses"]).all() and np.isfinite(log["val_losses"]).all()
    assert len(log["dice_per_class_or_region"][0]) == 2
    assert trainer.step == 1 and trainer.current_epoch == 1
    out = trainer.output_folder
    for f in ("checkpoint_final.pth", "checkpoint_best.pth", "debug.json"):
        assert os.path.isfile(os.path.join(out, f)), f
    assert not os.path.isfile(os.path.join(out, "checkpoint_latest.pth"))
    assert os.path.isfile(os.path.join(trainer.output_folder_base, "plans.json"))
    # 5-fold split written next to the preprocessed data; fold 0 trains on 3 of 4
    tr_keys, val_keys = trainer.do_split()
    assert len(tr_keys) == 3 and len(val_keys) == 1

    # the checkpoint: the JAX package's schema with a state_dict as weights
    ckpt = load_pickle(os.path.join(out, "checkpoint_final.pth"))
    assert set(ckpt) == {"network_weights", "optimizer_state", "step", "logging",
                         "_best_ema", "current_epoch", "init_args", "trainer_name",
                         "inference_allowed_mirroring_axes"}
    assert ckpt["trainer_name"] == NAME and ckpt["current_epoch"] == 1
    assert ckpt["inference_allowed_mirroring_axes"] == (0, 1)
    trained = trainer.model.state_dict()
    assert set(ckpt["network_weights"]) == set(trained)
    for k, v in trained.items():
        assert torch.equal(ckpt["network_weights"][k], v), k

    # resume for a second epoch from the folder
    resumed = _short(get_trainer_from_args(999, "2d", 0, NAME, device="cpu",
                                           seed=1), epochs=2)
    maybe_load_checkpoint(resumed, continue_training=True, validation_only=False)
    assert resumed.current_epoch == 1 and resumed.step == 1
    for k, v in trained.items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    moments = resumed.optimizer.state_dict()["state"]
    assert len(moments) == len(list(resumed.model.parameters()))
    assert all(int(s["step"]) == 1 for s in moments.values())
    resumed.run_training()
    assert resumed.current_epoch == 2 and resumed.step == 2
    assert len(resumed.logger.my_fantastic_logging["train_losses"]) == 2
    changed = sum(not torch.equal(resumed.model.state_dict()[k], v)
                  for k, v in trained.items())
    assert changed > 0.9 * len(trained)

    # a trainer made again from the checkpoint's own arguments
    again = load_trainer_from_checkpoint(os.path.join(out, "checkpoint_final.pth"),
                                         device="cpu")
    assert again.current_epoch == 2 and again.trainer_name == NAME

    # the port's predictor loads the folder and predicts a volume
    pred = Predictor(tile_batch_size=1, use_mirroring=False, device="cpu")
    pred.initialize_from_trained_model_folder(trainer.output_folder_base,
                                              use_folds=[0])
    assert pred.trainer_name == NAME and type(pred.model).__name__ == "M2NetP"
    assert pred.allowed_mirroring_axes == (0, 1)
    assert pred.auto_detect_available_folds(trainer.output_folder_base,
                                            "checkpoint_final.pth") == [0]
    volume = (100 * np.random.RandomState(0).rand(1, 2, 70, 66)).astype(np.float32)
    seg = pred.predict_single_npy_array(volume, {"spacing": [1.0, 1.0, 1.0]})
    assert seg.shape == volume.shape[1:] and set(np.unique(seg)) <= {0, 1, 2}


def test_run_training_entry_point_and_the_parts_that_wait(dataset, monkeypatch):
    """``run_training`` builds the trainer, trains and runs the final
    validation unless told to skip it; the options listed in the trainer's
    docstring are not ported: each raises ``NotImplementedError``."""
    calls = []

    def no_training(self):
        calls.append(self)
        self.initialize()
        # predict without mirror TTA to keep the file fast; the validation
        # with TTA is held to the JAX package in test_torch_validation.py
        self.inference_allowed_mirroring_axes = None

    monkeypatch.setattr(Trainer, "run_training", no_training)
    t = run_training(999, "2d", "all", NAME, num_epochs=1, skip_validation=True,
                     device="cpu", seed=0)
    assert calls == [t] and t.fold == "all"
    assert not os.path.isdir(os.path.join(t.output_folder, "validation"))
    t = run_training(999, "2d", 0, NAME, num_epochs=1, device="cpu", seed=0)
    val = os.path.join(t.output_folder, "validation")
    _, val_keys = t.do_split()
    assert sorted(os.listdir(val)) == sorted(
        [k + ".nii.gz" for k in val_keys] + ["summary.json"])
    assert set(t.validation_case_times) == set(val_keys)
    with pytest.raises(FileNotFoundError):
        run_training(999, "2d", 0, NAME, only_run_validation=True, device="cpu")

    from nnuzoo_tpu_torch.utilities.io import join, load_json
    pp = join(dataset, "Dataset999_Synth")
    plans = load_json(join(pp, "nnUNetPlans.json"))
    dataset_json = load_json(join(pp, "dataset.json"))
    make = functools.partial(Trainer, plans, "2d", 0, device="cpu")
    with pytest.raises(NotImplementedError, match="target_type"):
        make(dict(dataset_json, target_type="ssl"), trainer_name=NAME)
    # the fine-tuning trainer's encoder freeze is ported (test_torch_finetune.py)
    finetune = make(dataset_json, trainer_name="nnUNetTrainerFineTuneDecoderWarmUp")
    assert finetune.config.freeze_encoder_epochs == 50
    monkeypatch.setenv("NNUZOO_BF16", "1")
    with pytest.raises(NotImplementedError, match="bf16"):
        make(dataset_json, trainer_name=NAME)
    monkeypatch.delenv("NNUZOO_BF16")
    monkeypatch.setenv("NNUZOO_MODEL_PARALLEL", "2")
    with pytest.raises(NotImplementedError, match="mesh"):
        make(dataset_json, trainer_name=NAME)
    monkeypatch.delenv("NNUZOO_MODEL_PARALLEL")
    # a cascaded configuration builds: the previous stage's one-hot labels
    # are input channels and its augmentation moves them there
    cascaded = {**plans, "configurations": {
        **plans["configurations"],
        "2d": dict(plans["configurations"]["2d"], previous_stage="3d_lowres")}}
    t = Trainer(cascaded, "2d", 0, dataset_json, device="cpu", trainer_name=NAME)
    assert t.num_input_channels == 1 + len(t.label_manager.foreground_labels)
    train_cfg, val_cfg = t._make_augment_config()
    assert train_cfg.is_cascaded and val_cfg.is_cascaded
    assert train_cfg.foreground_labels == tuple(t.label_manager.foreground_labels)
    assert t._previous_stage_folder().endswith(
        os.path.join("predicted_next_stage", "2d"))
    # and so does a translation target
    t = make(dict(dataset_json, target_type="translation"), trainer_name=NAME)
    assert t.label_manager.num_segmentation_heads == \
        len(dataset_json["labels"]) - 1
    # nnUNetTrainer has a model now; a zoo model without one raises
    with pytest.raises(RuntimeError, match="No model registered"):
        make(dataset_json, trainer_name="nnUNetTrainerSwT2Net").initialize()


def test_entry_points_raise_without_the_card_they_were_asked_for(dataset):
    """``device`` defaults to CUDA and there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from nnuzoo_tpu_torch.data.loader import DevicePrefetcher
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_trainer_from_args(999, "2d", 0, NAME)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(999, "2d", 0, NAME)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetcher(iter(()))


def test_prefetcher_converts_on_the_cpu_and_surfaces_errors():
    from nnuzoo_tpu_torch.data.loader import DevicePrefetcher

    def batches():
        for i in range(3):
            yield {"data": np.full((2, 1, 4, 4), i, np.float32),
                   "target": np.zeros((2, 1, 4, 4), np.int16), "keys": ["a", "b"]}
        raise ValueError("sampler broke")

    loader = DevicePrefetcher(batches(), buffer_size=2, device="cpu")
    b = next(loader)
    assert isinstance(b["data"], torch.Tensor) and b["data"].dtype == torch.float32
    assert b["target"].dtype == torch.int16 and b["keys"] == ["a", "b"]
    assert float(b["data"].mean()) == 0.0
    # the worker's exception comes out of a later next(), at the latest when
    # the batches it made before are used up
    with pytest.raises(ValueError, match="sampler broke"):
        for _ in range(3):
            next(loader)
    loader.stop()
