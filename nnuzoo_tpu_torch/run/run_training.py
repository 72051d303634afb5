"""Training orchestration (port of ``nnuzoo_tpu/run/run_training.py``).

One process, one device. :func:`run_training` trains (or, with
``continue_training``, resumes from this package's checkpoints), then runs the
final validation unless ``skip_validation``; ``only_run_validation`` loads
``checkpoint_final`` (else ``checkpoint_best``) and validates, and
``validate_with_best`` validates the best checkpoint. A checkpoint to continue
may be the JAX package's (``Trainer.load_checkpoint``). Initialising from
pretrained weights is the library function
``run.load_pretrained_weights.load_pretrained_weights``, as in the JAX package.
"""

from typing import Optional, Union

from ..paths import get_preprocessed_folder
from ..training.trainer import Trainer
from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
from ..utilities.io import isfile, join, load_json


def get_trainer_from_args(dataset_name_or_id: Union[int, str], configuration: str,
                          fold, trainer_name: str = "nnUNetTrainer",
                          plans_identifier: str = "nnUNetPlans",
                          num_epochs: Optional[int] = None, device="cuda",
                          seed: Optional[int] = None) -> Trainer:
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    pp_folder = join(get_preprocessed_folder(), dataset_name)
    plans_file = join(pp_folder, plans_identifier + ".json")
    if not isfile(plans_file):
        raise FileNotFoundError(
            f"Plans file missing: {plans_file}. Run plan_and_preprocess first.")
    plans = load_json(plans_file)
    dataset_json = load_json(join(pp_folder, "dataset.json"))
    return Trainer(plans, configuration, fold, dataset_json,
                   trainer_name=trainer_name, num_epochs=num_epochs,
                   device=device, seed=seed)


def maybe_load_checkpoint(trainer: Trainer, continue_training: bool,
                          validation_only: bool) -> None:
    out = trainer.output_folder
    if continue_training:
        for name in ("checkpoint_final.pth", "checkpoint_latest.pth",
                     "checkpoint_best.pth"):
            f = join(out, name)
            if isfile(f):
                trainer.load_checkpoint(f)
                return
        print("No checkpoint found, starting fresh")
    elif validation_only:
        f = join(out, "checkpoint_final.pth")
        if not isfile(f):
            f = join(out, "checkpoint_best.pth")
        if not isfile(f):
            raise FileNotFoundError("Cannot run validation: no checkpoint_final/"
                                    f"best in {out}")
        trainer.load_checkpoint(f)


def run_training(dataset_name_or_id: Union[int, str], configuration: str, fold,
                 trainer_name: str = "nnUNetTrainer",
                 plans_identifier: str = "nnUNetPlans",
                 num_epochs: Optional[int] = None,
                 continue_training: bool = False, only_run_validation: bool = False,
                 validate_with_best: bool = False, skip_validation: bool = False,
                 export_validation_probabilities: bool = False,
                 device="cuda", seed: Optional[int] = None) -> Trainer:
    if fold != "all":
        fold = int(fold)
    trainer = get_trainer_from_args(dataset_name_or_id, configuration, fold,
                                    trainer_name, plans_identifier, num_epochs,
                                    device=device, seed=seed)
    if not only_run_validation:
        maybe_load_checkpoint(trainer, continue_training, False)
        trainer.run_training()
    else:
        trainer.initialize()
        maybe_load_checkpoint(trainer, False, True)

    if validate_with_best:
        best = join(trainer.output_folder, "checkpoint_best.pth")
        if isfile(best):
            trainer.load_checkpoint(best)
    if not skip_validation:
        trainer.perform_actual_validation(export_validation_probabilities)
    return trainer
