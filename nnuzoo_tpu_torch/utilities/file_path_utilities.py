"""Output-folder naming (copy of ``nnuzoo_tpu/utilities/file_path_utilities.py``,
trimmed to what training calls):
results/<Dataset>/<Trainer>__<Plans>__<configuration>/fold_<X>."""

from typing import Union

from ..paths import get_results_folder
from .io import join


def convert_trainer_plans_config_to_identifier(trainer_name, plans_identifier,
                                               configuration) -> str:
    return f"{trainer_name}__{plans_identifier}__{configuration}"


def get_output_folder(dataset_name: str, trainer_name: str = "nnUNetTrainer",
                      plans_identifier: str = "nnUNetPlans",
                      configuration: str = "3d_fullres",
                      fold: Union[str, int, None] = None) -> str:
    tmp = join(get_results_folder(), dataset_name,
               convert_trainer_plans_config_to_identifier(
                   trainer_name, plans_identifier, configuration))
    if fold is not None:
        tmp = join(tmp, f"fold_{fold}")
    return tmp
