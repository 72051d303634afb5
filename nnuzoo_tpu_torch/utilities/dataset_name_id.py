"""Dataset name <-> id conversion (reference: `nnunetv2/utilities/dataset_name_id_conversion.py`).

Datasets live in folders named ``Dataset{XXX}_{Name}``; users may refer to them by
integer id, ``DatasetXXX`` prefix, or full name.
"""

import os
from typing import Union

from ..paths import get_preprocessed_folder, get_raw_folder, get_results_folder


def convert_id_to_dataset_name(dataset_id: int) -> str:
    candidates = []
    for getter in (get_preprocessed_folder, get_raw_folder, get_results_folder):
        try:
            root = getter()
        except RuntimeError:
            continue
        if os.path.isdir(root):
            candidates += [d for d in os.listdir(root)
                           if d.startswith(f"Dataset{dataset_id:03d}_")
                           and os.path.isdir(os.path.join(root, d))]
    unique = sorted(set(candidates))
    if len(unique) == 0:
        raise RuntimeError(f"Could not find a dataset with id {dataset_id} in nnUNet_raw, "
                           f"nnUNet_preprocessed or nnUNet_results.")
    if len(unique) > 1:
        raise RuntimeError(f"More than one dataset name found for id {dataset_id}: {unique}")
    return unique[0]


def maybe_convert_to_dataset_name(dataset_name_or_id: Union[int, str]) -> str:
    if isinstance(dataset_name_or_id, str) and dataset_name_or_id.startswith("Dataset"):
        return dataset_name_or_id
    try:
        dataset_id = int(dataset_name_or_id)
    except ValueError:
        raise ValueError(f"dataset_name_or_id must be an integer or a string starting with "
                         f"'Dataset', got {dataset_name_or_id!r}")
    return convert_id_to_dataset_name(dataset_id)
