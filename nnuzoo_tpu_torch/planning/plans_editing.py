"""Plans-file editing helpers (reference:
`nnunetv2/tests/integration_tests/add_lowres_and_cascade.py` — plans editing is an
advertised nnU-Net v2 feature; this injects 3d_lowres + 3d_cascade_fullres
configurations derived from 3d_fullres).

This package's copy of ``nnuzoo_tpu/planning/plans_editing.py``; the port imports nothing of
the JAX package.
"""

from copy import deepcopy
from typing import Union

from ..paths import get_preprocessed_folder
from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
from ..utilities.io import join, load_json, save_json


def move_plans_between_datasets(source_dataset_name_or_id: Union[int, str],
                                target_dataset_name_or_id: Union[int, str],
                                source_plans_identifier: str,
                                target_plans_identifier: str = None) -> str:
    """Copy a plans file onto another dataset for pretraining/transfer
    (reference `nnunetv2/experiment_planning/plans_for_pretraining/
    move_plans_between_datasets.py:13-63`): rewrites dataset_name,
    data_identifiers and the reader-writer class for the target dataset."""
    from ..imageio.registry import determine_reader_writer_from_dataset_json
    from ..paths import get_raw_folder
    from ..utilities.dataset_utils import \
        get_filenames_of_train_images_and_targets
    from ..utilities.io import isdir, isfile

    source_name = maybe_convert_to_dataset_name(source_dataset_name_or_id)
    target_name = maybe_convert_to_dataset_name(target_dataset_name_or_id)
    if target_plans_identifier is None:
        target_plans_identifier = source_plans_identifier

    source_folder = join(get_preprocessed_folder(), source_name)
    assert isdir(source_folder), (
        f"preprocessed folder of source dataset {source_name} is missing; run "
        "nnUNetv2_plan_and_preprocess for the source dataset first")
    source_plans_file = join(source_folder, source_plans_identifier + ".json")
    assert isfile(source_plans_file), (
        f"source plans missing: {source_plans_file}")

    plans = load_json(source_plans_file)
    plans["dataset_name"] = target_name
    if target_plans_identifier != source_plans_identifier:
        for cfg in plans["configurations"].values():
            ident = cfg.get("data_identifier")
            if ident is None:
                continue
            if ident.startswith(source_plans_identifier):
                cfg["data_identifier"] = (target_plans_identifier +
                                          ident[len(source_plans_identifier):])
            else:
                cfg["data_identifier"] = target_plans_identifier + "_" + ident
    plans["plans_name"] = target_plans_identifier

    # the target dataset may use a different file format -> swap reader/writer
    target_raw = join(get_raw_folder(), target_name)
    target_dj = load_json(join(target_raw, "dataset.json"))
    dataset = get_filenames_of_train_images_and_targets(target_raw, target_dj)
    example = next(iter(dataset.values()))["images"][0]
    rw = determine_reader_writer_from_dataset_json(target_dj, example)
    plans["image_reader_writer"] = rw.__name__

    out_file = join(get_preprocessed_folder(), target_name,
                    target_plans_identifier + ".json")
    save_json(plans, out_file, sort_keys=False)
    return out_file


def add_lowres_and_cascade(dataset_name_or_id: Union[int, str],
                           plans_identifier: str = "nnUNetPlans",
                           lowres_spacing_factor: float = 2.0) -> dict:
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    plans_file = join(get_preprocessed_folder(), dataset_name,
                      plans_identifier + ".json")
    plans = load_json(plans_file)
    assert "3d_fullres" in plans["configurations"], \
        "needs a 3d_fullres configuration"
    fullres = plans["configurations"]["3d_fullres"]

    lowres = deepcopy(fullres)
    lowres["data_identifier"] = plans_identifier + "_3d_lowres"
    lowres["spacing"] = [s * lowres_spacing_factor for s in fullres["spacing"]]
    lowres["median_image_size_in_voxels"] = [
        round(i / lowres_spacing_factor)
        for i in fullres["median_image_size_in_voxels"]]
    lowres["batch_dice"] = False
    lowres["next_stage"] = "3d_cascade_fullres"
    plans["configurations"]["3d_lowres"] = lowres
    plans["configurations"]["3d_cascade_fullres"] = {
        "inherits_from": "3d_fullres",
        "previous_stage": "3d_lowres",
    }
    plans["configurations"]["3d_fullres"]["batch_dice"] = True
    save_json(plans, plans_file, sort_keys=False)
    return plans
