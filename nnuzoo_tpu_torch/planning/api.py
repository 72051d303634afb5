"""plan-and-preprocess API (reference:
`nnunetv2/experiment_planning/plan_and_preprocess_api.py:36-161`).

This package's copy of ``nnuzoo_tpu/planning/api.py``; the port imports nothing of
the JAX package.
"""

import shutil
from typing import List, Optional, Union

from ..paths import get_preprocessed_folder, get_raw_folder
from ..plans.plans_handler import PlansManager
from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
from ..utilities.io import isdir, join, load_json, maybe_mkdir
from .fingerprint import DatasetFingerprintExtractor
from .planner import get_planner_class_by_name


def extract_fingerprint_dataset(dataset_id: Union[int, str], num_processes: int = 8,
                                check_dataset_integrity: bool = False,
                                clean: bool = True, verbose: bool = False) -> dict:
    if check_dataset_integrity:
        from .integrity import verify_dataset_integrity
        verify_dataset_integrity(
            join(get_raw_folder(), maybe_convert_to_dataset_name(dataset_id)),
            num_processes)
    return DatasetFingerprintExtractor(dataset_id, num_processes,
                                       verbose=verbose).run(overwrite_existing=clean)


def extract_fingerprints(dataset_ids: List[Union[int, str]], num_processes: int = 8,
                         check_dataset_integrity: bool = False, clean: bool = True,
                         verbose: bool = False) -> None:
    for d in dataset_ids:
        extract_fingerprint_dataset(d, num_processes, check_dataset_integrity, clean,
                                    verbose)


def plan_experiment_dataset(dataset_id: Union[int, str],
                            experiment_planner_name: str = "ExperimentPlanner",
                            gpu_memory_target_in_gb: float = 8,
                            preprocess_class_name: str = "DefaultPreprocessor",
                            overwrite_target_spacing: Optional[List[float]] = None,
                            overwrite_plans_name: Optional[str] = None) -> dict:
    planner_cls = get_planner_class_by_name(experiment_planner_name)
    kwargs = {}
    if overwrite_plans_name is not None:
        kwargs["plans_name"] = overwrite_plans_name
    planner = planner_cls(dataset_id, gpu_memory_target_in_gb=gpu_memory_target_in_gb,
                          preprocessor_name=preprocess_class_name,
                          overwrite_target_spacing=overwrite_target_spacing, **kwargs)
    return planner.plan_experiment()


def plan_experiments(dataset_ids: List[Union[int, str]], **kwargs) -> List[str]:
    """Plan each dataset; the plans' names (``nnUNetResEncUNetPlans`` from
    ``ResEncUNetPlanner``), as their files are named."""
    return [plan_experiment_dataset(d, **kwargs)["plans_name"] for d in dataset_ids]


def preprocess_dataset(dataset_id: Union[int, str],
                       plans_identifier: str = "nnUNetPlans",
                       configurations=("2d", "3d_fullres", "3d_lowres"),
                       num_processes=(8, 4, 8), verbose: bool = False) -> None:
    if not isinstance(num_processes, (list, tuple)):
        num_processes = [num_processes] * len(configurations)
    if len(num_processes) == 1:
        num_processes = list(num_processes) * len(configurations)
    assert len(num_processes) == len(configurations)

    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    pp_root = join(get_preprocessed_folder(), dataset_name)
    plans_manager = PlansManager(join(pp_root, plans_identifier + ".json"))
    for n, c in zip(num_processes, configurations):
        if c not in plans_manager.available_configurations:
            continue
        cfg = plans_manager.get_configuration(c)
        preprocessor = cfg.preprocessor_class(verbose=verbose)
        preprocessor.run(dataset_id, c, plans_identifier, num_processes=n)

    # copy ground-truth segmentations for evaluation (reference api:121-128)
    raw = join(get_raw_folder(), dataset_name)
    gt_dir = join(pp_root, "gt_segmentations")
    maybe_mkdir(gt_dir)
    dataset_json = load_json(join(raw, "dataset.json"))
    if isdir(join(raw, "labelsTr")):
        import os
        for f in os.listdir(join(raw, "labelsTr")):
            src = join(raw, "labelsTr", f)
            if f.endswith(dataset_json["file_ending"]):
                shutil.copy(src, join(gt_dir, f))


def preprocess(dataset_ids: List[Union[int, str]],
               plans_identifier: str = "nnUNetPlans",
               configurations=("2d", "3d_fullres", "3d_lowres"),
               num_processes=(8, 4, 8), verbose: bool = False) -> None:
    for d in dataset_ids:
        preprocess_dataset(d, plans_identifier, configurations, num_processes, verbose)
