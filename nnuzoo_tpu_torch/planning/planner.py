"""Experiment planner (reference:
`nnunetv2/experiment_planning/experiment_planners/default_experiment_planner.py:24-601`).

Same decision logic and constants as the reference: median target spacing with
10th-percentile override on strongly anisotropic axes, transpose lowest-res axis
first, patch-size shrink loop against a memory budget, batch size from leftover
budget capped at 5% of dataset voxels, 2d + 3d_fullres + optional 3d_lowres +
3d_cascade_fullres configurations.

One deliberate difference: the memory estimate. The reference instantiates a torch
network per iteration and counts conv feature-map elements
(`static_estimate_VRAM_usage:96`). We compute the identical count analytically
(`estimate_conv_feature_map_elements`) — same number, no network instantiation, so
the shrink loop is ~1000x faster.

This package's copy of ``nnuzoo_tpu/planning/planner.py``; the port imports nothing of
the JAX package.
"""

import shutil
from copy import deepcopy
from typing import List, Tuple, Union

import numpy as np

from ..configuration import ANISO_THRESHOLD
from ..imageio.registry import determine_reader_writer_from_dataset_json
from ..paths import get_preprocessed_folder, get_raw_folder
from ..preprocessing.normalization import (get_normalization_class_by_name,
                                           get_normalization_scheme_for_channel)
from ..preprocessing.resampling import compute_new_shape
from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
from ..utilities.dataset_utils import get_filenames_of_train_images_and_targets
from ..utilities.io import isfile, join, load_json, maybe_mkdir, save_json
from ..utilities.json_export import recursive_fix_for_json_export
from .topology import get_pool_and_conv_props


def estimate_conv_feature_map_elements(patch_size, n_stages: int, features_per_stage,
                                       strides, n_conv_per_stage, n_conv_per_stage_decoder,
                                       num_classes: int) -> int:
    """Total conv output elements of a PlainConvUNet forward pass — the quantity
    dynamic_network_architectures' ``compute_conv_feature_map_size`` returns and the
    reference planner budgets against (`default_experiment_planner.py:96-117`).

    Encoder stage s runs at size patch/prod(strides[:s+1]) with n_conv convs; decoder
    stage mirrors the skip resolution with a transpconv + n_conv_dec convs + seg head.
    """
    patch_size = np.array(patch_size, dtype=np.int64)
    sizes = []
    cur = patch_size.copy()
    for s in range(n_stages):
        cur = cur // np.array(strides[s], dtype=np.int64)
        sizes.append(cur.copy())

    total = np.int64(0)
    for s in range(n_stages):
        total += n_conv_per_stage[s] * features_per_stage[s] * np.prod(sizes[s])
    # decoder: stages n_stages-2 .. 0 at skip resolution
    for i, s in enumerate(range(n_stages - 2, -1, -1)):
        numel = np.prod(sizes[s])
        total += features_per_stage[s] * numel  # transpconv output
        total += n_conv_per_stage_decoder[i] * features_per_stage[s] * numel
        if s == 0:  # final seg head (deep supervision off during planning)
            total += num_classes * numel
    return int(total)


class ExperimentPlanner:
    def __init__(self, dataset_name_or_id: Union[str, int],
                 gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetPlans",
                 overwrite_target_spacing=None,
                 suppress_transpose: bool = False):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.suppress_transpose = suppress_transpose
        self.raw_dataset_folder = join(get_raw_folder(), self.dataset_name)
        preprocessed_folder = join(get_preprocessed_folder(), self.dataset_name)
        self.dataset_json = load_json(join(self.raw_dataset_folder, "dataset.json"))
        self.num_output_channels = len(self.dataset_json["labels"]) \
            if "labels" in self.dataset_json else len(self.dataset_json["channel_names"])
        self.dataset = get_filenames_of_train_images_and_targets(
            self.raw_dataset_folder, self.dataset_json)

        fp_file = join(preprocessed_folder, "dataset_fingerprint.json")
        if not isfile(fp_file):
            raise RuntimeError(f"Fingerprint missing ({fp_file}). Run fingerprint "
                               f"extraction first.")
        self.dataset_fingerprint = load_json(fp_file)

        self.anisotropy_threshold = ANISO_THRESHOLD

        # reference constants (`default_experiment_planner.py:57-78`)
        self.UNet_base_num_features = 32
        self.UNet_class_name = "PlainConvUNet"
        self.UNet_reference_val_3d = 560000000
        self.UNet_reference_val_2d = 85000000
        self.UNet_reference_com_nfeatures = 32
        self.UNet_reference_val_corresp_GB = 8
        self.UNet_reference_val_corresp_bs_2d = 12
        self.UNet_reference_val_corresp_bs_3d = 2
        self.UNet_featuremap_min_edge_length = 4
        self.UNet_blocks_per_stage_encoder = (2,) * 14
        self.UNet_blocks_per_stage_decoder = (2,) * 13
        self.UNet_min_batch_size = 2
        self.UNet_max_features_2d = 512
        self.UNet_max_features_3d = 320
        self.max_dataset_covered = 0.05
        self.UNet_vram_target_GB = gpu_memory_target_in_gb
        self.lowres_creation_threshold = 0.25

        self.preprocessor_name = preprocessor_name
        self.plans_identifier = plans_name
        self.overwrite_target_spacing = overwrite_target_spacing
        self.plans = None

        splits_file = join(self.raw_dataset_folder, "splits_final.json")
        if isfile(splits_file):
            target = join(preprocessed_folder, "splits_final.json")
            if not isfile(target):
                maybe_mkdir(preprocessed_folder)
                shutil.copy(splits_file, target)

    # ------------------------------------------------------------------ decisions
    def determine_reader_writer(self):
        example = next(iter(self.dataset.values()))["images"][0]
        return determine_reader_writer_from_dataset_json(self.dataset_json, example)

    def determine_fullres_target_spacing(self) -> np.ndarray:
        """Median spacing; 10th percentile on an axis that is both spacing- and
        voxel-anisotropic (reference `:158-199`)."""
        if self.overwrite_target_spacing is not None:
            return np.array(self.overwrite_target_spacing)

        spacings = np.vstack(self.dataset_fingerprint["spacings"])
        sizes = self.dataset_fingerprint["shapes_after_crop"]
        target = np.percentile(spacings, 50, axis=0)
        target_size = np.percentile(np.vstack(sizes), 50, 0)

        worst_spacing_axis = int(np.argmax(target))
        other_axes = [i for i in range(len(target)) if i != worst_spacing_axis]
        other_spacings = [target[i] for i in other_axes]
        other_sizes = [target_size[i] for i in other_axes]

        has_aniso_spacing = target[worst_spacing_axis] > (
            self.anisotropy_threshold * max(other_spacings))
        has_aniso_voxels = target_size[worst_spacing_axis] * \
            self.anisotropy_threshold < min(other_sizes)
        if has_aniso_spacing and has_aniso_voxels:
            spacing_axis = spacings[:, worst_spacing_axis]
            target_axis = np.percentile(spacing_axis, 10)
            if target_axis < max(other_spacings):
                target_axis = max(max(other_spacings), target_axis) + 1e-5
            target[worst_spacing_axis] = target_axis
        return target

    def determine_normalization_scheme_and_whether_mask_is_used_for_norm(
            self) -> Tuple[List[str], List[bool]]:
        modalities = self.dataset_json.get("channel_names",
                                           self.dataset_json.get("modality"))
        schemes = [get_normalization_scheme_for_channel(m) for m in modalities.values()]
        if self.dataset_fingerprint["median_relative_size_after_cropping"] < 3 / 4.0:
            use_mask = [bool(get_normalization_class_by_name(s)
                             .leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true)
                        for s in schemes]
        else:
            use_mask = [False] * len(schemes)
        return schemes, use_mask

    def determine_transpose(self):
        if self.suppress_transpose:
            return [0, 1, 2], [0, 1, 2]
        target_spacing = self.determine_fullres_target_spacing()
        max_spacing_axis = int(np.argmax(target_spacing))
        remaining = [i for i in range(3) if i != max_spacing_axis]
        transpose_forward = [max_spacing_axis] + remaining
        transpose_backward = [transpose_forward.index(i) for i in range(3)]
        return transpose_forward, transpose_backward

    def determine_resampling(self):
        return ("resample_data_or_seg_to_shape",
                {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None},
                "resample_data_or_seg_to_shape",
                {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None})

    def determine_segmentation_softmax_export_fn(self):
        return ("resample_data_or_seg_to_shape",
                {"is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None})

    # ------------------------------------------------------------------ per-config
    def static_estimate_memory_usage(self, patch_size, num_input_channels: int,
                                     num_output_channels: int, arch_kwargs: dict) -> int:
        return estimate_conv_feature_map_elements(
            patch_size, arch_kwargs["n_stages"], arch_kwargs["features_per_stage"],
            arch_kwargs["strides"], arch_kwargs["n_conv_per_stage"],
            arch_kwargs["n_conv_per_stage_decoder"], num_output_channels)

    def get_plans_for_configuration(self, spacing, median_shape, data_identifier: str,
                                    approximate_n_voxels_dataset: float,
                                    _cache: dict) -> dict:
        def _features(num_stages, max_features):
            return [min(max_features, self.UNet_base_num_features * 2 ** i)
                    for i in range(num_stages)]

        def _keygen(ps, st):
            return str(ps) + "_" + str(st)

        assert all(i > 0 for i in spacing), f"Spacing must be > 0, got {spacing}"
        num_input_channels = len(self.dataset_json.get(
            "channel_names", self.dataset_json.get("modality")))
        max_features = (self.UNet_max_features_2d if len(spacing) == 2
                        else self.UNet_max_features_3d)

        # initial patch size: spacing aspect ratio scaled to 256^3 / 2048^2 volume
        tmp = 1 / np.array(spacing)
        if len(spacing) == 3:
            initial_patch_size = [round(i) for i in
                                  tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3)]
        elif len(spacing) == 2:
            initial_patch_size = [round(i) for i in
                                  tmp * (2048 ** 2 / np.prod(tmp)) ** (1 / 2)]
        else:
            raise RuntimeError(f"unsupported dim {len(spacing)}")
        initial_patch_size = np.array(
            [min(i, j) for i, j in zip(initial_patch_size, median_shape[:len(spacing)])])

        (num_pool, pool_op_kernel_sizes, conv_kernel_sizes, patch_size,
         shape_must_be_divisible_by) = get_pool_and_conv_props(
            spacing, initial_patch_size, self.UNet_featuremap_min_edge_length, 999999)
        num_stages = len(pool_op_kernel_sizes)

        norm_name = "InstanceNorm"
        arch = {
            "network_class_name": self.UNet_class_name,
            "arch_kwargs": {
                "n_stages": num_stages,
                "features_per_stage": _features(num_stages, max_features),
                "conv_op": f"Conv{len(spacing)}d",
                "kernel_sizes": conv_kernel_sizes,
                "strides": pool_op_kernel_sizes,
                "n_conv_per_stage": list(self.UNet_blocks_per_stage_encoder[:num_stages]),
                "n_conv_per_stage_decoder":
                    list(self.UNet_blocks_per_stage_decoder[:num_stages - 1]),
                "conv_bias": True,
                "norm_op": norm_name,
                "norm_op_kwargs": {"eps": 1e-5, "affine": True},
                "dropout_op": None,
                "dropout_op_kwargs": None,
                "nonlin": "LeakyReLU",
                "nonlin_kwargs": {"negative_slope": 0.01},
            },
            "_kw_requires_import": ("conv_op", "norm_op", "dropout_op", "nonlin"),
        }

        def _estimate():
            key = _keygen(patch_size, pool_op_kernel_sizes)
            if key not in _cache:
                _cache[key] = self.static_estimate_memory_usage(
                    patch_size, num_input_channels, self.num_output_channels,
                    arch["arch_kwargs"])
            return _cache[key]

        estimate = _estimate()
        reference = (self.UNet_reference_val_2d if len(spacing) == 2
                     else self.UNet_reference_val_3d) * \
            (self.UNet_vram_target_GB / self.UNet_reference_val_corresp_GB)
        ref_bs = (self.UNet_reference_val_corresp_bs_2d if len(spacing) == 2
                  else self.UNet_reference_val_corresp_bs_3d)

        while (estimate / ref_bs * 2) > reference:
            # shrink the axis most oversized relative to the median shape
            axis_to_reduce = int(np.argsort(
                [i / j for i, j in zip(patch_size, median_shape[:len(spacing)])])[-1])
            patch_size = list(patch_size)
            tmp2 = deepcopy(patch_size)
            tmp2[axis_to_reduce] -= shape_must_be_divisible_by[axis_to_reduce]
            _, _, _, _, shape_must_be_divisible_by = get_pool_and_conv_props(
                spacing, tmp2, self.UNet_featuremap_min_edge_length, 999999)
            patch_size[axis_to_reduce] -= shape_must_be_divisible_by[axis_to_reduce]

            (num_pool, pool_op_kernel_sizes, conv_kernel_sizes, patch_size,
             shape_must_be_divisible_by) = get_pool_and_conv_props(
                spacing, patch_size, self.UNet_featuremap_min_edge_length, 999999)
            num_stages = len(pool_op_kernel_sizes)
            arch["arch_kwargs"].update({
                "n_stages": num_stages,
                "kernel_sizes": conv_kernel_sizes,
                "strides": pool_op_kernel_sizes,
                "features_per_stage": _features(num_stages, max_features),
                "n_conv_per_stage": list(self.UNet_blocks_per_stage_encoder[:num_stages]),
                "n_conv_per_stage_decoder":
                    list(self.UNet_blocks_per_stage_decoder[:num_stages - 1]),
            })
            estimate = _estimate()

        batch_size = round((reference / estimate) * ref_bs)
        bs_5_percent = round(approximate_n_voxels_dataset * self.max_dataset_covered /
                             np.prod(patch_size, dtype=np.float64))
        batch_size = max(min(batch_size, bs_5_percent), self.UNet_min_batch_size)

        (res_data, res_data_kwargs, res_seg, res_seg_kwargs) = self.determine_resampling()
        res_softmax, res_softmax_kwargs = self.determine_segmentation_softmax_export_fn()
        norm_schemes, use_mask = \
            self.determine_normalization_scheme_and_whether_mask_is_used_for_norm()

        return {
            "data_identifier": data_identifier,
            "preprocessor_name": self.preprocessor_name,
            "batch_size": batch_size,
            "patch_size": [int(i) for i in patch_size],
            "median_image_size_in_voxels": [float(i) for i in median_shape],
            "spacing": [float(i) for i in spacing],
            "normalization_schemes": norm_schemes,
            "use_mask_for_norm": use_mask,
            "resampling_fn_data": res_data,
            "resampling_fn_seg": res_seg,
            "resampling_fn_data_kwargs": res_data_kwargs,
            "resampling_fn_seg_kwargs": res_seg_kwargs,
            "resampling_fn_probabilities": res_softmax,
            "resampling_fn_probabilities_kwargs": res_softmax_kwargs,
            "architecture": arch,
        }

    # ------------------------------------------------------------------ experiment
    def plan_experiment(self) -> dict:
        _tmp = {}
        transpose_forward, transpose_backward = self.determine_transpose()
        fullres_spacing = self.determine_fullres_target_spacing()
        fullres_spacing_transposed = fullres_spacing[transpose_forward]

        new_shapes = [compute_new_shape(j, i, fullres_spacing) for i, j in
                      zip(self.dataset_fingerprint["spacings"],
                          self.dataset_fingerprint["shapes_after_crop"])]
        new_median_shape = np.median(new_shapes, 0)
        new_median_shape_transposed = new_median_shape[transpose_forward]

        approximate_n_voxels_dataset = float(
            np.prod(new_median_shape_transposed, dtype=np.float64) *
            self.dataset_json["numTraining"])

        plan_3d_fullres, plan_3d_lowres = None, None
        if new_median_shape_transposed[0] != 1:
            plan_3d_fullres = self.get_plans_for_configuration(
                fullres_spacing_transposed, new_median_shape_transposed,
                self.generate_data_identifier("3d_fullres"),
                approximate_n_voxels_dataset, _tmp)

            patch_size_fullres = plan_3d_fullres["patch_size"]
            median_num_voxels = np.prod(new_median_shape_transposed, dtype=np.float64)
            num_voxels_in_patch = np.prod(patch_size_fullres, dtype=np.float64)
            lowres_spacing = np.array(deepcopy(plan_3d_fullres["spacing"]))
            spacing_increase_factor = 1.03

            while num_voxels_in_patch / median_num_voxels < self.lowres_creation_threshold:
                max_spacing = max(lowres_spacing)
                if np.any((max_spacing / lowres_spacing) > 2):
                    lowres_spacing[(max_spacing / lowres_spacing) > 2] *= \
                        spacing_increase_factor
                else:
                    lowres_spacing *= spacing_increase_factor
                median_num_voxels = np.prod(
                    np.array(plan_3d_fullres["spacing"]) / lowres_spacing *
                    new_median_shape_transposed, dtype=np.float64)
                plan_3d_lowres = self.get_plans_for_configuration(
                    lowres_spacing,
                    tuple(round(i) for i in np.array(plan_3d_fullres["spacing"]) /
                          lowres_spacing * new_median_shape_transposed),
                    self.generate_data_identifier("3d_lowres"),
                    float(median_num_voxels * self.dataset_json["numTraining"]), _tmp)
                num_voxels_in_patch = np.prod(plan_3d_lowres["patch_size"],
                                              dtype=np.int64)
            if plan_3d_lowres is not None and \
                    np.prod(new_median_shape_transposed, dtype=np.float64) / \
                    median_num_voxels < 2:
                plan_3d_lowres = None
            if plan_3d_lowres is not None:
                plan_3d_lowres["batch_dice"] = False
                plan_3d_fullres["batch_dice"] = True
            else:
                plan_3d_fullres["batch_dice"] = False

        plan_2d = self.get_plans_for_configuration(
            fullres_spacing_transposed[1:], new_median_shape_transposed[1:],
            self.generate_data_identifier("2d"), approximate_n_voxels_dataset, _tmp)
        plan_2d["batch_dice"] = True

        median_spacing = np.median(self.dataset_fingerprint["spacings"], 0)[transpose_forward]
        median_shape = np.median(self.dataset_fingerprint["shapes_after_crop"], 0)[transpose_forward]

        pp_folder = join(get_preprocessed_folder(), self.dataset_name)
        maybe_mkdir(pp_folder)
        shutil.copy(join(self.raw_dataset_folder, "dataset.json"),
                    join(pp_folder, "dataset.json"))

        plans = {
            "dataset_name": self.dataset_name,
            "plans_name": self.plans_identifier,
            "original_median_spacing_after_transp": [float(i) for i in median_spacing],
            "original_median_shape_after_transp": [int(round(i)) for i in median_shape],
            "image_reader_writer": self.determine_reader_writer().__name__,
            "transpose_forward": [int(i) for i in transpose_forward],
            "transpose_backward": [int(i) for i in transpose_backward],
            "configurations": {"2d": plan_2d},
            "experiment_planner_used": self.__class__.__name__,
            "label_manager": "LabelManager",
            "foreground_intensity_properties_per_channel":
                self.dataset_fingerprint["foreground_intensity_properties_per_channel"],
        }
        if plan_3d_lowres is not None:
            plans["configurations"]["3d_lowres"] = plan_3d_lowres
            if plan_3d_fullres is not None:
                plans["configurations"]["3d_lowres"]["next_stage"] = "3d_cascade_fullres"
        if plan_3d_fullres is not None:
            plans["configurations"]["3d_fullres"] = plan_3d_fullres
            if plan_3d_lowres is not None:
                plans["configurations"]["3d_cascade_fullres"] = {
                    "inherits_from": "3d_fullres", "previous_stage": "3d_lowres"}

        self.plans = plans
        self.save_plans(plans)
        return plans

    def save_plans(self, plans) -> None:
        plans = recursive_fix_for_json_export(plans)
        pp_folder = join(get_preprocessed_folder(), self.dataset_name)
        plans_file = join(pp_folder, self.plans_identifier + ".json")
        # keep user-added configurations from an existing plans file
        if isfile(plans_file):
            old_configurations = load_json(plans_file)["configurations"]
            for c in plans["configurations"]:
                old_configurations.pop(c, None)
            plans["configurations"].update(old_configurations)
        maybe_mkdir(pp_folder)
        save_json(plans, plans_file, sort_keys=False)

    def generate_data_identifier(self, configuration_name: str) -> str:
        return self.plans_identifier + "_" + configuration_name

    def load_plans(self, fname: str):
        self.plans = load_json(fname)


class ResEncUNetPlanner(ExperimentPlanner):
    """Planner emitting ResidualEncoderUNet plans (reference
    `resencUNet_planner.py:9-33`): residual encoder with 1/3/4/6/6/... blocks
    per stage and recalibrated memory-reference constants."""

    def __init__(self, dataset_name_or_id, gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetPlans",
                 overwrite_target_spacing=None, suppress_transpose: bool = False):
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name,
                         overwrite_target_spacing, suppress_transpose)
        self.UNet_class_name = "ResidualEncoderUNet"
        self.UNet_reference_val_3d = 680000000
        self.UNet_reference_val_2d = 135000000
        self.UNet_blocks_per_stage_encoder = (1, 3, 4, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6)
        self.UNet_blocks_per_stage_decoder = (1,) * 12


_PLANNERS = {"ExperimentPlanner": ExperimentPlanner,
             "ResEncUNetPlanner": ResEncUNetPlanner}


def get_planner_class_by_name(name: str):
    if name not in _PLANNERS:
        raise RuntimeError(f"Unknown planner {name!r}. Known: {sorted(_PLANNERS)}")
    return _PLANNERS[name]
