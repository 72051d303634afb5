"""Case preprocessing: transpose -> crop -> normalize -> resample -> fg sampling.

This package's copy of ``nnuzoo_tpu/preprocessing/preprocessor.py``; the port
imports nothing of the JAX package. ``run_case`` also takes a ``times`` dict.

Semantics follow `nnunetv2/preprocessing/preprocessors/default_preprocessor.py:42-305`:
normalization MUST run before resampling (the nonzero mask must still align), the
foreground-location sample uses RandomState(1234) with 10k samples / >=1% coverage per
class-or-region, and outputs are saved as ``{case}.npz`` (data+seg) plus ``{case}.pkl``
properties.

Host-side orchestration uses a thread pool; the cases are written in any order,
each to its own files.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Union

import numpy as np

from ..paths import get_preprocessed_folder, get_raw_folder
from ..plans.plans_handler import ConfigurationManager, PlansManager
from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
from ..utilities.dataset_utils import get_filenames_of_train_images_and_targets
from ..utilities.io import join, load_json, maybe_mkdir, save_pickle
from .cropping import crop_to_nonzero
from .normalization import get_normalization_class_by_name
from .resampling import compute_new_shape


class DefaultPreprocessor:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose

    def run_case_npy(self, data: np.ndarray, seg: Optional[np.ndarray], properties: dict,
                     plans_manager: PlansManager,
                     configuration_manager: ConfigurationManager,
                     dataset_json: Union[dict, str]):
        data = np.copy(data)
        has_seg = seg is not None
        if has_seg:
            assert data.shape[1:] == seg.shape[1:], \
                "Shape mismatch between image and segmentation"
            seg = np.copy(seg)

        # transpose (also applies to spacing)
        tf = plans_manager.transpose_forward
        data = data.transpose([0, *[i + 1 for i in tf]])
        if has_seg:
            seg = seg.transpose([0, *[i + 1 for i in tf]])
        original_spacing = [properties["spacing"][i] for i in tf]

        properties["shape_before_cropping"] = data.shape[1:]
        # without a segmentation, seg comes back as the nonzero mask (-1
        # outside), for mask-restricted normalization
        data, seg, bbox = crop_to_nonzero(data, seg if has_seg else None)
        properties["bbox_used_for_cropping"] = bbox
        properties["shape_after_cropping_and_before_resampling"] = data.shape[1:]

        target_spacing = list(configuration_manager.spacing)
        if len(target_spacing) < len(data.shape[1:]):
            # 2d config: keep through-plane spacing unchanged
            target_spacing = [original_spacing[0]] + target_spacing
        new_shape = compute_new_shape(data.shape[1:], original_spacing, target_spacing)

        # normalize BEFORE resampling
        data = self._normalize(data, seg, configuration_manager,
                               plans_manager.foreground_intensity_properties_per_channel)

        data = configuration_manager.resampling_fn_data(
            data, new_shape, original_spacing, target_spacing)
        if has_seg:
            seg = configuration_manager.resampling_fn_seg(
                seg, new_shape, original_spacing, target_spacing)
            label_manager = plans_manager.get_label_manager(
                dataset_json if isinstance(dataset_json, dict) else load_json(dataset_json))
            collect = list(label_manager.foreground_regions if label_manager.has_regions
                           else label_manager.foreground_labels)
            if label_manager.has_ignore_label:
                collect.append(label_manager.all_labels)
            properties["class_locations"] = self._sample_foreground_locations(
                seg, collect, verbose=self.verbose)
            seg = self.modify_seg_fn(seg, plans_manager, dataset_json,
                                     configuration_manager)
            seg = seg.astype(np.int16 if np.max(seg) > 127 else np.int8)
            return data.astype(np.float32, copy=False), seg
        return data.astype(np.float32, copy=False), None

    def modify_seg_fn(self, seg, plans_manager, dataset_json, configuration_manager):
        return seg

    def run_case(self, image_files: List[str], seg_file: Optional[str],
                 plans_manager: PlansManager, configuration_manager: ConfigurationManager,
                 dataset_json: Union[dict, str], times: Optional[dict] = None):
        """Read one case's image files (and a segmentation file) through the
        plans' reader and preprocess them: (data, seg or None, properties).
        A ``times`` dict gets the seconds of each part, ``read_s`` and
        ``preprocess_s``."""
        if isinstance(dataset_json, str):
            dataset_json = load_json(dataset_json)
        t0 = time.perf_counter()
        rw = plans_manager.image_reader_writer_class()
        data, data_properties = rw.read_images(image_files)
        seg = rw.read_seg(seg_file)[0] if seg_file is not None else None
        t1 = time.perf_counter()
        data, seg = self.run_case_npy(data, seg, data_properties, plans_manager,
                                      configuration_manager, dataset_json)
        if times is not None:
            times["read_s"] = t1 - t0
            times["preprocess_s"] = time.perf_counter() - t1
        return data, seg, data_properties

    def run_case_save(self, output_filename_truncated: str, image_files: List[str],
                      seg_file: Optional[str], plans_manager: PlansManager,
                      configuration_manager: ConfigurationManager,
                      dataset_json: Union[dict, str], continue_: bool = False):
        if continue_ and os.path.isfile(output_filename_truncated + ".npz") and \
                os.path.isfile(output_filename_truncated + ".pkl"):
            return
        data, seg, properties = self.run_case(image_files, seg_file, plans_manager,
                                              configuration_manager, dataset_json)
        if seg is not None:
            np.savez_compressed(output_filename_truncated + ".npz", data=data, seg=seg)
        else:
            np.save(output_filename_truncated + ".npy", data)
        save_pickle(properties, output_filename_truncated + ".pkl")

    @staticmethod
    def _sample_foreground_locations(seg: np.ndarray, classes_or_regions,
                                     seed: int = 1234, verbose: bool = False) -> dict:
        num_samples = 10000
        min_percent_coverage = 0.01
        rndst = np.random.RandomState(seed)
        class_locs = {}
        for c in classes_or_regions:
            k = tuple(c) if isinstance(c, list) else c
            if isinstance(c, (tuple, list)):
                mask = np.isin(seg, np.asarray(c))
            else:
                mask = seg == c
            all_locs = np.argwhere(mask)
            if len(all_locs) == 0:
                class_locs[k] = []
                continue
            target = min(num_samples, len(all_locs))
            target = max(target, int(np.ceil(len(all_locs) * min_percent_coverage)))
            class_locs[k] = all_locs[rndst.choice(len(all_locs), target, replace=False)]
            if verbose:
                print(c, target)
        return class_locs

    def _normalize(self, data: np.ndarray, seg: Optional[np.ndarray],
                   configuration_manager: ConfigurationManager,
                   foreground_intensity_properties_per_channel: dict) -> np.ndarray:
        for c in range(data.shape[0]):
            scheme = configuration_manager.normalization_schemes[c]
            normalizer = get_normalization_class_by_name(scheme)(
                use_mask_for_norm=configuration_manager.use_mask_for_norm[c],
                intensityproperties=foreground_intensity_properties_per_channel.get(
                    str(c), {}))
            data[c] = normalizer.run(data[c], seg[0] if seg is not None else None)
        return data

    def run(self, dataset_name_or_id: Union[int, str], configuration_name: str,
            plans_identifier: str, num_processes: int = 4, continue_: bool = False):
        dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        raw_folder = join(get_raw_folder(), dataset_name)
        pp_root = join(get_preprocessed_folder(), dataset_name)
        plans = PlansManager(join(pp_root, plans_identifier + ".json"))
        cfg = plans.get_configuration(configuration_name)
        dataset_json = load_json(join(raw_folder, "dataset.json"))
        dataset = get_filenames_of_train_images_and_targets(raw_folder, dataset_json)

        out_dir = join(pp_root, cfg.data_identifier)
        maybe_mkdir(out_dir)

        def one_case(item):
            ident, files = item
            self.run_case_save(join(out_dir, ident), files["images"], files["label"],
                               plans, cfg, dataset_json, continue_=continue_)
            return ident

        if num_processes <= 1:
            for item in dataset.items():
                one_case(item)
        else:
            with ThreadPoolExecutor(max_workers=num_processes) as pool:
                list(pool.map(one_case, dataset.items()))
        if self.verbose:
            print(f"Preprocessed {len(dataset)} cases -> {out_dir}")


_PREPROCESSORS = {"DefaultPreprocessor": DefaultPreprocessor}


def get_preprocessor_class_by_name(name: str):
    if name not in _PREPROCESSORS:
        raise RuntimeError(f"Unknown preprocessor {name!r}. Known: {sorted(_PREPROCESSORS)}")
    return _PREPROCESSORS[name]
