"""Case preprocessing: transpose -> crop -> normalize -> resample.

Copy of ``nnuzoo_tpu/preprocessing/preprocessor.py`` trimmed to
``run_case_npy`` and ``run_case``, which is what prediction and the cascade
input run. A segmentation is cropped and resampled with the image; the
foreground-location sampling that training's preprocessing adds
(``class_locations``), ``run_case_save`` and ``run`` wait for the port's
``plan_and_preprocess``. The port imports nothing of the JAX package.

Semantics follow `nnunetv2/preprocessing/preprocessors/default_preprocessor.py:42-305`:
normalization MUST run before resampling (the nonzero mask must still align).
"""

import time
from typing import List, Optional, Union

import numpy as np

from ..plans.plans_handler import ConfigurationManager, PlansManager
from ..utilities.io import load_json
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
