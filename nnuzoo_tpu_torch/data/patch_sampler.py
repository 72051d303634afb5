"""Host-side foreground-oversampled patch sampling.

Semantics follow `nnunetv2/training/dataloading/data_loader.py:19-259`: infinite
random sampling over case ids; the last 33% of each batch is forced to contain
foreground (bbox centered on a stored ``class_locations`` voxel); patches are
extracted with crop-and-pad (data padded 0, seg padded -1); 2D configs sample a
single slice via pseudo-3D patch (1, y, x).

This package's copy of ``nnuzoo_tpu/data/patch_sampler.py``: it produces raw
numpy patches at the *initial* (inflated) patch size; all augmentation happens
afterwards on the device (``data/augment.py``).
"""

from typing import List, Optional, Tuple, Union

import numpy as np

from ..plans.label_handling import LabelManager
from .dataset import DatasetNumpy


def crop_and_pad_nd(array: np.ndarray, bbox: List[List[int]], pad_value=0) -> np.ndarray:
    """Extract bbox (which may extend past the array bounds) from the *spatial* axes
    (all but the first); out-of-bounds area is filled with pad_value."""
    spatial_shape = array.shape[1:]
    out_shape = (array.shape[0],) + tuple(b[1] - b[0] for b in bbox)
    out = np.full(out_shape, pad_value, dtype=array.dtype)
    src_slices, dst_slices = [slice(None)], [slice(None)]
    for (lb, ub), size in zip(bbox, spatial_shape):
        src_lo, src_hi = max(lb, 0), min(ub, size)
        if src_hi <= src_lo:
            return out
        dst_lo = src_lo - lb
        src_slices.append(slice(src_lo, src_hi))
        dst_slices.append(slice(dst_lo, dst_lo + (src_hi - src_lo)))
    out[tuple(dst_slices)] = np.ascontiguousarray(array[tuple(src_slices)])
    return out


class PatchSampler:
    def __init__(self, data: DatasetNumpy, batch_size: int,
                 initial_patch_size, final_patch_size,
                 label_manager: Optional[LabelManager],
                 oversample_foreground_percent: float = 0.33,
                 sampling_probabilities=None,
                 probabilistic_oversampling: bool = False,
                 target_type: str = "segmentation",
                 seed: Optional[int] = None):
        self._data = data
        self.batch_size = batch_size
        self.target_type = target_type
        self.rng = np.random.RandomState(seed)

        if len(initial_patch_size) == 2:
            final_patch_size = (1, *final_patch_size)
            initial_patch_size = (1, *initial_patch_size)
            self.patch_size_was_2d = True
        else:
            self.patch_size_was_2d = False

        self.indices = list(data.identifiers)
        self.oversample_foreground_percent = oversample_foreground_percent
        self.final_patch_size = tuple(final_patch_size)
        self.patch_size = tuple(initial_patch_size)
        self.need_to_pad = (np.array(initial_patch_size) -
                            np.array(final_patch_size)).astype(int)
        self.sampling_probabilities = sampling_probabilities
        if label_manager is not None:
            # One key convention shared with DefaultPreprocessor (which stores the
            # all-annotated-voxels entry under tuple(all_labels)); the reference
            # fork uses tuple([-1] + all_labels) in the loader but never stores
            # that key (data_loader.py:66 vs default_preprocessor.py:111) so its
            # lookup silently degrades — we match the *stored* key instead.
            self.annotated_classes_key = tuple(label_manager.all_labels)
            self.has_ignore = label_manager.has_ignore_label
        else:
            self.annotated_classes_key = ()
            self.has_ignore = False
        self.probabilistic_oversampling = probabilistic_oversampling

    def _do_oversample(self, sample_idx: int) -> bool:
        if self.probabilistic_oversampling:
            return self.rng.uniform() < self.oversample_foreground_percent
        return not sample_idx < round(
            self.batch_size * (1 - self.oversample_foreground_percent))

    def get_bbox(self, data_shape, force_fg: bool, class_locations: Optional[dict],
                 overwrite_class=None) -> Tuple[List[int], List[int]]:
        need_to_pad = self.need_to_pad.copy()
        dim = len(data_shape)
        for d in range(dim):
            if need_to_pad[d] + data_shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - data_shape[d]

        lbs = [-need_to_pad[i] // 2 for i in range(dim)]
        ubs = [data_shape[i] + need_to_pad[i] // 2 + need_to_pad[i] % 2 -
               self.patch_size[i] for i in range(dim)]

        selected_class = None
        use_fg_path = force_fg or self.has_ignore
        if use_fg_path:
            if not force_fg and self.has_ignore:
                selected_class = self.annotated_classes_key
                if selected_class not in class_locations:
                    import warnings
                    warnings.warn(
                        f"annotated-classes key {selected_class} missing from "
                        "class_locations; patch falls back to a uniform random "
                        "crop (re-run preprocessing?)")
                    selected_class = None
                elif len(class_locations[selected_class]) == 0:
                    selected_class = None
            else:
                assert class_locations is not None
                eligible = [k for k, v in class_locations.items() if len(v) > 0]
                is_ann_key = [k == self.annotated_classes_key if isinstance(k, tuple)
                              else False for k in eligible]
                if any(is_ann_key) and len(eligible) > 1:
                    eligible.pop(int(np.where(is_ann_key)[0][0]))
                if len(eligible) == 0:
                    selected_class = None
                elif overwrite_class is not None and overwrite_class in eligible:
                    selected_class = overwrite_class
                else:
                    selected_class = eligible[self.rng.choice(len(eligible))]

        if selected_class is not None:
            voxels = class_locations[selected_class]
            voxel = voxels[self.rng.choice(len(voxels))]
            # voxel[0] is the channel axis; center patch on it, clamped to lbs
            bbox_lbs = [max(lbs[i], voxel[i + 1] - self.patch_size[i] // 2)
                        for i in range(dim)]
        else:
            bbox_lbs = [self.rng.randint(lbs[i], ubs[i] + 1) for i in range(dim)]

        bbox_ubs = [bbox_lbs[i] + self.patch_size[i] for i in range(dim)]
        return bbox_lbs, bbox_ubs

    def get_indices(self) -> List[str]:
        idx = self.rng.choice(len(self.indices), self.batch_size, replace=True,
                              p=self.sampling_probabilities)
        return [self.indices[i] for i in idx]

    def generate_train_batch(self) -> dict:
        selected_keys = self.get_indices()
        first_data = self._data.load_case(selected_keys[0])[0]
        num_channels = first_data.shape[0]

        data_all = np.zeros((self.batch_size, num_channels, *self.patch_size),
                            dtype=np.float32)
        if self.target_type == "ssl":
            seg_all = None
        else:
            seg_dtype = np.float32 if self.target_type == "translation" else np.int16
            seg_all = None  # allocated once we know seg channel count

        for j, key in enumerate(selected_keys):
            data, seg, seg_prev, properties = self._data.load_case(key)
            force_fg = self._do_oversample(j) if seg is not None else False
            bbox_lbs, bbox_ubs = self.get_bbox(data.shape[1:], force_fg,
                                               properties.get("class_locations"))
            bbox = [[lo, hi] for lo, hi in zip(bbox_lbs, bbox_ubs)]
            data_all[j] = crop_and_pad_nd(np.asarray(data), bbox, 0)
            if self.target_type != "ssl" and seg is not None:
                pad = 0 if self.target_type == "translation" else -1
                seg_c = crop_and_pad_nd(np.asarray(seg), bbox, pad)
                if seg_prev is not None:
                    # the previous stage's uint8 labels, signed so that the
                    # padding is -1 (numpy refuses -1 in a uint8 array)
                    sp = np.asarray(seg_prev).astype(np.int16)
                    if sp.ndim == len(bbox):  # stored without channel axis
                        sp = sp[None]
                    seg_c = np.vstack((seg_c, crop_and_pad_nd(sp, bbox, -1)))
                if seg_all is None:
                    seg_all = np.zeros((self.batch_size, seg_c.shape[0],
                                        *self.patch_size), dtype=seg_dtype)
                seg_all[j] = seg_c

        if self.patch_size_was_2d:
            data_all = data_all[:, :, 0]
            if seg_all is not None:
                seg_all = seg_all[:, :, 0]

        return {"data": data_all, "target": seg_all, "keys": selected_keys}

    def __iter__(self):
        return self

    def __next__(self):
        return self.generate_train_batch()
