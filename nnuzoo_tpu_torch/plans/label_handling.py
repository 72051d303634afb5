"""Label / region / ignore-label semantics.

Copy of ``nnuzoo_tpu/plans/label_handling.py``, trimmed to what prediction
and training call (its logic unchanged); the port imports nothing of the JAX package.

Numpy-only re-implementation of the reference LabelManager
(`nnunetv2/utilities/label_handling/label_handling.py:20-253`):

- ``dataset.json`` labels map name -> int, or name -> tuple of ints ("regions",
  trained as independent sigmoid heads), plus an optional ``ignore`` label that must
  be the highest value.
- ``num_segmentation_heads``: number of foreground regions if region-based, else
  number of labels (background included); for ``target_type == 'translation'`` the
  background head is dropped (reference `:242-251`).
- inference nonlinearity: sigmoid if regions else softmax over channel 0
  (reference `:46-49`).
"""

from typing import List, Optional, Tuple, Union

import numpy as np


class LabelManager:
    def __init__(self, label_dict: dict, regions_class_order: Union[List[int], None],
                 force_use_labels: bool = False, inference_nonlin=None,
                 target_type: str = "segmentation"):
        self._sanity_check(label_dict)
        self.label_dict = label_dict
        self.regions_class_order = regions_class_order
        self._force_use_labels = force_use_labels
        self._num_segmentation_heads = None
        self.target_type = target_type

        if force_use_labels:
            self._has_regions = False
        else:
            self._has_regions = any(isinstance(v, (tuple, list)) and len(v) > 1
                                    for v in label_dict.values())

        self._ignore_label = self._determine_ignore_label()
        self._all_labels = self._get_all_labels()
        self._regions = self._get_regions()

        if self.has_ignore_label:
            assert self.ignore_label == max(self.all_labels) + 1, (
                "If you use the ignore label it must have the highest label value. "
                f"Got ignore={self.ignore_label}, labels={self.all_labels}")

        self.inference_nonlin = inference_nonlin  # None -> sigmoid/softmax by has_regions

    @staticmethod
    def _sanity_check(label_dict: dict):
        if "background" not in label_dict:
            raise RuntimeError("Background label not declared (should be label 0)")
        bg = label_dict["background"]
        if isinstance(bg, (tuple, list)):
            raise RuntimeError(f"Background label must be 0, not a region. Got {bg}")
        assert int(bg) == 0, f"Background label must be 0, got {bg}"

    def _get_all_labels(self) -> List[int]:
        all_labels = []
        for k, r in self.label_dict.items():
            if k == "ignore":
                continue
            if isinstance(r, (tuple, list)):
                all_labels.extend(int(ri) for ri in r)
            else:
                all_labels.append(int(r))
        return sorted(np.unique(all_labels).tolist())

    def _get_regions(self) -> Optional[List[Union[int, Tuple[int, ...]]]]:
        if not self._has_regions or self._force_use_labels:
            return None
        assert self.regions_class_order is not None, (
            "region-based training requires regions_class_order in dataset.json")
        regions = []
        for k, r in self.label_dict.items():
            if k == "ignore":
                continue
            if (np.isscalar(r) and r == 0) or (
                    isinstance(r, (tuple, list)) and len(np.unique(r)) == 1
                    and np.unique(r)[0] == 0):
                continue
            regions.append(tuple(r) if isinstance(r, list) else r)
        assert len(self.regions_class_order) == len(regions), (
            "regions_class_order must have as many entries as there are regions")
        return regions

    def _determine_ignore_label(self) -> Optional[int]:
        ignore_label = self.label_dict.get("ignore")
        if ignore_label is not None:
            assert isinstance(ignore_label, int), (
                f"Ignore label must be an int, got {type(ignore_label)}")
        return ignore_label

    # ------------------------------------------------------------------ properties
    @property
    def has_regions(self) -> bool:
        return self._has_regions

    @property
    def has_ignore_label(self) -> bool:
        return self._ignore_label is not None

    @property
    def all_regions(self):
        return self._regions

    @property
    def all_labels(self) -> List[int]:
        return self._all_labels

    @property
    def ignore_label(self) -> Optional[int]:
        return self._ignore_label

    @staticmethod
    def filter_background(classes_or_regions):
        return [i for i in classes_or_regions
                if ((not isinstance(i, (tuple, list))) and i != 0)
                or (isinstance(i, (tuple, list))
                    and not (len(np.unique(i)) == 1 and np.unique(i)[0] == 0))]

    @property
    def foreground_regions(self):
        return self.filter_background(self.all_regions)

    @property
    def foreground_labels(self):
        return self.filter_background(self.all_labels)

    @property
    def num_segmentation_heads(self) -> int:
        if self._num_segmentation_heads is not None:
            return self._num_segmentation_heads
        if self.has_regions:
            return len(self.foreground_regions)
        if self.target_type == "translation":
            return len(self.all_labels) - 1
        return len(self.all_labels)

    @num_segmentation_heads.setter
    def num_segmentation_heads(self, value: int):
        self._num_segmentation_heads = value

    # ------------------------------------------------------------------ inference
    def apply_inference_nonlin(self, logits: np.ndarray) -> np.ndarray:
        """logits: (c, x, y(, z)) -> probabilities, fp32."""
        logits = np.asarray(logits, dtype=np.float32)
        if self.inference_nonlin is not None:
            return self.inference_nonlin(logits)
        if self.has_regions:
            return 1.0 / (1.0 + np.exp(-logits))
        shifted = logits - logits.max(axis=0, keepdims=True)
        e = np.exp(shifted)
        return e / e.sum(axis=0, keepdims=True)

    def convert_probabilities_to_segmentation(self, probs: np.ndarray) -> np.ndarray:
        assert probs.shape[0] == self.num_segmentation_heads, (
            f"expected {self.num_segmentation_heads} channels, got {probs.shape[0]}")
        if self.has_regions:
            seg = np.zeros(probs.shape[1:], dtype=np.uint16)
            for i, c in enumerate(self.regions_class_order):
                seg[probs[i] > 0.5] = c
            return seg
        return probs.argmax(0)

    def convert_logits_to_segmentation(self, logits: np.ndarray) -> np.ndarray:
        if self.has_regions:
            return self.convert_probabilities_to_segmentation(
                self.apply_inference_nonlin(logits))
        # argmax is identical on logits and probabilities
        return self.convert_probabilities_to_segmentation_noassert_argmax(logits)

    def convert_probabilities_to_segmentation_noassert_argmax(self, logits):
        assert logits.shape[0] == self.num_segmentation_heads
        return logits.argmax(0)

    def revert_cropping_on_probabilities(self, probs: np.ndarray, bbox, original_shape):
        """Insert (c, *cropped) probabilities back into a (c, *original_shape) canvas;
        padded area becomes background prob 1 in label mode (reference `:200-221`)."""
        out = np.zeros((probs.shape[0], *original_shape), dtype=probs.dtype)
        if not self.has_regions:
            out[0] = 1
        slicer = tuple([slice(None)] + [slice(b[0], b[1]) for b in bbox])
        out[slicer] = probs
        return out


def convert_labelmap_to_one_hot(segmentation: np.ndarray, all_labels,
                                output_dtype=np.uint8) -> np.ndarray:
    """(x, y(, z)) labelmap -> (len(all_labels), x, y(, z)) one-hot
    (reference `label_handling.py:269-302`)."""
    result = np.zeros((len(all_labels), *segmentation.shape), dtype=output_dtype)
    for i, l in enumerate(all_labels):
        result[i] = segmentation == l
    return result


def determine_num_input_channels(plans_manager, configuration_or_config_manager,
                                 dataset_json: dict) -> int:
    """Cascade stages get the one-hot foreground labels of the previous stage
    as extra input channels."""
    if isinstance(configuration_or_config_manager, str):
        config_manager = plans_manager.get_configuration(configuration_or_config_manager)
    else:
        config_manager = configuration_or_config_manager
    label_manager = plans_manager.get_label_manager(dataset_json)
    num_modalities = len(dataset_json.get("modality", dataset_json.get("channel_names")))
    if config_manager.previous_stage_name is not None:
        return num_modalities + len(label_manager.foreground_labels)
    return num_modalities
