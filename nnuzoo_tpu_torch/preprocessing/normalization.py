"""Intensity normalization schemes
(reference: `nnunetv2/preprocessing/normalization/default_normalization_schemes.py:8-94`).

Copy of ``nnuzoo_tpu/preprocessing/normalization.py`` (trimmed to what
prediction and planning call); the port imports nothing of the JAX package.
"""

from abc import ABC, abstractmethod
from typing import Optional, Type

import numpy as np


class ImageNormalization(ABC):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true: Optional[bool] = None

    def __init__(self, use_mask_for_norm: Optional[bool] = None,
                 intensityproperties: Optional[dict] = None,
                 target_dtype=np.float32):
        assert use_mask_for_norm is None or isinstance(use_mask_for_norm, bool)
        self.use_mask_for_norm = use_mask_for_norm
        self.intensityproperties = intensityproperties if intensityproperties is not None else {}
        self.target_dtype = target_dtype

    @abstractmethod
    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        ...


class ZScoreNormalization(ImageNormalization):
    """Plain z-score; with use_mask_for_norm, statistics and scaling are restricted to
    seg >= 0 (the crop-to-nonzero foreground), zeros elsewhere stay zero."""
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = True

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        image = image.astype(self.target_dtype, copy=False)
        if self.use_mask_for_norm:
            mask = seg >= 0
            mean = image[mask].mean()
            std = image[mask].std()
            image[mask] = (image[mask] - mean) / max(std, 1e-8)
        else:
            mean = image.mean()
            std = image.std()
            image = (image - mean) / max(std, 1e-8)
        return image


class CTNormalization(ImageNormalization):
    """Clip to dataset-global foreground percentiles 0.5/99.5, then z-score with
    dataset-global foreground mean/std."""
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        assert self.intensityproperties, "CTNormalization requires intensity properties"
        image = image.astype(self.target_dtype, copy=False)
        lower = self.intensityproperties["percentile_00_5"]
        upper = self.intensityproperties["percentile_99_5"]
        image = np.clip(image, lower, upper)
        return (image - self.intensityproperties["mean"]) / \
            max(self.intensityproperties["std"], 1e-8)


class NoNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        return image.astype(self.target_dtype, copy=False)


class RescaleTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        image = image.astype(self.target_dtype, copy=False)
        image = image - image.min()
        return image / np.clip(image.max(), a_min=1e-8, a_max=None)


class RGBTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        assert image.min() >= 0 and image.max() <= 255, \
            "RGBTo01Normalization expects uint8-range images"
        return image.astype(self.target_dtype, copy=False) / 255.0


_SCHEMES = {c.__name__: c for c in
            (ZScoreNormalization, CTNormalization, NoNormalization,
             RescaleTo01Normalization, RGBTo01Normalization)}


def get_normalization_class_by_name(name: str) -> Type[ImageNormalization]:
    if name not in _SCHEMES:
        raise RuntimeError(f"Unknown normalization scheme {name!r}. Known: {sorted(_SCHEMES)}")
    return _SCHEMES[name]



def get_normalization_scheme_for_channel(channel_name: str) -> str:
    """Channel name -> scheme (reference:
    `preprocessing/normalization/map_channel_name_to_normalization.py`)."""
    lower = channel_name.lower()
    if lower == "ct":
        return "CTNormalization"
    if lower in ("nonorm", "nonormalization", "no_norm"):
        return "NoNormalization"
    if lower in ("rescale_to_0_1", "rescale_0_1", "rescaleto01"):
        return "RescaleTo01Normalization"
    if lower in ("rgb_to_0_1", "rgb_to_01", "rgbto01", "rgbto1"):
        return "RGBTo01Normalization"
    return "ZScoreNormalization"
