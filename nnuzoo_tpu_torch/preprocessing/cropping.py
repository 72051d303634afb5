"""Crop-to-nonzero (reference: `nnunetv2/preprocessing/cropping/cropping.py:8-50`).

Copy of ``nnuzoo_tpu/preprocessing/cropping.py``; the port imports nothing of
the JAX package.

The nonzero mask is the union over channels of ``data != 0``, hole-filled; the crop
bbox is its bounding box. Voxels inside the bbox but outside the mask get label -1 in
the segmentation (used later by mask-restricted normalization).
"""

from typing import List, Optional, Tuple

import numpy as np
from scipy.ndimage import binary_fill_holes


def get_bbox_from_mask(mask: np.ndarray) -> List[List[int]]:
    """Per-axis [start, stop) of the True region. Empty mask -> full extent."""
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        proj = mask.any(axis=other)
        nz = np.flatnonzero(proj)
        if len(nz) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(nz[0]), int(nz[-1]) + 1])
    return bbox


def bounding_box_to_slice(bbox: List[List[int]]) -> Tuple[slice, ...]:
    return tuple(slice(b[0], b[1]) for b in bbox)


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    assert data.ndim in (3, 4), "data must be (c, x, y, z) or (c, x, y)"
    nonzero_mask = (data != 0).any(axis=0)
    return binary_fill_holes(nonzero_mask)


def crop_to_nonzero(data: np.ndarray, seg: Optional[np.ndarray] = None,
                    nonzero_label: int = -1):
    """Returns (cropped data, seg with nonzero_label outside mask, bbox)."""
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask)
    slicer = bounding_box_to_slice(bbox)

    data = data[(slice(None), *slicer)]
    if seg is not None:
        seg = seg[(slice(None), *slicer)]

    nonzero_mask = nonzero_mask[slicer][None]
    if seg is not None:
        seg[(seg == 0) & (~nonzero_mask)] = nonzero_label
    else:
        seg = np.where(nonzero_mask, 0, nonzero_label).astype(np.int8)
    return data, seg, bbox
