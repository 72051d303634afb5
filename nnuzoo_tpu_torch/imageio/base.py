"""Reader/writer interface (this package's copy of ``nnuzoo_tpu/imageio/base.py``).

Contract identical to the reference (`nnunetv2/imageio/base_reader_writer.py:21-107`):
``read_images`` returns a 4D float32 array ``(c, x, y, z)`` plus a properties dict
that must contain at least ``{'spacing': [sx, sy, sz]}`` matching the array axes;
``read_seg`` the same for a segmentation; ``write_seg`` restores geometry metadata
from the properties dict.
"""

from abc import ABC, abstractmethod
from typing import List, Tuple, Union

import numpy as np


class BaseReaderWriter(ABC):
    supported_file_endings: List[str] = []

    @staticmethod
    def _check_all_same(input_list) -> bool:
        if len(input_list) == 1:
            return True
        first = input_list[0]
        return all(len(first) == len(i) and np.allclose(first, i) for i in input_list[1:])

    @staticmethod
    def _check_all_same_array(input_list) -> bool:
        if len(input_list) == 1:
            return True
        first = input_list[0]
        return all(i.shape == first.shape and np.allclose(first, i) for i in input_list[1:])

    @abstractmethod
    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        """Read one case (one file per channel) -> ((c, x, y, z) float32, properties)."""

    @abstractmethod
    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        """Read a segmentation -> ((1, x, y, z), properties)."""

    @abstractmethod
    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        """Write a 3D ``(x, y, z)`` segmentation, restoring metadata from properties."""
