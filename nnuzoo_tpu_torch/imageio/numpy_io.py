"""Raw numpy IO: .npy (one 3D array per channel file) with spacing sidecar json
(this package's copy of ``nnuzoo_tpu/imageio/numpy_io.py``).

Not present in the reference; it needs no SimpleITK/nibabel and is handy for
synthetic/test datasets.
"""

import os
from typing import List, Tuple, Union

import numpy as np

from .base import BaseReaderWriter
from ..utilities.io import load_json, save_json


class NumpyIO(BaseReaderWriter):
    supported_file_endings = [".npy"]

    @staticmethod
    def _sidecar(fname: str) -> str:
        return fname[:-4] + ".json"

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            arr = np.load(f)
            if arr.ndim == 2:
                arr = arr[None]
            assert arr.ndim == 3, f"{f}: expected 2D/3D array, got {arr.shape}"
            images.append(arr)
            sidecar = self._sidecar(f)
            spacings.append(load_json(sidecar)["spacing"] if os.path.isfile(sidecar)
                            else [1.0] * 3)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Shapes differ: {[i.shape for i in images]}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"Spacings differ: {spacings}")
        return np.stack(images).astype(np.float32, copy=False), \
            {"spacing": [float(s) for s in spacings[0]]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        np.save(output_fname, seg.astype(np.uint8 if seg.max() < 255 else np.uint16))
        save_json({"spacing": properties["spacing"]}, self._sidecar(output_fname))
