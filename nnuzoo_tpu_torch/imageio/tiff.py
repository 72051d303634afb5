"""3D TIFF IO via PIL multipage support (this package's copy of
``nnuzoo_tpu/imageio/tiff.py``; PIL is imported where it is used).

Reference: `nnunetv2/imageio/tif_reader_writer.py` (Tiff3DIO, tifffile-based).
Spacing cannot be stored in TIFF, so it sits in a sidecar ``<name>.json``
(key ``'spacing'``) next to each image — same contract as the reference.
"""

import os
from typing import List, Tuple, Union

import numpy as np

from .base import BaseReaderWriter
from ..utilities.io import load_json, save_json


class Tiff3DIO(BaseReaderWriter):
    supported_file_endings = [".tif", ".tiff"]

    @staticmethod
    def _read_tiff_stack(fname: str) -> np.ndarray:
        from PIL import Image, ImageSequence
        img = Image.open(fname)
        frames = [np.asarray(page) for page in ImageSequence.Iterator(img)]
        return np.stack(frames) if len(frames) > 1 else frames[0][None]

    @staticmethod
    def _sidecar(fname: str) -> str:
        base = fname
        for ending in (".tiff", ".tif"):
            if base.endswith(ending):
                base = base[: -len(ending)]
                break
        return base + ".json"

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            images.append(self._read_tiff_stack(f))
            sidecar = self._sidecar(f)
            if os.path.isfile(sidecar):
                spacings.append(load_json(sidecar)["spacing"])
            else:
                spacings.append([1.0, 1.0, 1.0])
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Shapes of channel files differ: "
                               f"{[i.shape for i in images]} files: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"Spacings differ between channels: {spacings}")
        return np.stack(images).astype(np.float32, copy=False), \
            {"spacing": [float(s) for s in spacings[0]]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        from PIL import Image
        assert seg.ndim == 3
        frames = [Image.fromarray(s.astype(np.uint8, copy=False)) for s in seg]
        frames[0].save(output_fname, save_all=True, append_images=frames[1:])
        save_json({"spacing": properties["spacing"]}, self._sidecar(output_fname))
