"""2D natural-image IO (png/bmp/jpg/tif) via PIL (this package's copy of
``nnuzoo_tpu/imageio/natural.py``; PIL is imported where it is used, so the
registry imports without it).

Reference: `nnunetv2/imageio/natural_image_reader_writer.py` (NaturalImage2DIO,
skimage-based). Convention: a 2D image becomes (c, 1, x, y); spacing is
(999, 1, 1) — the large leading value tells the planner the fake third axis is
maximally anisotropic and must not be pooled.
"""

from typing import List, Tuple, Union

import numpy as np

from .base import BaseReaderWriter


class NaturalImage2DIO(BaseReaderWriter):
    supported_file_endings = [".png", ".bmp", ".tif", ".jpg", ".jpeg"]

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        from PIL import Image
        images = []
        for f in image_fnames:
            npy = np.asarray(Image.open(f))
            if npy.ndim == 3:  # (x, y, c) -> one channel per color plane
                npy = npy.transpose(2, 0, 1)[:, None]  # (c, 1, x, y)
            elif npy.ndim == 2:
                npy = npy[None, None]  # (1, 1, x, y)
            else:
                raise RuntimeError(f"Unexpected image dimensionality {npy.ndim} in {f}")
            images.append(npy)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Shapes of channel files differ: "
                               f"{[i.shape for i in images]} files: {image_fnames}")
        return np.vstack(images).astype(np.float32, copy=False), {"spacing": [999.0, 1.0, 1.0]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        from PIL import Image
        seg = np.asarray(seg)
        if seg.ndim == 3:
            assert seg.shape[0] == 1, "expected (1, x, y) segmentation"
            seg = seg[0]
        Image.fromarray(seg.astype(np.uint8, copy=False)).save(output_fname)
