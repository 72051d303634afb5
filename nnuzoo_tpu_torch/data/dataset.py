"""Preprocessed-dataset storage (numpy copy of ``nnuzoo_tpu/data/dataset.py``).

``{case}.npz{data,seg}`` + ``{case}.pkl`` properties; ``unpack_dataset`` expands to
``{case}.npy`` / ``{case}_seg.npy`` so training can mmap patches without decompressing
whole volumes. The blosc2 (``.b2nd``) backend is not in this package yet:
:func:`infer_dataset_class` raises ``NotImplementedError`` on such a folder.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..utilities.io import isfile, join, load_pickle, save_pickle


class DatasetNumpy:
    def __init__(self, folder: str, identifiers: Optional[List[str]] = None,
                 folder_with_segs_from_previous_stage: Optional[str] = None,
                 add_target: bool = True):
        if identifiers is None:
            identifiers = self.get_identifiers(folder)
        self.identifiers = sorted(identifiers)
        self.source_folder = folder
        self.folder_with_segs_from_previous_stage = folder_with_segs_from_previous_stage
        self.add_target = add_target

    def __len__(self):
        return len(self.identifiers)

    def __getitem__(self, identifier):
        return self.load_case(identifier)

    def load_case(self, identifier: str):
        data_npy = join(self.source_folder, identifier + ".npy")
        if isfile(data_npy):
            data = np.load(data_npy, mmap_mode="r")
        else:
            data = np.load(join(self.source_folder, identifier + ".npz"))["data"]

        seg = None
        if self.add_target:
            seg_npy = join(self.source_folder, identifier + "_seg.npy")
            if isfile(seg_npy):
                seg = np.load(seg_npy, mmap_mode="r")
            else:
                npz = np.load(join(self.source_folder, identifier + ".npz"))
                seg = npz["seg"] if "seg" in npz else None

        seg_prev = None
        if self.folder_with_segs_from_previous_stage is not None:
            prev_npy = join(self.folder_with_segs_from_previous_stage, identifier + ".npy")
            if isfile(prev_npy):
                seg_prev = np.load(prev_npy, mmap_mode="r")
            else:
                seg_prev = np.load(join(self.folder_with_segs_from_previous_stage,
                                        identifier + ".npz"))["seg"]

        properties = load_pickle(join(self.source_folder, identifier + ".pkl"))
        return data, seg, seg_prev, properties

    @staticmethod
    def save_case(data: np.ndarray, seg: np.ndarray, properties: dict,
                  output_filename_truncated: str) -> None:
        np.savez_compressed(output_filename_truncated + ".npz", data=data, seg=seg)
        save_pickle(properties, output_filename_truncated + ".pkl")

    @staticmethod
    def get_identifiers(folder: str) -> List[str]:
        return sorted({f[:-4] for f in os.listdir(folder) if f.endswith(".npz")}
                      | {f[:-4] for f in os.listdir(folder)
                         if f.endswith(".npy") and not f.endswith("_seg.npy")})


def _unpack_one(npz_file: str, unpack_segmentation: bool, overwrite: bool,
                verify: bool) -> None:
    truncated = npz_file[:-4]
    data_npy = truncated + ".npy"
    seg_npy = truncated + "_seg.npy"
    try:
        npz = np.load(npz_file)
        if overwrite or not isfile(data_npy):
            np.save(data_npy, npz["data"])
        if unpack_segmentation and "seg" in npz and (overwrite or not isfile(seg_npy)):
            np.save(seg_npy, npz["seg"])
        if verify:  # re-open to catch truncated writes
            np.load(data_npy, mmap_mode="r")
            if unpack_segmentation and isfile(seg_npy):
                np.load(seg_npy, mmap_mode="r")
    except Exception:
        # remove partial outputs so a retry starts clean
        for f in (data_npy, seg_npy):
            if isfile(f):
                os.remove(f)
        raise


def unpack_dataset(folder: str, unpack_segmentation: bool = True,
                   overwrite_existing: bool = False, num_processes: int = 4,
                   verify: bool = True) -> None:
    npzs = [join(folder, f) for f in sorted(os.listdir(folder)) if f.endswith(".npz")]
    if num_processes <= 1:
        for f in npzs:
            _unpack_one(f, unpack_segmentation, overwrite_existing, verify)
    else:
        with ThreadPoolExecutor(max_workers=num_processes) as pool:
            list(pool.map(lambda f: _unpack_one(f, unpack_segmentation,
                                                overwrite_existing, verify), npzs))


_FILE_ENDING_DATASET_MAPPING = {"npz": DatasetNumpy, "npy": DatasetNumpy}


def infer_dataset_class(folder: str):
    """Dispatch on the file endings present in a preprocessed folder
    (reference `nnunet_dataset.py:313-326`)."""
    endings = {f.split(".")[-1] for f in os.listdir(folder)
               if not f.startswith(".")}
    endings.discard("pkl")
    numpy_format = "npy" in endings
    endings.discard("npy")
    if not endings:
        if numpy_format:
            return DatasetNumpy
        raise RuntimeError(f"no dataset files found in {folder}")
    if len(endings) != 1:
        raise RuntimeError(f"found multiple file endings in {folder}: "
                           f"{sorted(endings)}; cannot infer dataset backend")
    ending = next(iter(endings))
    if ending == "b2nd":
        raise NotImplementedError(
            f"{folder} holds .b2nd files: the blosc2 dataset backend is not in "
            "nnuzoo_tpu_torch yet; preprocess with the numpy backend")
    if ending not in _FILE_ENDING_DATASET_MAPPING:
        raise RuntimeError(f"unknown dataset file ending .{ending} in {folder}")
    return _FILE_ENDING_DATASET_MAPPING[ending]
