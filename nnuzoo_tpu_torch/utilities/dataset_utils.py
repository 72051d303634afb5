"""Raw-dataset file discovery (this package's copy of
``nnuzoo_tpu/utilities/dataset_utils.py``).

A raw folder holds ``{identifier}_{CCCC}{ending}``, one file per channel.
"""

import re
from typing import List

from .io import join, subfiles


def get_identifiers_from_split_dataset_folder(folder: str, file_ending: str) -> List[str]:
    files = subfiles(folder, suffix=file_ending, join_path=False)
    crop = len(file_ending) + 5  # _XXXX + ending
    return sorted(set(f[:-crop] for f in files))


def create_lists_from_split_dataset_folder(folder: str, file_ending: str,
                                           identifiers: List[str] = None) -> List[List[str]]:
    if identifiers is None:
        identifiers = get_identifiers_from_split_dataset_folder(folder, file_ending)
    files = subfiles(folder, suffix=file_ending, join_path=False, sort=True)
    list_of_lists = []
    for ident in identifiers:
        p = re.compile(re.escape(ident) + r"_\d\d\d\d" + re.escape(file_ending))
        list_of_lists.append([join(folder, f) for f in files if p.fullmatch(f)])
    return list_of_lists
