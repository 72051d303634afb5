"""Raw-dataset file discovery (this package's copy of
``nnuzoo_tpu/utilities/dataset_utils.py``).

A raw dataset folder contains ``imagesTr/{identifier}_{CCCC}{ending}`` and
``labelsTr/{identifier}{ending}``. dataset.json may instead carry an explicit
``dataset`` map {identifier: {images: [...], label: ...}} with relative paths.
"""

import os
import re
from typing import Dict, List

from .io import join, load_json, subfiles


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


def get_filenames_of_train_images_and_targets(raw_dataset_folder: str,
                                              dataset_json: dict = None) -> Dict[str, dict]:
    if dataset_json is None:
        dataset_json = load_json(join(raw_dataset_folder, "dataset.json"))

    if "dataset" in dataset_json:
        dataset = dataset_json["dataset"]
        for k in dataset:
            dataset[k]["label"] = (os.path.abspath(join(raw_dataset_folder, dataset[k]["label"]))
                                   if dataset[k]["label"] is not None else None)
            dataset[k]["images"] = [os.path.abspath(join(raw_dataset_folder, i))
                                    for i in dataset[k]["images"]]
        return dataset

    identifiers = get_identifiers_from_split_dataset_folder(
        join(raw_dataset_folder, "imagesTr"), dataset_json["file_ending"])
    images = create_lists_from_split_dataset_folder(
        join(raw_dataset_folder, "imagesTr"), dataset_json["file_ending"], identifiers)
    return {i: {"images": im,
                "label": join(raw_dataset_folder, "labelsTr", i + dataset_json["file_ending"])}
            for i, im in zip(identifiers, images)}
