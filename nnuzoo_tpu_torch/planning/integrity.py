"""Dataset integrity verification (reference:
`nnunetv2/experiment_planning/verify_dataset_integrity.py:33-238`): labels within the
expected set, no NaNs, image/seg shape+spacing agreement, expected file presence.

This package's copy of ``nnuzoo_tpu/planning/integrity.py``; the port imports nothing of
the JAX package.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from ..imageio.registry import determine_reader_writer_from_dataset_json
from ..plans.label_handling import LabelManager
from ..utilities.dataset_utils import get_filenames_of_train_images_and_targets
from ..utilities.io import isfile, join, load_json


def verify_labels(label_file: str, readerclass, expected_labels: List[int]) -> bool:
    seg, _ = readerclass().read_seg(label_file)
    found = np.unique(seg)
    unexpected = [i for i in found if i not in expected_labels]
    if unexpected:
        raise RuntimeError(f"Unexpected labels {unexpected} in {label_file}. "
                           f"Expected subset of {expected_labels}")
    return True


def check_case(image_files: List[str], label_file: str, readerclass,
               num_channels: int) -> None:
    rw = readerclass()
    assert len(image_files) == num_channels, (
        f"Expected {num_channels} image files, got {len(image_files)}: {image_files}")
    images, props_img = rw.read_images(image_files)
    seg, props_seg = rw.read_seg(label_file)
    assert not np.any(np.isnan(images)), f"Images contain NaN: {image_files}"
    assert not np.any(np.isnan(seg)), f"Segmentation contains NaN: {label_file}"
    assert images.shape[1:] == seg.shape[1:], (
        f"Shape mismatch image {images.shape[1:]} vs seg {seg.shape[1:]}: {image_files}")
    assert np.allclose(props_img["spacing"], props_seg["spacing"]), (
        f"Spacing mismatch image {props_img['spacing']} vs seg {props_seg['spacing']}")


def verify_dataset_integrity(folder: str, num_processes: int = 8) -> None:
    assert isfile(join(folder, "dataset.json")), f"dataset.json missing in {folder}"
    dataset_json = load_json(join(folder, "dataset.json"))
    dataset = get_filenames_of_train_images_and_targets(folder, dataset_json)
    assert len(dataset) == dataset_json["numTraining"], (
        f"numTraining={dataset_json['numTraining']} but found {len(dataset)} cases")

    num_channels = len(dataset_json.get("channel_names",
                                        dataset_json.get("modality")))
    rw = determine_reader_writer_from_dataset_json(
        dataset_json, next(iter(dataset.values()))["images"][0])

    label_manager = LabelManager(dataset_json["labels"],
                                 dataset_json.get("regions_class_order"))
    expected = list(label_manager.all_labels)
    if label_manager.has_ignore_label:
        expected.append(label_manager.ignore_label)

    def one(item):
        check_case(item["images"], item["label"], rw, num_channels)
        verify_labels(item["label"], rw, expected)

    with ThreadPoolExecutor(max_workers=max(1, num_processes)) as pool:
        list(pool.map(one, dataset.values()))
