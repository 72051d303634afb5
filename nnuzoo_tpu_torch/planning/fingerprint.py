"""Dataset fingerprint extraction (reference:
`nnunetv2/experiment_planning/dataset_fingerprint/fingerprint_extractor.py:18-199`).

Per case: read, crop-to-nonzero, sample foreground intensities per channel (with
replacement, RandomState(1234), 1e7 / num_cases samples per case), record
shape-after-crop / spacing / relative size. Aggregate to per-channel intensity
statistics -> ``dataset_fingerprint.json``.

This package's copy of ``nnuzoo_tpu/planning/fingerprint.py``; the port imports nothing of
the JAX package.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import List, Type, Union

import numpy as np

from ..imageio.base import BaseReaderWriter
from ..imageio.registry import determine_reader_writer_from_dataset_json
from ..paths import get_preprocessed_folder, get_raw_folder
from ..preprocessing.cropping import crop_to_nonzero
from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
from ..utilities.dataset_utils import get_filenames_of_train_images_and_targets
from ..utilities.io import isfile, join, load_json, maybe_mkdir, save_json


class DatasetFingerprintExtractor:
    def __init__(self, dataset_name_or_id: Union[str, int], num_processes: int = 8,
                 verbose: bool = False):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.verbose = verbose
        self.input_folder = join(get_raw_folder(), self.dataset_name)
        self.num_processes = num_processes
        self.dataset_json = load_json(join(self.input_folder, "dataset.json"))
        self.dataset = get_filenames_of_train_images_and_targets(self.input_folder,
                                                                 self.dataset_json)
        self.num_foreground_voxels_for_intensitystats = 10e7

    @staticmethod
    def collect_foreground_intensities(segmentation: np.ndarray, images: np.ndarray,
                                       seed: int = 1234, num_samples: int = 10000):
        assert images.ndim == 4 and segmentation.ndim == 4
        assert not np.any(np.isnan(segmentation)), "Segmentation contains NaN values"
        assert not np.any(np.isnan(images)), "Images contain NaN values"

        rs = np.random.RandomState(seed)
        foreground_mask = segmentation[0] > 0
        intensities_per_channel = []
        for i in range(len(images)):
            fg = images[i][foreground_mask]
            intensities_per_channel.append(
                rs.choice(fg, num_samples, replace=True) if len(fg) > 0 else [])
        return intensities_per_channel

    @staticmethod
    def analyze_case(image_files: List[str], segmentation_file: str,
                     reader_writer_class: Type[BaseReaderWriter],
                     num_samples: int = 10000):
        rw = reader_writer_class()
        images, properties_images = rw.read_images(image_files)
        segmentation, _ = rw.read_seg(segmentation_file)
        data_cropped, seg_cropped, bbox = crop_to_nonzero(images, segmentation)
        fg_intensities = DatasetFingerprintExtractor.collect_foreground_intensities(
            seg_cropped, data_cropped, num_samples=num_samples)
        shape_before_crop = images.shape[1:]
        shape_after_crop = data_cropped.shape[1:]
        relative_size = np.prod(shape_after_crop) / np.prod(shape_before_crop)
        return (shape_after_crop, properties_images["spacing"], fg_intensities,
                relative_size)

    def run(self, overwrite_existing: bool = False) -> dict:
        out_folder = join(get_preprocessed_folder(), self.dataset_name)
        maybe_mkdir(out_folder)
        properties_file = join(out_folder, "dataset_fingerprint.json")
        if isfile(properties_file) and not overwrite_existing:
            return load_json(properties_file)

        first_case = next(iter(self.dataset.values()))
        rw_class = determine_reader_writer_from_dataset_json(
            self.dataset_json, first_case["images"][0])
        num_samples_per_case = int(self.num_foreground_voxels_for_intensitystats
                                   // len(self.dataset))

        def one(item):
            return self.analyze_case(item["images"], item["label"], rw_class,
                                     num_samples_per_case)

        items = list(self.dataset.values())
        if self.num_processes <= 1:
            results = [one(i) for i in items]
        else:
            with ThreadPoolExecutor(max_workers=self.num_processes) as pool:
                results = list(pool.map(one, items))

        shapes_after_crop = [r[0] for r in results]
        spacings = [r[1] for r in results]
        num_channels = len(self.dataset_json.get("channel_names",
                                                 self.dataset_json.get("modality")))
        fg_per_channel = [np.concatenate([np.asarray(r[2][i]).ravel() for r in results])
                          for i in range(num_channels)]
        median_relative_size = float(np.median([r[3] for r in results], 0))

        intensity_statistics_per_channel = {}
        for i in range(num_channels):
            v = fg_per_channel[i]
            intensity_statistics_per_channel[i] = {
                "mean": float(np.mean(v)), "median": float(np.median(v)),
                "std": float(np.std(v)), "min": float(np.min(v)),
                "max": float(np.max(v)),
                "percentile_99_5": float(np.percentile(v, 99.5)),
                "percentile_00_5": float(np.percentile(v, 0.5)),
            }

        fingerprint = {
            "spacings": [list(map(float, s)) for s in spacings],
            "shapes_after_crop": [list(map(int, s)) for s in shapes_after_crop],
            "foreground_intensity_properties_per_channel": intensity_statistics_per_channel,
            "median_relative_size_after_cropping": median_relative_size,
        }
        save_json(fingerprint, properties_file)
        return fingerprint
