"""Reader/writer registry (this package's copy of ``nnuzoo_tpu/imageio/registry.py``;
reference: `nnunetv2/imageio/reader_writer_registry.py:14-79`).

Resolution order: explicit ``overwrite_image_reader_writer`` in dataset.json, then
file ending. Reference class names (SimpleITKIO, NibabelIO, ...) are aliased to our
NiftiIO so reference-produced plans files keep working.
"""

from typing import Type

from .base import BaseReaderWriter
from .natural import NaturalImage2DIO
from .nifti import NiftiIO, NiftiIOWithReorient
from .numpy_io import NumpyIO
from .sitk_formats import SitkFormatsIO
from .tiff import Tiff3DIO

# order matters for file-ending resolution: tif prefers Tiff3DIO like the reference
LIST_OF_IO_CLASSES = [NaturalImage2DIO, Tiff3DIO, NiftiIO, SitkFormatsIO, NumpyIO]

_ALIASES = {
    "NiftiIO": NiftiIO,
    "NiftiIOWithReorient": NiftiIOWithReorient,
    "SimpleITKIO": NiftiIO,
    "SitkFormatsIO": SitkFormatsIO,
    "NibabelIO": NiftiIO,
    "NibabelIOWithReorient": NiftiIOWithReorient,
    "NaturalImage2DIO": NaturalImage2DIO,
    "Tiff3DIO": Tiff3DIO,
    "NumpyIO": NumpyIO,
}


def find_reader_writer_by_name(rw_class_name: str) -> Type[BaseReaderWriter]:
    if rw_class_name in _ALIASES:
        return _ALIASES[rw_class_name]
    raise RuntimeError(f"Unknown reader/writer class {rw_class_name!r}. "
                       f"Known: {sorted(_ALIASES)}")


def determine_reader_writer_from_file_ending(file_ending: str, example_file: str = None,
                                             allow_nonmatching_filename: bool = False,
                                             verbose: bool = False
                                             ) -> Type[BaseReaderWriter]:
    for rw in LIST_OF_IO_CLASSES:
        if file_ending.lower() in rw.supported_file_endings:
            return rw
    raise RuntimeError(f"No reader/writer supports file ending {file_ending!r}")


def determine_reader_writer_from_dataset_json(dataset_json: dict, example_file: str = None,
                                              allow_nonmatching_filename: bool = False,
                                              verbose: bool = False
                                              ) -> Type[BaseReaderWriter]:
    if dataset_json.get("overwrite_image_reader_writer") not in (None, "None"):
        return find_reader_writer_by_name(dataset_json["overwrite_image_reader_writer"])
    return determine_reader_writer_from_file_ending(
        dataset_json["file_ending"], example_file, allow_nonmatching_filename, verbose)
