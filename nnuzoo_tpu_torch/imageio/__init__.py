"""Image readers and writers (this package's copy of ``nnuzoo_tpu/imageio``)."""

from .base import BaseReaderWriter
from .registry import (determine_reader_writer_from_dataset_json,
                       determine_reader_writer_from_file_ending,
                       find_reader_writer_by_name)
