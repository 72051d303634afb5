"""Data-root resolution from environment variables.

Same contract as the reference (`nnunetv2/paths.py:46-48`): three roots
``nnUNet_raw``, ``nnUNet_preprocessed``, ``nnUNet_results``. Resolved lazily so
tests can set env vars after import (the reference resolves at import time, which
makes testing painful — we deliberately do better).
"""

import os


def get_raw_folder() -> str:
    p = os.environ.get("nnUNet_raw")
    if p is None:
        raise RuntimeError(
            "nnUNet_raw is not defined. Set the environment variable nnUNet_raw to the "
            "folder containing your raw datasets (DatasetXXX_Name subfolders)."
        )
    return p


def get_preprocessed_folder() -> str:
    p = os.environ.get("nnUNet_preprocessed")
    if p is None:
        raise RuntimeError(
            "nnUNet_preprocessed is not defined. Set the environment variable "
            "nnUNet_preprocessed to the folder for preprocessed data."
        )
    return p


def get_results_folder() -> str:
    p = os.environ.get("nnUNet_results")
    if p is None:
        raise RuntimeError(
            "nnUNet_results is not defined. Set the environment variable nnUNet_results "
            "to the folder where trained models will be saved."
        )
    return p
