"""Small file/JSON/pickle helpers (this package's copy of
``nnuzoo_tpu/utilities/io.py``)."""

import json
import os
import pickle
from typing import Any, List


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(obj: Any, path: str, sort_keys: bool = True, indent: int = 4) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=sort_keys, indent=indent)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def maybe_mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def join(*args: str) -> str:
    return os.path.join(*args)


def isfile(path: str) -> bool:
    return os.path.isfile(path)


def isdir(path: str) -> bool:
    return os.path.isdir(path)


def subfiles(folder: str, prefix: str = None, suffix: str = None, sort: bool = True,
             join_path: bool = True) -> List[str]:
    res = []
    for f in os.listdir(folder):
        full = os.path.join(folder, f)
        if not os.path.isfile(full):
            continue
        if prefix is not None and not f.startswith(prefix):
            continue
        if suffix is not None and not f.endswith(suffix):
            continue
        res.append(full if join_path else f)
    if sort:
        res.sort()
    return res


def subdirs(folder: str, prefix: str = None, suffix: str = None, sort: bool = True,
            join_path: bool = True) -> List[str]:
    res = []
    for f in os.listdir(folder):
        full = os.path.join(folder, f)
        if not os.path.isdir(full):
            continue
        if prefix is not None and not f.startswith(prefix):
            continue
        if suffix is not None and not f.endswith(suffix):
            continue
        res.append(full if join_path else f)
    if sort:
        res.sort()
    return res
