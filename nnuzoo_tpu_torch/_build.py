"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under ``build/kernels/``
at the root of the checkout, then loaded with ``ctypes``. The library's name
carries a hash of its source and of the shared headers ``csrc/*.cuh``, so an
edited source or header builds anew and an unchanged one is reused. Nothing is compiled when this module is imported: a kernel is
built on its first use, or for all sources at once by :func:`build_all`, which
starts one ``nvcc`` per source in parallel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# -Xptxas -v: each kernel's registers, shared memory and spills go into the
# compiler output that build_all() returns
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of nnuzoo_tpu_torch are "
                       "built on a machine with the CUDA toolkit")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every header
    in ``csrc/`` (a source may include any of them)."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; it writes to a temporary name that
    :func:`_finish` moves into place."""
    out = library_path(name)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library, all at once.
    Returns each built source's compiler output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        jobs = {n: _start(n) for n in sources()
                if not library_path(n).is_file()}
        try:
            return {n: _finish(n, job) for n, job in jobs.items()}
        finally:
            for proc, _, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = library_path(name)
        if not path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        return lib
