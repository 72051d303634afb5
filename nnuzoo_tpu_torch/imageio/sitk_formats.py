"""This package's copy of ``nnuzoo_tpu/imageio/sitk_formats.py``.

Pure-Python readers/writers for the SimpleITK-served formats the reference
supports beyond NIfTI (reference `nnunetv2/imageio/simpleitk_reader_writer.py`
handles .mha/.nrrd/.gipl through SimpleITK; this module implements the three
container formats directly — no SimpleITK dependency).

All on-disk formats store voxels x-fastest; we read straight into the
framework's (z, y, x) convention with spacing (sz, sy, sx).
"""

import gzip
import struct
import zlib
from typing import List, Tuple, Union

import numpy as np

from .base import BaseReaderWriter

# ----------------------------------------------------------------- MetaImage
_MET_TYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read_mha(fname: str) -> Tuple[np.ndarray, dict]:
    """MetaImage (.mha, header+data in one file). Returns ((z, y, x), info)."""
    with open(fname, "rb") as f:
        raw = f.read()
    header = {}
    pos = 0
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("ascii", errors="replace")
        pos = eol + 1
        if "=" not in line:
            raise RuntimeError(f"{fname}: malformed MetaImage header line {line!r}")
        key, value = (s.strip() for s in line.split("=", 1))
        header[key] = value
        if key == "ElementDataFile":
            break
    if header.get("ElementDataFile", "LOCAL").upper() != "LOCAL":
        raise RuntimeError(f"{fname}: detached-data .mhd is not supported; "
                           "use single-file .mha")
    ndims = int(header.get("NDims", 3))
    dims = [int(d) for d in header["DimSize"].split()]        # (X, Y, Z)
    dtype = np.dtype(_MET_TYPES[header.get("ElementType", "MET_FLOAT")])
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true":
        dtype = dtype.newbyteorder(">")
    payload = raw[pos:]
    if header.get("CompressedData", "False").lower() == "true":
        payload = zlib.decompress(payload)
    count = int(np.prod(dims))
    data = np.frombuffer(payload, dtype=dtype, count=count)
    data = data.reshape(dims[::-1])                            # x fastest -> (Z, Y, X)
    data = data.astype(data.dtype.newbyteorder("="), copy=False)
    spacing = [float(s) for s in header.get(
        "ElementSpacing", " ".join(["1"] * ndims)).split()]    # (sx, sy, sz)
    info = {"spacing_zyx": spacing[::-1], "header": header, "format": "mha"}
    return data, info


def write_mha(fname: str, data_zyx: np.ndarray, spacing_zyx,
              extra_header: dict = None) -> None:
    data_zyx = np.ascontiguousarray(data_zyx)
    dims = list(data_zyx.shape[::-1])                          # (X, Y, Z)
    spacing_xyz = list(spacing_zyx[::-1])
    lines = [
        ("ObjectType", "Image"),
        ("NDims", str(data_zyx.ndim)),
        ("BinaryData", "True"),
        ("BinaryDataByteOrderMSB", "False"),
        ("CompressedData", "False"),
    ]
    keep = {"TransformMatrix", "Offset", "CenterOfRotation",
            "AnatomicalOrientation"}
    if extra_header:
        lines += [(k, v) for k, v in extra_header.items() if k in keep]
    lines += [
        ("ElementSpacing", " ".join(f"{s:g}" for s in spacing_xyz)),
        ("DimSize", " ".join(str(d) for d in dims)),
        ("ElementType", _MET_NAMES[np.dtype(data_zyx.dtype)]),
        ("ElementDataFile", "LOCAL"),
    ]
    with open(fname, "wb") as f:
        for k, v in lines:
            f.write(f"{k} = {v}\n".encode("ascii"))
        f.write(data_zyx.tobytes())


# -------------------------------------------------------------------- NRRD
_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "unsigned long long": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NRRD_NAMES = {np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
               np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
               np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
               np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
               np.dtype(np.float32): "float", np.dtype(np.float64): "double"}


def read_nrrd(fname: str) -> Tuple[np.ndarray, dict]:
    """NRRD (attached data). Returns ((z, y, x), info)."""
    with open(fname, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"NRRD"):
        raise RuntimeError(f"{fname}: not a NRRD file")
    pos = raw.index(b"\n") + 1
    fields = {}
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("ascii", errors="replace").rstrip("\r")
        pos = eol + 1
        if line == "":
            break                        # header/data separator
        if line.startswith("#"):
            continue
        if ":=" in line:                 # key-value pairs (metadata)
            k, v = line.split(":=", 1)
            fields[k.strip()] = v.strip()
        elif ": " in line or line.endswith(":"):
            k, v = line.split(":", 1)
            fields[k.strip().lower()] = v.strip()
    sizes = [int(s) for s in fields["sizes"].split()]          # (X, Y, Z)
    dtype = np.dtype(_NRRD_TYPES[fields["type"].strip()])
    if fields.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    encoding = fields.get("encoding", "raw").lower()
    payload = raw[pos:]
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding not in ("raw",):
        raise RuntimeError(f"{fname}: unsupported NRRD encoding {encoding!r}")
    data = np.frombuffer(payload, dtype=dtype, count=int(np.prod(sizes)))
    data = data.reshape(sizes[::-1])                           # (Z, Y, X)
    data = data.astype(data.dtype.newbyteorder("="), copy=False)

    spacing_xyz = [1.0] * len(sizes)
    if "space directions" in fields:
        # e.g. "(0.78,0,0) (0,0.78,0) (0,0,3.2)" — row norm = axis spacing
        vecs = [v for v in fields["space directions"].replace("none", "").split(")")
                if "(" in v]
        for i, v in enumerate(vecs):
            comps = [float(c) for c in v[v.index("(") + 1:].split(",")]
            spacing_xyz[i] = float(np.linalg.norm(comps))
    elif "spacings" in fields:
        spacing_xyz = [float(s) for s in fields["spacings"].split()]
    info = {"spacing_zyx": spacing_xyz[::-1], "header": fields, "format": "nrrd"}
    return data, info


def write_nrrd(fname: str, data_zyx: np.ndarray, spacing_zyx,
               extra_header: dict = None) -> None:
    data_zyx = np.ascontiguousarray(data_zyx)
    sizes = list(data_zyx.shape[::-1])
    spacing_xyz = list(spacing_zyx[::-1])
    dirs = []
    for i, s in enumerate(spacing_xyz):
        v = [0.0] * len(spacing_xyz)
        v[i] = float(s)
        dirs.append("(" + ",".join(f"{c:g}" for c in v) + ")")
    lines = [
        "NRRD0004",
        f"type: {_NRRD_NAMES[np.dtype(data_zyx.dtype)]}",
        f"dimension: {data_zyx.ndim}",
        "space: left-posterior-superior",
        f"sizes: {' '.join(str(s) for s in sizes)}",
        f"space directions: {' '.join(dirs)}",
        "kinds: " + " ".join(["domain"] * data_zyx.ndim),
        "endian: little",
        "encoding: raw",
    ]
    if extra_header and "space origin" in extra_header:
        lines.append(f"space origin: {extra_header['space origin']}")
    with open(fname, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(data_zyx.tobytes())


# -------------------------------------------------------------------- GIPL
_GIPL_MAGIC = 0xEFFFE9B0
_GIPL_TYPES = {8: np.uint8, 7: np.int8, 15: np.int16, 16: np.uint16,
               31: np.uint32, 32: np.int32, 64: np.float32, 65: np.float64}
_GIPL_CODES = {np.dtype(v): k for k, v in _GIPL_TYPES.items()}
_GIPL_HDR = 256


def read_gipl(fname: str) -> Tuple[np.ndarray, dict]:
    """Guys Image Processing Lab format (big-endian 256-byte header)."""
    opener = gzip.open if fname.endswith(".gz") else open
    with opener(fname, "rb") as f:
        raw = f.read()
    hdr = raw[:_GIPL_HDR]
    magic = struct.unpack(">I", hdr[252:256])[0]
    if magic != _GIPL_MAGIC:
        raise RuntimeError(f"{fname}: bad GIPL magic {magic:#x}")
    dims = struct.unpack(">4H", hdr[0:8])                      # (X, Y, Z, T)
    image_type = struct.unpack(">H", hdr[8:10])[0]
    pixdim = struct.unpack(">4f", hdr[10:26])                  # (sx, sy, sz, st)
    if image_type not in _GIPL_TYPES:
        raise RuntimeError(f"{fname}: unsupported GIPL type {image_type}")
    dtype = np.dtype(_GIPL_TYPES[image_type]).newbyteorder(">")
    shape_xyz = [d for d in dims[:3] if d > 0] or [1]
    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=_GIPL_HDR)
    data = data.reshape(shape_xyz[::-1])                       # (Z, Y, X)
    data = data.astype(data.dtype.newbyteorder("="), copy=False)
    spacing_xyz = [float(p) if p > 0 else 1.0 for p in pixdim[:len(shape_xyz)]]
    info = {"spacing_zyx": spacing_xyz[::-1], "format": "gipl"}
    return data, info


def write_gipl(fname: str, data_zyx: np.ndarray, spacing_zyx) -> None:
    data_zyx = np.ascontiguousarray(data_zyx)
    hdr = bytearray(_GIPL_HDR)
    dims = list(data_zyx.shape[::-1]) + [1] * (4 - data_zyx.ndim)
    struct.pack_into(">4H", hdr, 0, *dims[:4])
    struct.pack_into(">H", hdr, 8, _GIPL_CODES[np.dtype(data_zyx.dtype)])
    pixdim = list(spacing_zyx[::-1]) + [1.0] * (4 - len(spacing_zyx))
    struct.pack_into(">4f", hdr, 10, *pixdim[:4])
    struct.pack_into(">I", hdr, 252, _GIPL_MAGIC)
    opener = gzip.open if fname.endswith(".gz") else open
    with opener(fname, "wb") as f:
        f.write(bytes(hdr))
        f.write(data_zyx.astype(data_zyx.dtype.newbyteorder(">")).tobytes())


# ------------------------------------------------------------------ IO class
_READERS = {".mha": read_mha, ".nrrd": read_nrrd, ".gipl": read_gipl,
            ".gipl.gz": read_gipl}


def _split_ending(fname: str) -> str:
    for ending in (".gipl.gz", ".mha", ".nrrd", ".gipl"):
        if fname.endswith(ending):
            return ending
    raise RuntimeError(f"unsupported file ending: {fname}")


class SitkFormatsIO(BaseReaderWriter):
    """MetaImage/NRRD/GIPL reader-writer (the non-NIfTI part of the reference's
    SimpleITKIO surface, `nnunetv2/imageio/simpleitk_reader_writer.py`).
    Arrays are (c, z, y, x) with spacing (sz, sy, sx)."""

    supported_file_endings = [".mha", ".nrrd", ".gipl", ".gipl.gz"]

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        images, spacings, infos = [], [], []
        for f in image_fnames:
            data, info = _READERS[_split_ending(f)](f)
            if data.ndim == 2:
                data = data[None]
            assert data.ndim == 3, f"{f}: expected 3D, got {data.shape}"
            images.append(data)
            spacings.append(info["spacing_zyx"])
            infos.append(info)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"shapes differ across channels: "
                               f"{[i.shape for i in images]}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"spacings differ across channels: {spacings}")
        stacked = np.stack(images).astype(np.float32, copy=False)
        properties = {"spacing": [float(s) for s in spacings[0]],
                      "sitk_stuff": {"format": infos[0]["format"],
                                     "header": infos[0].get("header", {})}}
        return stacked, properties

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str,
                  properties: dict) -> None:
        assert seg.ndim == 3, "write_seg expects (z, y, x)"
        seg = seg.astype(np.uint8 if seg.max() < 255 else np.uint16, copy=False)
        spacing = properties.get("spacing", [1.0] * seg.ndim)
        extra = properties.get("sitk_stuff", {}).get("header", {})
        ending = _split_ending(output_fname)
        if ending == ".mha":
            write_mha(output_fname, seg, spacing, extra)
        elif ending == ".nrrd":
            write_nrrd(output_fname, seg, spacing, extra)
        else:
            write_gipl(output_fname, seg, spacing)
