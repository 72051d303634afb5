"""Pure-Python NIfTI-1 reader/writer (.nii / .nii.gz); this package's copy of
``nnuzoo_tpu/imageio/nifti.py``.

The package depends on neither SimpleITK nor nibabel, so we parse the NIfTI-1 binary
format directly. Axis convention matches the reference ``SimpleITKIO``
(`nnunetv2/imageio/simpleitk_reader_writer.py`): arrays are returned ``(c, z, y, x)``
relative to the on-disk ``(x, y, z)`` voxel order, with ``spacing`` listed in the
same (z, y, x) order, so downstream code (fingerprint, planner, preprocessing) sees
identical semantics. ``write_seg`` restores the original header so geometry
round-trips bit-exactly.
"""

import gzip
import struct
from typing import List, Tuple, Union

import numpy as np

from .base import BaseReaderWriter

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348


def _open(fname: str, mode: str):
    if fname.endswith(".gz"):
        return gzip.open(fname, mode)
    return open(fname, mode)


# byte offsets of all multi-byte fields in the fixed 348-byte NIfTI-1 header
_HDR_I32_OFFSETS = (0, 32, 140, 144)
_HDR_I16_OFFSETS = (36,) + tuple(range(40, 56, 2)) + (68, 70, 72, 74, 120, 252, 254)
_HDR_F32_OFFSETS = ((56, 60, 64) + tuple(range(76, 120, 4)) +
                    (124, 128, 132, 136) + tuple(range(256, 328, 4)))


def _swap_header_to_le(hdr: bytes) -> bytes:
    """Byte-swap every multi-byte field of a big-endian NIfTI-1 header to
    little-endian, so a header captured from a BE file can be re-used verbatim
    by the (always little-endian) writer."""
    out = bytearray(hdr)
    for off in _HDR_I32_OFFSETS + _HDR_F32_OFFSETS:
        out[off:off + 4] = hdr[off:off + 4][::-1]
    for off in _HDR_I16_OFFSETS:
        out[off:off + 2] = hdr[off:off + 2][::-1]
    return bytes(out)


def read_nifti(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (data in on-disk (x, y, z[, t]) order, header-info dict)."""
    with _open(fname, "rb") as f:
        raw = f.read()
    hdr = raw[:HDR_SIZE]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    swapped = False
    if sizeof_hdr != HDR_SIZE:
        sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
        if sizeof_hdr != HDR_SIZE:
            raise RuntimeError(f"{fname}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        swapped = True
    end = ">" if swapped else "<"

    dim = struct.unpack(end + "8h", hdr[40:56])
    datatype = struct.unpack(end + "h", hdr[70:72])[0]
    pixdim = struct.unpack(end + "8f", hdr[76:108])
    vox_offset = int(struct.unpack(end + "f", hdr[108:112])[0])
    scl_slope = struct.unpack(end + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(end + "f", hdr[116:120])[0]
    magic = hdr[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise RuntimeError(f"{fname}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(max(1, d) for d in dim[1:1 + ndim])
    if datatype not in _DTYPES:
        raise RuntimeError(f"{fname}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype])
    if swapped:
        np_dtype = np_dtype.newbyteorder(">")

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    # NIfTI is Fortran (column-major) ordered: x fastest
    data = data.reshape(shape, order="F")
    if swapped:
        data = data.astype(data.dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        if scl_slope == 0.0:
            scl_slope = 1.0
        data = data.astype(np.float32) * scl_slope + scl_inter

    info = {
        "shape": shape,
        "spacing_xyz": tuple(float(abs(p)) if p != 0 else 1.0 for p in pixdim[1:1 + min(ndim, 3)]),
        # stored little-endian so write_nifti's LE field patching stays coherent
        "header_bytes": _swap_header_to_le(hdr) if swapped else bytes(hdr),
        "swapped": swapped,
        "gz": fname.endswith(".gz"),
    }
    # pad spacing to 3 entries for 2D niftis
    sp = list(info["spacing_xyz"])
    while len(sp) < 3:
        sp.append(1.0)
    info["spacing_xyz"] = tuple(sp[:3])
    return data, info


def _build_header(shape_xyz, spacing_xyz, dtype: np.dtype) -> bytes:
    """Minimal valid NIfTI-1 header (sform identity*spacing, RAS)."""
    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    ndim = len(shape_xyz)
    dim = [ndim] + list(shape_xyz) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(dtype)])
    struct.pack_into("<h", hdr, 72, np.dtype(dtype).itemsize * 8)
    pixdim = [1.0] + list(spacing_xyz) + [1.0] * (7 - len(spacing_xyz))
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<h", hdr, 252, 1)      # qform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    # quatern b/c/d = 0 -> identity rotation; qoffset 0
    sx, sy, sz = (list(spacing_xyz) + [1.0, 1.0, 1.0])[:3]
    struct.pack_into("<4f", hdr, 280, sx, 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, sy, 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, sz, 0)  # srow_z
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr)


def write_nifti(fname: str, data_xyz: np.ndarray, spacing_xyz=None,
                header_bytes: bytes = None) -> None:
    """Write array in on-disk (x, y, z) order. If header_bytes given, reuse it
    (updating dim/datatype/scl fields); else build a fresh header."""
    data_xyz = np.asarray(data_xyz)
    if data_xyz.dtype == np.bool_:
        data_xyz = data_xyz.astype(np.uint8)
    if data_xyz.dtype not in _DTYPE_CODES:
        data_xyz = data_xyz.astype(np.float32)

    if header_bytes is not None:
        hdr = bytearray(header_bytes)
        ndim = data_xyz.ndim
        dim = [ndim] + list(data_xyz.shape) + [1] * (7 - ndim)
        struct.pack_into("<8h", hdr, 40, *dim)
        struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data_xyz.dtype)])
        struct.pack_into("<h", hdr, 72, np.dtype(data_xyz.dtype).itemsize * 8)
        struct.pack_into("<f", hdr, 108, 352.0)
        struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
        struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
        hdr[344:348] = b"n+1\x00"
        hdr = bytes(hdr)
    else:
        if spacing_xyz is None:
            spacing_xyz = (1.0,) * data_xyz.ndim
        hdr = _build_header(data_xyz.shape, spacing_xyz, data_xyz.dtype)

    payload = hdr + b"\x00" * 4 + data_xyz.tobytes(order="F")
    with _open(fname, "wb") as f:
        f.write(payload)


class NiftiIO(BaseReaderWriter):
    """nnU-Net-convention NIfTI reader/writer. Arrays are (c, z, y, x) with spacing
    (sz, sy, sx) — the same orientation the reference's SimpleITKIO produces."""

    supported_file_endings = [".nii", ".nii.gz"]

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        images, spacings, infos = [], [], []
        for f in image_fnames:
            data, info = read_nifti(f)
            if data.ndim == 2:
                data = data[:, :, None]
            if data.ndim == 4:
                if data.shape[3] != 1:
                    raise RuntimeError(f"{f}: 4D NIfTI with >1 volume not supported as "
                                       f"a single channel; split channels into files")
                data = data[..., 0]
            assert data.ndim == 3, f"{f}: expected 3D image, got shape {data.shape}"
            images.append(data.transpose(2, 1, 0))  # (x,y,z) -> (z,y,x)
            spacings.append(info["spacing_xyz"][::-1])
            infos.append(info)

        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Shapes of channel files differ: "
                               f"{[i.shape for i in images]} files: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"Spacings of channel files differ: {spacings}")

        stacked = np.stack(images).astype(np.float32, copy=False)
        properties = {
            "spacing": [float(s) for s in spacings[0]],
            "nifti_stuff": {"header_bytes": infos[0]["header_bytes"]},
        }
        return stacked, properties

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3, "write_seg expects (z, y, x)"
        seg = seg.astype(np.uint8 if seg.max() < 255 else np.uint16, copy=False)
        header = None
        if "nifti_stuff" in properties:
            header = properties["nifti_stuff"]["header_bytes"]
        spacing = properties.get("spacing")
        spacing_xyz = spacing[::-1] if spacing is not None else None
        write_nifti(output_fname, seg.transpose(2, 1, 0), spacing_xyz=spacing_xyz,
                    header_bytes=header)


# -------------------------------------------------------------- reorient-to-RAS
def _affine_from_header(hdr: bytes) -> np.ndarray:
    """4x4 voxel->world affine from a (little-endian) NIfTI-1 header: sform if
    sform_code > 0, else qform, else diagonal spacing."""
    pixdim = struct.unpack("<8f", hdr[76:108])
    sform_code = struct.unpack("<h", hdr[254:256])[0]
    if sform_code > 0:
        rows = [struct.unpack("<4f", hdr[o:o + 16]) for o in (280, 296, 312)]
        return np.array(list(rows) + [(0.0, 0.0, 0.0, 1.0)], dtype=np.float64)
    qform_code = struct.unpack("<h", hdr[252:254])[0]
    aff = np.diag([abs(pixdim[1]) or 1.0, abs(pixdim[2]) or 1.0,
                   abs(pixdim[3]) or 1.0, 1.0])
    if qform_code > 0:
        b, c, d = struct.unpack("<3f", hdr[256:268])
        off = struct.unpack("<3f", hdr[268:280])
        a = max(0.0, 1.0 - b * b - c * c - d * d) ** 0.5
        R = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        spac = np.array([abs(pixdim[1]) or 1.0, abs(pixdim[2]) or 1.0,
                         (abs(pixdim[3]) or 1.0) * qfac])
        aff[:3, :3] = R * spac[None, :]
        aff[:3, 3] = off
    return aff


def _orientation_ops(affine: np.ndarray):
    """(perm, flips): data axis perm[i] (after flips) becomes output axis i,
    such that output axes point along +R, +A, +S (nearest-axis approximation,
    same as nibabel ``io_orientation`` for orthogonal affines)."""
    R = affine[:3, :3].copy()
    perm = [-1, -1, -1]
    flips = [False, False, False]
    used = set()
    # greedy assignment by magnitude keeps this well-defined for oblique affines
    order = np.dstack(np.unravel_index(np.argsort(-np.abs(R), axis=None),
                                       R.shape))[0]
    for i, j in order:                     # world axis i <- data axis j
        i, j = int(i), int(j)
        if perm[i] != -1 or j in used:
            continue
        perm[i] = j
        used.add(j)
        flips[i] = R[i, j] < 0
    return perm, flips


def reorient_xyz_to_ras(data_xyz: np.ndarray, affine: np.ndarray):
    """Reorient an on-disk (x, y, z) array so axes point +R, +A, +S. Returns
    (reoriented, op) where op = (perm, flips) is needed to invert."""
    perm, flips = _orientation_ops(affine)
    out = np.transpose(data_xyz, perm)
    for ax, f in enumerate(flips):
        if f:
            out = np.flip(out, axis=ax)
    return out, (perm, flips)


def revert_ras_orientation(data_ras: np.ndarray, op) -> np.ndarray:
    """Inverse of :func:`reorient_xyz_to_ras`."""
    perm, flips = op
    out = data_ras
    for ax, f in enumerate(flips):
        if f:
            out = np.flip(out, axis=ax)
    inv = np.argsort(np.asarray(perm))
    return np.ascontiguousarray(np.transpose(out, inv))


class NiftiIOWithReorient(NiftiIO):
    """NIfTI reader that reorients every volume to RAS before handing it to the
    pipeline and restores the original orientation on write (reference
    `nnunetv2/imageio/nibabel_reader_writer.py` NibabelIOWithReorient /
    ``as_closest_canonical``). Needed for datasets with mixed orientations
    (e.g. KiTS/AutoPET via NibabelIOWithReorient in the reference converters)."""

    def read_images(self, image_fnames):
        images, spacings, infos, ops = [], [], [], []
        for f in image_fnames:
            data, info = read_nifti(f)
            if data.ndim == 2:
                data = data[:, :, None]
            assert data.ndim == 3, f"{f}: expected 3D, got {data.shape}"
            affine = _affine_from_header(info["header_bytes"])
            data_ras, op = reorient_xyz_to_ras(data, affine)
            perm, _ = op
            sp_xyz = info["spacing_xyz"]
            sp_ras = [sp_xyz[perm[i]] for i in range(3)]
            images.append(np.ascontiguousarray(data_ras.transpose(2, 1, 0)))
            spacings.append(sp_ras[::-1])
            infos.append(info)
            ops.append(op)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"shapes differ: {[i.shape for i in images]}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"spacings differ: {spacings}")
        stacked = np.stack(images).astype(np.float32, copy=False)
        properties = {
            "spacing": [float(s) for s in spacings[0]],
            "nifti_stuff": {"header_bytes": infos[0]["header_bytes"],
                            "reorient_op": ops[0]},
        }
        return stacked, properties

    def write_seg(self, seg, output_fname, properties):
        assert seg.ndim == 3
        seg = seg.astype(np.uint8 if seg.max() < 255 else np.uint16, copy=False)
        stuff = properties.get("nifti_stuff", {})
        op = stuff.get("reorient_op")
        data_xyz = seg.transpose(2, 1, 0)
        if op is not None:
            data_xyz = revert_ras_orientation(data_xyz, op)
        write_nifti(output_fname, data_xyz,
                    header_bytes=stuff.get("header_bytes"))
