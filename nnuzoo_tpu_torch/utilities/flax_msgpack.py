"""A reader of the JAX package's checkpoints, which needs neither flax nor msgpack.

The JAX ``Trainer`` stores ``network_weights`` as
``flax.serialization.to_bytes(params)``: msgpack of the parameter tree, each
array an ext object. :func:`msgpack_restore` decodes the subset that flax
writes and returns the nested dict of numpy arrays that
``nnuzoo_tpu_torch.convert.convert_params`` takes:

- nil, bool, ints, floats, str, bin, arrays (as lists) and maps;
- ext type 1, an ndarray packed as msgpack ``(shape, dtype name, C-order
  buffer)``; ext type 3, a numpy scalar packed the same way;
- maps of the form ``{"__msgpack_chunked_array__": True, "shape": {"0": ..},
  "chunks": {"0": .., ..}}``, which flax writes for arrays above its
  ``MAX_CHUNK_SIZE``, joined back into one array.

Lists in a flax state dict are maps keyed ``"0"``, ``"1"``, ..., which
``convert_params`` walks like any other name.
"""

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def array(self, n: int):
        return [self.read() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b](self)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


_FIXED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_(r.unpack(">B")),
    0xDA: lambda r: r.str_(r.unpack(">H")),
    0xDB: lambda r: r.str_(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def _unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after "
                         "the msgpack object")
    return out


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpackb(payload)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(payload)[()]
    raise ValueError(f"msgpack ext type {code} is not read: only ndarrays (1) "
                     "and numpy scalars (3) are")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_serialize`` (and so
    ``to_bytes``) encoded: nested dicts with numpy arrays at the leaves."""
    return _unchunk(_unpackb(bytes(encoded)))
