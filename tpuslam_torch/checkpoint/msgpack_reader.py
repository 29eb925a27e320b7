"""Reader of the msgpack that `flax.serialization.to_bytes` writes.

The JAX package stores its checkpoints as flax msgpack (`params.msgpack`,
`batch_stats.msgpack`).  The port reads them without `msgpack` or `flax`,
with this decoder of the subset those files use: maps, arrays, str, bin,
ints, floats, nil and bool, and two of flax's extension types:

* ext 1, an ndarray, whose payload is itself msgpack: the triple
  (shape, dtype name, C-order bytes);
* ext 3, a numpy scalar, the same triple with shape ().

Anything else is refused with ValueError: other extension types, flax's
chunked form of arrays over 2^30 bytes (which these networks never reach),
the bfloat16 dtype and trailing bytes.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {
            0xC4: (">B", lambda n: bytes(self.take(n))),
            0xC5: (">H", lambda n: bytes(self.take(n))),
            0xC6: (">I", lambda n: bytes(self.take(n))),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if out.get("__msgpack_chunked_array__"):
            raise ValueError("msgpack: flax's chunked arrays (over 2^30 bytes) are not read")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported extension type {code}")
        arr = _ndarray(payload)
        return arr[()] if code == EXT_NPSCALAR else arr


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = loads(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not read (numpy has no bfloat16)")
    dtype = np.dtype(dtype_name)
    if dtype.hasobject:
        raise ValueError(f"msgpack: object dtype {dtype_name} refused")
    return np.frombuffer(buffer, dtype=dtype).reshape(tuple(shape)).copy()


def loads(data: bytes) -> Any:
    """Decode one msgpack object that spans all of `data`."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} trailing bytes")
    return out


def load_flax_variables(folder) -> Tuple[dict, dict]:
    """(params, batch_stats) as nested dicts of numpy arrays from a
    checkpoint folder that the JAX package wrote."""
    folder = Path(folder)
    return tuple(loads((folder / name).read_bytes())
                 for name in ("params.msgpack", "batch_stats.msgpack"))
