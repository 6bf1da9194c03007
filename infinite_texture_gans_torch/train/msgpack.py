"""Pure-Python decoder for the msgpack subset that flax.serialization writes.

The ``.ckpt`` body is a flax msgpack blob (docs/CHECKPOINT.md). This decoder
reads maps, arrays, strings, binaries, integers, floats, nil and booleans,
and flax's extension types 1 (ndarray: a packed ``(shape, dtype name,
bytes)`` triple) and 3 (numpy scalar, same payload). Arrays come back as
numpy arrays, except bfloat16 (numpy has no such type), which comes back as
a ``torch.bfloat16`` tensor read through uint16.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, nbytes: int) -> int:
        return int.from_bytes(self.take(nbytes), "big")


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of ``data``."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after msgpack object")
    return obj


def _decode(r: _Reader):
    t = r.take(1)[0]
    if t <= 0x7F:  # positive fixint
        return t
    if t >= 0xE0:  # negative fixint
        return t - 0x100
    if t <= 0x8F:
        return _map(r, t & 0x0F)
    if t <= 0x9F:
        return _array(r, t & 0x0F)
    if t <= 0xBF:
        return _str(r, t & 0x1F)
    if t == 0xC0:
        return None
    if t == 0xC2:
        return False
    if t == 0xC3:
        return True
    if 0xC4 <= t <= 0xC6:  # bin 8/16/32
        return bytes(r.take(r.uint(1 << (t - 0xC4))))
    if 0xC7 <= t <= 0xC9:  # ext 8/16/32
        n = r.uint(1 << (t - 0xC7))
        code = struct.unpack(">b", r.take(1))[0]
        return _ext(code, bytes(r.take(n)))
    if t == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if t == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if 0xCC <= t <= 0xCF:  # uint 8/16/32/64
        return r.uint(1 << (t - 0xCC))
    if 0xD0 <= t <= 0xD3:  # int 8/16/32/64
        return int.from_bytes(r.take(1 << (t - 0xD0)), "big", signed=True)
    if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
        code = struct.unpack(">b", r.take(1))[0]
        return _ext(code, bytes(r.take(1 << (t - 0xD4))))
    if 0xD9 <= t <= 0xDB:  # str 8/16/32
        return _str(r, r.uint(1 << (t - 0xD9)))
    if t in (0xDC, 0xDD):
        return _array(r, r.uint(2 if t == 0xDC else 4))
    if t in (0xDE, 0xDF):
        return _map(r, r.uint(2 if t == 0xDE else 4))
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    return out


def _array(r: _Reader, n: int) -> list:
    return [_decode(r) for _ in range(n)]


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _ndarray(payload: bytes):
    shape, dtype_name, buf = unpackb(payload)
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")
