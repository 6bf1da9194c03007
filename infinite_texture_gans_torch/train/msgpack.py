"""Pure-Python encoder and decoder for the msgpack subset that
flax.serialization writes.

The ``.ckpt`` body is a flax msgpack blob (docs/CHECKPOINT.md). The format
has maps, arrays, strings, binaries, integers, floats, nil and booleans,
and flax's extension types 1 (ndarray: a packed ``(shape, dtype name,
bytes)`` triple) and 3 (numpy scalar, same payload). The decoder returns
arrays as numpy arrays, except bfloat16 (numpy has no such type), which
comes back as a ``torch.bfloat16`` tensor read through uint16. The encoder
(:func:`packb`) takes numpy arrays, numpy scalars and CPU tensors as array
leaves, so what it writes loads with ``flax.serialization.msgpack_restore``.
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


# ---------------------------------------------------------------------------
# encoder


def packb(obj) -> bytes:
    """Encode ``obj`` (nested dicts with string keys, lists, tuples, str,
    bytes, int, float, bool, None and array leaves) as msgpack."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form (``fix | n``) up to ``fix_max``, else
    the 8/16/32-bit form from ``codes`` (None where the form does not
    exist)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, nbytes in zip(codes, (1, 2, 4)):
        if code is not None and n < (1 << (8 * nbytes)):
            out.append(code)
            out += n.to_bytes(nbytes, "big")
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _array_payload(a: np.ndarray) -> bytes:
    return packb((list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()))


def _tensor_payload(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return packb((list(t.shape), "bfloat16", t.view(torch.uint16).numpy().tobytes()))
    return _array_payload(t.numpy())


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, torch.Tensor):
        _pack_ext(out, _EXT_NDARRAY, _tensor_payload(obj))
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for value in obj:
            _encode(value, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")


def _int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, nbytes in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < (1 << (8 * nbytes)):
                out.append(code)
                out += v.to_bytes(nbytes, "big")
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, nbytes in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * nbytes - 1)):
                out.append(code)
                out += v.to_bytes(nbytes, "big", signed=True)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
