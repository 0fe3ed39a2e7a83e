"""A reader and a writer of flax's msgpack checkpoints, without flax or
msgpack.

``flax.serialization.to_bytes`` writes a variables tree as msgpack: nested
maps of str keys whose leaves are ndarrays, each an extension of type 1
holding the msgpack of (shape, dtype name, raw bytes). ``restore`` decodes
that subset of msgpack (maps, arrays, strings, binaries, integers, floats,
nil, booleans and type-1 extensions) into nested dicts of numpy arrays.
Any other extension type raises, as does a truncated buffer. ``dump``
writes the same subset as ``to_bytes`` does, each value in msgpack's
smallest encoding, so ``dump(restore(b)) == b`` for flax's own bytes.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: buffer ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
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
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte {b:#04x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: extension type {code} is not an "
                             "ndarray (type 1)")
        shape, dtype, raw = _Reader(data).obj()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def restore(buf: bytes):
    """The nested dict of numpy arrays that `buf` (flax's to_bytes of a
    variables tree) holds."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A sized type's header: the fix form below fix_max, else the first
    of `codes` ((type byte, struct format, limit), ...) that holds n."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {n} items or bytes is too many")


_U8, _U16, _U32 = 1 << 8, 1 << 16, 1 << 32


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    if v >= 0:
        forms = ((0xCC, ">B", _U8), (0xCD, ">H", _U16), (0xCE, ">I", _U32),
                 (0xCF, ">Q", 1 << 64))
        for code, fmt, limit in forms:
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                out.append(code)
                out += struct.pack(fmt, v)
                return
    raise ValueError(f"msgpack: integer {v} out of range")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _head(out, len(data), None, 0,
              ((0xC7, ">B", _U8), (0xC8, ">H", _U16), (0xC9, ">I", _U32)))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), 0xA0, 32,
              ((0xD9, ">B", _U8), (0xDA, ">H", _U16), (0xDB, ">I", _U32)))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, 0,
              ((0xC4, ">B", _U8), (0xC5, ">H", _U16), (0xC6, ">I", _U32)))
        out += v
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, ((0xDC, ">H", _U16), (0xDD, ">I", _U32)))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, ((0xDE, ">H", _U16), (0xDF, ">I", _U32)))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        inner = bytearray()
        _pack(inner, (tuple(int(n) for n in v.shape), v.dtype.name,
                      np.ascontiguousarray(v).tobytes()))
        _ext(out, EXT_NDARRAY, bytes(inner))
    else:
        raise TypeError(f"msgpack: cannot write {type(v).__name__}")


def dump(tree) -> bytes:
    """The msgpack bytes of `tree` (nested dicts of str keys whose leaves
    are numpy arrays, or lists, str, bytes, int, float, bool, None), as
    ``flax.serialization.to_bytes`` writes them."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)
