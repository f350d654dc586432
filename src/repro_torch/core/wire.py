"""The subset of msgpack that the serializer uses, in plain Python.

The fabric's wire format is msgpack (``serializer.py``). The port carries this
codec instead of depending on the ``msgpack`` package: the machines the port
runs on need not have it. It writes exactly what ``msgpack.packb(obj,
use_bin_type=True)`` writes, so payload hashes and memo keys agree with the
reference package's, and reads what that writes.

Types: nil, bool, int (every width, each in its smallest encoding), float
(float64), str, bin (bytes, bytearray, memoryview), array (list and tuple),
map and ext. ``packb`` checks them in msgpack's order and calls ``default``
once for an object of any other type; ``unpackb`` and :class:`Unpacker` give
lists for arrays and ``str`` for strings, and hand every ext to ``ext_hook``.
"""
from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Callable, Optional

__all__ = ["ExtType", "ExtraData", "Unpacker", "packb", "unpackb"]


class ExtType(namedtuple("ExtType", "code data")):
    """An ext value: an application type code (0..127) and its bytes."""

    def __new__(cls, code, data):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class ExtraData(ValueError):
    """``unpackb`` found bytes after the first object."""

    def __init__(self, unpacked, extra):
        self.unpacked = unpacked
        self.extra = extra

    def __str__(self):
        return "unpack(b) received extra data."


_B = struct.Struct(">B").pack
_BB = struct.Struct(">BB").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(o: int, out: bytearray) -> bool:
    """Append ``o`` in its smallest encoding; False where 64 bits cannot hold it."""
    if o >= 0:
        if o < 0x80:
            out.append(o)
        elif o < 0x100:
            out += _BB(0xCC, o)
        elif o < 0x10000:
            out += _BH(0xCD, o)
        elif o < 0x100000000:
            out += _BI(0xCE, o)
        elif o < 0x10000000000000000:
            out += _BQ(0xCF, o)
        else:
            return False
    elif o >= -32:
        out.append(o & 0xFF)
    elif o >= -0x80:
        out += _Bb(0xD0, o)
    elif o >= -0x8000:
        out += _Bh(0xD1, o)
    elif o >= -0x80000000:
        out += _Bi(0xD2, o)
    elif o >= -0x8000000000000000:
        out += _Bq(0xD3, o)
    else:
        return False
    return True


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, c8: Optional[int],
              c16: int, c32: int) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif c8 is not None and n < 0x100:
        out += _BB(c8, n)
    elif n < 0x10000:
        out += _BH(c16, n)
    elif n < 0x100000000:
        out += _BI(c32, n)
    else:
        raise ValueError(f"object too large to pack: {n}")


def _pack_bin(data, out: bytearray) -> None:
    n = len(data)
    if n < 0x100:
        out += _BB(0xC4, n)
    elif n < 0x10000:
        out += _BH(0xC5, n)
    elif n < 0x100000000:
        out += _BI(0xC6, n)
    else:
        raise ValueError(f"bin too large to pack: {n}")
    out += data


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out += _Bb(_FIXEXT[n], code)
    elif n < 0x100:
        out += _BB(0xC7, n)
        out += _B(code & 0xFF)
    elif n < 0x10000:
        out += _BH(0xC8, n)
        out += _B(code & 0xFF)
    else:
        out += _BI(0xC9, n)
        out += _B(code & 0xFF)
    out += data


def _pack(o: Any, out: bytearray, default: Optional[Callable]) -> None:
    defaulted = False
    while True:
        if o is None:
            out.append(0xC0)
        elif o is True:
            out.append(0xC3)
        elif o is False:
            out.append(0xC2)
        elif isinstance(o, int):
            if not _pack_int(o, out):
                if default is not None and not defaulted:
                    o, defaulted = default(o), True
                    continue
                raise OverflowError("Integer value out of range")
        elif isinstance(o, float):
            out += _Bd(0xCB, o)
        elif isinstance(o, (bytes, bytearray)):
            _pack_bin(o, out)
        elif isinstance(o, str):
            data = o.encode("utf-8")
            _pack_len(len(data), out, 0xA0, 32, 0xD9, 0xDA, 0xDB)
            out += data
        elif isinstance(o, dict):
            _pack_len(len(o), out, 0x80, 16, None, 0xDE, 0xDF)
            for k, v in o.items():
                _pack(k, out, default)
                _pack(v, out, default)
        elif isinstance(o, ExtType):
            _pack_ext(o.code, o.data, out)
        elif isinstance(o, (list, tuple)):
            _pack_len(len(o), out, 0x90, 16, None, 0xDC, 0xDD)
            for v in o:
                _pack(v, out, default)
        elif isinstance(o, memoryview):
            _pack_bin(o.cast("B"), out)
        elif default is not None and not defaulted:
            o, defaulted = default(o), True
            continue
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")
        return


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """Pack ``obj`` as ``msgpack.packb(obj, default=default, use_bin_type=True)``
    does."""
    out = bytearray()
    _pack(obj, out, default)
    return bytes(out)


# ------------------------------------------------------------------ unpacking
_u8 = struct.Struct(">B").unpack_from
_u16 = struct.Struct(">H").unpack_from
_u32 = struct.Struct(">I").unpack_from
_u64 = struct.Struct(">Q").unpack_from
_i8 = struct.Struct(">b").unpack_from
_i16 = struct.Struct(">h").unpack_from
_i32 = struct.Struct(">i").unpack_from
_i64 = struct.Struct(">q").unpack_from
_f32 = struct.Struct(">f").unpack_from
_f64 = struct.Struct(">d").unpack_from


class _OutOfData(ValueError):
    pass


class _Reader:
    __slots__ = ("buf", "pos", "ext_hook", "raw", "strict_map_key")

    def __init__(self, buf, ext_hook, raw, strict_map_key):
        self.buf = buf
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw
        self.strict_map_key = strict_map_key

    def _take(self, n: int):
        start, end = self.pos, self.pos + n
        if end > len(self.buf):
            raise _OutOfData("unpack: truncated data")
        self.pos = end
        return self.buf[start:end]

    def _fixed(self, fn, n: int):
        if self.pos + n > len(self.buf):
            raise _OutOfData("unpack: truncated data")
        v = fn(self.buf, self.pos)[0]
        self.pos += n
        return v

    def _str(self, n: int):
        data = bytes(self._take(n))
        return data if self.raw else data.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if self.strict_map_key and type(k) not in (str, bytes):
                raise ValueError(f"{type(k)} is not allowed for map key")
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._fixed(_i8, 1)
        data = bytes(self._take(n))
        return self.ext_hook(code, data) if self.ext_hook is not None else ExtType(code, data)

    def read(self) -> Any:
        if self.pos >= len(self.buf):
            raise _OutOfData("unpack: no data")
        b = self.buf[self.pos]
        self.pos += 1
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self._map(b & 0x0F)
        if b < 0xA0:
            return self._array(b & 0x0F)
        if b < 0xC0:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b == 0xC4:
            return bytes(self._take(self._fixed(_u8, 1)))
        if b == 0xC5:
            return bytes(self._take(self._fixed(_u16, 2)))
        if b == 0xC6:
            return bytes(self._take(self._fixed(_u32, 4)))
        if b == 0xC7:
            return self._ext(self._fixed(_u8, 1))
        if b == 0xC8:
            return self._ext(self._fixed(_u16, 2))
        if b == 0xC9:
            return self._ext(self._fixed(_u32, 4))
        if b == 0xCA:
            return self._fixed(_f32, 4)
        if b == 0xCB:
            return self._fixed(_f64, 8)
        if b == 0xCC:
            return self._fixed(_u8, 1)
        if b == 0xCD:
            return self._fixed(_u16, 2)
        if b == 0xCE:
            return self._fixed(_u32, 4)
        if b == 0xCF:
            return self._fixed(_u64, 8)
        if b == 0xD0:
            return self._fixed(_i8, 1)
        if b == 0xD1:
            return self._fixed(_i16, 2)
        if b == 0xD2:
            return self._fixed(_i32, 4)
        if b == 0xD3:
            return self._fixed(_i64, 8)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b == 0xD9:
            return self._str(self._fixed(_u8, 1))
        if b == 0xDA:
            return self._str(self._fixed(_u16, 2))
        if b == 0xDB:
            return self._str(self._fixed(_u32, 4))
        if b == 0xDC:
            return self._array(self._fixed(_u16, 2))
        if b == 0xDD:
            return self._array(self._fixed(_u32, 4))
        if b == 0xDE:
            return self._map(self._fixed(_u16, 2))
        if b == 0xDF:
            return self._map(self._fixed(_u32, 4))
        raise ValueError(f"unpack: unknown header byte 0x{b:02x}")


def unpackb(data, ext_hook: Optional[Callable[[int, bytes], Any]] = None, raw: bool = False,
            strict_map_key: bool = False) -> Any:
    """Unpack one object from ``data``, as ``msgpack.unpackb`` does with
    ``use_list=True``. Bytes left after it raise :class:`ExtraData`."""
    reader = _Reader(memoryview(data).cast("B"), ext_hook, raw, strict_map_key)
    try:
        obj = reader.read()
    except _OutOfData as exc:
        raise ValueError(str(exc)) from None
    if reader.pos < len(reader.buf):
        raise ExtraData(obj, bytes(reader.buf[reader.pos:]))
    return obj


class Unpacker:
    """Streaming unpacker: ``feed`` bytes, ``unpack`` the next object, and
    ``tell`` the offset just past it in everything fed so far."""

    def __init__(self, ext_hook: Optional[Callable[[int, bytes], Any]] = None,
                 raw: bool = False, strict_map_key: bool = False):
        self._buf = b""
        self._pos = 0
        self._ext_hook = ext_hook
        self._raw = raw
        self._strict_map_key = strict_map_key

    def feed(self, data) -> None:
        self._buf = self._buf + bytes(data) if self._buf else bytes(data)

    def unpack(self) -> Any:
        reader = _Reader(memoryview(self._buf), self._ext_hook, self._raw,
                         self._strict_map_key)
        reader.pos = self._pos
        try:
            obj = reader.read()
        except _OutOfData as exc:
            raise ValueError(str(exc)) from None
        self._pos = reader.pos
        return obj

    def tell(self) -> int:
        return self._pos
