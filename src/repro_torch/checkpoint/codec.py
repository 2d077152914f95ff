"""The MessagePack subset of the federation checkpoints, with no msgpack
package.

``packb`` writes exactly the bytes ``msgpack.packb(obj)`` (msgpack-python
1.x: ``use_bin_type=True``, ``use_single_float=False``) writes for the
types a checkpoint holds, and ``unpackb`` reads every format of those
types, as ``msgpack.unpackb(data, raw=False, strict_map_key=False)`` does:

* nil, false, true;
* integers: positive and negative fixint, uint8-64, int8-64, each value in
  the narrowest format that holds it (unsigned for a value >= 0);
* float64;
* ``str``: fixstr, str8, str16, str32 (UTF-8);
* ``bytes``: bin8, bin16, bin32;
* ``list`` / ``tuple``: fixarray, array16, array32 (read back as lists);
* ``dict``: fixmap, map16, map32, keys and values in insertion order.

``default`` maps any other object to one of these before it is packed
(the checkpoint's array leaves); ``object_hook`` rewrites every map after
it is read. Packed bytes are collected in a list of parts and joined
once, and a bin payload is read as one slice, so a checkpoint of several
hundred MB costs a copy or two of its size, not a pass a byte."""
from __future__ import annotations

import struct
from typing import Any, Callable, Optional

__all__ = ["packb", "unpackb"]


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                return bytes((tag,)) + struct.pack(fmt, x)
    else:
        for tag, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if x >= low:
                return bytes((tag,)) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit 64 bits")


def _head(n: int, fix: Optional[int], fix_max: int, tags) -> bytes:
    """The header of a str / bin / array / map of length ``n``: the fix
    form (``fix`` | n) up to ``fix_max``, else the 8-, 16- or 32-bit one
    of ``tags`` (None where the type has no such width)."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            return bytes((tag,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit 32 bits")


def _pack(obj: Any, out: list, default: Optional[Callable]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(_head(len(obj), None, 0, (0xC4, 0xC5, 0xC6)))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for x in obj:
            _pack(x, out, default)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out, default)
            _pack(v, out, default)
    elif default is not None:
        _pack(default(obj), out, None)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """``msgpack.packb(obj, default=default)``'s bytes."""
    out: list = []
    _pack(obj, out, default)
    return b"".join(out)


class _Reader:
    def __init__(self, data, object_hook):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.hook = object_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, t: int, base: int) -> int:
        """The 8-, 16- or 32-bit length after tag ``t`` (``base`` the
        8-bit tag of its type)."""
        return self.unpack((">B", ">H", ">I")[t - base])

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t < 0x90:
            return self.map(t & 0x0F)
        if t < 0xA0:
            return self.array(t & 0x0F)
        if t < 0xC0:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if 0xC4 <= t <= 0xC6:
            return bytes(self.take(self.length(t, 0xC4)))
        if t == 0xCB:
            return self.unpack(">d")
        if 0xCC <= t <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q",
                                ">b", ">h", ">i", ">q")[t - 0xCC])
        if 0xD9 <= t <= 0xDB:
            return str(self.take(self.length(t, 0xD9)), "utf-8")
        if t in (0xDC, 0xDD):
            return self.array(self.length(t, 0xDB))
        if t in (0xDE, 0xDF):
            return self.map(self.length(t, 0xDD))
        raise ValueError(f"msgpack type 0x{t:02x} is not a checkpoint type")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out if self.hook is None else self.hook(out)


def unpackb(data, object_hook: Optional[Callable] = None) -> Any:
    """``msgpack.unpackb(data, object_hook=object_hook,
    strict_map_key=False)``: ``str`` for str formats, ``bytes`` for bin,
    lists for arrays."""
    r = _Reader(data, object_hook)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return out
