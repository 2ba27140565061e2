"""The subset of MessagePack that flax's checkpoints use, without the
``msgpack`` package: nil, booleans, integers, floats, strings, bytes,
arrays, maps and extension types, each written in its smallest form (as
``msgpack.packb(..., use_bin_type=True)`` writes it) and read in any
form.

``packb(obj, default)``: ``default(x)`` turns what the codec does not take
into an ``ExtType`` (or a type it takes). ``unpackb(data, ext_hook)``:
arrays come back as lists, maps as dicts, strings as str and bytes as
bytes (``raw=True``: strings as bytes too); ``ext_hook(code, data)``
turns an extension back into a value.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional


class ExtType(NamedTuple):
    code: int
    data: bytes


def _len_header(n: int, fix: Optional[int], fix_max: int,
                codes: tuple) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_ext(e: ExtType) -> bytes:
    n = len(e.data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[n]]) if n in fixed
            else _len_header(n, None, 0, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", e.code) + e.data


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """``obj`` as MessagePack bytes; exact types only (a tuple goes to
    ``default``, as with ``strict_types=True``)."""
    out: list = []

    def pack(x, depth=0):
        if depth > 512:
            raise ValueError("msgpack object nested too deep")
        t = type(x)
        if x is None:
            out.append(b"\xc0")
        elif t is bool:
            out.append(b"\xc3" if x else b"\xc2")
        elif t is int:
            out.append(_pack_int(x))
        elif t is float:
            out.append(b"\xcb" + struct.pack(">d", x))
        elif t is str:
            b = x.encode("utf-8")
            out.append(_len_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b)
        elif t in (bytes, bytearray, memoryview):
            b = bytes(x)
            out.append(_len_header(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b)
        elif t is list:
            out.append(_len_header(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
            for v in x:
                pack(v, depth + 1)
        elif t is dict:
            out.append(_len_header(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
            for k, v in x.items():
                pack(k, depth + 1)
                pack(v, depth + 1)
        elif t is ExtType:
            out.append(_pack_ext(x))
        elif default is not None:
            y = default(x)
            if y is x:
                raise TypeError(f"can not serialize {t.__name__!r} object")
            pack(y, depth + 1)
        else:
            raise TypeError(f"can not serialize {t.__name__!r} object")

    pack(obj)
    return b"".join(out)


def unpackb(data: bytes, ext_hook: Optional[Callable] = None,
            raw: bool = False) -> Any:
    """MessagePack bytes -> the object (one, filling ``data``)."""
    buf = memoryview(bytes(data))
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError("truncated msgpack data")
        b = buf[pos:pos + n]
        pos += n
        return b

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def string(n):
        b = bytes(take(n))
        return b if raw else b.decode("utf-8")

    def ext(n):
        code = num(">b")
        payload = bytes(take(n))
        return (ext_hook(code, payload) if ext_hook is not None
                else ExtType(code, payload))

    def array(n):
        return [unpack() for _ in range(n)]

    def mapping(n):
        out = {}
        for _ in range(n):
            k = unpack()
            out[k] = unpack()
        return out

    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
               0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
               0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}

    def unpack():
        c = num(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return mapping(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return string(c & 0x1F)
        if c in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[c]
        if c in scalars:
            return num(scalars[c])
        if 0xD4 <= c <= 0xD8:
            return ext(1 << (c - 0xD4))
        if c in lengths:
            n = num(lengths[c])
            if c <= 0xC6:
                return bytes(take(n))
            if c <= 0xC9:
                return ext(n)
            if c <= 0xDB:
                return string(n)
            return array(n) if c <= 0xDD else mapping(n)
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    obj = unpack()
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra msgpack data")
    return obj
