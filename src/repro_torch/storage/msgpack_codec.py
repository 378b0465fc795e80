"""A small MessagePack codec: the subset the SPAX footers, the catalog,
the calibration entries and the registry manifests use.

``packb`` emits the same bytes as ``msgpack.packb`` with its defaults
(``use_bin_type=True``: str as the str family, bytes as the bin family;
floats as float64; integers in the narrowest format; dict items in
insertion order), and ``unpackb`` reads them back as
``msgpack.unpackb`` does with its defaults (``raw=False``: str decoded
as UTF-8; arrays as lists; ``strict_map_key=True``: map keys must be
str or bytes). Any other type raises, as msgpack does, so a store
written by either package is read by the other.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        if x <= 0xFF:
            out += b"\xcc" + struct.pack(">B", x)
        elif x <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", x)
        elif x <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", x)
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + struct.pack(">Q", x)
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -0x80:
        out += b"\xd0" + struct.pack(">b", x)
    elif x >= -0x8000:
        out += b"\xd1" + struct.pack(">h", x)
    elif x >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", x)
    elif x >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple,
              out: bytearray) -> None:
    """Length header: fixed form below ``fix_max``, else the 8/16/32-bit
    forms in ``codes`` (None where the family has no such form)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object too large to pack ({n})")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", float(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("unpackb: truncated data")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # code → struct format of a scalar payload
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # code → (kind, struct format of the length)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def _read(r: _Reader):
    code = r.unpack(">B")
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        return _read_map(r, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return [_read(r) for _ in range(code & 0x0F)]
    if 0xA0 <= code <= 0xBF:
        return str(r.take(code & 0x1F), "utf-8")
    if code == 0xC0:
        return None
    if code == 0xC2:
        return False
    if code == 0xC3:
        return True
    if code in _FIXED:
        return r.unpack(_FIXED[code])
    if code in _LEN:
        kind, fmt = _LEN[code]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"unpackb: unsupported type code 0x{code:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _read(r)
    return out


def unpackb(data) -> object:
    r = _Reader(bytes(data))
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("unpackb: extra data after the object")
    return obj
