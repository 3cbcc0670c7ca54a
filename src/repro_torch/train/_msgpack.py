"""A standard-library msgpack reader and writer for the checkpoint payload.

The reference writes its checkpoints with ``msgpack.packb(payload,
use_bin_type=True)`` and reads them with ``unpackb(raw=False)``; the port
imports no ``msgpack``, so it carries this codec for the subset those
payloads use: maps, str, int, list (and tuple, written as a list), bin
(bytes), nil, bool and float (written as float 64). Each value takes the
shortest form, as msgpack-python packs it, so :func:`packb` gives the same
bytes as the reference's writer for such a payload.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, b"\xdc", b"\xdd"))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _header(n: int, fix: int, h16: bytes, h32: bytes) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < 1 << 16:
        return h16 + struct.pack(">H", n)
    return h32 + struct.pack(">I", n)


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, bound in ((b"\xcc", ">B", 1 << 8), (b"\xcd", ">H", 1 << 16),
                                 (b"\xce", ">I", 1 << 32), (b"\xcf", ">Q", 1 << 64)):
            if n < bound:
                return code + struct.pack(fmt, n)
    else:
        for code, fmt, bound in ((b"\xd0", ">b", 1 << 7), (b"\xd1", ">h", 1 << 15),
                                 (b"\xd2", ">i", 1 << 31), (b"\xd3", ">q", 1 << 63)):
            if n >= -bound:
                return code + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit in 64 bits")


def unpackb(data: bytes) -> Any:
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"{len(view) - pos} bytes after the msgpack object")
    return obj


_FIXED = {  # code -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4,
        0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(buf, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_list(buf, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        return _str(buf, pos, code & 0x1F)
    if code == 0xC0:
        return None, pos
    if code == 0xC2:
        return False, pos
    if code == 0xC3:
        return True, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if code in _LEN:
        size = _LEN[code]
        n = struct.unpack_from(_LEN_FMT[size], buf, pos)[0]
        pos += size
        if code in (0xC4, 0xC5, 0xC6):
            return bytes(buf[pos:pos + n]), pos + n
        if code in (0xD9, 0xDA, 0xDB):
            return _str(buf, pos, n)
        if code in (0xDC, 0xDD):
            return _unpack_list(buf, pos, n)
        return _unpack_map(buf, pos, n)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _str(buf: memoryview, pos: int, n: int) -> Tuple[str, int]:
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _unpack_list(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, pos = _unpack(buf, pos)
        out.append(x)
    return out, pos


def _unpack_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos
