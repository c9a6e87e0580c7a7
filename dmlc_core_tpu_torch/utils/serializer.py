"""Binary serialization of scalars, containers and numpy arrays to
streams.

Counterpart of ``dmlc_core_tpu/utils/serializer.py``, kept as a copy so
that the port imports nothing of the JAX package: the same fixed-width
little-endian helpers (``write_uint32`` ...) and the same tagged,
self-describing :func:`save` / :func:`load` of scalars, str/bytes,
list/tuple/set/dict, None, numpy arrays and objects with
``save(stream)`` / ``load(stream)``.  The bytes written are identical to
the JAX package's, so ``RowBlockContainer`` streams and ``DiskRowIter``
caches written by either package load in the other.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Optional

import numpy as np

from .logging import DMLCError

__all__ = [
    "save", "load",
    "write_uint32", "read_uint32", "write_uint64", "read_uint64",
    "write_int64", "read_int64", "write_float64", "read_float64",
    "write_bytes", "read_bytes", "write_string", "read_string",
]


# ---- fixed-width scalar helpers (little-endian wire format) ----

def write_uint32(s: Any, v: int) -> None:
    s.write(struct.pack("<I", v))


def write_uint64(s: Any, v: int) -> None:
    s.write(struct.pack("<Q", v))


def write_int64(s: Any, v: int) -> None:
    s.write(struct.pack("<q", v))


def write_float64(s: Any, v: float) -> None:
    s.write(struct.pack("<d", v))


def write_bytes(s: Any, b: bytes) -> None:
    s.write(b)


def _read_exact(s: Any, n: int) -> bytes:
    b = s.read(n)
    if len(b) != n:
        raise DMLCError(f"unexpected EOF: wanted {n} bytes, got {len(b)}")
    return b


def read_uint32(s: Any) -> int:
    return struct.unpack("<I", _read_exact(s, 4))[0]


def read_uint64(s: Any) -> int:
    return struct.unpack("<Q", _read_exact(s, 8))[0]


def read_int64(s: Any) -> int:
    return struct.unpack("<q", _read_exact(s, 8))[0]


def read_float64(s: Any) -> float:
    return struct.unpack("<d", _read_exact(s, 8))[0]


def read_bytes(s: Any, n: int) -> bytes:
    return _read_exact(s, n)


def write_string(s: Any, text: str) -> None:
    """Length-prefixed UTF-8 (reference string handler `serializer.h:125-140`)."""
    b = text.encode("utf-8")
    write_uint64(s, len(b))
    s.write(b)


def read_string(s: Any) -> str:
    n = read_uint64(s)
    return _read_exact(s, n).decode("utf-8")


# ---- tagged self-describing object serialization ----

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2
_T_FLOAT = 3
_T_STR = 4
_T_BYTES = 5
_T_LIST = 6
_T_TUPLE = 7
_T_SET = 8
_T_DICT = 9
_T_NDARRAY = 10
_T_SAVELOAD = 11
_T_BIGINT = 12

_INT64_MIN, _INT64_MAX = -(2**63), 2**63 - 1


def save(s: Any, obj: Any) -> None:
    """Serialize ``obj`` to stream ``s`` (reference ``Stream::Write<T>`` `io.h:428`)."""
    if obj is None:
        s.write(bytes([_T_NONE]))
    elif isinstance(obj, bool):
        s.write(bytes([_T_BOOL, 1 if obj else 0]))
    elif isinstance(obj, int):
        if _INT64_MIN <= obj <= _INT64_MAX:
            s.write(bytes([_T_INT]))
            write_int64(s, obj)
        else:
            # arbitrary-precision fallback: sign byte + length-prefixed magnitude
            b = abs(obj).to_bytes((abs(obj).bit_length() + 7) // 8, "little")
            s.write(bytes([_T_BIGINT, 1 if obj < 0 else 0]))
            write_uint64(s, len(b))
            s.write(b)
    elif isinstance(obj, float):
        s.write(bytes([_T_FLOAT]))
        write_float64(s, obj)
    elif isinstance(obj, str):
        s.write(bytes([_T_STR]))
        write_string(s, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        s.write(bytes([_T_BYTES]))
        write_uint64(s, len(b))
        s.write(b)
    elif isinstance(obj, list):
        s.write(bytes([_T_LIST]))
        write_uint64(s, len(obj))
        for x in obj:
            save(s, x)
    elif isinstance(obj, tuple):
        s.write(bytes([_T_TUPLE]))
        write_uint64(s, len(obj))
        for x in obj:
            save(s, x)
    elif isinstance(obj, (set, frozenset)):
        s.write(bytes([_T_SET]))
        write_uint64(s, len(obj))
        # deterministic ordering for byte-stable output
        for x in sorted(obj, key=repr):
            save(s, x)
    elif isinstance(obj, dict):
        s.write(bytes([_T_DICT]))
        write_uint64(s, len(obj))
        for k, v in obj.items():
            save(s, k)
            save(s, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise DMLCError(
                "cannot serialize object-dtype ndarray; convert to a POD dtype first")
        # contiguous little-endian payload: dtype-str, ndim, shape, raw bytes
        arr = np.ascontiguousarray(obj)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        s.write(bytes([_T_NDARRAY]))
        write_string(s, arr.dtype.str)
        write_uint32(s, arr.ndim)
        for d in arr.shape:
            write_uint64(s, d)
        write_uint64(s, arr.nbytes)
        s.write(arr.tobytes())
    elif hasattr(obj, "save") and callable(obj.save):
        # Serializable classes (reference io.h:112, serializer.h:81): type must
        # be reconstructible by the caller; we store the class path for checking.
        s.write(bytes([_T_SAVELOAD]))
        write_string(s, f"{type(obj).__module__}.{type(obj).__qualname__}")
        obj.save(s)
    else:
        raise DMLCError(f"cannot serialize object of type {type(obj).__name__}")


def load(s: Any, obj: Any = None) -> Any:
    """Deserialize one value.  If ``obj`` is given and the tag is SAVELOAD,
    loads into ``obj`` via ``obj.load(stream)`` and returns it."""
    tag = _read_exact(s, 1)[0]
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return _read_exact(s, 1)[0] != 0
    if tag == _T_INT:
        return read_int64(s)
    if tag == _T_FLOAT:
        return read_float64(s)
    if tag == _T_STR:
        return read_string(s)
    if tag == _T_BYTES:
        return _read_exact(s, read_uint64(s))
    if tag in (_T_LIST, _T_TUPLE, _T_SET):
        n = read_uint64(s)
        items = [load(s) for _ in range(n)]
        if tag == _T_TUPLE:
            return tuple(items)
        if tag == _T_SET:
            return set(items)
        return items
    if tag == _T_DICT:
        n = read_uint64(s)
        out = {}
        for _ in range(n):
            k = load(s)
            out[k] = load(s)
        return out
    if tag == _T_NDARRAY:
        dtype = np.dtype(read_string(s))
        ndim = read_uint32(s)
        shape = tuple(read_uint64(s) for _ in range(ndim))
        nbytes = read_uint64(s)
        return np.frombuffer(_read_exact(s, nbytes), dtype=dtype).reshape(shape).copy()
    if tag == _T_BIGINT:
        neg = _read_exact(s, 1)[0] != 0
        n = read_uint64(s)
        v = int.from_bytes(_read_exact(s, n), "little")
        return -v if neg else v
    if tag == _T_SAVELOAD:
        cls_path = read_string(s)
        if obj is None:
            raise DMLCError(
                f"stream holds a Serializable of type {cls_path}; pass an "
                f"instance via load(stream, obj) to receive it")
        obj.load(s)
        return obj
    raise DMLCError(f"corrupt stream: unknown type tag {tag}")
