"""In-memory streams.

Counterpart of ``dmlc_core_tpu/utils/memory_io.py``, kept as a copy so
that the port imports nothing of the JAX package:

* :class:`MemoryFixedSizeStream` — read/write over a caller-owned fixed
  buffer (a ``memoryview``/``bytearray``); writing past the end raises;
* :class:`MemoryStringStream` — a growable stream over an owned buffer;
  ``value`` holds the bytes written so far.

Both satisfy the binary-stream contract the serializer and
``RowBlockContainer.save``/``load`` use.
"""

from __future__ import annotations

import io
import os

from .logging import check

__all__ = ["MemoryFixedSizeStream", "MemoryStringStream"]


class MemoryFixedSizeStream(io.RawIOBase):
    """Stream over a fixed caller buffer (`memory_io.h:21-60`)."""

    def __init__(self, buffer) -> None:
        super().__init__()
        self._buf = memoryview(buffer)
        self._pos = 0

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return not self._buf.readonly

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            new = offset
        elif whence == os.SEEK_CUR:
            new = self._pos + offset
        elif whence == os.SEEK_END:
            new = len(self._buf) + offset
        else:
            raise ValueError(f"bad whence {whence}")
        check(0 <= new <= len(self._buf),
              f"seek {new} outside fixed buffer of {len(self._buf)}")
        self._pos = new
        return self._pos

    def readinto(self, b) -> int:
        n = min(len(b), len(self._buf) - self._pos)
        b[:n] = self._buf[self._pos:self._pos + n]
        self._pos += n
        return n

    def write(self, b) -> int:
        check(not self._buf.readonly, "stream over a readonly buffer")
        # reference CHECKs the write fits (`memory_io.h:38`)
        check(self._pos + len(b) <= len(self._buf),
              f"write of {len(b)} at {self._pos} overflows fixed buffer "
              f"of {len(self._buf)}")
        self._buf[self._pos:self._pos + len(b)] = b
        self._pos += len(b)
        return len(b)


class MemoryStringStream(io.BytesIO):
    """Growable in-memory stream (`memory_io.h:66-103`)."""

    @property
    def value(self) -> bytes:
        return self.getvalue()
