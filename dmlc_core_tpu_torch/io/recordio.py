"""The recordio codec.

Counterpart of ``dmlc_core_tpu/io/recordio.py`` (the reference's
``include/dmlc/recordio.h`` and ``src/recordio.cc``), kept as a copy so
that the port imports nothing of the JAX package.  Each record is
framed as::

    [u32 kMagic][u32 lrec] payload [zero-pad to 4-byte alignment]

with ``lrec = cflag << 29 | length`` and ``kMagic = 0xced7230a``.  The
writer escapes any 4-aligned magic word inside a payload by splitting
the record into multi-part frames (cflag 1 = start, 2 = middle, 3 =
end; the removed magic word is put back between the parts on read), so
a reader dropped at any 4-aligned offset finds the next frame by its
magic word.  The frames are byte-identical to the JAX package's.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

from ..utils.logging import DMLCError, check
from .filesys import read_full

__all__ = [
    "KMAGIC", "encode_lrec", "decode_lrec",
    "RecordIOWriter", "RecordIOReader", "RecordIOChunkReader",
]

KMAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", KMAGIC)
_MAX_LEN = (1 << 29) - 1


def encode_lrec(cflag: int, length: int) -> int:
    """Reference ``EncodeLRec`` (`recordio.h:52`)."""
    check(length < 1 << 29, "recordio record too long")
    return (cflag << 29) | length


def decode_lrec(lrec: int) -> Tuple[int, int]:
    """Return (cflag, length) (reference ``DecodeFlag``/``DecodeLength`` `recordio.h:58-66`)."""
    return lrec >> 29, lrec & _MAX_LEN


def _aligned_magic_positions(data: bytes) -> np.ndarray:
    """4-aligned offsets where the magic word occurs inside ``data``."""
    lower = len(data) & ~3
    if lower == 0:
        return np.empty(0, dtype=np.int64)
    words = np.frombuffer(data, dtype="<u4", count=lower // 4)
    return (np.nonzero(words == KMAGIC)[0] * 4).astype(np.int64)


class RecordIOWriter:
    """Frame writer with magic escaping (reference `recordio.h:38`, `src/recordio.cc:11-51`)."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream
        self.except_counter = 0  # count of escaped magic collisions (`recordio.h:85`)

    def write_record(self, data: bytes) -> None:
        check(len(data) < 1 << 29, "recordio record too long")
        positions = _aligned_magic_positions(data)
        dptr = 0
        parts: List[bytes] = []
        for i in map(int, positions):
            cflag = 1 if dptr == 0 else 2
            parts.append(_MAGIC_BYTES)
            parts.append(struct.pack("<I", encode_lrec(cflag, i - dptr)))
            parts.append(data[dptr:i])
            dptr = i + 4
            self.except_counter += 1
        cflag = 3 if dptr != 0 else 0
        parts.append(_MAGIC_BYTES)
        parts.append(struct.pack("<I", encode_lrec(cflag, len(data) - dptr)))
        parts.append(data[dptr:])
        pad = (-(len(data) - dptr)) & 3
        if pad:
            parts.append(b"\x00" * pad)
        self.stream.write(b"".join(parts))


def _read_frame(read_exact) -> Optional[Tuple[int, bytes]]:
    """Read one frame: returns (cflag, content) or None at EOF."""
    head = read_exact(4, allow_eof=True)
    if head is None:
        return None
    if head != _MAGIC_BYTES:
        raise DMLCError(
            f"recordio: bad magic {head!r} (corrupt stream or unaligned read)")
    lrec = struct.unpack("<I", read_exact(4))[0]
    cflag, length = decode_lrec(lrec)
    upper = (length + 3) & ~3
    buf = read_exact(upper)
    return cflag, buf[:length]


class RecordIOReader:
    """Sequential reader rejoining multi-part records
    (reference ``RecordIOReader::NextRecord`` `src/recordio.cc:53+`)."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream

    def _read_exact(self, n: int, allow_eof: bool = False) -> Optional[bytes]:
        b = read_full(self.stream, n)
        if not b and allow_eof:
            return None
        if len(b) != n:
            raise DMLCError(f"recordio: truncated stream (wanted {n}, got {len(b)})")
        return b

    def next_record(self) -> Optional[bytes]:
        frame = _read_frame(self._read_exact)
        if frame is None:
            return None
        cflag, content = frame
        if cflag == 0:
            return content
        if cflag != 1:
            raise DMLCError(f"recordio: unexpected continuation frame (cflag={cflag})")
        # multi-part record: rejoin with the escaped magic re-inserted
        parts = [content]
        while True:
            frame = _read_frame(self._read_exact)
            if frame is None:
                raise DMLCError("recordio: EOF inside multi-part record")
            cflag, content = frame
            if cflag not in (2, 3):
                raise DMLCError(f"recordio: bad multi-part cflag {cflag}")
            parts.append(_MAGIC_BYTES)
            parts.append(content)
            if cflag == 3:
                return b"".join(parts)

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


class RecordIOChunkReader:
    """Parse records out of an in-memory blob of whole frames, optionally only
    a [part_index/num_parts] sub-range split at frame boundaries
    (reference ``RecordIOChunkReader`` `recordio.h:166-187`).

    The blob must start at a frame boundary (as produced by the recordio
    InputSplit).  Sub-range boundaries are found by scanning for aligned magic
    words with cflag ∈ {0, 1} — valid because written content never contains
    aligned magic.
    """

    def __init__(self, blob: bytes, part_index: int = 0, num_parts: int = 1):
        check(num_parts >= 1, "num_parts must be >= 1")
        if num_parts == 1:
            begin, end = 0, len(blob)
        else:
            nstep = (len(blob) + num_parts - 1) // num_parts
            pbegin = min(nstep * part_index, len(blob))
            pend = min(nstep * (part_index + 1), len(blob))
            begin = _seek_record_boundary(blob, pbegin)
            end = _seek_record_boundary(blob, pend)
        self._view = memoryview(blob)[begin:end]
        self._pos = 0

    def _read_exact(self, n: int, allow_eof: bool = False) -> Optional[bytes]:
        if self._pos >= len(self._view) and allow_eof:
            return None
        if self._pos + n > len(self._view):
            raise DMLCError("recordio chunk: truncated frame")
        out = bytes(self._view[self._pos:self._pos + n])
        self._pos += n
        return out

    def next_record(self) -> Optional[bytes]:
        return RecordIOReader.next_record(self)  # type: ignore[arg-type]

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def _seek_record_boundary(blob: bytes, pos: int) -> int:
    """First offset >= pos (4-aligned) holding a frame header with cflag∈{0,1}
    (the scan the reference runs in `src/io/recordio_split.cc:9-42`)."""
    pos = (pos + 3) & ~3
    n = len(blob)
    while pos + 8 <= n:
        if blob[pos:pos + 4] == _MAGIC_BYTES:
            lrec = struct.unpack("<I", blob[pos + 4:pos + 8])[0]
            cflag, _ = decode_lrec(lrec)
            if cflag in (0, 1):
                return pos
        pos += 4
    return n
