"""Line records from stdin or one file, unpartitioned.

Counterpart of ``dmlc_core_tpu/io/single_file_split.py`` (the
reference's ``src/io/single_file_split.h``), chosen for ``stdin://`` and
``-``: its own 256 KB buffering, records split on ``\\n`` and ``\\r``
runs, no partitioning, no rewind of stdin.
"""

from __future__ import annotations

import sys
from typing import Optional

from ..utils.logging import DMLCError
from .filesys import open_stream
from .input_split import InputSplit

__all__ = ["SingleFileSplit"]


class SingleFileSplit(InputSplit):
    """Sequential line records from stdin or one file; no partitioning."""

    BUFFER_SIZE = 256 << 10  # reference uses 256KB (`single_file_split.h:91`)

    def __init__(self, uri: str):
        self.uri = uri
        self._stream = None
        self._open()

    def _open(self):
        if self._stream is not None and self._stream is not sys.stdin.buffer:
            self._stream.close()
        if self.uri in ("stdin://", "-", ""):
            self._stream = sys.stdin.buffer
        else:
            self._stream = open_stream(self.uri, "r")
        self._buf = b""
        self._pos = 0  # cursor into _buf; _buf is only rebuilt on refill
        self._eof = False

    @staticmethod
    def _find_nl(data: bytes, pos: int) -> int:
        ln = data.find(b"\n", pos)
        lr = data.find(b"\r", pos)
        if ln < 0:
            return lr
        if lr < 0:
            return ln
        return min(ln, lr)

    def next_record(self) -> Optional[bytes]:
        while True:
            # skip leading newline run
            n = len(self._buf)
            while self._pos < n and self._buf[self._pos] in (0x0A, 0x0D):
                self._pos += 1
            nl = self._find_nl(self._buf, self._pos)
            if nl >= 0:
                rec = self._buf[self._pos:nl]
                self._pos = nl + 1
                if rec:
                    return rec
                continue
            if self._eof:
                if self._pos < n:
                    rec = self._buf[self._pos:]
                    self._pos = n
                    return rec
                return None
            data = self._stream.read(self.BUFFER_SIZE)
            if not data:
                self._eof = True
            else:
                self._buf = self._buf[self._pos:] + data
                self._pos = 0

    def next_chunk(self) -> Optional[bytes]:
        recs = []
        total = 0
        while total < self.BUFFER_SIZE:
            r = self.next_record()
            if r is None:
                break
            recs.append(r)
            total += len(r) + 1
        if not recs:
            return None
        return b"\n".join(recs) + b"\n"

    def before_first(self) -> None:
        if self._stream is sys.stdin.buffer:
            raise DMLCError("cannot rewind stdin")
        self._open()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        if num_parts != 1:
            raise DMLCError("SingleFileSplit does not support partitioning")

    def close(self) -> None:
        if self._stream is not None and self._stream is not sys.stdin.buffer:
            self._stream.close()
