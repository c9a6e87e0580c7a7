"""Indexed recordio split: partitions by record count, with an optional
shuffle of the records each epoch.

Counterpart of ``dmlc_core_tpu/io/indexed_recordio_split.py`` (the
reference's ``src/io/indexed_recordio_split.{h,cc}``): a text index of
``key offset`` lines (:func:`write_recordio_index` writes one), the
records cut evenly by count into parts, batched reads, and with
``shuffle`` a permutation from ``np.random.default_rng(seed + epoch)``
each epoch, so the order matches the JAX package's for the same seed.
"""

from __future__ import annotations

import numpy as np
from typing import List, Optional, Tuple

from ..utils.logging import DMLCError, check
from .filesys import get_filesystem, open_stream
from .input_split import InputSplit, expand_uris
from .recordio import RecordIOReader
from .uri import URI

__all__ = ["IndexedRecordIOSplit", "write_recordio_index"]


def write_recordio_index(rec_uri: str, index_uri: str) -> int:
    """Build a ``key offset`` index file for a recordio file (utility the
    reference assumes exists; format per `indexed_recordio_split.cc:43-61`)."""
    n = 0
    with open_stream(rec_uri, "r") as f, open_stream(index_uri, "w") as out:
        reader = RecordIOReader(f)
        while True:
            offset = f.tell()
            rec = reader.next_record()
            if rec is None:
                break
            out.write(f"{n} {offset}\n".encode())
            n += 1
    return n


class IndexedRecordIOSplit(InputSplit):
    """Record-count partitioning over an indexed recordio file."""

    def __init__(self, uri: str, index_uri: str, part_index: int,
                 num_parts: int, shuffle: bool = False, seed: int = 0,
                 batch_size: int = 256):
        self.uri = uri
        self.files = expand_uris(uri)
        check(len(self.files) == 1,
              "IndexedRecordIOSplit supports a single recordio file per index")
        self._fs = get_filesystem(URI(self.files[0].path))
        self._stream = self._fs.open_for_read(URI(self.files[0].path))
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size
        self._epoch = 0
        # index: offsets[i] = byte offset of record i (reference ReadIndexFile)
        offsets: List[Tuple[int, int]] = []
        with open_stream(index_uri, "r") as f:
            for line in f.read().decode().splitlines():
                parts = line.split()
                if not parts:
                    continue
                if len(parts) < 2:
                    raise DMLCError(f"bad index line {line!r}")
                offsets.append((int(parts[0]), int(parts[1])))
        offsets.sort()
        self._offsets = np.array([o for _, o in offsets], dtype=np.int64)
        self.num_records_total = len(self._offsets)
        self.reset_partition(part_index, num_parts)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check(0 <= part_index < num_parts,
              f"bad partition {part_index}/{num_parts}")
        # partition by record count (reference .cc:12-41)
        n = self.num_records_total
        step = (n + num_parts - 1) // num_parts
        self._rec_begin = min(step * part_index, n)
        self._rec_end = min(step * (part_index + 1), n)
        self.part_index, self.num_parts = part_index, num_parts
        self._epoch = 0
        self.before_first()

    def before_first(self) -> None:
        self._perm = np.arange(self._rec_begin, self._rec_end, dtype=np.int64)
        if self.shuffle:
            # fresh permutation every epoch (reference .cc:220-232)
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(self._perm)
        self._epoch += 1
        self._pos = 0

    def _read_record_at(self, rec_idx: int) -> bytes:
        self._stream.seek(int(self._offsets[rec_idx]))
        reader = RecordIOReader(self._stream)
        rec = reader.next_record()
        if rec is None:
            raise DMLCError(f"indexed recordio: empty record at index {rec_idx}")
        return rec

    def next_record(self) -> Optional[bytes]:
        if self._pos >= len(self._perm):
            return None
        rec = self._read_record_at(int(self._perm[self._pos]))
        self._pos += 1
        return rec

    def next_batch(self, n: Optional[int] = None) -> Optional[List[bytes]]:
        """Batched read (reference NextBatchEx .cc:158-211)."""
        n = n or self.batch_size
        out: List[bytes] = []
        while len(out) < n:
            rec = self.next_record()
            if rec is None:
                break
            out.append(rec)
        return out or None

    def next_chunk(self) -> Optional[bytes]:
        batch = self.next_batch()
        if batch is None:
            return None
        # re-frame as a plain recordio blob so chunk consumers can parse it
        import io as _io
        from .recordio import RecordIOWriter
        buf = _io.BytesIO()
        w = RecordIOWriter(buf)
        for rec in batch:
            w.write_record(rec)
        return buf.getvalue()

    def close(self) -> None:
        self._stream.close()
