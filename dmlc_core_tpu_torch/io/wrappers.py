"""InputSplit wrappers: prefetch on a thread, the raw-chunk cache, and
the epoch shuffle.

Counterpart of ``dmlc_core_tpu/io/wrappers.py`` (the reference's
``threaded_input_split.h``, ``cached_input_split.h`` and
``input_split_shuffle.h``), kept as a copy so that the port imports
nothing of the JAX package.  Each wraps any split and keeps its
interface.  One difference: :class:`ThreadedInputSplit` starts its
thread at the first chunk asked for, not at construction, so a
``hint_chunk_size`` made after construction still applies (the port's
``TextParser.chunk_bytes``), and a split that is never read starts no
thread.
"""

from __future__ import annotations

import os
import random
import struct
from typing import List, Optional

from ..utils.logging import DMLCError, check
from ..utils.threaded_iter import ThreadedIter
from .input_split import InputSplit

__all__ = ["ThreadedInputSplit", "CachedInputSplit", "ShuffleInputSplit"]


class ThreadedInputSplit(InputSplit):
    """Chunk prefetch on a background thread (queue of ``max_capacity``
    chunks; ``create_input_split`` applies it by default).  The thread
    starts at the first :meth:`next_chunk`."""

    def __init__(self, base: InputSplit, max_capacity: int = 2):
        self.base = base
        self.max_capacity = max_capacity
        self._iter: Optional[ThreadedIter] = None
        self._reset_record_iter()

    def _started(self) -> ThreadedIter:
        if self._iter is None:
            self._iter = ThreadedIter(max_capacity=self.max_capacity)
            self._iter.init(lambda _cell: self.base.next_chunk(),
                            self.base.before_first, name="dmlc-split")
        return self._iter

    def extract_records(self, chunk, pos):
        return self.base.extract_records(chunk, pos)

    def next_chunk(self) -> Optional[bytes]:
        return self._started().next()

    def next_record(self) -> Optional[bytes]:
        return self._next_record_via(self.next_chunk, self.base.extract_records)

    def before_first(self) -> None:
        if self._iter is None:
            self.base.before_first()
        else:
            self._iter.before_first()
        self._reset_record_iter()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        # quiesce the producer, repartition the base, restart lazily
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None
        self.base.reset_partition(part_index, num_parts)
        self._reset_record_iter()

    def hint_chunk_size(self, chunk_size: int) -> None:
        self.base.hint_chunk_size(chunk_size)

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None
        self.base.close()


class CachedInputSplit(InputSplit):
    """First epoch streams chunks to a local cache file while serving them;
    later epochs replay the cache (reference `cached_input_split.h:148-189`).

    The cache is a simple length-prefixed chunk log.  Crash safety: the
    first pass writes ``<cache>.tmp.<pid>`` and atomically renames it into
    place before dropping the ``.done`` finalize marker, so a killed run
    leaves no half-written cache under the real name; framing is
    re-validated on open, so a truncated or corrupt survivor is discarded
    and rebuilt from the source instead of silently truncating the epoch.
    ``reset_partition`` is unsupported, as in the reference
    (`cached_input_split.h:87`).
    """

    def __init__(self, base: InputSplit, cache_file: str):
        self.base = base
        self.cache_file = cache_file
        self._tmp_file = f"{cache_file}.tmp.{os.getpid()}"
        self._cache_complete = (os.path.exists(cache_file + ".done")
                                and self._validate_cache())
        if not self._cache_complete:
            self._discard_cache()
        self._writer = None if self._cache_complete \
            else open(self._tmp_file, "wb")
        self._reader = None
        self._first_epoch = not self._cache_complete
        self._reset_record_iter()

    def _validate_cache(self) -> bool:
        """Walk the length-prefixed framing end to end; a short read or an
        out-of-bounds length means a damaged cache."""
        try:
            size = os.path.getsize(self.cache_file)
            with open(self.cache_file, "rb") as f:
                pos = 0
                while pos < size:
                    head = f.read(8)
                    if len(head) < 8:
                        return False
                    (n,) = struct.unpack("<Q", head)
                    pos += 8 + n
                    if pos > size:
                        return False
                    f.seek(n, 1)
            return True
        except OSError:
            return False

    def _discard_cache(self) -> None:
        # the marker goes first: if unlink dies between the two, a marker
        # without a cache file fails validation next open, not this order
        for path in (self.cache_file + ".done", self.cache_file):
            try:
                os.unlink(path)
            except OSError:
                pass

    def next_chunk(self) -> Optional[bytes]:
        if self._first_epoch:
            chunk = self.base.next_chunk()
            if chunk is None:
                self._finish_cache()
                return None
            self._writer.write(struct.pack("<Q", len(chunk)))
            self._writer.write(chunk)
            return chunk
        if self._reader is None:
            self._reader = open(self.cache_file, "rb")
        head = self._reader.read(8)
        if len(head) < 8:
            return None
        (n,) = struct.unpack("<Q", head)
        data = self._reader.read(n)
        if len(data) != n:
            raise DMLCError(f"corrupt input-split cache {self.cache_file}")
        return data

    def extract_records(self, chunk, pos):
        return self.base.extract_records(chunk, pos)

    def next_record(self) -> Optional[bytes]:
        return self._next_record_via(self.next_chunk, self.base.extract_records)

    def _finish_cache(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            os.fsync(self._writer.fileno())
            self._writer.close()
            self._writer = None
            os.replace(self._tmp_file, self.cache_file)
            with open(self.cache_file + ".done", "w") as f:
                f.write("ok")
        self._cache_complete = True
        self._first_epoch = False

    def before_first(self) -> None:
        self._reset_record_iter()
        if self._first_epoch and not self._cache_complete:
            # restart an incomplete first pass from the source
            self.base.before_first()
            if self._writer is not None:
                self._writer.close()
            self._writer = open(self._tmp_file, "wb")
            return
        self._first_epoch = False
        if self._reader is not None:
            self._reader.close()
        self._reader = None

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise DMLCError("CachedInputSplit does not support ResetPartition "
                        "(reference cached_input_split.h:87)")

    def hint_chunk_size(self, chunk_size: int) -> None:
        self.base.hint_chunk_size(chunk_size)

    def close(self) -> None:
        if self._writer is not None:
            # incomplete first pass: drop the partial tmp file — a future
            # open must rebuild from the source, not trust half a log
            self._writer.close()
            self._writer = None
            try:
                os.unlink(self._tmp_file)
            except OSError:
                pass
        if self._reader is not None:
            self._reader.close()
        self.base.close()


class ShuffleInputSplit(InputSplit):
    """Global shuffle by over-partitioning (reference `input_split_shuffle.h:18-137`).

    Each real partition is split into ``num_shuffle_parts`` sub-parts; every
    epoch visits the sub-parts in a seeded random order re-drawn per epoch
    (reference reshuffle in BeforeFirst `input_split_shuffle.h:23-32`).
    """

    def __init__(self, base: InputSplit, part_index: int, num_parts: int,
                 num_shuffle_parts: int = 16, seed: int = 0):
        check(num_shuffle_parts >= 1, "num_shuffle_parts must be >= 1")
        self.base = base
        self.part_index = part_index
        self.num_parts = num_parts
        self.num_shuffle_parts = num_shuffle_parts
        self._rng = random.Random(seed)
        self._order: List[int] = []
        self._order_pos = 0
        self._active = False
        self._reshuffle()

    def _sub_part(self, i: int) -> int:
        return self.part_index * self.num_shuffle_parts + i

    def _reshuffle(self) -> None:
        self._order = list(range(self.num_shuffle_parts))
        self._rng.shuffle(self._order)
        self._order_pos = 0
        self._active = False

    def _advance(self) -> bool:
        if self._order_pos >= len(self._order):
            return False
        sub = self._order[self._order_pos]
        self._order_pos += 1
        self.base.reset_partition(self._sub_part(sub),
                                  self.num_parts * self.num_shuffle_parts)
        self._active = True
        return True

    def next_record(self) -> Optional[bytes]:
        while True:
            if self._active:
                rec = self.base.next_record()
                if rec is not None:
                    return rec
                self._active = False
            if not self._advance():
                return None

    def next_chunk(self) -> Optional[bytes]:
        while True:
            if self._active:
                chunk = self.base.next_chunk()
                if chunk is not None:
                    return chunk
                self._active = False
            if not self._advance():
                return None

    def before_first(self) -> None:
        # a fresh permutation each epoch comes from advancing self._rng state
        self._reshuffle()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self.part_index, self.num_parts = part_index, num_parts
        self._reshuffle()

    def extract_records(self, chunk, pos):
        return self.base.extract_records(chunk, pos)

    def hint_chunk_size(self, chunk_size: int) -> None:
        self.base.hint_chunk_size(chunk_size)

    def close(self) -> None:
        self.base.close()
