"""RowBlock iterators: the whole data set in memory, or replayed from an
on-disk block cache.

Counterpart of ``dmlc_core_tpu/data/iterators.py`` (the reference's
``basic_row_iter.h``, ``disk_row_iter.h`` and ``RowBlockIter::Create``):

* :class:`BasicRowIter` parses everything at construction and yields it
  as one block;
* :class:`DiskRowIter` parses once into pages of about ``page_size``
  bytes, each a ``RowBlockContainer.save`` stream appended to the cache
  file, with a ``.meta`` file written last (its presence marks the cache
  complete), then replays the pages each epoch on a thread.  The files
  are the JAX package's byte for byte, so either package replays the
  other's cache;
* :func:`create_row_block_iter` picks the disk iterator when the URI has
  a ``#cachefile`` fragment.

The JAX package's MB/s progress lines are left out; one line at the end
says what was read.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

from ..io import URISpec
from ..utils import serializer as ser
from ..utils.logging import check, log_info
from ..utils.threaded_iter import ThreadedIter
from .parser import create_parser
from .row_block import RowBlock, RowBlockContainer

__all__ = ["RowBlockIter", "BasicRowIter", "DiskRowIter",
           "create_row_block_iter"]


class RowBlockIter:
    """Pull-iterator of RowBlocks."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next_block(self) -> Optional[RowBlock]:
        raise NotImplementedError

    @property
    def num_col(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BasicRowIter(RowBlockIter):
    """The whole data set parsed into memory at construction, served as
    one block."""

    def __init__(self, parser) -> None:
        self.container = RowBlockContainer()
        t0 = time.monotonic()
        for blk in parser:
            self.container.push_block(blk)
        parser.close()
        secs = time.monotonic() - t0
        mb = parser.bytes_read / (1 << 20)
        log_info("%.2f MB read in %.2f sec, %.2f MB/sec, %d rows",
                 mb, secs, mb / max(secs, 1e-9), self.container.size)
        self._done = False

    def before_first(self) -> None:
        self._done = False

    def next_block(self) -> Optional[RowBlock]:
        if self._done:
            return None
        self._done = True
        return self.container.get_block()

    @property
    def num_col(self) -> int:
        return self.container.get_block().num_col


class DiskRowIter(RowBlockIter):
    """Parse once into pages of a cache file; each epoch replays them on
    a prefetch thread."""

    PAGE_SIZE = 64 << 20

    def __init__(self, parser, cache_file: str,
                 page_size: int = PAGE_SIZE) -> None:
        self.cache_file = cache_file
        self.page_size = page_size
        self._meta = None
        if os.path.exists(cache_file + ".meta"):
            self._load_meta()
        else:
            check(parser is not None, "no cache and no parser given")
            self._build_cache(parser)
            parser.close()
        self._iter: Optional[ThreadedIter] = None
        self.before_first()

    def _build_cache(self, parser) -> None:
        num_col = 0
        max_field = 0
        nrows = 0
        npages = 0
        tmp_cache = self.cache_file + ".tmp"
        with open(tmp_cache, "wb") as f:
            page = RowBlockContainer()
            page_bytes = 0

            def flush():
                nonlocal npages, page_bytes, page
                if page.size == 0:
                    return
                page.save(f)
                npages += 1
                page = RowBlockContainer()
                page_bytes = 0

            for blk in parser:
                nrows += blk.size
                num_col = max(num_col, blk.num_col)
                max_field = max(max_field, blk.max_field)
                # slice incoming blocks so pages honor page_size even when
                # one parsed chunk is larger than a page
                per_row = max(1, blk.memcost_bytes() // max(blk.size, 1))
                start = 0
                while start < blk.size:
                    room = max(1, (self.page_size - page_bytes) // per_row)
                    end = min(blk.size, start + room)
                    sub = blk.slice(start, end)
                    page.push_block(sub)
                    page_bytes += sub.memcost_bytes()
                    start = end
                    if page_bytes >= self.page_size:
                        flush()
            flush()
        self._meta = {"num_col": num_col, "max_field": max_field,
                      "nrows": nrows, "npages": npages}
        # a crash mid-build must leave no .meta: its existence is what
        # marks the cache reusable on the next run
        os.replace(tmp_cache, self.cache_file)
        tmp_meta = self.cache_file + ".meta.tmp"
        with open(tmp_meta, "wb") as f:
            ser.save(f, self._meta)
        os.replace(tmp_meta, self.cache_file + ".meta")
        log_info("disk cache built: %d rows, %d pages → %s",
                 nrows, npages, self.cache_file)

    def _load_meta(self) -> None:
        with open(self.cache_file + ".meta", "rb") as f:
            self._meta = ser.load(f)

    def _page_reader(self):
        with open(self.cache_file, "rb") as f:
            for _ in range(self._meta["npages"]):
                c = RowBlockContainer()
                c.load(f)
                yield c.get_block()

    def before_first(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        self._iter = ThreadedIter.from_iterable_factory(
            self._page_reader, max_capacity=2)

    def next_block(self) -> Optional[RowBlock]:
        return self._iter.next()

    @property
    def num_col(self) -> int:
        return self._meta["num_col"]

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None


def create_row_block_iter(uri: str, part_index: int = 0, num_parts: int = 1,
                          parser_type: str = "auto") -> RowBlockIter:
    """The in-memory iterator, or the disk-cached one when the URI has a
    ``#cachefile`` fragment."""
    spec = URISpec(uri, part_index, num_parts)
    if spec.cache_file is not None:
        base_uri = spec.uri + ("?" + "&".join(
            f"{k}={v}" for k, v in spec.args.items()) if spec.args else "")
        if os.path.exists(spec.cache_file + ".meta"):
            return DiskRowIter(None, spec.cache_file)
        parser = create_parser(base_uri, part_index, num_parts, parser_type)
        return DiskRowIter(parser, spec.cache_file)
    parser = create_parser(uri, part_index, num_parts, parser_type)
    return BasicRowIter(parser)
