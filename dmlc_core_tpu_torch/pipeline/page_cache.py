"""The packed-page epoch cache: the loader's fused wire buffers kept on
disk, so epochs from the second on skip reading, parsing and packing.

Counterpart of ``dmlc_core_tpu/pipeline/page_cache.py``, in the same
``DMLCPGC1`` format, so a page file written by either package's loader
is served by the other's.  One file per loader part, at
``<#cachefile fragment>.pages`` (:func:`page_path`; the fragment itself
names ``CachedInputSplit``'s raw-chunk log, so both caches can sit on
one URI)::

    [file header]  magic "DMLCPGC1" + u64 json length + fingerprint JSON
    [page]*        16-aligned: (meta u64, words u32, rows u32) + payload
    [index]        u64 page offsets  x npages
    [footer]       (index offset u64, npages u64, version u64, "DMLCPGE1")

The footer is written last, into ``<path>.tmp.<pid>``, which is fsync'd
and renamed into place, so a killed first epoch leaves nothing under the
real name, and an unfinished or truncated file never validates.  The
fingerprint JSON (the source files with their sizes and mtimes, the
part, and the whole pack configuration) must match exactly, or the file
is rebuilt and never served.

Writer: the first epoch is served from the normal pipeline while a
thread writes each fused buffer through a bounded queue
(``queue_pages``, 8 by default); a full queue or a write error drops the
build, never the epoch.  Each page crosses the ``page_cache.write``
fault point (:mod:`..utils.faults`) before it is written.  Reader: the file is mapped (``MADV_SEQUENTIAL``,
with a ``MADV_WILLNEED`` window of ``readahead`` pages, 2 by default)
and each page is a read-only int32 view of the map; the loader copies
views into its own buffers and never recycles one.

Left out: the JAX package's ``DMLC_PAGE_CACHE_QUEUE`` /
``DMLC_PAGE_CACHE_READAHEAD`` environment knobs (the loader's
``cache_queue_pages`` / ``cache_readahead`` arguments remain) and the
reader's descriptor-passing constructor (ROADMAP A.11.b).
"""

from __future__ import annotations

import json
import mmap
import os
import queue
import struct
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from ..utils.faults import fault_point
from ..utils.logging import log_info, log_warning

__all__ = ["FORMAT_VERSION", "PageCacheError", "PageCacheWriter",
           "PageCacheReader", "open_reader", "page_path", "page_file_info"]

DEFAULT_QUEUE_PAGES = 8
DEFAULT_READAHEAD = 2

FORMAT_VERSION = 1
_FILE_MAGIC = b"DMLCPGC1"
_FOOT_MAGIC = b"DMLCPGE1"
_HEAD = struct.Struct("<8sQ")      # file magic, fingerprint JSON bytes
_PAGE = struct.Struct("<QII")      # meta u64, words u32, rows u32
_FOOT = struct.Struct("<QQQ8s")    # index offset, npages, version, magic
_ALIGN = 16
_NO_ROWS = 0xFFFFFFFF              # rows unknown (native packer pages)


def page_path(cache_file: str) -> str:
    """Page-file path derived from a ``#cachefile`` fragment path.  Distinct
    from the fragment path itself, which ``CachedInputSplit`` owns for its
    raw-chunk log — both caches can coexist on one URI."""
    return f"{cache_file}.pages"


def _fingerprint_bytes(fingerprint: dict) -> bytes:
    return json.dumps(fingerprint, sort_keys=True).encode("utf-8")


class PageCacheError(Exception):
    """A page file failed validation (truncated, unfinalized, corrupt)."""


class _Cancelled(Exception):
    pass


class PageCacheWriter:
    """Background write-through writer of one page file.

    ``offer()`` is the only hot-path call: one copy of the fused payload
    into a bounded queue (the caller's buffer is pool-recycled, so the
    writer must own its bytes).  Everything else — open, page writes,
    index, footer, fsync, atomic rename — happens on the writer thread.
    """

    def __init__(self, path: str, fingerprint: dict,
                 queue_pages: int = 0):
        self.path = path
        self._tmp = f"{path}.tmp.{os.getpid()}"
        self._header = _fingerprint_bytes(fingerprint)
        cap = int(queue_pages) or DEFAULT_QUEUE_PAGES
        self._q: queue.Queue = queue.Queue(max(2, cap))
        self._dead = threading.Event()
        self._finalized = False
        self.error: Optional[BaseException] = None
        self.pages = 0
        self._thread = threading.Thread(target=self._run,
                                        name="page-cache-writer",
                                        daemon=True)
        self._thread.start()

    @property
    def active(self) -> bool:
        """False once the build is dropped (backpressure or write error)."""
        return not self._dead.is_set()

    def offer(self, buf: np.ndarray, meta: int, rows: Optional[int],
              words: int) -> bool:
        """Mirror one fused buffer to the build.  Never blocks: a full
        queue means the disk can't keep up with the pipeline, and the
        whole build is dropped rather than stalling the epoch."""
        if self._dead.is_set():
            return False
        payload = np.ascontiguousarray(buf[:words]).tobytes()
        item = (int(meta), _NO_ROWS if rows is None else int(rows), payload)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self._dead.set()
            log_warning("page cache %s: writer fell behind, dropping this "
                        "build (epoch unaffected)", self.path)
            return False
        self.pages += 1
        return True

    def _run(self) -> None:
        try:
            d = os.path.dirname(self._tmp)
            if d:
                os.makedirs(d, exist_ok=True)
            offsets = []
            with open(self._tmp, "wb") as f:
                f.write(_HEAD.pack(_FILE_MAGIC, len(self._header)))
                f.write(self._header)
                self._pad(f)
                while True:
                    if self._dead.is_set():
                        raise _Cancelled
                    try:
                        item = self._q.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if item is None:
                        if self._dead.is_set():
                            # abort's wake-up, not finalize's: a build
                            # cut short must not be sealed
                            raise _Cancelled
                        break
                    meta, rows, payload = item
                    fault_point("page_cache.write")
                    offsets.append(f.tell())
                    f.write(_PAGE.pack(meta, len(payload) // 4, rows))
                    f.write(payload)
                    self._pad(f)
                index_off = f.tell()
                f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
                f.write(_FOOT.pack(index_off, len(offsets),
                                   FORMAT_VERSION, _FOOT_MAGIC))
                f.flush()
                os.fsync(f.fileno())
            os.replace(self._tmp, self.path)
            self._finalized = True
        except _Cancelled:
            pass
        except BaseException as e:  # noqa: BLE001 — builds are best-effort
            self.error = e
            log_warning("page cache %s: build failed, epoch served "
                        "uncached: %r", self.path, e)
        finally:
            if not self._finalized:
                self._dead.set()
                try:
                    os.unlink(self._tmp)
                except OSError:
                    pass

    @staticmethod
    def _pad(f) -> None:
        r = f.tell() % _ALIGN
        if r:
            f.write(b"\0" * (_ALIGN - r))

    def finalize(self) -> bool:
        """Seal the page file (index + footer + fsync + atomic rename).
        True iff the cache is now valid on disk."""
        if self._dead.is_set():
            self.abort()
            return False
        try:
            self._q.put(None, timeout=10.0)
        except queue.Full:
            self.abort()
            return False
        self._thread.join(timeout=120.0)
        if not self._finalized:
            self.abort()
            return False
        log_info("page cache %s: finalized %d pages", self.path, self.pages)
        return True

    def abort(self) -> None:
        """Drop the build: no partial file survives under the real name."""
        self._dead.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10.0)


class PageCacheReader:
    """mmap-backed page reader.  Construction validates the WHOLE frame
    structure (footer magic, index bounds, every page header, optionally
    the expected word count per page) so a truncated or damaged file is
    rejected up front — never discovered mid-epoch."""

    def __init__(self, path: str,
                 expected_words: Optional[Callable[[int], int]] = None,
                 readahead: Optional[int] = None):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < _HEAD.size + _FOOT.size:
                raise PageCacheError(f"{path}: too small to be a page file")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            self._validate(size, expected_words)
        except (struct.error, ValueError) as e:
            self.close()
            raise PageCacheError(f"{path}: corrupt framing: {e}") from e
        except PageCacheError:
            self.close()
            raise
        try:
            self._mm.madvise(mmap.MADV_SEQUENTIAL)
        except (AttributeError, OSError, ValueError):
            pass
        self._ra = (max(0, int(readahead)) if readahead is not None
                    else DEFAULT_READAHEAD)

    def _validate(self, size: int, expected_words) -> None:
        mm = self._mm
        magic, hlen = _HEAD.unpack_from(mm, 0)
        if magic != _FILE_MAGIC:
            raise PageCacheError(f"{self.path}: bad file magic")
        index_off, npages, version, fmagic = _FOOT.unpack_from(
            mm, size - _FOOT.size)
        if fmagic != _FOOT_MAGIC:
            raise PageCacheError(f"{self.path}: missing finalize footer")
        if version != FORMAT_VERSION:
            raise PageCacheError(f"{self.path}: format v{version}, "
                                 f"want v{FORMAT_VERSION}")
        if index_off + 8 * npages + _FOOT.size != size:
            raise PageCacheError(f"{self.path}: index/footer out of bounds")
        if _HEAD.size + hlen > index_off:
            raise PageCacheError(f"{self.path}: header out of bounds")
        self.header_json = bytes(mm[_HEAD.size:_HEAD.size + hlen])
        self._offsets = struct.unpack_from(f"<{npages}Q", mm, index_off)
        for off in self._offsets:
            if off % _ALIGN or off + _PAGE.size > index_off:
                raise PageCacheError(f"{self.path}: misplaced page @{off}")
            meta, words, _rows = _PAGE.unpack_from(mm, off)
            if off + _PAGE.size + words * 4 > index_off:
                raise PageCacheError(f"{self.path}: page @{off} overruns")
            if expected_words is not None and words != expected_words(meta):
                raise PageCacheError(
                    f"{self.path}: page @{off} has {words} words, config "
                    f"implies {expected_words(meta)}")

    @property
    def npages(self) -> int:
        return len(self._offsets)

    def pages(self) -> Iterator[Tuple[int, Optional[int], np.ndarray]]:
        """Yield ``(meta, rows|None, view)`` per page — ``view`` is a
        read-only int32 array aliasing the map (zero-copy)."""
        mm = self._mm
        for i, off in enumerate(self._offsets):
            self._advise(i + 1)
            meta, words, rows = _PAGE.unpack_from(mm, off)
            view = np.frombuffer(mm, dtype=np.int32, count=words,
                                 offset=off + _PAGE.size)
            yield int(meta), (None if rows == _NO_ROWS else int(rows)), view

    def _advise(self, i: int) -> None:
        # tell the kernel about the next window so the transfer stage never
        # faults on a cold page; one failed madvise disables readahead
        if not self._ra or i >= len(self._offsets):
            return
        j = min(len(self._offsets), i + self._ra)
        last = self._offsets[j - 1]
        _meta, words, _rows = _PAGE.unpack_from(self._mm, last)
        end = last + _PAGE.size + words * 4
        start = (self._offsets[i] // mmap.PAGESIZE) * mmap.PAGESIZE
        try:
            self._mm.madvise(mmap.MADV_WILLNEED, start, end - start)
        except (AttributeError, OSError, ValueError):
            self._ra = 0

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            # live page views still alias the map (in-flight transfers,
            # emit='host' consumers) — the map closes when they die
            pass


def open_reader(path: str, fingerprint: dict,
                expected_words: Optional[Callable[[int], int]] = None,
                readahead: Optional[int] = None
                ) -> Optional[PageCacheReader]:
    """A validated reader for ``path`` iff it exists, frames correctly AND
    matches ``fingerprint`` exactly; None means rebuild (absent, stale,
    truncated, version-skewed — all the same answer, never an error)."""
    try:
        reader = PageCacheReader(path, expected_words=expected_words,
                                 readahead=readahead)
    except OSError:
        return None
    except PageCacheError as e:
        log_info("page cache invalid, rebuilding: %s", e)
        return None
    if reader.header_json != _fingerprint_bytes(fingerprint):
        log_info("page cache %s stale (source or pack config changed), "
                 "rebuilding", path)
        reader.close()
        return None
    return reader


def page_file_info(path: str) -> Optional[dict]:
    """``{"pages": n, "size": bytes}`` for a structurally valid page file
    at ``path``, else None: the whole framing is validated, no
    fingerprint is compared."""
    try:
        reader = PageCacheReader(path, readahead=0)
    except (OSError, PageCacheError):
        return None
    try:
        return {"pages": reader.npages, "size": os.path.getsize(path)}
    except OSError:
        return None
    finally:
        reader.close()
