"""ctypes binding to the port's native parse and pack library.

Counterpart of ``dmlc_core_tpu/native/__init__.py``, for the libsvm feed:
:func:`parse_libsvm` (libsvm text → numpy CSR arrays, OpenMP over line-
aligned slices of the chunk), :class:`Packer` (RowBlocks → fused v2 wire
buffers, ``PackerC``) and :class:`SpPacker` (libsvm text → fused v2 wire
buffers in one pass, ``SpPackC``).  The library is the port's own copy
of ``dmlc_native.cpp``, built with g++ at first use by :mod:`.build`.

A build that fails where g++ exists raises :class:`DMLCError`; only a
host with no compiler (and no built library) has no native library, and
then :func:`available` is False.  The libfm and csv entry points and the
v3 compact wire stay unbound for now.

ctypes releases the interpreter lock for the length of each native call,
so parsing and packing overlap the Python of other threads.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from ..utils.logging import DMLCError, IdOverflowError, log_info
from . import build as _build

__all__ = ["available", "has_packer", "has_sppack", "parse_libsvm",
           "num_threads", "fused_words", "Packer", "SpPacker"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)


class _CSRBlockC(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_values", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("labels", ctypes.POINTER(ctypes.c_float)),
        ("weights", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_uint64)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("fields", ctypes.POINTER(ctypes.c_uint32)),
        ("max_index", ctypes.c_uint64),
        ("max_field", ctypes.c_uint32),
        ("bad_lines", ctypes.c_int64),
        ("owner", ctypes.c_void_p),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.dmlc_parse_libsvm.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int,
                                      ctypes.POINTER(_CSRBlockC)]
    lib.dmlc_parse_libsvm.restype = ctypes.c_int
    lib.dmlc_free_block.argtypes = [ctypes.POINTER(_CSRBlockC)]
    lib.dmlc_free_block.restype = None
    lib.dmlc_num_threads.argtypes = []
    lib.dmlc_num_threads.restype = ctypes.c_int
    for pre in ("dmlc_packer2", "dmlc_sppack"):
        create = getattr(lib, pre + "_create")
        create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_uint64]
        create.restype = ctypes.c_void_p
        destroy = getattr(lib, pre + "_destroy")
        destroy.argtypes = [ctypes.c_void_p]
        destroy.restype = None
        flush = getattr(lib, pre + "_flush")
        flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p, _I64P]
        flush.restype = ctypes.c_int64
    lib.dmlc_packer2_feed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), _I64P, ctypes.c_int64, _I64P]
    lib.dmlc_packer2_feed.restype = ctypes.c_int64
    lib.dmlc_packer2_stats.argtypes = [ctypes.c_void_p] + [_I64P] * 4
    lib.dmlc_packer2_stats.restype = None
    lib.dmlc_sppack_feed_libsvm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _I64P,
        ctypes.c_void_p, _I64P]
    lib.dmlc_sppack_feed_libsvm.restype = ctypes.c_int32
    lib.dmlc_sppack_stats.argtypes = [ctypes.c_void_p] + [_I64P] * 5
    lib.dmlc_sppack_stats.restype = None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None only when there is no g++
    and no fresh library.  Raises :class:`DMLCError` when g++ exists but
    the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build.compiler() is None and not _build.is_fresh():
            return None
        ok, report = _build.build_native()
        if not ok:
            raise DMLCError(f"the native library failed to build:\n{report}")
        if report != "fresh":
            log_info("native: %s", report)
        lib = ctypes.CDLL(_build.OUT)
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (building it on
    first call); False only when there is no compiler."""
    return _load() is not None


def has_packer() -> bool:
    """True when the loaded library carries the fused packer."""
    return available()


def has_sppack() -> bool:
    """True when the loaded library carries the one-pass parse and pack."""
    return available()


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise DMLCError("the native library is unavailable: g++ not found")
    return lib


def num_threads() -> int:
    """The OpenMP team size the library uses when asked for 0 threads."""
    return int(_lib_or_raise().dmlc_num_threads())


class _NativeBlockOwner:
    """Owns a C-allocated CSR block; frees it when the last view dies."""

    def __init__(self, lib: ctypes.CDLL, blk: _CSRBlockC) -> None:
        self._free = lib.dmlc_free_block
        self._ref = ctypes.byref(blk)     # held: usable at shutdown too
        self._blk = blk

    def __del__(self) -> None:
        self._free(self._ref)


def _wrap(ptr, count: int, dtype, owner: _NativeBlockOwner) -> np.ndarray:
    """numpy view over native memory that keeps ``owner`` alive."""
    if count == 0 or not ptr:
        return np.empty(0, dtype)
    nbytes = count * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * nbytes).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value)
    buf._dmlc_owner = owner
    return np.frombuffer(buf, dtype=dtype)


def _buf_view(data) -> np.ndarray:
    """uint8 view over bytes, a memoryview or an array, without a copy."""
    if isinstance(data, np.ndarray):
        return data.view(np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def parse_libsvm(data, nthreads: int = 0) -> Dict:
    """libsvm text → the CSR arrays of the port's python parser
    (``offsets``, ``labels``, ``weights``, ``indices``, ``values``,
    ``max_index``, ``bad_lines``), as zero-copy views of the library's
    block.  ``nthreads`` 0 takes the library's OpenMP default."""
    lib = _lib_or_raise()
    view = _buf_view(data)
    blk = _CSRBlockC()
    rc = lib.dmlc_parse_libsvm(ctypes.c_char_p(view.ctypes.data), len(view),
                               int(nthreads), ctypes.byref(blk))
    if rc != 0:
        lib.dmlc_free_block(ctypes.byref(blk))
        raise MemoryError(f"dmlc_parse_libsvm failed with code {rc}")
    n, m = blk.n_rows, blk.n_values
    owner = _NativeBlockOwner(lib, blk)
    return {
        "offsets": _wrap(blk.offsets, n + 1, np.int64, owner),
        "labels": _wrap(blk.labels, n, np.float32, owner),
        "weights": _wrap(blk.weights, n, np.float32, owner),
        "indices": _wrap(blk.indices, m, np.uint64, owner),
        "values": _wrap(blk.values, m, np.float32, owner),
        "max_index": int(blk.max_index),
        "bad_lines": int(blk.bad_lines),
    }


def fused_words(batch_rows: int, nnz_bucket: int) -> int:
    """int32 words of a v2 fused batch: ids|vals|row_ptr|labels|weights."""
    return 2 * nnz_bucket + 3 * batch_rows + 1


GetBuf = Callable[[int], np.ndarray]
PutBuf = Callable[[np.ndarray], None]


def _fresh_buf(words: int) -> np.ndarray:
    return np.empty(words, np.int32)


def _id_overflow(where: str) -> IdOverflowError:
    return IdOverflowError(
        f"feature id > 2^31-1 {where} — pass id_mod (feature hashing) or "
        f"keep ids below int32 range")


def _check_compact(compact: bool) -> None:
    if compact:
        raise DMLCError("the v3 compact wire (compact=True) is not ported "
                        "yet")


class Packer:
    """RowBlocks → fused v2 wire buffers (``PackerC`` in the library):
    ``ids[B]|vals[B]|row_ptr|labels|weights`` with B the batch's nnz
    rounded up to ``quantum`` (default ``nnz_cap // 8``, so at most 8
    shapes per ``(batch_rows, nnz_cap)``).  A batch closes when it holds
    ``batch_rows`` rows or the next row would overflow ``nnz_cap``; a
    partial batch carries across blocks until :meth:`flush`.  Emitted
    items are ``(buffer, meta)`` with meta = B."""

    def __init__(self, batch_rows: int, nnz_cap: int, id_mod: int = 0,
                 quantum: int = 0, compact: bool = False) -> None:
        _check_compact(compact)
        self._lib = _lib_or_raise()
        if quantum <= 0:
            quantum = max(1, nnz_cap // 8)
        self._p = self._lib.dmlc_packer2_create(batch_rows, nnz_cap,
                                                quantum, id_mod)
        if not self._p:
            raise MemoryError("dmlc_packer2_create failed")
        self.batch_rows = batch_rows
        self.nnz_cap = nnz_cap
        self.quantum = min(quantum, nnz_cap)
        self.words_max = fused_words(batch_rows, nnz_cap)

    def close(self) -> None:
        if self._p:
            self._lib.dmlc_packer2_destroy(self._p)
            self._p = None

    def __del__(self) -> None:
        if getattr(self, "_p", None):
            self.close()

    def feed(self, block, max_out: int = 8, get_buf: GetBuf = _fresh_buf,
             put_buf: Optional[PutBuf] = None
             ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield the ``(buf, meta)`` batches that ``block`` completes.
        ``get_buf(words)`` supplies buffers and ``put_buf(buf)`` takes
        back the ones left unused."""
        offsets = np.ascontiguousarray(block.offsets, np.int64)
        labels = np.ascontiguousarray(block.labels, np.float32)
        indices = np.ascontiguousarray(block.indices, np.uint64)
        values = (None if block.values is None
                  else np.ascontiguousarray(block.values, np.float32))
        weights = (None if block.weights is None
                   else np.ascontiguousarray(block.weights, np.float32))
        addr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
        n_rows = len(offsets) - 1
        row = 0
        consumed = ctypes.c_int64(0)
        spare: list = []
        try:
            while row < n_rows:
                left = int(offsets[-1] - offsets[row])
                est = max(1, min(max_out, left // self.nnz_cap + 1))
                bufs = spare[:est]
                del spare[:len(bufs)]
                bufs += [get_buf(self.words_max)
                         for _ in range(est - len(bufs))]
                ptrs = (ctypes.c_void_p * est)(*[b.ctypes.data for b in bufs])
                nnz_out = (ctypes.c_int64 * est)()
                emitted = self._lib.dmlc_packer2_feed(
                    self._p, n_rows, offsets.ctypes.data, labels.ctypes.data,
                    addr(weights), indices.ctypes.data, addr(values), row,
                    ptrs, nnz_out, est, ctypes.byref(consumed))
                if emitted == -2:
                    raise _id_overflow(f"at row {consumed.value}")
                if emitted < 0:
                    raise DMLCError(f"dmlc_packer2_feed error {emitted}")
                spare.extend(bufs[emitted:])
                for i in range(emitted):
                    yield bufs[i], int(nnz_out[i])
                row = consumed.value
                if emitted == 0 and row < n_rows:
                    raise DMLCError("the native packer made no progress")
        finally:
            if put_buf is not None:
                for b in spare:
                    put_buf(b)

    def flush(self, get_buf: GetBuf = _fresh_buf
              ) -> Optional[Tuple[np.ndarray, int]]:
        """The last, partial batch as ``(buf, meta)`` (padded), or None
        when nothing is carried."""
        buf = get_buf(self.words_max)
        nnz = ctypes.c_int64(0)
        rows = self._lib.dmlc_packer2_flush(self._p, buf.ctypes.data,
                                            ctypes.byref(nnz))
        return (buf, int(nnz.value)) if rows > 0 else None

    def stats(self) -> Dict[str, int]:
        vals = [ctypes.c_int64(0) for _ in range(4)]
        self._lib.dmlc_packer2_stats(self._p,
                                     *[ctypes.byref(v) for v in vals])
        return {"rows": vals[0].value, "padded_rows": vals[1].value,
                "truncated_values": vals[2].value, "batches": vals[3].value}


class SpPacker:
    """libsvm text chunks → fused v2 wire buffers in one native pass
    (``SpPackC`` in the library), without the CSR block that
    :func:`parse_libsvm` then :class:`Packer` build in between.  Same
    layout, meta and carry as :class:`Packer`."""

    FORMATS = ("libsvm",)

    def __init__(self, batch_rows: int, nnz_cap: int, id_mod: int = 0,
                 quantum: int = 0, compact: bool = False,
                 fmt: str = "libsvm") -> None:
        _check_compact(compact)
        if fmt not in self.FORMATS:
            raise DMLCError(f"streampack format {fmt!r} is not ported yet; "
                            f"only 'libsvm' is")
        self._lib = _lib_or_raise()
        if quantum <= 0:
            quantum = max(1, nnz_cap // 8)
        self._p = self._lib.dmlc_sppack_create(batch_rows, nnz_cap, quantum,
                                               id_mod)
        if not self._p:
            raise MemoryError("dmlc_sppack_create failed")
        self.batch_rows = batch_rows
        self.nnz_cap = nnz_cap
        self.words_max = fused_words(batch_rows, nnz_cap)

    def close(self) -> None:
        if self._p:
            self._lib.dmlc_sppack_destroy(self._p)
            self._p = None

    def __del__(self) -> None:
        if getattr(self, "_p", None):
            self.close()

    def feed_text(self, chunk, get_buf: GetBuf = _fresh_buf,
                  put_buf: Optional[PutBuf] = None
                  ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield the ``(buf, meta)`` batches parsed from one chunk of
        whole lines; buffers as in :meth:`Packer.feed`."""
        pos = ctypes.c_int64(0)
        meta = ctypes.c_int64(0)
        view = _buf_view(chunk)
        addr = ctypes.c_char_p(view.ctypes.data)
        buf = None
        try:
            while True:
                if buf is None:
                    buf = get_buf(self.words_max)
                rc = self._lib.dmlc_sppack_feed_libsvm(
                    self._p, addr, len(view), ctypes.byref(pos),
                    buf.ctypes.data, ctypes.byref(meta))
                if rc == -2:
                    raise _id_overflow(f"near text offset {pos.value}")
                if rc < 0:
                    raise DMLCError(f"dmlc_sppack_feed error {rc}")
                if rc == 0:
                    break
                out, buf = buf, None
                yield out, int(meta.value)
        finally:
            if buf is not None and put_buf is not None:
                put_buf(buf)

    def flush(self, get_buf: GetBuf = _fresh_buf
              ) -> Optional[Tuple[np.ndarray, int]]:
        """The last, partial batch as ``(buf, meta)``, or None."""
        buf = get_buf(self.words_max)
        meta = ctypes.c_int64(0)
        rows = self._lib.dmlc_sppack_flush(self._p, buf.ctypes.data,
                                           ctypes.byref(meta))
        return (buf, int(meta.value)) if rows > 0 else None

    def stats(self) -> Dict[str, int]:
        vals = [ctypes.c_int64(0) for _ in range(5)]
        self._lib.dmlc_sppack_stats(self._p,
                                    *[ctypes.byref(v) for v in vals])
        return {"rows": vals[0].value, "padded_rows": vals[1].value,
                "truncated_values": vals[2].value, "batches": vals[3].value,
                "bad_lines": vals[4].value}
