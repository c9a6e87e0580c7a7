"""Host→device batch feed: parse, pack and copy on threads, decode on the
card.

Counterpart of ``dmlc_core_tpu/pipeline/device_loader.py``
(``DeviceLoader``, ``_BufPool``, ``_TransferPool``, the fused v2 wire
and ``make_decoder``).  Two stages, each on its own thread:

  parser → [pack thread]      fixed-shape host items into a bounded queue
         → [transfer thread]  one copy per batch on its own CUDA stream,
                              then the decode, into a bounded queue

While step N computes on the card, batch N+1 is being copied and N+2
packed.  The pack stage takes one of three host paths, as the JAX loader
chooses them:

* the native path (flat layout): the library's packer streams RowBlocks
  into fused v2 wire buffers ``ids[B]|vals[B]|row_ptr|labels|weights``,
  B the batch's nnz rounded up to ``nnz_cap // 8`` (at most 8 shapes per
  ``(batch_rows, nnz_cap)``); a batch closes early rather than truncate;
* the streampack path: the same buffers straight from text in one native
  pass, for an unthreaded :class:`~..data.TextParser` with one parse
  thread (``streampack=False`` turns it off);
* the python path: :func:`.packing.pack_flat` (into the fused wire, B =
  ``nnz_cap``) or :func:`.packing.pack_rowmajor`, with partial slices
  carried across blocks in row order; ``ragged=True`` cuts flat batches
  by cumulative nnz with :func:`.packing.pack_ragged`.

A fused buffer crosses in one copy and :func:`make_decoder` turns it into
the batch's views plus one ``searchsorted`` for ``segments`` (padding →
the ``batch_rows`` scratch row).  Row-major and ragged batches cross as
one int32 buffer of their arrays laid end to end.  On the card the
copies run from pinned buffers of a recycling pool, on the transfer
thread's own stream; the consumer's stream waits on an event recorded
after the decode, every device buffer of the batch is marked used by the
consumer's stream, and a pinned buffer returns to the pool only once its
copy has completed.  On the CPU the decode computes ``segments`` with
numpy and copies each region out of the pooled buffer.

``emit="host"`` stops after the pack stage and yields its fused items
``("fused", buf, meta, rows)`` (``rows`` the real row count, or None
where the packer counts them itself); hand each ``buf`` back with
:meth:`DeviceLoader.recycle`.  The v3 compact wire, the page cache,
``put_threads="auto"`` and the loader's metrics and spans stay with the
JAX package for now.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import native
from ..data.parser import ENGINES, TextParser, resolve_engine
from ..data.row_block import RowBlock, concat_blocks
from ..native import fused_words
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, check
from ..utils.threaded_iter import JOIN_TIMEOUT_S, ThreadedIter
from .packing import (PackStats, batch_slices, pack_flat, pack_ragged,
                      pack_rowmajor, ragged_slices)

__all__ = ["DeviceLoader", "make_decoder", "fused_words"]

Batch = Dict[str, torch.Tensor]


# -- the fused v2 wire -------------------------------------------------------

def _decode_meta(meta: int) -> int:
    """B, the nnz bucket, of a packer's emit meta.  Only the v2 layout
    (id width 0) is ported."""
    if (int(meta) >> 32) & 0xFF:
        raise DMLCError("a v3 compact wire buffer (id width "
                        f"{(int(meta) >> 32) & 0xFF}): not ported yet")
    return int(meta) & 0xFFFFFFFF


def _host_fused(host: Dict[str, np.ndarray], rows: int, nnz: int,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """The v2 fused buffer of a packed flat batch (the python path; the
    native packer writes this layout itself)."""
    words = fused_words(rows, nnz)
    buf = (out if out is not None and len(out) >= words
           else np.empty(words, np.int32))
    buf[:nnz] = host["ids"]
    buf[nnz:2 * nnz] = host["vals"].view(np.int32)
    buf[2 * nnz:2 * nnz + rows + 1] = host["row_ptr"]
    buf[2 * nnz + rows + 1:2 * nnz + 2 * rows + 1] = \
        host["labels"].view(np.int32)
    buf[2 * nnz + 2 * rows + 1:words] = host["weights"].view(np.int32)
    return buf


def _host_segments(view: np.ndarray, rows: int, nnz: int,
                   words: int) -> np.ndarray:
    """Each value's row, from the buffer's ``row_ptr`` on the host
    (padding → the ``rows`` scratch row): the CPU's decode."""
    voff = words - 3 * rows - 1
    rp = view[voff:voff + rows + 1]
    seg = np.full(nnz, rows, np.int32)
    n = int(rp[rows])
    seg[:n] = np.repeat(np.arange(rows, dtype=np.int32), np.diff(rp))
    return seg


def make_decoder(rows: int, meta: int):
    """``decode(buf, segments=None) -> batch``: one int32 wire buffer (a
    tensor on any device) → ``ids``, ``vals``, ``segments``, ``row_ptr``,
    ``labels`` and ``weights``, every one but ``segments`` a view of
    ``buf``; ``segments`` come from one ``searchsorted`` over ``row_ptr``
    unless given."""
    nnz = _decode_meta(meta)

    def decode(b: torch.Tensor, segments: Optional[torch.Tensor] = None
               ) -> Batch:
        rp = b[2 * nnz:2 * nnz + rows + 1]
        if segments is None:
            segments = torch.searchsorted(
                rp[1:], torch.arange(nnz, dtype=torch.int32,
                                     device=b.device),
                right=True, out_int32=True)
        return {
            "ids": b[:nnz],
            "vals": b[nnz:2 * nnz].view(torch.float32),
            "segments": segments,
            "row_ptr": rp,
            "labels": b[2 * nnz + rows + 1:2 * nnz + 2 * rows + 1]
            .view(torch.float32),
            "weights": b[2 * nnz + 2 * rows + 1:2 * nnz + 3 * rows + 1]
            .view(torch.float32),
        }

    return decode


def _decode_on_host(view: np.ndarray, rows: int, meta: int) -> Batch:
    """The CPU's decode: segments from numpy, every region copied out of
    the (pooled) buffer."""
    nnz = _decode_meta(meta)
    words = fused_words(rows, nnz)
    segs = torch.from_numpy(_host_segments(view, rows, nnz, words))
    own = torch.from_numpy(view[:words].copy())
    return make_decoder(rows, meta)(own, segs)


# -- buffers -----------------------------------------------------------------

class _BufPool:
    """Bounded recycle pool of int32 host buffers (pinned when the target
    is a card); a buffer serves any request no larger than itself."""

    def __init__(self, cap: int, pinned: bool) -> None:
        self.cap = cap
        self.pinned = pinned
        self._lock = threading.Lock()
        self._bufs: List[np.ndarray] = []

    def get(self, words: int) -> np.ndarray:
        with self._lock:
            while self._bufs:
                b = self._bufs.pop()
                if len(b) >= words:
                    return b
        if self.pinned:
            # the array keeps the pinned tensor (and its memory) alive
            return torch.empty(words, dtype=torch.int32,
                               pin_memory=True).numpy()
        return np.empty(words, np.int32)

    def put(self, buf: np.ndarray) -> None:
        with self._lock:
            if len(self._bufs) < self.cap:
                self._bufs.append(buf)

    def clear(self) -> None:
        with self._lock:
            self._bufs.clear()


class _TransferPool:
    """``n_threads`` ordered transfer workers over the pack queue (the
    JAX ``_TransferPool``): items are pulled under one lock, so sequence
    numbers follow pull order, and finished batches leave strictly in
    that order.  Same consumer contract as :class:`ThreadedIter`."""

    def __init__(self, pack_iter: ThreadedIter, do_transfer,
                 n_threads: int, window: int) -> None:
        self._pack = pack_iter
        self._do = do_transfer
        self._window = max(int(n_threads), int(window))
        self._cv = threading.Condition()
        self._pull_lock = threading.Lock()
        self._done: Dict[int, tuple] = {}   # seq -> (batch, error)
        self._next_seq = 0
        self._emit_seq = 0
        self._end_seq: Optional[int] = None
        self._epoch = 0
        self._stop = False
        self._threads = [threading.Thread(target=self._worker,
                                          name=f"dmlc-transfer-{i}",
                                          daemon=True)
                         for i in range(int(n_threads))]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (
                        self._end_seq is not None
                        or self._next_seq - self._emit_seq >= self._window):
                    self._cv.wait()
                if self._stop:
                    return
            with self._pull_lock:
                with self._cv:
                    if self._stop:
                        return
                    if self._end_seq is not None:
                        continue
                    epoch, seq = self._epoch, self._next_seq
                try:
                    item = self._pack.next()
                except BaseException as e:  # noqa: BLE001 — re-raised in
                    with self._cv:          # next(), in stream order
                        if self._epoch == epoch:
                            self._done[seq] = (None, e)
                            self._next_seq = seq + 1
                            self._end_seq = seq + 1
                            self._cv.notify_all()
                    continue
                with self._cv:
                    if item is None:
                        self._end_seq = seq
                        self._cv.notify_all()
                    else:
                        self._next_seq = seq + 1
            if item is None:
                continue
            try:
                result = (self._do(item), None)
            except BaseException as e:  # noqa: BLE001 — re-raised in next()
                result = (None, e)
            with self._cv:
                if self._epoch == epoch:
                    self._done[seq] = result
                    self._cv.notify_all()

    def next(self):
        with self._cv:
            while True:
                if self._emit_seq in self._done:
                    out, err = self._done.pop(self._emit_seq)
                    self._emit_seq += 1
                    self._cv.notify_all()
                    if err is not None:
                        raise DMLCError(
                            f"transfer worker failed: {err!r}") from err
                    return out
                if (self._end_seq is not None
                        and self._emit_seq >= self._end_seq):
                    return None
                if self._stop:
                    return None
                self._cv.wait()

    def before_first(self) -> None:
        with self._pull_lock:
            with self._cv:
                self._epoch += 1
                self._done.clear()
                self._next_seq = 0
                self._emit_seq = 0
                self._end_seq = None
                self._cv.notify_all()
            self._pack.before_first()

    def destroy(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        self._threads = []


class _Accum:
    """Partial RowBlocks carried, in row order, until they fill a
    batch."""

    def __init__(self, batch_rows: int) -> None:
        self.batch_rows = batch_rows
        self._pieces: List[RowBlock] = []
        self.rows = 0

    def add(self, piece: RowBlock) -> Optional[RowBlock]:
        self._pieces.append(piece)
        self.rows += piece.size
        if self.rows < self.batch_rows:
            return None
        blk = concat_blocks(self._pieces)
        rest = blk.slice(self.batch_rows, blk.size)
        self._pieces = [rest] if rest.size else []
        self.rows = rest.size
        return blk.slice(0, self.batch_rows)

    def flush(self) -> RowBlock:
        blk = concat_blocks(self._pieces)
        self._pieces, self.rows = [], 0
        return blk


def _nnz(blk: RowBlock) -> int:
    return int(blk.offsets[-1] - blk.offsets[0])


# -- the loader --------------------------------------------------------------

class DeviceLoader:
    """Stream fixed-shape device batches from a parser.

    Parameters
    ----------
    source:         a parser of :mod:`..data` or any iterable of
                    RowBlocks (``before_first()`` and ``close()`` are
                    called on it when it has them).
    batch_rows:     rows per batch (static shape).
    nnz_cap:        flat layout: value capacity per batch; row-major
                    layout: per-row capacity ``k_cap``.
    layout:         ``"flat"`` (segment-sum ops, ragged-gather kernels) or
                    ``"rowmajor"`` (embed-bag kernels).
    id_mod:         feature hashing (``id % id_mod``); 0 keeps raw ids.
    device:         target device; the card unless ``"cpu"`` is given.
    prefetch:       device batches queued ahead of the consumer.
    drop_remainder: drop the last, partial batch instead of padding it
                    (padding rows weigh 0).
    put_threads:    1: one transfer thread with a ring of copies in
                    flight; more: that many ordered transfer workers,
                    each waiting for its own copy.
    emit:           ``"device"`` or ``"host"`` (the pack stage's fused
                    items, flat layout only; see :meth:`recycle`).
    ragged:         flat batches cut by cumulative nnz, with ``nnz_used``
                    and ``rows_used`` words and garbage tails
                    (:func:`.packing.pack_ragged`); never truncates.
    engine:         ``"auto"``, ``"native"`` or ``"python"``: the packer
                    of the flat layout (``native`` raises when the
                    library cannot be built; ``auto`` takes it wherever
                    g++ exists).  The row-major layout and ragged batches
                    have no native packer, in either package.
    streampack:     parse and pack in one native pass when the source is
                    an unthreaded single-thread :class:`~..data.TextParser`.
    """

    def __init__(self, source, batch_rows: int, nnz_cap: int,
                 layout: str = "flat", id_mod: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 prefetch: int = 2, drop_remainder: bool = False,
                 put_threads: int = 1, emit: str = "device",
                 ragged: bool = False, engine: str = "auto",
                 streampack: bool = True) -> None:
        check(layout in ("flat", "rowmajor"), f"bad layout {layout!r}")
        check(emit in ("device", "host"), f"bad emit {emit!r}")
        check(engine in ENGINES, f"bad engine {engine!r}")
        check(batch_rows > 0 and nnz_cap > 0,
              f"batch_rows and nnz_cap must be > 0, got {batch_rows}, "
              f"{nnz_cap}")
        if ragged:
            check(layout == "flat", "ragged=True requires the flat layout")
            check(emit == "device", "ragged=True is incompatible with "
                  "emit='host' (the fused wire carries no nnz_used word)")
        if emit == "host":
            check(layout == "flat", "emit='host' requires the flat layout")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the transfer threads set this device before their first call
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.source = source
        self.batch_rows = int(batch_rows)
        self.nnz_cap = int(nnz_cap)
        self.layout = layout
        self.id_mod = int(id_mod)
        self.drop_remainder = bool(drop_remainder)
        self.ragged = bool(ragged)
        self.emit = emit
        self.streampack = bool(streampack)
        self.engine = resolve_engine(engine)
        self.stats = PackStats()
        self._cuda = self.device.type == "cuda"
        put_threads = max(1, int(put_threads))
        depth = max(2, int(prefetch), put_threads)
        self._pool = _BufPool(cap=2 * depth + 2,
                              pinned=self._cuda and emit == "device")
        self._inflight: deque = deque()     # (copy event, host buffer)
        self._inflight_depth = depth
        self._local = threading.local()     # per thread: device, stream
        self._gen: Optional[Iterator] = None
        self._pack_iter: ThreadedIter = ThreadedIter(max_capacity=depth)
        self._pack_iter.init(self._pack_next, self._reset_source,
                             name="dmlc-pack")
        if emit == "host":
            self._iter = self._pack_iter
        elif put_threads > 1:
            self._iter = _TransferPool(
                self._pack_iter,
                lambda item: self._transfer_item(item, sync=True),
                n_threads=put_threads,
                window=max(int(prefetch), put_threads))
        else:
            self._iter = ThreadedIter(max_capacity=max(1, int(prefetch)))
            self._iter.init(self._transfer_next, self._reset_transfer,
                            name="dmlc-transfer")

    # -- stage 1: pack ---------------------------------------------------
    def _blocks(self) -> Iterator[RowBlock]:
        for blk in self.source:
            yield blk

    def _use_native_pack(self) -> bool:
        return (self.layout == "flat" and not self.ragged
                and self.engine == "native")

    def _use_streampack(self) -> bool:
        return (self.streampack and self._use_native_pack()
                and type(self.source) is TextParser
                and self.source.nthreads == 1)

    def _host_items(self) -> Iterator[tuple]:
        """Host items: ``("fused", buf, meta, rows or None)`` for the
        fused wire, ``("arrays", dict)`` for row-major and ragged
        batches."""
        if self.ragged:
            yield from self._host_items_ragged()
        elif self._use_streampack():
            yield from self._host_items_streampack()
        elif self._use_native_pack():
            yield from self._host_items_native()
        else:
            yield from self._host_items_python()

    def _host_items_python(self) -> Iterator[tuple]:
        carry = _Accum(self.batch_rows)
        for blk in self._blocks():
            for piece in batch_slices(blk, self.batch_rows):
                if carry.rows == 0 and piece.size == self.batch_rows:
                    yield self._pack_host(piece)
                    continue
                # once a tail is carried every later piece goes through
                # the carry, or batches would leave out of row order
                full = carry.add(piece)
                if full is not None:
                    yield self._pack_host(full)
        if carry.rows and not self.drop_remainder:
            yield self._pack_host(carry.flush())

    def _pack_host(self, block: RowBlock) -> tuple:
        if self.layout == "rowmajor":
            host = pack_rowmajor(block, self.batch_rows, self.nnz_cap,
                                 self.stats, id_mod=self.id_mod)
            return ("arrays", host)
        host = pack_flat(block, self.batch_rows, self.nnz_cap, self.stats,
                         id_mod=self.id_mod, want_segments=False)
        buf = _host_fused(host, self.batch_rows, self.nnz_cap,
                          out=self._pool.get(fused_words(self.batch_rows,
                                                         self.nnz_cap)))
        return ("fused", buf, self.nnz_cap, block.size)

    def _host_items_ragged(self) -> Iterator[tuple]:
        """Blocks gathered in row order and cut by cumulative nnz; the
        last, possibly partial, cut waits for the next block's rows."""
        acc: List[RowBlock] = []
        acc_rows = acc_nnz = 0
        for blk in self._blocks():
            acc.append(blk)
            acc_rows += blk.size
            acc_nnz += _nnz(blk)
            if acc_rows < self.batch_rows and acc_nnz < self.nnz_cap:
                continue
            pieces = list(ragged_slices(concat_blocks(acc), self.batch_rows,
                                        self.nnz_cap))
            for piece in pieces[:-1]:
                yield self._pack_host_ragged(piece)
            acc = [pieces[-1]]
            acc_rows, acc_nnz = pieces[-1].size, _nnz(pieces[-1])
        if acc_rows:
            pieces = list(ragged_slices(concat_blocks(acc), self.batch_rows,
                                        self.nnz_cap))
            if self.drop_remainder:
                pieces = pieces[:-1]
            for piece in pieces:
                yield self._pack_host_ragged(piece)

    def _pack_host_ragged(self, block: RowBlock) -> tuple:
        host = pack_ragged(block, self.batch_rows, self.nnz_cap, self.stats,
                           id_mod=self.id_mod)
        host.pop("row_ptr")          # the JAX loader ships no row_ptr here
        return ("arrays", host)

    def _native_stats(self, st: Dict[str, int]) -> None:
        self.stats.rows += st["rows"]
        self.stats.padded_rows += st["padded_rows"]
        self.stats.truncated_values += st["truncated_values"]

    def _host_items_native(self) -> Iterator[tuple]:
        packer = native.Packer(self.batch_rows, self.nnz_cap,
                               id_mod=self.id_mod)
        try:
            for blk in self._blocks():
                for buf, meta in packer.feed(blk, get_buf=self._pool.get,
                                             put_buf=self._pool.put):
                    yield ("fused", buf, meta, None)
            if not self.drop_remainder:
                tail = packer.flush(get_buf=self._pool.get)
                if tail is not None:
                    yield ("fused", tail[0], tail[1], None)
            self._native_stats(packer.stats())
        finally:
            packer.close()

    def _host_items_streampack(self) -> Iterator[tuple]:
        split = self.source.source          # the TextParser's byte split
        sp = native.SpPacker(self.batch_rows, self.nnz_cap,
                             id_mod=self.id_mod)
        try:
            while True:
                chunk = split.next_chunk()
                if chunk is None:
                    break
                for buf, meta in sp.feed_text(chunk, get_buf=self._pool.get,
                                              put_buf=self._pool.put):
                    yield ("fused", buf, meta, None)
            if not self.drop_remainder:
                tail = sp.flush(get_buf=self._pool.get)
                if tail is not None:
                    yield ("fused", tail[0], tail[1], None)
            self._native_stats(sp.stats())
        finally:
            sp.close()

    def _pack_next(self, _cell) -> Optional[tuple]:
        self._bind_device()              # the pool pins memory here
        if self._gen is None:
            self._gen = self._host_items()
        item = next(self._gen, None)
        if item is None:
            self._gen = None
        return item

    def _reset_source(self) -> None:
        if self._gen is not None:
            self._gen.close()                # runs the packers' finally
            self._gen = None
        if hasattr(self.source, "before_first"):
            self.source.before_first()

    # -- stage 2: transfer -----------------------------------------------
    def _bind_device(self) -> None:
        """Set the loader's card as this thread's device, once, before
        the thread's first CUDA call."""
        if self._cuda and not getattr(self._local, "bound", False):
            torch.cuda.set_device(self.device)
            self._local.bound = True

    def _stream(self) -> "torch.cuda.Stream":
        """This thread's copy stream."""
        stream = getattr(self._local, "stream", None)
        if stream is None:
            self._bind_device()
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    def _arrays_buffer(self, host: Dict[str, np.ndarray]
                       ) -> Tuple[np.ndarray, list]:
        """The arrays laid end to end in one pooled int32 buffer, and
        their (key, dtype, shape, offset, words)."""
        regions, pos = [], 0
        for k, v in host.items():
            v = np.asarray(v)
            regions.append((k, v, pos, v.size))
            pos += v.size
        buf = self._pool.get(pos)
        for _, v, off, n in regions:
            buf[off:off + n] = v.reshape(-1).view(np.int32)
        return buf, [(k, v.dtype, v.shape, off, n)
                     for k, v, off, n in regions]

    def _transfer_item(self, item: tuple, sync: bool) -> tuple:
        """One host item → ``(batch, ready event or None, device
        buffers)``.  ``sync=False`` (one transfer thread): the host
        buffer joins the in-flight ring; ``sync=True`` (the pool of
        workers): wait for this copy, then recycle it."""
        if not self._cuda:
            return self._transfer_cpu(item), None, ()
        stream = self._stream()
        if item[0] == "fused":
            _, buf, meta, _rows = item
            words = fused_words(self.batch_rows, _decode_meta(meta))
        else:
            buf, regions = self._arrays_buffer(item[1])
            words = sum(r[4] for r in regions)
        with torch.cuda.stream(stream):
            dev = torch.empty(words, dtype=torch.int32, device=self.device)
            dev.copy_(torch.from_numpy(buf[:words]), non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
            if item[0] == "fused":
                batch = make_decoder(self.batch_rows, item[2])(dev)
            else:
                batch = {k: dev[off:off + n].view(_TORCH[dt]).view(shape)
                         for k, dt, shape, off, n in regions}
            ready = torch.cuda.Event()
            ready.record(stream)
        owned = [dev] + ([batch["segments"]] if item[0] == "fused" else [])
        if sync:
            copied.synchronize()
            self._pool.put(buf)
        else:
            self._ring_push(copied, buf)
        return batch, ready, owned

    def _transfer_cpu(self, item: tuple) -> Batch:
        if item[0] == "fused":
            _, buf, meta, _rows = item
            batch = _decode_on_host(buf, self.batch_rows, meta)
            self._pool.put(buf)
            return batch
        return {k: torch.from_numpy(np.array(v)) for k, v in item[1].items()}

    def _ring_push(self, copied: "torch.cuda.Event", buf: np.ndarray
                   ) -> None:
        """Track an in-flight copy; recycle the host buffers of the copies
        that have completed, waiting for the oldest once more than the
        pipeline's depth are in flight."""
        self._inflight.append((copied, buf))
        while self._inflight and (len(self._inflight) > self._inflight_depth
                                  or self._inflight[0][0].query()):
            ev, old = self._inflight.popleft()
            ev.synchronize()
            self._pool.put(old)

    def _drain_inflight(self) -> None:
        while self._inflight:
            ev, buf = self._inflight.popleft()
            ev.synchronize()
            self._pool.put(buf)

    def _transfer_next(self, _cell) -> Optional[tuple]:
        item = self._pack_iter.next()
        if item is None:
            self._drain_inflight()
            return None
        return self._transfer_item(item, sync=False)

    def _reset_transfer(self) -> None:
        self._drain_inflight()
        self._pack_iter.before_first()

    # -- consumer side ---------------------------------------------------
    def next_batch(self):
        """The next batch (a dict of tensors on the loader's device; with
        ``emit="host"`` a fused host item), or None at the end of the
        epoch."""
        out = self._iter.next()
        if out is None or self.emit == "host":
            return out
        batch, ready, owned = out
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in owned:
                t.record_stream(consumer)
        return batch

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def before_first(self) -> None:
        """Rewind to the first batch (the source is rewound too)."""
        self._iter.before_first()

    def recycle(self, buf: np.ndarray) -> None:
        """Hand a consumed host buffer back to the pool (``emit="host"``)."""
        self._pool.put(buf)

    def close(self) -> None:
        """Stop and join every thread of the loader, then close the
        source."""
        self._pack_iter.destroy()
        if self._iter is not self._pack_iter:
            self._iter.destroy()
        self._drain_inflight()
        self._pool.clear()
        if hasattr(self.source, "close"):
            self.source.close()

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_TORCH = {np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32}
