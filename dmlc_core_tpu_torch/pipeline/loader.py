"""Host→device batch feed: parse, pack and copy on threads, decode on the
card.

Counterpart of ``dmlc_core_tpu/pipeline/device_loader.py``
(``DeviceLoader``, ``_BufPool``, ``_TransferPool``, the fused wire and
``make_decoder``).  Two stages, each on its own thread:

  parser → [pack thread]      fixed-shape host items into a bounded queue
         → [transfer thread]  one copy per batch on its own CUDA stream,
                              then the decode, into a bounded queue

While step N computes on the card, batch N+1 is being copied and N+2
packed.  The pack stage takes one of three host paths, as the JAX loader
chooses them:

* the native path (flat layout): the library's packer streams RowBlocks
  into fused wire buffers, v2 ``ids[B]|vals[B]|row_ptr|labels|weights``
  or, with ``wire_compact``, the v3 compact layout (ids bit-packed at the
  batch's width, values dictionary-coded or raw; lossless), B the
  batch's nnz rounded up to ``nnz_cap // 8`` (at most 8 shapes per
  ``(batch_rows, nnz_cap)``); a batch closes early rather than truncate;
* the streampack path: the same buffers straight from libsvm, libfm or
  csv text in one native pass, for an unthreaded
  :class:`~..data.TextParser` with one parse thread (``streampack=False``
  turns it off);
* the python path: :func:`.packing.pack_flat` (into the fused wire, B =
  ``nnz_cap``) or :func:`.packing.pack_rowmajor`, with partial slices
  carried across blocks in row order; ``ragged=True`` cuts flat batches
  by cumulative nnz with :func:`.packing.pack_ragged`.  ``fields=True``
  (libfm field ids for ``FieldAwareFM``) always takes this path, as in
  the JAX loader: the fused wire has no field region.

A fused buffer crosses in one copy and :func:`make_decoder` turns it into
the batch: a v2 buffer into views plus one ``searchsorted`` for
``segments`` (padding → the ``batch_rows`` scratch row), a v3 buffer on
the card by one launch of the decode kernel
(:mod:`..kernels.wire_decode`).  ``wire_compact`` and ``put_threads``
default to ``"auto"``, resolved for the loader's device type by
:func:`.tuned.resolve` as the JAX loader resolves them for its backend:
v3 on the card, v2 on the CPU, unless the environment or the tuned file
says otherwise.  Row-major and ragged batches cross as
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
:meth:`DeviceLoader.recycle`.

The packed-page epoch cache (:mod:`.page_cache`, ``cache="auto"``: on
when the source's URI has a ``#cachefile`` fragment and the loader is
on the fused path) writes each fused buffer of the first epoch through
to ``<fragment>.pages`` on a thread, and serves the later epochs from
that file: mapped pages, each copied into a buffer of the pool (pinned
on the card) and from there to the card in one copy, with no read,
parse or pack.  A page file whose fingerprint (source files, sizes and
mtimes, part, pack configuration) does not match, or whose framing
fails to validate, is rebuilt and never served.  A page view never
enters the pool: it is read-only, and the pool refuses a buffer that
is not writable.  A cached epoch packs nothing, so ``stats`` counts no
rows in it; ``cache_stats`` counts hits, misses, dropped builds and the
bytes read from and written to page files.

The loader publishes the JAX loader's metrics under its names,
re-fetched when :data:`~..utils.metrics.metrics` is reset: the stage
timers ``device_loader.pack``, ``.h2d`` (one transfer thread), ``.h2d_pool``
(the pool of workers), ``.cache_read`` and ``.cache_write``, the counter
``device_loader.batches``, the throughput ``device_loader.rows`` (real rows,
counted once: at the pack on the native paths, at the transfer on the
others), the counters ``page_cache.hits``, ``.misses``, ``.drops``,
``.bytes_read`` and ``.bytes_written``, and two
:class:`~..telemetry.anomaly.StallDetector` s, ``device_loader.pack`` (the
python packs' time a batch, as the JAX loader observes it) and
``device_loader.h2d`` (a batch's transfer), whose
``anomaly.stalls.*`` counters freeze the autotuner
(:mod:`.autotune`).  The page writer's ``fault_point`` is
:mod:`.page_cache`'s.

It records the JAX loader's spans, under the trace context that was
live where it was constructed: ``device_loader.pack`` (``rows``, and
``ragged`` on the ragged path) around each python pack,
``device_loader.h2d`` (``sync``: True in the pool of workers) around
each transfer, and ``page_cache.serve_epoch`` (``pages``) over an
epoch served from the page file.  While a ``torch.profiler`` capture
runs, each pack (the native ones too) and each transfer is also a
:func:`~..utils.metrics.trace_span` range of that name on its timeline
(otherwise that range is a no-op).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import native
from ..data.parser import ENGINES, TextParser, resolve_engine
from ..data.row_block import RowBlock, concat_blocks
from ..kernels.common import ENGINES as KERNEL_ENGINES
from ..kernels.wire_decode import (v3_layout, wire_decode,
                                   wire_decode_reference)
from ..native import fused_words
from ..parallel.mesh import DataSharding
from ..telemetry import trace as teltrace
from ..telemetry.anomaly import StallDetector
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, check
from ..utils.metrics import metrics, trace_span
from ..utils.threaded_iter import JOIN_TIMEOUT_S, ThreadedIter
from . import fingerprint as fingerprint_mod
from . import page_cache, tuned
from .packing import (PackStats, batch_slices, pack_flat, pack_ragged,
                      pack_rowmajor, ragged_slices)

__all__ = ["DeviceLoader", "make_decoder", "fused_words"]

Batch = Dict[str, torch.Tensor]


# -- the fused wire (v2 and the v3 compact layout) ----------------------------

def _decode_meta(meta: int) -> Tuple[int, int, int]:
    """``(B, id_width, dict_bits)`` of a packer's emit meta: id width 0 is
    the v2 layout, dict bits 0 raw f32 values."""
    meta = int(meta)
    return meta & 0xFFFFFFFF, (meta >> 32) & 0xFF, (meta >> 40) & 0xFF


def _fused_words_meta(rows: int, meta: int) -> int:
    """int32 words of a fused batch in either layout (v2 or v3)."""
    nnz, w, dbits = _decode_meta(meta)
    if w == 0:
        return fused_words(rows, nnz)
    return v3_layout(rows, nnz, w, dbits)[3] + 3 * rows + 1


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
    (padding → the ``rows`` scratch row): the CPU's decode.  ``row_ptr``
    ends the buffer's last ``3 * rows + 1`` words in both layouts."""
    voff = words - 3 * rows - 1
    rp = view[voff:voff + rows + 1]
    seg = np.full(nnz, rows, np.int32)
    n = int(rp[rows])
    seg[:n] = np.repeat(np.arange(rows, dtype=np.int32), np.diff(rp))
    return seg


def make_decoder(rows: int, meta: int, engine: str = "auto"):
    """``decode(buf, segments=None) -> batch``: one int32 wire buffer (a
    tensor on any device) → ``ids``, ``vals``, ``segments``, ``row_ptr``,
    ``labels`` and ``weights``.

    v2 (id width 0): every array but ``segments`` is a view of ``buf``,
    and ``segments`` come from one ``searchsorted`` over ``row_ptr``
    unless given.  v3: ``row_ptr``, ``labels`` and ``weights`` are views;
    ``ids``, ``vals`` and ``segments`` come from one launch of the decode
    kernel on a CUDA buffer under ``engine`` ``"auto"`` or ``"kernel"``
    (:func:`..kernels.wire_decode.wire_decode`), else from its plain
    version (``"torch"``, or a buffer on the CPU), with given
    ``segments`` used as they are."""
    nnz, w, dbits = _decode_meta(meta)
    check(engine in KERNEL_ENGINES, f"bad engine {engine!r}")
    voff = 2 * nnz if w == 0 else v3_layout(rows, nnz, w, dbits)[3]

    def decode(b: torch.Tensor, segments: Optional[torch.Tensor] = None
               ) -> Batch:
        rp = b[voff:voff + rows + 1]
        if w == 0:
            ids, vals = b[:nnz], b[nnz:2 * nnz].view(torch.float32)
            if segments is None:
                segments = torch.searchsorted(
                    rp[1:], torch.arange(nnz, dtype=torch.int32,
                                         device=b.device),
                    right=True, out_int32=True)
        elif segments is None:
            ids, vals, segments = wire_decode(b, rows, nnz, w, dbits,
                                              engine=engine)
        else:
            ids, vals, _ = wire_decode_reference(b, rows, nnz, w, dbits,
                                                 segments=segments)
        return {
            "ids": ids,
            "vals": vals,
            "segments": segments,
            "row_ptr": rp,
            "labels": b[voff + rows + 1:voff + 2 * rows + 1]
            .view(torch.float32),
            "weights": b[voff + 2 * rows + 1:voff + 3 * rows + 1]
            .view(torch.float32),
        }

    return decode


def _decode_on_host(view: np.ndarray, rows: int, meta: int) -> Batch:
    """The CPU's decode: segments from numpy, every region copied out of
    the (pooled) buffer; the v3 ids and values by the plain decode."""
    nnz = _decode_meta(meta)[0]
    words = _fused_words_meta(rows, meta)
    segs = torch.from_numpy(_host_segments(view, rows, nnz, words))
    own = torch.from_numpy(view[:words].copy())
    return make_decoder(rows, meta, engine="torch")(own, segs)


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
        if not buf.flags.writeable:
            # a mapped page-cache view: recycled, it would be handed to a
            # packer as scratch and written; it is dropped instead
            return
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


class _TransferStage:
    """The transfer stage of a fused (or row-major) host item, shared by
    :class:`DeviceLoader` and the ingest service's
    :class:`~.ingest_service.RemoteIngestLoader`: on the card one copy
    from a pinned pool buffer on the calling thread's own stream, the
    decode on that stream, an event the consumer's stream waits on, and
    the pool buffer recycled only once its copy has completed; on the
    CPU the host decode.  The subclass sets ``batch_rows`` and calls
    :meth:`_init_transfer`."""

    def _init_transfer(self, device: torch.device, pinned: bool,
                       pool_cap: int, depth: int) -> None:
        self.device = device
        self._cuda = device.type == "cuda"
        self._pool = _BufPool(cap=pool_cap, pinned=pinned)
        self._inflight: deque = deque()     # (copy event, host buffer)
        self._inflight_depth = depth
        self._local = threading.local()     # per thread: device, stream

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
            words = _fused_words_meta(self.batch_rows, meta)
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
        # the decode's own outputs (segments; v3 ids and vals) as well as
        # the copy: a view adds nothing, record_stream marks the storage
        owned = [dev] + ([batch["ids"], batch["vals"], batch["segments"]]
                         if item[0] == "fused" else [])
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

    def _handoff(self, out):
        """A transferred batch to the consumer: its stream waits for the
        transfer and uses the batch's device buffers."""
        batch, ready, owned = out
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in owned:
                t.record_stream(consumer)
        return batch


# -- the loader --------------------------------------------------------------

def _sharded_device(source, sharding: DataSharding, device, ragged: bool,
                    emit: str) -> torch.device:
    """The device of a data-parallel rank's loader, once its options and
    its source's partition are checked against ``sharding``."""
    check(not ragged, "ragged=True cannot shard over a batch axis (the "
          "nnz_used and rows_used words are the whole batch's)")
    check(emit == "device", "emit='host' requires the fused path with no "
          "sharding (single-card k-step training)")
    if device is not None and resolve_device(device) != sharding.device:
        raise DMLCError(f"device {device} is not the sharding's "
                        f"{sharding.device}: a rank's batches stay on its "
                        "own device")
    split = fingerprint_mod.find_file_split(source)
    want = (sharding.rank, sharding.world)
    if split is None or not hasattr(split, "part_index"):
        if sharding.world > 1:
            raise DMLCError(
                f"cannot tell which partition the source reads, and rank "
                f"{sharding.rank} of {sharding.world} must read partition "
                f"{want}: open it with create_parser(uri, {want[0]}, "
                f"{want[1]})")
    else:
        got = (int(split.part_index), int(split.num_parts))
        if got != want:
            raise DMLCError(
                f"the source reads partition {got}, but this is rank "
                f"{want[0]} of {want[1]}: open it with "
                f"create_parser(uri, {want[0]}, {want[1]})")
    return sharding.device


class DeviceLoader(_TransferStage):
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
                    each waiting for its own copy; ``"auto"`` resolves
                    through :func:`.tuned.resolve`.
    wire_compact:   the native packers write the v3 compact wire (the
                    python packs always write v2); ``"auto"`` resolves
                    through :func:`.tuned.resolve` (v3 on the card, v2 on
                    the CPU).
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
    fields:         also ship the libfm field ids (``fields``, int32,
                    padding 0, shaped as ``ids``); the source must carry
                    them.  The native packer and streampack are then off,
                    the python packs run and ``fields`` crosses in the
                    batch's one copy with the other arrays.
    cache:          the packed-page epoch cache: ``"auto"`` (on when the
                    source has a ``cache_file``, the ``#cachefile``
                    fragment, and the loader is on the fused path: flat,
                    no fields, not ragged), a page-file path (the fused
                    path required), or None / False (off).
    cache_queue_pages / cache_readahead:
                    the page writer's queue and the reader's
                    ``MADV_WILLNEED`` window, in pages (0 / None: 8 and
                    2).
    sharding:       a data-parallel rank's
                    :class:`~..parallel.mesh.DataSharding`
                    (``models.batch_sharding(mesh)``): the batches stay
                    on its device, and the source must read partition
                    ``(rank, world)`` of the input (the reference's
                    ``ResetPartition`` contract; a source whose
                    partition cannot be read is refused above world 1).
                    Not with ``ragged`` or ``emit="host"``.
    """

    def __init__(self, source, batch_rows: int, nnz_cap: int,
                 layout: str = "flat", id_mod: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 prefetch: int = 2, drop_remainder: bool = False,
                 put_threads="auto", wire_compact="auto",
                 emit: str = "device",
                 ragged: bool = False, engine: str = "auto",
                 streampack: bool = True, fields: bool = False,
                 cache="auto", cache_queue_pages: int = 0,
                 cache_readahead: Optional[int] = None,
                 sharding: Optional[DataSharding] = None) -> None:
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
            check(layout == "flat" and not fields,
                  "emit='host' requires the fused path (flat layout, no "
                  "fields)")
        if sharding is not None:
            device = _sharded_device(source, sharding, device, ragged,
                                     emit)
        self.sharding = sharding
        device = resolve_device(device)
        put_threads, wire_compact = tuned.resolve(
            device.type, put_threads, wire_compact)
        self.wire_compact = bool(wire_compact)
        if device.type == "cuda" and device.index is None:
            # the transfer threads set this device before their first call
            device = torch.device("cuda", torch.cuda.current_device())
        self.source = source
        self.batch_rows = int(batch_rows)
        self.nnz_cap = int(nnz_cap)
        self.layout = layout
        self.id_mod = int(id_mod)
        self.drop_remainder = bool(drop_remainder)
        self.ragged = bool(ragged)
        self.fields = bool(fields)
        self.emit = emit
        self.streampack = bool(streampack)
        self.engine = resolve_engine(engine)
        self.stats = PackStats()
        # the constructing thread's trace context: the pack and transfer
        # threads activate it, so their spans join the consumer's trace
        # instead of each rooting one of its own
        self._trace = teltrace.current()
        self._cache_path = self._resolve_cache(cache)
        self._cache_queue_pages = max(0, int(cache_queue_pages))
        self._cache_readahead = cache_readahead
        self._cache_writer: Optional[page_cache.PageCacheWriter] = None
        self._cache_reader: Optional[page_cache.PageCacheReader] = None
        self.cache_stats = {"hits": 0, "misses": 0, "drops": 0,
                            "bytes_read": 0, "bytes_written": 0}
        self._m_gen: Optional[int] = None
        put_threads = max(1, int(put_threads))
        depth = max(2, int(prefetch), put_threads)
        self._init_transfer(device, pinned=(device.type == "cuda"
                                            and emit == "device"),
                            pool_cap=2 * depth + 2, depth=depth)
        self._gen: Optional[Iterator] = None
        self._source_read = False           # rewind it before its next epoch
        self._pack_iter: ThreadedIter = ThreadedIter(max_capacity=depth)
        self._pack_iter.init(self._pack_next, self._reset_source,
                             name="dmlc-pack")
        if emit == "host":
            self._iter = self._pack_iter
        elif put_threads > 1:
            self._iter = _TransferPool(
                self._pack_iter,
                lambda item: self._timed_transfer(item, sync=True),
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
                and not self.fields and self.engine == "native")

    def _use_streampack(self) -> bool:
        return (self.streampack and self._use_native_pack()
                and type(self.source) is TextParser
                and self.source.nthreads == 1)

    # -- the packed-page epoch cache ---------------------------------------
    def _fused_path(self) -> bool:
        return self.layout == "flat" and not self.fields and not self.ragged

    def _resolve_cache(self, cache) -> Optional[str]:
        if cache in (None, False, ""):
            return None
        if cache == "auto":
            if not self._fused_path():
                return None
            cf = fingerprint_mod.source_attr(self.source, "cache_file")
            return page_cache.page_path(cf) if cf else None
        check(self._fused_path(), "cache= requires the fused path (flat "
              "layout, no fields, not ragged)")
        return str(cache)

    def _cache_fingerprint(self) -> Optional[dict]:
        """The source's identity (files, sizes, mtimes, part) and the
        whole pack configuration, in the JAX loader's keys; None when no
        file-backed split is under the source.  Taken at every epoch's
        start, so a touched file or a changed configuration rebuilds."""
        split = fingerprint_mod.find_file_split(self.source)
        if split is None:
            return None
        pack_path = ("streampack" if self._use_streampack() else
                     "native" if self._use_native_pack() else "python")
        attr = fingerprint_mod.source_attr
        return fingerprint_mod.pack_fingerprint(
            split, page_format=page_cache.FORMAT_VERSION,
            batch_rows=self.batch_rows, nnz_cap=self.nnz_cap,
            layout=self.layout, id_mod=self.id_mod,
            wire_compact=self.wire_compact,
            drop_remainder=self.drop_remainder, ragged=self.ragged,
            pack_path=pack_path,
            text_format=attr(self.source, "text_format"),
            csv=[attr(self.source, "csv_label_col", -1),
                 attr(self.source, "csv_delim", ",")])

    def _open_cache(self, fingerprint: dict,
                    readahead: Optional[int]
                    ) -> Optional[page_cache.PageCacheReader]:
        return page_cache.open_reader(
            self._cache_path, fingerprint,
            expected_words=self._page_words,
            readahead=readahead)

    def _page_words(self, meta: int) -> int:
        """A page's words as its meta says this loader packed it."""
        return _fused_words_meta(self.batch_rows, meta)

    def cached_page_file(self) -> Optional[str]:
        """The page file the next epoch would be served from, or None
        (no cache configured, or none valid for this configuration)."""
        if self._cache_path is None:
            return None
        fingerprint = self._cache_fingerprint()
        reader = (self._open_cache(fingerprint, 0)
                  if fingerprint is not None else None)
        if reader is None:
            return None
        reader.close()
        return self._cache_path

    def _serve_cached(self, reader: page_cache.PageCacheReader
                      ) -> Iterator[tuple]:
        """An epoch from the page file: each mapped page copied into a
        pool buffer (pinned on the card, so the copy to it is
        asynchronous; the view itself is read-only and never pooled)."""
        self._cache_reader = reader
        # started, not entered: the span outlives each yield, and a
        # generator may be finished from another thread's context
        sp = teltrace.start_span("page_cache.serve_epoch", parent=self._trace,
                                 pages=reader.npages)
        try:
            pages = reader.pages()
            while True:
                with self._m_cache_read.time():
                    page = next(pages, None)
                    if page is not None:
                        meta, rows, view = page
                        buf = self._pool.get(len(view))
                        buf[:len(view)] = view
                if page is None:
                    return
                self._cache_count("bytes_read", view.nbytes)
                yield ("fused", buf, meta, rows)
        except BaseException as e:
            sp.end(error=f"{type(e).__name__}: {e}")
            raise
        finally:
            sp.end()
            self._cache_reader = None
            reader.close()

    def _write_through(self, fingerprint: dict) -> Iterator[tuple]:
        """The first epoch against a missing or stale page file: the
        normal stream, each fused buffer also offered to the page writer;
        a clean end of epoch seals the file, anything else drops it."""
        writer = page_cache.PageCacheWriter(
            self._cache_path, fingerprint,
            queue_pages=self._cache_queue_pages)
        self._cache_writer = writer
        ok = False
        try:
            for item in self._host_items_uncached():
                if item[0] == "fused" and writer.active:
                    _, buf, meta, rows = item
                    words = _fused_words_meta(self.batch_rows, meta)
                    with self._m_cache_write.time():
                        offered = writer.offer(buf, int(meta), rows, words)
                    if offered:
                        self._cache_count("bytes_written", words * 4)
                    else:
                        self._cache_count("drops", 1)
                yield item
            ok = True
        finally:
            self._cache_writer = None
            if not (ok and writer.finalize()):
                writer.abort()

    def _host_items(self) -> Iterator[tuple]:
        """Host items: ``("fused", buf, meta, rows or None)`` for the
        fused wire, ``("arrays", dict, rows)`` for row-major and ragged
        batches; from the page file when a valid one exists, else
        packed (and written through when a cache is configured)."""
        self._maybe_bind()
        if self._cache_path is None:
            yield from self._host_items_uncached()
            return
        fingerprint = self._cache_fingerprint()
        if fingerprint is None:
            # the source's identity is unknowable: never risk a stale page
            yield from self._host_items_uncached()
            return
        reader = self._open_cache(fingerprint, self._cache_readahead)
        if reader is not None:
            self._cache_count("hits", 1)
            yield from self._serve_cached(reader)
            return
        self._cache_count("misses", 1)
        yield from self._write_through(fingerprint)

    def _cache_count(self, key: str, n: int) -> None:
        """One of the page cache's counts: the loader's own
        ``cache_stats`` and the process's ``page_cache.*`` counter."""
        self.cache_stats[key] += n
        self._m_cache[key].add(n)

    def _host_items_uncached(self) -> Iterator[tuple]:
        self._rewind_source()
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
        t0 = time.monotonic()
        with teltrace.activate(self._trace), \
                teltrace.span("device_loader.pack", rows=block.size), \
                trace_span("device_loader.pack"), self._m_pack.time():
            item = self._pack_block(block)
        self._stall_pack.observe(time.monotonic() - t0)
        return item

    def _pack_block(self, block: RowBlock) -> tuple:
        if self.layout == "rowmajor":
            host = pack_rowmajor(block, self.batch_rows, self.nnz_cap,
                                 self.stats, id_mod=self.id_mod,
                                 want_fields=self.fields)
            return ("arrays", host, block.size)
        if self.fields:
            host = pack_flat(block, self.batch_rows, self.nnz_cap,
                             self.stats, id_mod=self.id_mod,
                             want_fields=True)
            host.pop("row_ptr")      # the JAX loader ships no row_ptr here
            return ("arrays", host, block.size)
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
        t0 = time.monotonic()
        with teltrace.activate(self._trace), \
                teltrace.span("device_loader.pack", rows=block.size,
                              ragged=True), \
                trace_span("device_loader.pack"), self._m_pack.time():
            host = pack_ragged(block, self.batch_rows, self.nnz_cap,
                               self.stats, id_mod=self.id_mod,
                               want_fields=self.fields)
        self._stall_pack.observe(time.monotonic() - t0)
        host.pop("row_ptr")          # the JAX loader ships no row_ptr here
        return ("arrays", host, block.size)

    def _native_stats(self, st: Dict[str, int]) -> None:
        self.stats.rows += st["rows"]
        self.stats.padded_rows += st["padded_rows"]
        self.stats.truncated_values += st["truncated_values"]

    def _host_items_native(self) -> Iterator[tuple]:
        packer = native.Packer(self.batch_rows, self.nnz_cap,
                               id_mod=self.id_mod,
                               compact=self.wire_compact)
        try:
            for blk in self._blocks():
                batches = packer.feed(blk, get_buf=self._pool.get,
                                      put_buf=self._pool.put)
                while True:
                    with trace_span("device_loader.pack"), \
                            self._m_pack.time():
                        out = next(batches, None)
                    if out is None:
                        break
                    yield ("fused", out[0], out[1], None)
                # real rows, once a block: the transfer counts none here
                self._m_rows.add(blk.size)
            if not self.drop_remainder:
                tail = packer.flush(get_buf=self._pool.get)
                if tail is not None:
                    yield ("fused", tail[0], tail[1], None)
            self._native_stats(packer.stats())
        finally:
            packer.close()

    def _host_items_streampack(self) -> Iterator[tuple]:
        src = self.source
        split = src.source                  # the TextParser's byte split
        sp = native.SpPacker(self.batch_rows, self.nnz_cap,
                             id_mod=self.id_mod,
                             compact=self.wire_compact, fmt=src.text_format,
                             label_col=src.csv_label_col,
                             delim=src.csv_delim)
        m_chunk = metrics.stage("parser.chunk")
        m_bytes = metrics.throughput("parser.bytes")
        rows_seen = 0
        try:
            while True:
                with m_chunk.time():
                    chunk = split.next_chunk()
                if chunk is None:
                    break
                m_bytes.add(len(chunk))
                batches = sp.feed_text(chunk, get_buf=self._pool.get,
                                       put_buf=self._pool.put)
                while True:
                    with trace_span("device_loader.pack"), \
                            self._m_pack.time():
                        out = next(batches, None)
                    if out is None:
                        break
                    yield ("fused", out[0], out[1], None)
                rows = sp.stats()["rows"]
                self._m_rows.add(rows - rows_seen)
                rows_seen = rows
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
        # the source is rewound where an epoch next reads it: rewound
        # here, a threaded parser would parse the whole source again in
        # the background of an epoch served from the page file
        self._source_read = True

    def _rewind_source(self) -> None:
        if self._source_read and hasattr(self.source, "before_first"):
            self.source.before_first()
        self._source_read = False

    # -- stage 2: transfer (the methods of _TransferStage) ---------------
    def _transfer_next(self, _cell) -> Optional[tuple]:
        item = self._pack_iter.next()
        if item is None:
            self._drain_inflight()
            return None
        return self._timed_transfer(item, sync=False)

    def _timed_transfer(self, item: tuple, sync: bool) -> tuple:
        """:meth:`_transfer_item` under the ``device_loader.h2d`` (or, for
        the pool's workers, ``.h2d_pool``) timer and stall detector; counts
        the batch, and its rows where the pack did not."""
        self._maybe_bind()
        t0 = time.monotonic()
        with teltrace.activate(self._trace), \
                teltrace.span("device_loader.h2d", sync=sync), \
                trace_span("device_loader.h2d"), \
                (self._m_h2d_pool if sync else self._m_h2d).time():
            out = self._transfer_item(item, sync)
        self._stall_h2d.observe(time.monotonic() - t0)
        self._m_batches.add(1)
        rows = item[3] if item[0] == "fused" else item[2]
        if rows is not None:
            self._m_rows.add(rows)
        return out

    def _reset_transfer(self) -> None:
        self._drain_inflight()
        self._pack_iter.before_first()

    # -- metrics -----------------------------------------------------------
    def _maybe_bind(self) -> None:
        if self._m_gen != metrics.generation:
            self._bind_metrics()

    def _bind_metrics(self) -> None:
        """The JAX loader's metric handles, fetched once a registry
        generation (the lookups are locked; the per-batch path reads the
        cached handles).  The stall detectors keep their history across
        generations and re-bind their own metrics."""
        if not hasattr(self, "_stall_pack"):
            self._stall_pack = StallDetector("device_loader.pack")
            self._stall_h2d = StallDetector("device_loader.h2d")
        self._m_gen = metrics.generation
        self._m_pack = metrics.stage("device_loader.pack")
        self._m_h2d = metrics.stage("device_loader.h2d")
        self._m_h2d_pool = metrics.stage("device_loader.h2d_pool")
        self._m_batches = metrics.counter("device_loader.batches")
        self._m_rows = metrics.throughput("device_loader.rows")
        self._m_cache_read = metrics.stage("device_loader.cache_read")
        self._m_cache_write = metrics.stage("device_loader.cache_write")
        self._m_cache = {k: metrics.counter(f"page_cache.{k}")
                         for k in self.cache_stats}

    # -- consumer side ---------------------------------------------------
    def next_batch(self):
        """The next batch (a dict of tensors on the loader's device; with
        ``emit="host"`` a fused host item), or None at the end of the
        epoch."""
        out = self._iter.next()
        if out is None or self.emit == "host":
            return out
        return self._handoff(out)

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
        # a close mid-epoch leaves the pack generator suspended in the
        # cache stream: drop its build and unmap its file now
        writer, reader = self._cache_writer, self._cache_reader
        if writer is not None:
            writer.abort()
        if reader is not None:
            reader.close()
        if hasattr(self.source, "close"):
            self.source.close()

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_TORCH = {np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32}
