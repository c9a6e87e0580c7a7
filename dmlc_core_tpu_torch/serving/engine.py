"""Shape-bucketed inference engine, one captured CUDA graph a bucket,
with atomic hot-reload.

Counterpart of ``dmlc_core_tpu/serving/engine.py``.  A request (CSR
``ids``, ``vals``, ``row_ptr``) is padded up to the smallest bucket of a
(rows × nnz) ladder, so the device only ever sees the ladder's shapes:
flat (``_pad_to_bucket``, padding at the scratch row) or, with
``ragged=True``, at capacity with garbage tails and ``nnz_used`` /
``rows_used`` words (``_pad_to_capacity``; the forward masks the tails
with ``mask_batch``, as the JAX engine does inside its compiled program).

Where the JAX engine compiles each bucket ahead of time, this one
captures each bucket's forward as a CUDA graph, at the bucket's first
use or in :meth:`InferenceEngine.warmup_all`, and replays it on every
later call; ``compile_count`` counts the captured graphs and can never
exceed the ladder's size.  A bucket owns a pinned staging buffer and a
static device buffer, both in the packed int32 layout of
:func:`_batch_to_device` (every array of the padded batch end to end,
viewed back with its own dtype and shape), and the graph's static output
with a pinned copy of it.  A call pads into the staging buffer, copies it
to the static buffer (non-blocking, outside the graph), replays, copies
the scores out and waits on an event, all under the engine's one lock:
a replay's inputs and outputs are static, and every graph of the engine
shares one memory pool, which is safe only because replays run one at a
time and each output is copied out before the next.  Before its capture
a bucket's forward runs once on a side stream, which builds the kernels
and whatever library workspace the forward needs.  A capture that fails
raises.  On the CPU the forward runs eagerly (a bucket is *prepared* by
one dummy batch, which ``compile_count`` counts).

A graph holds the addresses of the weights, so a hot-reload copies the
new weights into the engine's tensors in place: it stages them on the
device first, checks names, shapes and dtypes, then copies under the
same lock a replay holds, so every call sees either the old weights or
the new ones.  The engine clones its weights at construction, so a
reload never writes into the caller's module.  The model is called with
``torch.func.functional_call`` on the engine's parameter dict.

Each call records a ``serving.engine.forward`` span (``rows``,
``bucket_rows``, ``bucket_nnz``, ``ragged``) from before the copy-in to
after the copy-out's event wait, so its duration covers the device's
work, as the JAX engine's does; it is host-side only, never part of a
graph, and recorded after the lock with
:func:`~..telemetry.trace.record_span` (two clock reads and a ring
append on the batcher's serial thread).

Metrics, as the JAX engine's: ``serving.engine.compiles`` (a captured
graph, or a prepared CPU bucket: what ``compile_count`` counts),
``.batches`` and ``.rows`` (throughput) a successful call, the
``.forward`` stage over the same stretch as the span (copy-in, replay
and the copy-out's event wait: no synchronization of its own),
``.occupancy`` (rows over the bucket's), ``.params_version`` (set at a
reload) and ``.padding_ratio`` (the bucket's nnz over the request's;
1.0 when ragged).

The capture watchdog (:mod:`..telemetry.graph_introspect`) is fed as the
JAX engine feeds its compile watchdog, under the same ``xla.*`` names and
bucket keys: each capture (on the CPU, each prepared bucket) with its
wall time, each call on a bucket that was already there as a hit (a
counter add on the calling thread), :meth:`InferenceEngine.warmup_all`
as a declared warm-up window after which a capture is a recapture alert,
and a request too large for the ladder as a ladder miss.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from ..kernels.common import add_launches, record_launches
from ..models.convert import params_from_jax
from ..ops.ragged_csr import mask_batch
from ..telemetry import graph_introspect
from ..telemetry import trace as teltrace
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, check, log_info
from ..utils.metrics import metrics

__all__ = ["ShapeBucket", "BucketLadder", "InferenceEngine",
           "RequestTooLarge"]


class RequestTooLarge(DMLCError):
    """Request exceeds the largest shape bucket."""


class ShapeBucket(NamedTuple):
    rows: int
    nnz: int


class BucketLadder:
    """Sorted ladder of (rows, nnz) buckets; :meth:`best_fit` picks the
    smallest padded area (rows × nnz) that fits."""

    def __init__(self, buckets: Sequence[Tuple[int, int]]) -> None:
        check(len(buckets) > 0, "bucket ladder cannot be empty")
        seen = set()
        self.buckets: List[ShapeBucket] = []
        for r, n in buckets:
            check(r > 0 and n > 0, f"bad bucket ({r}, {n})")
            b = ShapeBucket(int(r), int(n))
            if b not in seen:
                seen.add(b)
                self.buckets.append(b)
        self.buckets.sort(key=lambda b: (b.rows * b.nnz, b.rows))
        self.max_rows = max(b.rows for b in self.buckets)
        self.max_nnz = max(b.nnz for b in self.buckets)
        self._areas = [b.rows * b.nnz for b in self.buckets]

    @classmethod
    def default(cls, max_rows: int = 128, max_nnz: int = 8192,
                min_rows: int = 8, nnz_per_row: int = 64) -> "BucketLadder":
        """Rows 8, 16, … max_rows, each with ``rows × nnz_per_row``
        slots plus one max-nnz catch-all."""
        rungs: List[Tuple[int, int]] = []
        r = min_rows
        while True:
            r = min(r, max_rows)
            rungs.append((r, min(r * nnz_per_row, max_nnz)))
            rungs.append((r, max_nnz))
            if r >= max_rows:
                break
            r *= 2
        return cls(rungs)

    @classmethod
    def ragged_default(cls, max_rows: int = 128, max_nnz: int = 8192,
                       tiers: int = 3) -> "BucketLadder":
        """Capacity ladder for ragged mode: ``tiers`` tiers halving rows
        and nnz together from the max."""
        check(tiers >= 1, "need at least one capacity tier")
        rungs = []
        r, n = max_rows, max_nnz
        for _ in range(tiers):
            rungs.append((max(r, 1), max(n, 1)))
            r //= 2
            n //= 2
        return cls(rungs)

    def best_fit(self, rows: int, nnz: int) -> ShapeBucket:
        """Smallest-area bucket that fits.  Every bucket before
        ``bisect_left(areas, rows·nnz)`` is too small, so the scan
        starts there."""
        start = bisect.bisect_left(self._areas, rows * nnz)
        for b in self.buckets[start:]:
            if b.rows >= rows and b.nnz >= nnz:
                return b
        raise RequestTooLarge(
            f"request ({rows} rows, {nnz} nnz) exceeds the largest bucket "
            f"({self.max_rows} rows, {self.max_nnz} nnz) — split the "
            f"request or widen the ladder")

    def __len__(self) -> int:
        return len(self.buckets)

    def __iter__(self):
        return iter(self.buckets)


def _pad_to_bucket(bucket: ShapeBucket, ids: np.ndarray, vals: np.ndarray,
                   row_ptr: np.ndarray) -> Dict[str, np.ndarray]:
    """CSR request → fixed-shape flat batch; padding values sit at
    ``segment == bucket.rows`` with id 0 and value 0, padding rows carry
    weight 0."""
    rows = len(row_ptr) - 1
    nnz = len(ids)
    out_ids = np.zeros(bucket.nnz, np.int32)
    out_vals = np.zeros(bucket.nnz, np.float32)
    segments = np.full(bucket.nnz, bucket.rows, np.int32)
    out_ids[:nnz] = ids
    out_vals[:nnz] = vals
    counts = np.diff(row_ptr.astype(np.int64))
    segments[:nnz] = np.repeat(np.arange(rows, dtype=np.int32), counts)
    out_ptr = np.empty(bucket.rows + 1, np.int32)
    out_ptr[:rows + 1] = row_ptr
    out_ptr[rows + 1:] = nnz
    labels = np.zeros(bucket.rows, np.float32)
    weights = np.zeros(bucket.rows, np.float32)
    weights[:rows] = 1.0
    return {"ids": out_ids, "vals": out_vals, "segments": segments,
            "row_ptr": out_ptr, "labels": labels, "weights": weights}


def _pad_to_capacity(bucket: ShapeBucket, ids: np.ndarray,
                     vals: np.ndarray,
                     row_ptr: np.ndarray) -> Dict[str, np.ndarray]:
    """CSR request → ragged capacity batch: nnz-sized arrays are
    ``np.empty`` past the request (never zeroed) and validity ends at the
    ``nnz_used``/``rows_used`` words."""
    rows = len(row_ptr) - 1
    nnz = len(ids)
    out_ids = np.empty(bucket.nnz, np.int32)
    out_vals = np.empty(bucket.nnz, np.float32)
    segments = np.empty(bucket.nnz, np.int32)
    out_ids[:nnz] = ids
    out_vals[:nnz] = vals
    counts = np.diff(row_ptr.astype(np.int64))
    segments[:nnz] = np.repeat(np.arange(rows, dtype=np.int32), counts)
    out_ptr = np.empty(bucket.rows + 1, np.int32)
    out_ptr[:rows + 1] = row_ptr
    out_ptr[rows + 1:] = nnz
    labels = np.zeros(bucket.rows, np.float32)
    weights = np.zeros(bucket.rows, np.float32)
    weights[:rows] = 1.0
    return {"ids": out_ids, "vals": out_vals, "segments": segments,
            "row_ptr": out_ptr, "labels": labels, "weights": weights,
            "nnz_used": np.int32(nnz), "rows_used": np.int32(rows)}


Layout = List[Tuple[str, int, Tuple[int, ...], np.dtype]]


def _layout(batch: Dict[str, np.ndarray]) -> Tuple[Layout, int]:
    """The packed int32 layout of a padded batch: ``(name, first word,
    shape, dtype)`` of every array end to end, and the total words."""
    layout, off = [], 0
    for name, arr in batch.items():
        arr = np.asarray(arr)
        check(arr.dtype.itemsize == 4, f"batch field {name} is not 32-bit")
        layout.append((name, off, arr.shape, arr.dtype))
        off += arr.size
    return layout, off


def _pack_into(batch: Dict[str, np.ndarray], out: np.ndarray) -> None:
    """Write ``batch`` into ``out`` (int32 words) in its packed layout."""
    np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.int32)
                    for a in batch.values()], out=out)


def _views(buf: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """The batch's arrays as views of a packed int32 tensor."""
    out = {}
    for name, start, shape, dtype in layout:
        n = int(np.prod(shape, dtype=np.int64))
        piece = buf[start:start + n]
        if dtype == np.float32:
            piece = piece.view(torch.float32)
        out[name] = piece.reshape(shape)
    return out


def _batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Pack every array into one int32 buffer, copy it once, and view
    the pieces back with their own dtypes and shapes."""
    layout, words = _layout(batch)
    host = np.empty(words, np.int32)
    _pack_into(batch, host)
    return _views(torch.from_numpy(host).to(device), layout)


def _device_params(params: Mapping[str, Any], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """A param tree, nested (the JAX layout) or with dotted names (a
    ``state_dict``), → ``{dotted.name: tensor}`` on ``device``."""
    tree: Dict[str, Any] = {}
    for name, value in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return params_from_jax(tree, device)


def _signature(params: Mapping[str, torch.Tensor]) -> Dict[str, Tuple]:
    """name → (shape, dtype name)."""
    return {name: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for name, v in params.items()}


class _BucketGraph:
    """One bucket on the card: the pinned staging buffer and the static
    device input (packed layout), the captured forward, its static output
    and the pinned copy of it."""

    __slots__ = ("host", "host_np", "static", "batch", "graph", "out",
                 "host_out", "out_np", "done", "launches")

    def __init__(self, layout: Layout, words: int, rows: int,
                 device: torch.device) -> None:
        self.host = torch.empty(words, dtype=torch.int32, pin_memory=True)
        self.host_np = self.host.numpy()
        self.static = torch.empty(words, dtype=torch.int32, device=device)
        self.batch = _views(self.static, layout)
        self.host_out = torch.empty(rows, dtype=torch.float32,
                                    pin_memory=True)
        self.out_np = self.host_out.numpy()
        self.done = torch.cuda.Event()
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}   # a replay's kernel launches


class InferenceEngine:
    """Bucketed forward engine over a model module, one captured CUDA
    graph a bucket on the card, with atomic hot-reload.

    ``model`` is an ``nn.Module`` whose ``forward(batch)`` returns
    scores; it is called on the engine's own copy of the weights
    (``params``, or the model's state when omitted; a nested JAX param
    tree of numpy arrays is taken too).  ``device`` defaults to ``cuda``
    and raises when no card is present; pass ``"cpu"`` for the plain
    PyTorch path.  ``postprocess="sigmoid"`` applies the binary link on the
    device.  ``predict`` may be called from any thread and ``reload``
    from any other.
    """

    def __init__(self, model: nn.Module,
                 params: Optional[Mapping[str, Any]] = None, *,
                 buckets: Optional[BucketLadder] = None,
                 postprocess: str = "none", warmup: bool = False,
                 ragged: bool = False,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        check(postprocess in ("none", "sigmoid"),
              f"bad postprocess {postprocess!r}")
        self.device = resolve_device(device)
        self.model = model
        self.ragged = bool(ragged)
        self.ladder = buckets or (BucketLadder.ragged_default() if ragged
                                  else BucketLadder.default())
        # the watchdog's key of each bucket, made once: a hit builds none
        self._keys = {b: graph_introspect.bucket_key(b.rows, b.nnz,
                                                     self.ragged)
                      for b in self.ladder}
        self._postprocess = postprocess
        if params is None:
            params = dict(model.state_dict())
        # the engine's own tensors: a reload copies into them in place
        # (the graphs hold their addresses), never into the caller's
        self._params = {k: v.clone() for k, v in
                        _device_params(params, self.device).items()}
        self._signature = _signature(self._params)
        model_sig = _signature(model.state_dict())
        if self._signature != model_sig:
            raise DMLCError(f"params do not match the model's parameters\n"
                            f"  model:  {model_sig}\n"
                            f"  params: {self._signature}")
        # held by capture, every call's copy-in / replay / copy-out, and
        # the in-place copy of a reload
        self._lock = threading.Lock()
        self._graphs: Dict[ShapeBucket, _BucketGraph] = {}
        self._prepared: set = set()          # the CPU's eager buckets
        self._pool = None                    # the graphs' memory pool
        self.compile_count = 0
        self.params_version = 0
        self._bind_metrics()
        if warmup:
            self.warmup_all()

    def _bind_metrics(self) -> None:
        m = metrics
        self._m_gen = m.generation
        self._m_compiles = m.counter("serving.engine.compiles")
        self._m_batches = m.counter("serving.engine.batches")
        self._m_rows = m.throughput("serving.engine.rows")
        self._m_fwd = m.stage("serving.engine.forward")
        self._m_occupancy = m.gauge("serving.engine.occupancy")
        self._m_version = m.gauge("serving.engine.params_version")
        self._m_padding = m.histogram("serving.engine.padding_ratio")

    def _maybe_rebind(self) -> None:
        if self._m_gen != metrics.generation:
            self._bind_metrics()

    # -- forward --------------------------------------------------------
    def _forward(self, params: Dict[str, torch.Tensor],
                 batch: Dict[str, np.ndarray]) -> torch.Tensor:
        return self._forward_device(params,
                                    _batch_to_device(batch, self.device))

    def _forward_device(self, params: Dict[str, torch.Tensor],
                        batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The device half of a call: the batch is already on the card."""
        with torch.inference_mode():
            if self.ragged:
                batch = mask_batch(batch)
            out = torch.func.functional_call(self.model, params, (batch,))
            if self._postprocess == "sigmoid":
                out = torch.sigmoid(out)
            return out

    def _pad(self, bucket: ShapeBucket, ids, vals, row_ptr):
        pad = _pad_to_capacity if self.ragged else _pad_to_bucket
        return pad(bucket, ids, vals, row_ptr)

    def _dummy(self, bucket: ShapeBucket) -> Dict[str, np.ndarray]:
        return self._pad(bucket, np.zeros(1, np.int32),
                         np.zeros(1, np.float32), np.array([0, 1], np.int64))

    def _capture(self, bucket: ShapeBucket) -> _BucketGraph:
        """The bucket's graph, under the lock: warm-up on a side stream,
        then the capture of one forward over the static input."""
        dev = self.device
        dummy = self._dummy(bucket)
        g = _BucketGraph(*_layout(dummy), bucket.rows, dev)
        self._stage(g, dummy)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._forward_device(self._params, g.batch)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the server's reader threads and the checkpoint
        # watcher keep running while this thread captures
        with record_launches() as launches:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                g.out = self._forward_device(self._params, g.batch)
        g.graph, g.launches = graph, launches
        return g

    def _ready(self, bucket: ShapeBucket) -> Optional[_BucketGraph]:
        """Under the lock: on the card the bucket's graph, captured at
        its first use; on the CPU None, after one dummy forward at the
        bucket's first use."""
        g = self._graphs.get(bucket)
        if g is not None or bucket in self._prepared:
            graph_introspect.watchdog.note_hit(self._keys[bucket])
            return g
        t0 = time.monotonic()
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                g = self._graphs[bucket] = self._capture(bucket)
        else:
            self._forward(self._params, self._dummy(bucket))
            self._prepared.add(bucket)
        wall_s = time.monotonic() - t0
        self.compile_count += 1
        self._maybe_rebind()
        self._m_compiles.add(1)
        graph_introspect.watchdog.note_compile(self._keys[bucket], wall_s)
        log_info("serving: %s bucket rows=%d nnz=%d in %.2fs (%d/%d buckets "
                 "hot)", "captured" if g is not None else "prepared",
                 bucket.rows, bucket.nnz, wall_s, self.compile_count,
                 len(self.ladder))
        return g

    def warmup_all(self) -> None:
        """Capture (on the CPU: prepare) every bucket of the ladder before
        serving.  Afterwards the capture watchdog treats every further
        capture as an alert: the ladder is complete, so a capture means
        traffic fell off it."""
        graph_introspect.watchdog.begin_warmup()
        for bucket in self.ladder:
            with self._lock:
                self._ready(bucket)
        graph_introspect.watchdog.mark_steady()

    # -- a call on the card: copy in, replay, copy out --------------------
    def _stage(self, g: _BucketGraph, batch: Dict[str, np.ndarray]) -> None:
        """The padded batch into the pinned staging buffer, then one
        non-blocking copy into the graph's static input."""
        _pack_into(batch, g.host_np)
        g.static.copy_(g.host, non_blocking=True)

    def _replay(self, g: _BucketGraph) -> None:
        g.graph.replay()
        add_launches(g.launches)

    def _copy_out(self, g: _BucketGraph, rows: int) -> np.ndarray:
        """The scores of the last replay, once they are on the host."""
        g.host_out.copy_(g.out, non_blocking=True)
        g.done.record(torch.cuda.current_stream(self.device))
        g.done.synchronize()
        return g.out_np[:rows].copy()

    # -- serving path ---------------------------------------------------
    def predict(self, ids: np.ndarray, vals: np.ndarray,
                row_ptr: Optional[np.ndarray] = None) -> np.ndarray:
        """Score one CSR request: ``ids``/``vals`` concatenated over its
        rows, ``row_ptr`` ``[rows+1]`` offsets (omitted = one row).
        Returns float32 scores ``[rows]``."""
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        if row_ptr is None:
            row_ptr = np.array([0, len(ids)], np.int64)
        row_ptr = np.asarray(row_ptr)
        rows = len(row_ptr) - 1
        check(rows >= 1, "request has no rows")
        check(len(ids) == len(vals), "ids/vals length mismatch")
        check(int(row_ptr[0]) == 0 and int(row_ptr[-1]) == len(ids),
              "row_ptr does not cover ids")
        try:
            bucket = self.ladder.best_fit(rows, max(len(ids), 1))
        except RequestTooLarge as e:
            graph_introspect.watchdog.note_ladder_miss(str(e))
            raise
        batch = self._pad(bucket, ids, vals, row_ptr)
        self._maybe_rebind()
        with self._lock:
            g = self._ready(bucket)
            # the span's clock (and the forward stage's) starts after the
            # capture and stops once the scores are on the host, so it
            # covers the device's work; the span is recorded after the
            # lock, a host-side record only.  A child of the request
            # context the batcher activated, or a new root
            t0_wall, t0 = time.time(), time.monotonic()
            try:
                with self._m_fwd.time():
                    if g is None:
                        out = self._forward(self._params,
                                            batch).numpy()[:rows]
                    else:
                        with torch.cuda.device(self.device):
                            self._stage(g, batch)
                            self._replay(g)
                            out = self._copy_out(g, rows)
            except BaseException as e:
                teltrace.record_span(
                    "serving.engine.forward", t0_wall, t0, rows=rows,
                    bucket_rows=bucket.rows, bucket_nnz=bucket.nnz,
                    ragged=self.ragged, error=f"{type(e).__name__}: {e}")
                raise
        teltrace.record_span("serving.engine.forward", t0_wall, t0,
                             rows=rows, bucket_rows=bucket.rows,
                             bucket_nnz=bucket.nnz, ragged=self.ragged)
        self._m_batches.add(1)
        self._m_rows.add(rows)
        self._m_occupancy.set(rows / bucket.rows)
        # padded nnz over true nnz: the padded forward reduces the whole
        # bucket, the ragged one only nnz_used
        self._m_padding.observe(1.0 if self.ragged
                                else bucket.nnz / max(len(ids), 1))
        return out

    # -- hot reload -----------------------------------------------------
    def reload(self, params: Mapping[str, Any]) -> None:
        """Swap the weights atomically.  Names, shapes and dtypes must
        match the serving ones, or the reload is refused and the old
        weights keep serving.  The new weights are staged on the device,
        then copied into the engine's tensors under the lock."""
        new = _device_params(params, self.device)
        sig = _signature(new)
        if sig != self._signature:
            raise DMLCError(
                "hot-reload refused: new params do not match the serving "
                f"model's shapes/dtypes\n  serving: {self._signature}\n"
                f"  reload:  {sig}")
        with self._lock:
            for name, t in self._params.items():
                t.copy_(new[name])
            if self.device.type == "cuda":
                # complete before any replay, whichever stream it is on
                torch.cuda.current_stream(self.device).synchronize()
            self.params_version += 1
            self._maybe_rebind()
            self._m_version.set(self.params_version)

    def reload_from_checkpoint(self, directory: str,
                               step: Optional[int] = None) -> int:
        """Restore params from a checkpoint directory (the port's or the
        JAX package's) and hot-swap them; returns the restored step."""
        from ..utils.checkpoint import load_for_inference
        step, params, meta = load_for_inference(
            directory, step, template=self._params)
        self.reload(params)
        log_info("serving: hot-reloaded step %s from %s (model=%s)",
                 step, directory, meta.get("model", "?"))
        return step
