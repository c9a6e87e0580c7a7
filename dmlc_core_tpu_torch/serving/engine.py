"""Shape-bucketed inference engine with atomic hot-reload.

Counterpart of ``dmlc_core_tpu/serving/engine.py``.  A request (CSR
``ids``, ``vals``, ``row_ptr``) is padded up to the smallest bucket of a
(rows × nnz) ladder, so the device only ever sees the ladder's shapes:
flat (``_pad_to_bucket``, padding at the scratch row) or, with
``ragged=True``, at capacity with garbage tails and ``nnz_used`` /
``rows_used`` words (``_pad_to_capacity``; the forward masks the tails
with ``mask_batch``, as the JAX engine does inside its compiled program).

PyTorch runs eagerly, so there is nothing to compile: a bucket is
*prepared* on its first use (or by :meth:`InferenceEngine.warmup_all`)
by running one dummy batch through it, which builds the kernels and
warms the allocator.  ``compile_count`` counts prepared buckets and can
never exceed the ladder's size.  Capturing one CUDA graph per bucket is
later work.

The padded batch travels to the card in one host-to-device copy: every
array is packed into one int32 buffer and viewed back on the device.

Hot-reload swaps the parameter dict atomically (one reference assignment
under a lock) after checking names, shapes and dtypes; requests already
holding the old dict finish on it.  The model is called with
``torch.func.functional_call`` on the engine's parameter dict.
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

from ..models.convert import params_from_jax
from ..ops.ragged_csr import mask_batch
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, check, log_info

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


def _batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Pack every array into one int32 buffer, copy it once, and view
    the pieces back with their own dtypes and shapes."""
    parts, layout, off = [], [], 0
    for name, arr in batch.items():
        arr = np.asarray(arr)
        check(arr.dtype.itemsize == 4, f"batch field {name} is not 32-bit")
        flat = np.ascontiguousarray(arr).reshape(-1).view(np.int32)
        parts.append(flat)
        layout.append((name, off, arr.shape, arr.dtype))
        off += flat.size
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    out = {}
    for name, start, shape, dtype in layout:
        n = int(np.prod(shape, dtype=np.int64))
        piece = buf[start:start + n]
        if dtype == np.float32:
            piece = piece.view(torch.float32)
        out[name] = piece.reshape(shape)
    return out


def _signature(params: Mapping[str, Any]) -> Dict[str, Tuple]:
    """name → (shape, dtype name), for numpy and torch leaves alike."""
    sig = {}
    for name, value in params.items():
        if isinstance(value, torch.Tensor):
            sig[name] = (tuple(value.shape),
                         str(value.dtype).removeprefix("torch."))
        else:
            arr = np.asarray(value)
            sig[name] = (tuple(arr.shape), str(arr.dtype))
    return sig


class InferenceEngine:
    """Bucketed forward engine over a model module, with atomic
    hot-reload.

    ``model`` is an ``nn.Module`` whose ``forward(batch)`` returns
    scores; its parameters are replaced, at every call, by the engine's
    own dict (``params``, or the model's state when omitted).  ``device``
    defaults to ``cuda`` and raises when no card is present; pass
    ``"cpu"`` for the plain PyTorch path.  ``postprocess="sigmoid"``
    applies the binary link on the device.  ``predict`` may be called
    from any thread and ``reload`` from any other.
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
        self._postprocess = postprocess
        if params is None:
            params = dict(model.state_dict())
        self._signature = _signature(params)
        model_sig = _signature(model.state_dict())
        if self._signature != model_sig:
            raise DMLCError(f"params do not match the model's parameters\n"
                            f"  model:  {model_sig}\n"
                            f"  params: {self._signature}")
        self._params = params_from_jax(params, self.device)
        self._prepared: set = set()
        self._prepare_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self.compile_count = 0
        self.params_version = 0
        if warmup:
            self.warmup_all()

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

    def _prepare(self, bucket: ShapeBucket) -> None:
        """First use of a bucket: one dummy batch through the forward."""
        if bucket in self._prepared:
            return
        with self._prepare_lock:
            if bucket in self._prepared:
                return
            t0 = time.monotonic()
            dummy = self._pad(bucket, np.zeros(1, np.int32),
                              np.zeros(1, np.float32),
                              np.array([0, 1], np.int64))
            self._forward(self._params, dummy).cpu()
            self._prepared.add(bucket)
            self.compile_count += 1
            log_info("serving: prepared bucket rows=%d nnz=%d in %.2fs "
                     "(%d/%d buckets hot)", bucket.rows, bucket.nnz,
                     time.monotonic() - t0, len(self._prepared),
                     len(self.ladder))

    def warmup_all(self) -> None:
        """Prepare every bucket of the ladder before serving."""
        for bucket in self.ladder:
            self._prepare(bucket)

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
        bucket = self.ladder.best_fit(rows, max(len(ids), 1))
        self._prepare(bucket)
        params = self._params          # one read: hot-reload safe
        out = self._forward(params, self._pad(bucket, ids, vals, row_ptr))
        return out.cpu().numpy()[:rows]

    # -- hot reload -----------------------------------------------------
    def reload(self, params: Mapping[str, Any]) -> None:
        """Swap the weights atomically.  Names, shapes and dtypes must
        match the serving ones, or the reload is refused and the old
        weights keep serving."""
        sig = _signature(params)
        if sig != self._signature:
            raise DMLCError(
                "hot-reload refused: new params do not match the serving "
                f"model's shapes/dtypes\n  serving: {self._signature}\n"
                f"  reload:  {sig}")
        new = params_from_jax(params, self.device)
        with self._reload_lock:
            self._params = new
            self.params_version += 1

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
