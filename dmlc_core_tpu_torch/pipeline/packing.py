"""Pack ragged CSR RowBlocks into fixed-shape batches.

Counterpart of ``dmlc_core_tpu/pipeline/packing.py`` (``batch_slices``,
``pack_flat`` with its water-fill truncation, ``pack_rowmajor``,
``ragged_slices`` and ``pack_ragged``, ``_ids32`` with ``id_mod``,
``PackStats``).  Pure numpy, and bit-equal to
the JAX package's packing on the same blocks:

* :func:`pack_flat` — flat CSR: ``ids[nnz_cap]``, ``vals[nnz_cap]``,
  ``segments[nnz_cap]`` (row of each entry; padding entries get
  ``segment == batch_rows``, the scratch row), ``row_ptr[batch_rows+1]``
  and ``labels/weights[batch_rows]``.  A batch whose values overflow
  ``nnz_cap`` is truncated row by row with the fewest values dropped.
* :func:`pack_rowmajor` — row-padded ``ids/vals[batch_rows, k_cap]``,
  padding id 0 and value 0.
* :func:`pack_ragged` — the flat layout as a capacity buffer: entries
  valid only below the ``nnz_used`` prefix word (the tail is garbage by
  contract), batches cut by cumulative nnz (:func:`ragged_slices`), and
  never a value truncated.

Padding rows carry weight 0, so losses ignore them without masking.  Any
truncation is counted in :class:`PackStats` and logged (at most once a
minute); the JAX package also bumps its metrics registry, which the port
does not have yet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..data.row_block import RowBlock
from ..utils.logging import IdOverflowError, log_warning

__all__ = ["pack_flat", "pack_rowmajor", "pack_ragged", "batch_slices",
           "ragged_slices", "PackStats"]


@dataclass
class PackStats:
    rows: int = 0
    padded_rows: int = 0
    truncated_values: int = 0
    truncated_rows: int = 0
    true_nnz: int = 0          # values the data holds
    padded_nnz: int = 0        # values the dense math reduces over

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / self.true_nnz if self.true_nnz else 1.0


_trunc_warn_lock = threading.Lock()
_trunc_warn_last = [0.0]
_TRUNC_WARN_EVERY_S = 60.0


def _note_truncation(values: int, rows: int, where: str) -> None:
    if values <= 0:
        return
    now = time.monotonic()
    with _trunc_warn_lock:
        fire = now - _trunc_warn_last[0] >= _TRUNC_WARN_EVERY_S
        if fire:
            _trunc_warn_last[0] = now
    if fire:
        log_warning("%s dropped %d value(s) across %d row(s) that overflowed "
                    "the batch capacity; raise nnz_cap/k_cap", where, values,
                    rows)


def _ids32(idx: np.ndarray, id_mod: int) -> np.ndarray:
    """uint64 feature ids → int32 ids.  ``id_mod`` > 0 hashes them
    (``id % id_mod``); otherwise an id beyond int32 raises instead of
    wrapping negative."""
    if id_mod:
        return (idx.astype(np.uint64) % np.uint64(id_mod)).astype(np.int32)
    if len(idx) and int(idx.max()) > np.iinfo(np.int32).max:
        raise IdOverflowError(
            f"feature id {int(idx.max())} > 2^31-1 — pass id_mod (feature "
            f"hashing) or keep ids below int32 range")
    return idx.astype(np.int32)


def _waterfill(counts: np.ndarray, cap: int) -> np.ndarray:
    """keep[i] = min(counts[i], t) + at most 1, chosen so keep.sum() == cap
    exactly (when counts.sum() >= cap) with the fewest values dropped."""
    counts = counts.astype(np.int64)
    if counts.sum() <= cap:
        return counts
    order = np.argsort(counts)
    sorted_counts = counts[order]
    n = len(counts)
    prefix = np.concatenate([[0], np.cumsum(sorted_counts)])
    # with level t, usage = prefix[k] + (n - k) * t where k = #counts <= t
    t = 0
    for k in range(n):
        level = (cap - prefix[k]) // (n - k)
        if level <= sorted_counts[k]:
            t = max(t, level)
            break
        t = sorted_counts[k]
    keep = np.minimum(counts, t)
    leftover = cap - int(keep.sum())
    if leftover > 0:
        # hand spare slots to the rows still truncated, largest first
        cand = np.argsort(-(counts - keep))
        for i in cand[:leftover]:
            if counts[i] > keep[i]:
                keep[i] += 1
    return keep


def batch_slices(block: RowBlock, batch_rows: int) -> Iterator[RowBlock]:
    """Split a RowBlock into consecutive ≤batch_rows slices (O(1) views)."""
    for start in range(0, block.size, batch_rows):
        yield block.slice(start, min(start + batch_rows, block.size))


def _row_tail(block: RowBlock, batch_rows: int):
    n = block.size
    labels = np.zeros(batch_rows, np.float32)
    weights = np.zeros(batch_rows, np.float32)          # padding rows weigh 0
    labels[:n] = block.labels
    weights[:n] = (block.weights if block.weights is not None
                   else np.ones(n, np.float32))
    return labels, weights


def pack_flat(block: RowBlock, batch_rows: int, nnz_cap: int,
              stats: Optional[PackStats] = None, id_mod: int = 0,
              want_segments: bool = True) -> Dict[str, np.ndarray]:
    """Flat-CSR fixed-shape batch; ``block.size`` must be ≤ batch_rows.
    ``want_segments=False`` leaves out ``segments`` (the fused wire
    rebuilds them from ``row_ptr``)."""
    n = block.size
    if n > batch_rows:
        raise ValueError(f"block rows {n} > batch_rows {batch_rows}")
    offsets = block.offsets.astype(np.int64)
    rel = offsets - offsets[0]
    counts = np.diff(rel)
    total = int(rel[-1])

    ids = np.zeros(nnz_cap, np.int32)
    vals = np.zeros(nnz_cap, np.float32)
    segments = (np.full(nnz_cap, batch_rows, np.int32)  # padding → scratch
                if want_segments else None)
    row_ptr = np.empty(batch_rows + 1, np.int32)

    truncated = trunc_rows = 0
    if total <= nnz_cap:
        src = slice(int(offsets[0]), int(offsets[0]) + total)
        ids[:total] = _ids32(block.indices[src], id_mod)
        vals[:total] = block.values[src] if block.values is not None else 1.0
        if want_segments:
            segments[:total] = np.repeat(np.arange(n, dtype=np.int32),
                                         counts)
        row_ptr[:n + 1] = rel
        row_ptr[n + 1:] = total
    else:
        # water-fill: short rows keep everything, the fewest values drop
        keep = _waterfill(counts, nnz_cap)
        trunc_rows = int(np.count_nonzero(keep < counts))
        pos = 0
        for r in range(n):
            k = int(keep[r])
            b = int(offsets[r])
            ids[pos:pos + k] = _ids32(block.indices[b:b + k], id_mod)
            vals[pos:pos + k] = (block.values[b:b + k]
                                 if block.values is not None else 1.0)
            if want_segments:
                segments[pos:pos + k] = r
            pos += k
        truncated = total - pos
        _note_truncation(truncated, trunc_rows, "pack_flat")
        row_ptr[0] = 0
        row_ptr[1:n + 1] = np.cumsum(keep)
        row_ptr[n + 1:] = pos

    labels, weights = _row_tail(block, batch_rows)
    if stats is not None:
        stats.rows += n
        stats.padded_rows += batch_rows - n
        stats.truncated_values += truncated
        stats.truncated_rows += trunc_rows
        stats.true_nnz += total - truncated
        stats.padded_nnz += nnz_cap
    out = {"ids": ids, "vals": vals, "row_ptr": row_ptr, "labels": labels,
           "weights": weights}
    if want_segments:
        out["segments"] = segments
    return out


def pack_rowmajor(block: RowBlock, batch_rows: int, k_cap: int,
                  stats: Optional[PackStats] = None,
                  id_mod: int = 0) -> Dict[str, np.ndarray]:
    """Row-padded ``[batch_rows, k_cap]`` batch for the embed-bag kernel;
    a row longer than ``k_cap`` keeps its first ``k_cap`` values."""
    n = block.size
    if n > batch_rows:
        raise ValueError(f"block rows {n} > batch_rows {batch_rows}")
    ids = np.zeros((batch_rows, k_cap), np.int32)
    vals = np.zeros((batch_rows, k_cap), np.float32)
    offsets = block.offsets.astype(np.int64)
    truncated = trunc_rows = 0
    for r in range(n):
        b, e = int(offsets[r]), int(offsets[r + 1])
        k = min(e - b, k_cap)
        truncated += (e - b) - k
        trunc_rows += (e - b) > k
        ids[r, :k] = _ids32(block.indices[b:b + k], id_mod)
        vals[r, :k] = block.values[b:b + k] if block.values is not None else 1.0
    labels, weights = _row_tail(block, batch_rows)
    _note_truncation(truncated, trunc_rows, "pack_rowmajor")
    if stats is not None:
        stats.rows += n
        stats.padded_rows += batch_rows - n
        stats.truncated_values += truncated
        stats.truncated_rows += trunc_rows
        stats.true_nnz += int(offsets[n] - offsets[0]) - truncated
        stats.padded_nnz += batch_rows * k_cap
    return {"ids": ids, "vals": vals, "labels": labels, "weights": weights}


def ragged_slices(block: RowBlock, batch_rows: int,
                  nnz_cap: int) -> Iterator[RowBlock]:
    """Consecutive slices of ``block`` cut by cumulative nnz against
    ``nnz_cap`` and by rows against ``batch_rows`` (O(1) views).  A row
    that alone holds more than ``nnz_cap`` values raises: the ragged path
    never truncates."""
    offsets = block.offsets.astype(np.int64)
    rel = offsets - offsets[0]
    start = 0
    while start < block.size:
        end = int(np.searchsorted(rel, rel[start] + nnz_cap,
                                  side="right")) - 1
        end = min(end, start + batch_rows, block.size)
        if end <= start:
            raise ValueError(
                f"row {start} holds {int(rel[start + 1] - rel[start])} "
                f"values > nnz_cap={nnz_cap}; the ragged path never "
                f"truncates — raise the capacity")
        yield block.slice(start, end)
        start = end


def pack_ragged(block: RowBlock, batch_rows: int, nnz_cap: int,
                stats: Optional[PackStats] = None,
                id_mod: int = 0) -> Dict[str, np.ndarray]:
    """Flat capacity batch: :func:`pack_flat`'s keys and shapes plus the
    int32 words ``nnz_used`` and ``rows_used``.  The nnz-sized arrays are
    ``np.empty`` and written only below ``nnz_used`` (their tails are
    garbage by contract); the row-sized arrays get clean tails.  Raises
    when ``block`` exceeds either capacity (cut it with
    :func:`ragged_slices`)."""
    n = block.size
    if n > batch_rows:
        raise ValueError(f"block rows {n} > batch_rows {batch_rows}")
    offsets = block.offsets.astype(np.int64)
    rel = offsets - offsets[0]
    total = int(rel[-1])
    if total > nnz_cap:
        raise ValueError(
            f"block nnz {total} > nnz_cap {nnz_cap}; the ragged path "
            f"never truncates — cut with ragged_slices")
    ids = np.empty(nnz_cap, np.int32)
    vals = np.empty(nnz_cap, np.float32)
    segments = np.empty(nnz_cap, np.int32)
    src = slice(int(offsets[0]), int(offsets[0]) + total)
    ids[:total] = _ids32(block.indices[src], id_mod)
    vals[:total] = block.values[src] if block.values is not None else 1.0
    segments[:total] = np.repeat(np.arange(n, dtype=np.int32), np.diff(rel))
    row_ptr = np.empty(batch_rows + 1, np.int32)
    row_ptr[:n + 1] = rel
    row_ptr[n + 1:] = total
    labels, weights = _row_tail(block, batch_rows)
    if stats is not None:
        stats.rows += n
        stats.padded_rows += batch_rows - n
        stats.true_nnz += total
        stats.padded_nnz += total          # ragged math reduces true nnz
    return {"ids": ids, "vals": vals, "segments": segments,
            "row_ptr": row_ptr, "labels": labels, "weights": weights,
            "nnz_used": np.int32(total), "rows_used": np.int32(n)}
