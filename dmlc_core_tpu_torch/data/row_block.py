"""Sparse CSR row blocks and their growable owner.

Counterpart of ``dmlc_core_tpu/data/row_block.py``: :class:`RowBlock`,
the immutable CSR view (its ``size``, ``num_values``, ``num_col``,
``memcost_bytes``, ``row``, ``weight``, ``sdot`` and O(1) ``slice``), and
:class:`RowBlockContainer`, the growable owner (``push_row``,
``push_block``, ``from_arrays``, ``get_block`` and the binary
``save``/``load``, whose stream is the JAX package's byte for byte, so a
container saved by either package loads in the other).  Plus
:func:`concat_blocks`, which does what ``push_block`` + ``get_block`` do
for the loader's carry of partial batches.  Arrays:

* ``offsets``  int64[n+1] — row k's entries live in [offsets[k], offsets[k+1])
* ``labels``   float32[n]
* ``weights``  float32[n] or None (implicit 1.0)
* ``indices``  uint64[m] — feature ids
* ``values``   float32[m] or None (implicit 1.0)
* ``fields``   uint32[m] or None (libfm field ids); ``max_field`` the
  largest (0 without fields)

One difference from the JAX class: the seventh positional argument is
``max_field`` (as the port's parsers have always passed it) and
``max_index``, when not given, is computed at its first use.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from ..utils import serializer as ser
from ..utils.logging import check

__all__ = ["RowBlock", "RowBlockContainer", "concat_blocks"]


class RowBlock:
    """Immutable CSR view over numpy arrays."""

    def __init__(self, offsets: np.ndarray, labels: np.ndarray,
                 indices: np.ndarray, values: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None,
                 fields: Optional[np.ndarray] = None,
                 max_field: int = 0,
                 max_index: Optional[int] = None) -> None:
        self.offsets = offsets
        self.labels = labels
        self.indices = indices
        self.values = values
        self.weights = weights
        self.fields = fields
        self.max_field = max_field
        self._max_index = max_index
        check(len(labels) == len(offsets) - 1,
              f"labels length {len(labels)} != num rows {len(offsets) - 1}")

    @property
    def max_index(self) -> int:
        """The largest feature id (0 for a block without values)."""
        if self._max_index is None:
            self._max_index = (int(self.indices.max())
                               if len(self.indices) else 0)
        return self._max_index

    @property
    def size(self) -> int:
        """Number of rows."""
        return len(self.offsets) - 1

    @property
    def num_values(self) -> int:
        return int(self.offsets[-1] - self.offsets[0])

    @property
    def num_col(self) -> int:
        return self.max_index + 1

    def memcost_bytes(self) -> int:
        """Bytes of the block's arrays."""
        total = self.offsets.nbytes + self.labels.nbytes + self.indices.nbytes
        for a in (self.values, self.weights, self.fields):
            if a is not None:
                total += a.nbytes
        return total

    def __len__(self) -> int:
        return self.size

    def row(self, i: int) -> Tuple[float, np.ndarray, Optional[np.ndarray]]:
        """``(label, indices, values)`` of row ``i``."""
        b, e = int(self.offsets[i]), int(self.offsets[i + 1])
        vals = self.values[b:e] if self.values is not None else None
        return float(self.labels[i]), self.indices[b:e], vals

    def weight(self, i: int) -> float:
        return float(self.weights[i]) if self.weights is not None else 1.0

    def sdot(self, i: int, dense: np.ndarray) -> float:
        """Row ``i`` · ``dense``."""
        _, idx, vals = self.row(i)
        picked = dense[idx.astype(np.int64)]
        return float(picked.sum() if vals is None else (picked * vals).sum())

    def slice(self, begin: int, end: int) -> "RowBlock":
        """O(1) sub-range view of rows ``[begin, end)``."""
        check(0 <= begin <= end <= self.size,
              f"bad slice [{begin}, {end}) of {self.size} rows")
        vb, ve = int(self.offsets[begin]), int(self.offsets[end])
        return RowBlock(
            offsets=self.offsets[begin:end + 1] - self.offsets[begin],
            labels=self.labels[begin:end],
            indices=self.indices[vb:ve],
            values=self.values[vb:ve] if self.values is not None else None,
            weights=(self.weights[begin:end]
                     if self.weights is not None else None),
            fields=self.fields[vb:ve] if self.fields is not None else None,
            max_field=self.max_field, max_index=self._max_index)


class RowBlockContainer:
    """Growable CSR owner."""

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self._block: Optional[RowBlock] = None
        self._offsets: List[int] = [0]
        self._labels: List[float] = []
        self._weights: List[float] = []
        self._index_arrays: List[np.ndarray] = []
        self._value_arrays: List[Optional[np.ndarray]] = []
        self._field_arrays: List[Optional[np.ndarray]] = []
        self.max_index = 0
        self.max_field = 0

    @property
    def size(self) -> int:
        if self._block is not None and not self._labels:
            return self._block.size
        return len(self._labels)

    def _ensure_mutable(self) -> None:
        """Fold a cached or wrapped block back into growable form before a
        push."""
        blk = self._block
        if blk is None:
            return
        self._block = None
        if not self._labels and blk.size > 0:
            self.push_block(blk)

    def push_row(self, label: float, indices: np.ndarray,
                 values: Optional[np.ndarray] = None, weight: float = 1.0,
                 fields: Optional[np.ndarray] = None) -> None:
        """Append one row."""
        self._ensure_mutable()
        self._labels.append(label)
        self._weights.append(weight)
        self._offsets.append(self._offsets[-1] + len(indices))
        self._index_arrays.append(np.asarray(indices, dtype=np.uint64))
        self._value_arrays.append(
            None if values is None else np.asarray(values, dtype=np.float32))
        self._field_arrays.append(
            None if fields is None else np.asarray(fields, dtype=np.uint32))
        if len(indices):
            self.max_index = max(self.max_index, int(np.max(indices)))
        if fields is not None and len(fields):
            self.max_field = max(self.max_field, int(np.max(fields)))

    def push_block(self, block: RowBlock) -> None:
        """Append a whole block (values made explicit, as the JAX
        container makes them)."""
        self._ensure_mutable()
        base = self._offsets[-1]
        rel = (block.offsets[1:] - block.offsets[0]).astype(np.int64)
        self._offsets.extend((base + rel).tolist())
        self._labels.extend(block.labels.tolist())
        w = (block.weights if block.weights is not None
             else np.ones(block.size, np.float32))
        self._weights.extend(w.tolist())
        vb, ve = int(block.offsets[0]), int(block.offsets[-1])
        self._index_arrays.append(block.indices[vb:ve])
        self._value_arrays.append(
            block.values[vb:ve] if block.values is not None else
            np.ones(ve - vb, np.float32))
        self._field_arrays.append(
            block.fields[vb:ve] if block.fields is not None else None)
        self.max_index = max(self.max_index, block.max_index)
        self.max_field = max(self.max_field, block.max_field)

    @staticmethod
    def from_arrays(offsets, labels, indices, values=None, weights=None,
                    fields=None, max_index=None,
                    max_field=0) -> "RowBlockContainer":
        """Wrap parser output arrays without copying."""
        c = RowBlockContainer()
        c._block = RowBlock(
            np.asarray(offsets, np.int64), np.asarray(labels, np.float32),
            np.asarray(indices, np.uint64),
            None if values is None else np.asarray(values, np.float32),
            None if weights is None else np.asarray(weights, np.float32),
            None if fields is None else np.asarray(fields, np.uint32),
            max_field=max_field, max_index=max_index)
        c.max_index = c._block.max_index
        c.max_field = max_field
        return c

    def get_block(self) -> RowBlock:
        """The rows as one CSR block (built once, then cached)."""
        if self._block is not None:
            return self._block
        n = self.size
        indices = (np.concatenate(self._index_arrays)
                   if self._index_arrays else np.empty(0, np.uint64))
        have_values = any(v is not None for v in self._value_arrays)
        have_fields = any(f is not None for f in self._field_arrays)
        values = None
        fields = None
        if have_values:
            values = np.concatenate([
                v if v is not None
                else np.ones(len(self._index_arrays[i]), np.float32)
                for i, v in enumerate(self._value_arrays)]) \
                if n else np.empty(0, np.float32)
        if have_fields:
            fields = np.concatenate([
                f if f is not None
                else np.zeros(len(self._index_arrays[i]), np.uint32)
                for i, f in enumerate(self._field_arrays)]) \
                if n else np.empty(0, np.uint32)
        weights = np.asarray(self._weights, np.float32)
        if np.all(weights == 1.0):
            weights = None
        self._block = RowBlock(
            np.asarray(self._offsets, np.int64),
            np.asarray(self._labels, np.float32),
            indices.astype(np.uint64, copy=False), values, weights, fields,
            max_field=self.max_field, max_index=self.max_index)
        return self._block

    # -- the binary round trip: the JAX package's stream, byte for byte --
    def save(self, stream: Any) -> None:
        b = self.get_block()
        ser.save(stream, {
            "offsets": b.offsets, "labels": b.labels, "indices": b.indices,
            "values": b.values, "weights": b.weights, "fields": b.fields,
            "max_index": b.max_index, "max_field": b.max_field,
        })

    def load(self, stream: Any) -> None:
        d = ser.load(stream)
        self.clear()
        self._block = RowBlock(
            d["offsets"], d["labels"], d["indices"], d["values"],
            d["weights"], d["fields"], max_field=d["max_field"],
            max_index=d["max_index"])
        self.max_index = d["max_index"]
        self.max_field = d["max_field"]


def concat_blocks(blocks: List[RowBlock]) -> RowBlock:
    """Rows of ``blocks`` in order, as one block.  A missing ``values`` or
    ``weights`` array becomes explicit ones, and missing ``fields`` zeros,
    where another block has one, as ``RowBlockContainer.push_block`` and
    ``get_block`` do."""
    if len(blocks) == 1:
        return blocks[0]
    counts = np.concatenate([np.diff(b.offsets) for b in blocks])
    offsets = np.concatenate([[0], np.cumsum(counts)])
    span = [slice(int(b.offsets[0]), int(b.offsets[-1])) for b in blocks]
    indices = np.concatenate([b.indices[s] for b, s in zip(blocks, span)])
    values = None
    if any(b.values is not None for b in blocks):
        values = np.concatenate([
            b.values[s] if b.values is not None
            else np.ones(s.stop - s.start, np.float32)
            for b, s in zip(blocks, span)])
    weights = None
    if any(b.weights is not None for b in blocks):
        weights = np.concatenate([
            b.weights if b.weights is not None
            else np.ones(b.size, np.float32) for b in blocks])
    fields = None
    if any(b.fields is not None for b in blocks):
        fields = np.concatenate([
            b.fields[s] if b.fields is not None
            else np.zeros(s.stop - s.start, np.uint32)
            for b, s in zip(blocks, span)])
    return RowBlock(offsets.astype(np.int64),
                    np.concatenate([b.labels for b in blocks]),
                    indices, values, weights, fields,
                    max(b.max_field for b in blocks))
