"""Sparse CSR row blocks, the subset that parsing and packing need.

Counterpart of ``dmlc_core_tpu/data/row_block.py`` (``RowBlock``: the
immutable CSR view, its ``size`` and O(1) ``slice``), plus
:func:`concat_blocks`, which does what ``RowBlockContainer.push_block`` +
``get_block`` do for the loader's carry of partial batches.  Arrays:

* ``offsets``  int64[n+1] — row k's entries live in [offsets[k], offsets[k+1])
* ``labels``   float32[n]
* ``weights``  float32[n] or None (implicit 1.0)
* ``indices``  uint64[m] — feature ids
* ``values``   float32[m] or None (implicit 1.0)
* ``fields``   uint32[m] or None (libfm field ids); ``max_field`` the
  largest (0 without fields)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.logging import check

__all__ = ["RowBlock", "concat_blocks"]


class RowBlock:
    """Immutable CSR view over numpy arrays."""

    def __init__(self, offsets: np.ndarray, labels: np.ndarray,
                 indices: np.ndarray, values: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None,
                 fields: Optional[np.ndarray] = None,
                 max_field: int = 0) -> None:
        self.offsets = offsets
        self.labels = labels
        self.indices = indices
        self.values = values
        self.weights = weights
        self.fields = fields
        self.max_field = max_field
        check(len(labels) == len(offsets) - 1,
              f"labels length {len(labels)} != num rows {len(offsets) - 1}")

    @property
    def size(self) -> int:
        """Number of rows."""
        return len(self.offsets) - 1

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
            max_field=self.max_field)


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
