"""Ragged CSR ops: static-capacity buffers with a runtime ``nnz_used``.

Counterpart of ``dmlc_core_tpu/ops/ragged_csr.py``.  Batches arrive as
``ids/vals/segments[cap]`` plus ``nnz_used``; entries at ``i >=
nnz_used`` are arbitrary garbage and never reach a result.

* ``engine="torch"`` (and ``"auto"`` on CPU tensors) computes the
  kernel's plain version, which gives the same bits as the padded path
  of :mod:`.csr` on the same live entries (the contract of the JAX
  module's docstring, lines 18-24).
* ``engine="kernel"`` (and ``"auto"`` on CUDA tensors) runs the
  ragged-gather kernel, which reads ``nnz_used`` on the device and skips
  the tail: no load, no flop.  Its sums are allclose to the plain ones.

``nnz_used`` may be an int or a one-element int32 tensor on the batch's
device.  Every op is differentiable with respect to ``vals`` and the
table (the ragged-gather backward kernel on CUDA tensors);
``ragged_embed_grad`` calls that backward's embed variant directly.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from ..kernels.common import clamp_ids
from ..kernels.ragged_gather import ragged_gather, ragged_gather_table_grad
from .csr import fm_reduce

__all__ = ["mask_ragged", "mask_batch", "ragged_segment_sum",
           "ragged_dense_matvec", "ragged_embed_sum", "ragged_embed_grad",
           "ragged_fm_pairwise"]

NnzUsed = Union[int, torch.Tensor]


def _live(cap: int, nnz_used: NnzUsed, device: torch.device) -> torch.Tensor:
    if isinstance(nnz_used, torch.Tensor):
        nnz_used = nnz_used.reshape(())
    return torch.arange(cap, dtype=torch.int32, device=device) < nnz_used


def mask_ragged(ids: torch.Tensor, vals: torch.Tensor,
                segments: torch.Tensor, nnz_used: NnzUsed, num_rows: int):
    """Entries at ``i >= nnz_used`` become ``(id 0, val 0.0, segment
    num_rows)``: the padding convention of the flat layout."""
    live = _live(ids.shape[0], nnz_used, ids.device)
    return (torch.where(live, ids, 0),
            torch.where(live, vals, 0.0),
            torch.where(live, segments, num_rows))


def mask_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Ragged batch → padded-convention batch that every flat
    ``forward`` takes: tails masked to the scratch row, weights and
    labels of tail rows zeroed, the scalar words dropped."""
    out = dict(batch)
    nnz_used = out.pop("nnz_used")
    rows_used = out.pop("rows_used", None)
    rows_cap = batch["labels"].shape[0]
    out["ids"], out["vals"], out["segments"] = mask_ragged(
        batch["ids"], batch["vals"], batch["segments"], nnz_used, rows_cap)
    if rows_used is not None:
        rlive = _live(rows_cap, rows_used, batch["labels"].device)
        out["weights"] = torch.where(rlive, batch["weights"], 0.0)
        out["labels"] = torch.where(rlive, batch["labels"], 0.0)
    return out


def ragged_segment_sum(data: torch.Tensor, segments: torch.Tensor,
                       nnz_used: NnzUsed, num_rows: int) -> torch.Tensor:
    """Per-row sum of ``data[:nnz_used]`` grouped by ``segments``;
    ``data`` is ``[cap]`` or ``[cap, d]``.  Segments outside
    ``[0, num_rows)`` are dropped, as ``jax.ops.segment_sum`` drops
    them."""
    live = _live(segments.shape[0], nnz_used, segments.device)
    keep = live & (segments >= 0) & (segments < num_rows)
    seg = torch.where(keep, segments, num_rows).long()
    d = torch.where(keep if data.dim() == 1 else keep[:, None], data,
                    torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_rows + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg, d)[:num_rows]


def ragged_dense_matvec(ids: torch.Tensor, vals: torch.Tensor,
                        segments: torch.Tensor, nnz_used: NnzUsed,
                        w: torch.Tensor, num_rows: int,
                        engine: str = "auto") -> torch.Tensor:
    """Ragged twin of :func:`.csr.csr_dense_matvec`."""
    out, _ = ragged_gather(ids, vals, segments, nnz_used, w.reshape(-1, 1),
                           num_rows, fm=False, engine=engine)
    return out[:num_rows, 0]


def ragged_embed_sum(ids: torch.Tensor, vals: torch.Tensor,
                     segments: torch.Tensor, nnz_used: NnzUsed,
                     table: torch.Tensor, num_rows: int,
                     engine: str = "auto") -> torch.Tensor:
    """Ragged twin of :func:`.csr.csr_embed_sum`."""
    out, _ = ragged_gather(ids, vals, segments, nnz_used, table, num_rows,
                           fm=False, engine=engine)
    return out[:num_rows]


def ragged_embed_grad(ids: torch.Tensor, vals: torch.Tensor,
                      segments: torch.Tensor, nnz_used: NnzUsed,
                      g_rows: torch.Tensor, num_table_rows: int,
                      engine: str = "auto") -> torch.Tensor:
    """Backward twin of :func:`ragged_embed_sum` with respect to the
    table: ``grad[ids[i]] += vals[i]·g_rows[segments[i]]`` over live
    entries, ``grad`` of shape ``[num_table_rows, D]`` for ``g_rows`` of
    shape ``[num_rows, D]``.  The backward kernel's embed variant with no
    ``dvals`` (:func:`~dmlc_core_tpu_torch.kernels.ragged_gather.
    ragged_gather_table_grad`).  Entries past ``nnz_used`` never reach
    the result; ids follow the scatter rule (a negative id wraps once,
    then out-of-range ids are dropped).  A live entry's segment is read
    as the JAX version reads ``g_rows[min(seg, num_rows - 1)]``: a
    negative segment counts from the end, then it is clamped into
    ``[0, num_rows)``."""
    num_rows, D = g_rows.shape
    if num_rows == 0:
        return g_rows.new_zeros(num_table_rows, D)
    seg = clamp_ids(segments, num_rows).to(torch.int32)
    return ragged_gather_table_grad(ids, vals, seg, nnz_used,
                                    g_rows.contiguous(), num_rows - 1,
                                    num_table_rows, engine=engine)


def ragged_fm_pairwise(ids: torch.Tensor, vals: torch.Tensor,
                       segments: torch.Tensor, nnz_used: NnzUsed,
                       table: torch.Tensor, num_rows: int,
                       engine: str = "auto") -> torch.Tensor:
    """Ragged twin of :func:`.csr.fm_pairwise`: both FM sums from one
    pass over the live entries."""
    s1, s2 = ragged_gather(ids, vals, segments, nnz_used, table, num_rows,
                           fm=True, engine=engine)
    return fm_reduce(s1[:num_rows], s2[:num_rows])
