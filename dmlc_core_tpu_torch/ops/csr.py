"""Sparse ops over flat padded CSR batches.

Counterpart of ``dmlc_core_tpu/ops/csr.py``.  A batch is ``ids[nnz]``,
``vals[nnz]`` and ``segments[nnz]`` (the row of each value); padding
entries carry ``segment == num_rows`` (a scratch row that is cut off),
value 0 and id 0.

On CUDA tensors all three ops run the ragged-gather kernel with every
entry live (``nnz_used = cap``): with padding pointing at the scratch
row, the kernel's sums over the first ``num_rows`` rows are exactly the
segment sums these ops define.  ``csr_dense_matvec`` is the embed
variant over the weight vector seen as a ``[F, 1]`` table.  On CPU
tensors they run the kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..kernels.ragged_gather import ragged_gather

__all__ = ["csr_dense_matvec", "csr_embed_sum", "fm_pairwise",
           "fm_reduce"]


def fm_reduce(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """½·Σ_d (s1² − s2): the FM second-order term from its two sums."""
    return 0.5 * torch.sum(s1 * s1 - s2, dim=-1)


def csr_dense_matvec(ids: torch.Tensor, vals: torch.Tensor,
                     segments: torch.Tensor, w: torch.Tensor, num_rows: int,
                     engine: str = "auto") -> torch.Tensor:
    """out[r] = Σ vals[i]·w[ids[i]] over i with segments[i] == r."""
    out, _ = ragged_gather(ids, vals, segments, None, w.reshape(-1, 1),
                           num_rows, fm=False, engine=engine)
    return out[:num_rows, 0]


def csr_embed_sum(ids: torch.Tensor, vals: torch.Tensor,
                  segments: torch.Tensor, table: torch.Tensor,
                  num_rows: int, engine: str = "auto") -> torch.Tensor:
    """Weighted embedding bag: out[r, :] = Σ vals[i]·table[ids[i], :]."""
    out, _ = ragged_gather(ids, vals, segments, None, table, num_rows,
                           fm=False, engine=engine)
    return out[:num_rows]


def fm_pairwise(ids: torch.Tensor, vals: torch.Tensor,
                segments: torch.Tensor, table: torch.Tensor, num_rows: int,
                engine: str = "auto") -> torch.Tensor:
    """FM second-order term per row, 0.5·Σ_d[(Σ v·x)² − Σ (v·x)²];
    returns ``[num_rows]``."""
    s1, s2 = ragged_gather(ids, vals, segments, None, table, num_rows,
                           fm=True, engine=engine)
    return fm_reduce(s1[:num_rows], s2[:num_rows])
