"""Ragged CSR gather-accumulate: the CUDA kernel and its plain version.

Counterpart of ``dmlc_core_tpu/ops/ragged_csr.py::_ragged_gather_kernel``
(launched there by ``_gather_pallas_one``/``_gather_pallas``).  For every
entry ``i < nnz_used`` whose segment lies in ``[0, num_rows]``::

    out1[seg[i]] += vals[i] * table[ids[i]]
    out2[seg[i]] += (vals[i] * table[ids[i]]) ** 2     # fm variant

with outputs of shape ``[num_rows + 1, D]`` (the last row is the padded
layout's scratch row).  The kernel lives in ``ragged_gather.cu``;
:func:`ragged_gather_reference` is the same function in plain PyTorch,
used on CPU tensors and as the yardstick on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from ..utils.logging import DMLCError
from . import build
from .common import (check_tensor, clamp_ids, count_launch, stream_handle,
                     use_kernel)

__all__ = ["ragged_gather", "ragged_gather_reference"]

NnzUsed = Optional[Union[int, torch.Tensor]]

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("ragged_gather").ragged_gather_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_inputs(ids, vals, segments, nnz_used, table, num_rows):
    dev = table.device
    check_tensor("table", table, torch.float32, 2, dev)
    check_tensor("ids", ids, torch.int32, 1, dev)
    check_tensor("segments", segments, torch.int32, 1, dev)
    check_tensor("vals", vals, torch.float32, 1, dev)
    cap = ids.shape[0]
    if segments.shape[0] != cap or vals.shape[0] != cap:
        raise DMLCError(f"ids/vals/segments lengths differ: {cap}, "
                        f"{vals.shape[0]}, {segments.shape[0]}")
    if table.shape[0] < 1 or table.shape[0] >= 2 ** 31:
        raise DMLCError(f"table must have 1..2^31-1 rows, got "
                        f"{table.shape[0]}")
    if num_rows < 0:
        raise DMLCError(f"num_rows must be >= 0, got {num_rows}")
    if isinstance(nnz_used, torch.Tensor):
        if (nnz_used.dtype != torch.int32 or nnz_used.numel() != 1
                or nnz_used.device != dev):
            raise DMLCError("nnz_used must be a one-element int32 tensor "
                            f"on {dev}")


def ragged_gather_reference(ids: torch.Tensor, vals: torch.Tensor,
                            segments: torch.Tensor, nnz_used: NnzUsed,
                            table: torch.Tensor, num_rows: int, fm: bool
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel (``index_select`` +
    ``index_add_``).  Entries past ``nnz_used`` or with an out-of-range
    segment are routed, with value 0, to a dump row that is cut off, so
    garbage (even NaN) there never reaches the result."""
    cap = ids.shape[0]
    D = table.shape[1]
    live = torch.ones(cap, dtype=torch.bool, device=ids.device)
    if nnz_used is not None:
        used = (nnz_used.reshape(()) if isinstance(nnz_used, torch.Tensor)
                else int(nnz_used))
        live = torch.arange(cap, dtype=torch.int32, device=ids.device) < used
    valid = live & (segments >= 0) & (segments <= num_rows)
    seg = torch.where(valid, segments, num_rows + 1).long()
    vx = table.index_select(0, clamp_ids(ids, table.shape[0])) * vals[:, None]
    vx = torch.where(valid[:, None], vx, 0.0)
    out1 = table.new_zeros(num_rows + 2, D).index_add_(0, seg, vx)
    out2 = (table.new_zeros(num_rows + 2, D).index_add_(0, seg, vx * vx)
            if fm else None)
    return out1[:num_rows + 1], (out2[:num_rows + 1] if fm else None)


def ragged_gather(ids: torch.Tensor, vals: torch.Tensor,
                  segments: torch.Tensor, nnz_used: NnzUsed,
                  table: torch.Tensor, num_rows: int, fm: bool,
                  engine: str = "auto"
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out1, out2)`` of shape ``[num_rows + 1, D]``; ``out2`` is None
    unless ``fm``.  ``nnz_used`` is None (every entry is live), an int,
    or a one-element int32 tensor on the table's device, which the kernel
    reads on the device (no host sync)."""
    _check_inputs(ids, vals, segments, nnz_used, table, num_rows)
    if not use_kernel(engine, table.device):
        return ragged_gather_reference(ids, vals, segments, nnz_used, table,
                                       num_rows, fm)
    if torch.is_grad_enabled() and (table.requires_grad
                                    or vals.requires_grad):
        raise DMLCError("the ragged-gather kernel has no backward yet; run "
                        "it under torch.no_grad() or use engine='torch'")
    dev = table.device
    if nnz_used is not None and not isinstance(nnz_used, torch.Tensor):
        nnz_used = torch.tensor([int(nnz_used)], dtype=torch.int32,
                                device=dev)
    cap = ids.shape[0]
    F, D = table.shape
    out1 = torch.zeros(num_rows + 1, D, dtype=torch.float32, device=dev)
    out2 = torch.zeros_like(out1) if fm else None
    if cap == 0:
        return out1, out2
    vec4 = D % 4 == 0 and table.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        err = _launcher()(
            ids.data_ptr(), segments.data_ptr(), vals.data_ptr(),
            None if nnz_used is None else nnz_used.data_ptr(),
            table.data_ptr(), out1.data_ptr(),
            None if out2 is None else out2.data_ptr(),
            cap, num_rows, F, D, int(vec4), stream_handle(dev))
    if err != 0:
        raise DMLCError(f"ragged_gather launch failed: cudaError {err}")
    count_launch("ragged_gather_fm" if fm else "ragged_gather_embed")
    return out1, out2
