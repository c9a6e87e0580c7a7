"""Row-major FM terms: the CUDA kernel and its plain version.

Counterpart of ``dmlc_core_tpu/ops/pallas_embed.py::_fm_kernel`` (launched
there by ``_fm_terms_pallas_one``/``fm_terms_pallas``), forward only.  For
``ids``/``vals`` of shape ``[B, K]`` and a table ``[F, D]`` it returns
``s1[B, D] = Σ_k v·x`` and ``s2[B, D] = Σ_k v²·x²`` with
``x = table[ids[b, k]]``.  The kernel lives in ``fm_terms.cu``;
:func:`fm_terms_reference` is the plain version (``take`` + ``einsum``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.logging import DMLCError
from . import build
from .common import (check_tensor, count_launch, gather_rows, stream_handle,
                     use_kernel)

__all__ = ["fm_terms", "fm_terms_reference"]

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("fm_terms").fm_terms_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fm_terms_reference(ids: torch.Tensor, vals: torch.Tensor,
                       table: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one gather, two einsums (the JAX xla
    branch of ``fm_embed_terms``).  Differentiable, with the gradient
    rule of :func:`.common.gather_rows`."""
    g = gather_rows(table, ids)                          # [B, K, D]
    s1 = torch.einsum("bk,bkd->bd", vals, g)
    s2 = torch.einsum("bk,bkd->bd", vals * vals, g * g)
    return s1, s2


def fm_terms(ids: torch.Tensor, vals: torch.Tensor, table: torch.Tensor,
             engine: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s1, s2)``, each ``[B, D]``."""
    dev = table.device
    check_tensor("table", table, torch.float32, 2, dev)
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("vals", vals, torch.float32, 2, dev)
    if ids.shape != vals.shape:
        raise DMLCError(f"ids {tuple(ids.shape)} and vals "
                        f"{tuple(vals.shape)} differ")
    F, D = table.shape
    if F < 1 or F >= 2 ** 31:
        raise DMLCError(f"table must have 1..2^31-1 rows, got {F}")
    if not use_kernel(engine, dev):
        return fm_terms_reference(ids, vals, table)
    if torch.is_grad_enabled() and (table.requires_grad
                                    or vals.requires_grad):
        raise DMLCError("the fm-terms kernel has no backward yet (the VJP "
                        "of dmlc_core_tpu/ops/pallas_embed.py:199-209 is not "
                        "ported): run it under torch.no_grad() or use "
                        "engine='torch'")
    B, K = ids.shape
    if B * D == 0:
        return (torch.zeros(B, D, device=dev), torch.zeros(B, D, device=dev))
    s1 = torch.empty(B, D, dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(dev):
        err = _launcher()(ids.data_ptr(), vals.data_ptr(), table.data_ptr(),
                          s1.data_ptr(), s2.data_ptr(), B, K, F, D,
                          stream_handle(dev))
    if err != 0:
        raise DMLCError(f"fm_terms launch failed: cudaError {err}")
    count_launch("fm_terms")
    return s1, s2
