"""Row-major FM terms: the CUDA kernels (forward and backward) and their
plain versions.

Counterpart of ``dmlc_core_tpu/ops/pallas_embed.py::_fm_kernel``
(launched there by ``_fm_terms_pallas_one``/``fm_terms_pallas``) and of
the backward of its custom VJP (``fm_embed_terms``, lines 199-209).  For
``ids``/``vals`` of shape ``[B, K]``, a table ``[F, D]``,
``x = table[ids[b, k]]`` and upstream gradients ``g1``, ``g2`` ``[B, D]``::

    s1[b, :]    = Σ_k v·x,   s2[b, :] = Σ_k v²·x²                 forward
    dvals[b,k]  = Σ_d g1[b]·x + 2·v·Σ_d g2[b]·x²                  backward
    dtable[id] += v·g1[b] + 2·v²·x·g2[b]

Ids follow :mod:`.common`: the forward clamps, the backward drops.  The
kernels live in ``fm_terms.cu``; :func:`fm_terms_reference` and
:func:`fm_terms_grad_reference` are the same functions in plain PyTorch
(``take`` + ``einsum``, ``index_add_``), used on CPU tensors and as the
yardstick on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.logging import DMLCError
from . import build
from .common import (check_tensor, clamp_ids, count_launch, float_types,
                     gather_rows, grad_rows, scatter_rows, stream_handle,
                     use_kernel, vec4_ok)

__all__ = ["fm_terms", "fm_terms_reference", "fm_terms_grad",
           "fm_terms_grad_reference"]

_fns = {}


def _launcher(name: str, nptr: int, nint: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("fm_terms"), name)
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_inputs(ids: torch.Tensor, vals: torch.Tensor,
                  table: torch.Tensor, kernel: bool) -> None:
    dev = table.device
    check_tensor("table", table, float_types(kernel), 2, dev)
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("vals", vals, (table.dtype,), 2, dev)
    if ids.shape != vals.shape:
        raise DMLCError(f"ids {tuple(ids.shape)} and vals "
                        f"{tuple(vals.shape)} differ")
    if table.shape[0] < 1 or table.shape[0] >= 2 ** 31:
        raise DMLCError(f"table must have 1..2^31-1 rows, got "
                        f"{table.shape[0]}")


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


def fm_terms_grad_reference(ids: torch.Tensor, vals: torch.Tensor,
                            table: torch.Tensor, g1: torch.Tensor,
                            g2: torch.Tensor, need_dvals: bool = True,
                            need_dtable: bool = True
                            ) -> Tuple[Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
    """Plain version of the backward, ``(dvals[B, K], dtable[F, D])``
    (None where not asked for): the JAX VJP's gather and einsums, and an
    ``index_add_`` that drops out-of-range ids."""
    F, D = table.shape
    x = table.index_select(0, clamp_ids(ids.reshape(-1), F))
    x = x.reshape(tuple(ids.shape) + (D,))                       # [B, K, D]
    dvals = None
    if need_dvals:
        dvals = (torch.einsum("bd,bkd->bk", g1, x)
                 + 2.0 * vals * torch.einsum("bd,bkd->bk", g2, x * x))
    dtable = None
    if need_dtable:
        v = vals[..., None]
        drows = v * g1[:, None, :] + 2.0 * v * v * x * g2[:, None, :]
        dtable = scatter_rows(grad_rows(ids.reshape(-1), F),
                              drows.reshape(-1, D), F)
    return dvals, dtable


def fm_terms(ids: torch.Tensor, vals: torch.Tensor, table: torch.Tensor,
             engine: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s1, s2)``, each ``[B, D]``: the forward kernel, or its plain
    version as ``engine`` and the device say (no autograd here; see
    :func:`dmlc_core_tpu_torch.ops.embed.fm_embed_terms`)."""
    kernel = use_kernel(engine, table.device)
    _check_inputs(ids, vals, table, kernel)
    if not kernel:
        return fm_terms_reference(ids, vals, table)
    dev = table.device
    B, K = ids.shape
    F, D = table.shape
    s1 = torch.empty(B, D, dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    if B * D == 0:
        return s1, s2
    with torch.cuda.device(dev):
        err = _launcher("fm_terms_launch", 5, 5)(
            ids.data_ptr(), vals.data_ptr(), table.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), B, K, F, D,
            int(vec4_ok(D, table, s1, s2)), stream_handle(dev))
    if err != 0:
        raise DMLCError(f"fm_terms launch failed: cudaError {err}")
    count_launch("fm_terms")
    return s1, s2


def fm_terms_grad(ids: torch.Tensor, vals: torch.Tensor,
                  table: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor,
                  need_dvals: bool = True, need_dtable: bool = True,
                  engine: str = "auto"
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dvals[B, K], dtable[F, D])`` for the upstream gradients
    ``g1``, ``g2`` ``[B, D]`` of ``(s1, s2)``; either is None when not
    asked for.  ``dtable`` is dense, as the JAX VJP's
    ``jnp.zeros_like(table).at[ids].add``."""
    kernel = use_kernel(engine, table.device)
    _check_inputs(ids, vals, table, kernel)
    dev = table.device
    B, K = ids.shape
    F, D = table.shape
    for name, g in (("g1", g1), ("g2", g2)):
        check_tensor(name, g, (table.dtype,), 2, dev)
        if tuple(g.shape) != (B, D):
            raise DMLCError(f"{name} must be {(B, D)}, got {tuple(g.shape)}")
    if not kernel:
        return fm_terms_grad_reference(ids, vals, table, g1, g2, need_dvals,
                                       need_dtable)
    dvals = (torch.empty(B, K, dtype=torch.float32, device=dev)
             if need_dvals else None)
    dtable = (torch.zeros(F, D, dtype=torch.float32, device=dev)
              if need_dtable else None)
    if B * K * D == 0 or not (need_dvals or need_dtable):
        if dvals is not None:
            dvals.zero_()
        return dvals, dtable
    ptrs = [t for t in (table, g1, g2, dtable) if t is not None]
    with torch.cuda.device(dev):
        err = _launcher("fm_terms_grad_launch", 7, 5)(
            ids.data_ptr(), vals.data_ptr(), table.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), None if dvals is None else dvals.data_ptr(),
            None if dtable is None else dtable.data_ptr(),
            B, K, F, D, int(vec4_ok(D, *ptrs)), stream_handle(dev))
    if err != 0:
        raise DMLCError(f"fm_terms_grad launch failed: cudaError {err}")
    count_launch("fm_terms_grad")
    return dvals, dtable
