"""Row-padded weighted embedding bag: CUDA kernels (forward and backward)
and their plain versions.

Counterpart of ``dmlc_core_tpu/ops/pallas_embed.py::_kernel`` (launched
there by ``_embed_bag_pallas_one``/``embed_bag_pallas``) and of the
backward of its custom VJP (``_embed_bag_pallas_diff``, lines 229-239).
For ``ids``/``vals`` of shape ``[B, K]`` and a table ``[F, D]``, with
``t(x) = x²`` when ``square`` else ``x``::

    out[b]      = Σ_k vals[b,k]·t(table[ids[b,k]])                 forward
    dvals[b,k]  = Σ_d g[b,d]·t(x_bk)[d]                            backward
    dtable[id] += (2·v·x if square else v)·g[b]

Ids follow :mod:`.common`: the forward clamps, the backward drops.  The
kernels live in ``embed_bag.cu``; :func:`embed_bag_reference` and
:func:`embed_bag_grad_reference` are the same functions in plain PyTorch
(``index_select`` + ``einsum``, ``index_add_``), used on CPU tensors and
as the yardstick on the card.
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

__all__ = ["embed_bag_forward", "embed_bag_reference", "embed_bag_grad",
           "embed_bag_grad_reference"]

_fns = {}


def _launcher(name: str, nptr: int, nint: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("embed_bag"), name)
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_inputs(ids: torch.Tensor, vals: torch.Tensor,
                  table: torch.Tensor, kernel: bool) -> None:
    dev = table.device
    floats = float_types(kernel)
    check_tensor("table", table, floats, 2, dev)
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("vals", vals, (table.dtype,), 2, dev)
    if ids.shape != vals.shape:
        raise DMLCError(f"ids {tuple(ids.shape)} and vals "
                        f"{tuple(vals.shape)} differ")
    if table.shape[0] < 1 or table.shape[0] >= 2 ** 31:
        raise DMLCError(f"table must have 1..2^31-1 rows, got "
                        f"{table.shape[0]}")


def embed_bag_reference(ids: torch.Tensor, vals: torch.Tensor,
                        table: torch.Tensor, square: bool = False
                        ) -> torch.Tensor:
    """Plain version of the forward: one gather, one einsum (the JAX
    package's ``embed_bag_reference``).  Differentiable, with the
    gradient rule of :func:`.common.gather_rows`."""
    g = gather_rows(table, ids)                                  # [B, K, D]
    if square:
        g = g * g
    return torch.einsum("bk,bkd->bd", vals, g)


def embed_bag_grad_reference(ids: torch.Tensor, vals: torch.Tensor,
                             table: torch.Tensor, g: torch.Tensor,
                             square: bool = False, need_dvals: bool = True,
                             need_dtable: bool = True
                             ) -> Tuple[Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """Plain version of the backward, ``(dvals[B, K], dtable[F, D])``
    (None where not asked for): the JAX VJP's gather and einsum, and an
    ``index_add_`` that drops out-of-range ids."""
    F, D = table.shape
    x = table.index_select(0, clamp_ids(ids.reshape(-1), F))
    x = x.reshape(tuple(ids.shape) + (D,))                       # [B, K, D]
    dvals = None
    if need_dvals:
        dvals = torch.einsum("bd,bkd->bk", g, x * x if square else x)
    dtable = None
    if need_dtable:
        coeff = 2.0 * vals[..., None] * x if square else vals[..., None]
        drows = (coeff * g[:, None, :]).reshape(-1, D)
        dtable = scatter_rows(grad_rows(ids.reshape(-1), F), drows, F)
    return dvals, dtable


def embed_bag_forward(ids: torch.Tensor, vals: torch.Tensor,
                      table: torch.Tensor, square: bool = False,
                      engine: str = "auto") -> torch.Tensor:
    """``out[B, D]``: the forward kernel, or its plain version as
    ``engine`` and the device say (no autograd here; see
    :func:`dmlc_core_tpu_torch.ops.embed.embed_bag`)."""
    kernel = use_kernel(engine, table.device)
    _check_inputs(ids, vals, table, kernel)
    dev = table.device
    if not kernel:
        return embed_bag_reference(ids, vals, table, square)
    B, K = ids.shape
    F, D = table.shape
    out = torch.empty(B, D, dtype=torch.float32, device=dev)
    if B * D == 0:
        return out
    if K == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        err = _launcher("embed_bag_launch", 4, 6)(
            ids.data_ptr(), vals.data_ptr(), table.data_ptr(),
            out.data_ptr(), B, K, F, D, int(square),
            int(vec4_ok(D, table, out)), stream_handle(dev))
    if err != 0:
        raise DMLCError(f"embed_bag launch failed: cudaError {err}")
    count_launch("embed_bag")
    return out


def embed_bag_grad(ids: torch.Tensor, vals: torch.Tensor,
                   table: torch.Tensor, g: torch.Tensor,
                   square: bool = False, need_dvals: bool = True,
                   need_dtable: bool = True, engine: str = "auto"
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dvals[B, K], dtable[F, D])`` for the upstream gradient
    ``g[B, D]``; either is None when not asked for.  ``dtable`` is dense,
    as the JAX VJP's ``jnp.zeros_like(table).at[ids].add``."""
    kernel = use_kernel(engine, table.device)
    _check_inputs(ids, vals, table, kernel)
    dev = table.device
    check_tensor("g", g, (table.dtype,), 2, dev)
    B, K = ids.shape
    F, D = table.shape
    if tuple(g.shape) != (B, D):
        raise DMLCError(f"g must be {(B, D)}, got {tuple(g.shape)}")
    if not kernel:
        return embed_bag_grad_reference(ids, vals, table, g, square,
                                        need_dvals, need_dtable)
    dvals = (torch.empty(B, K, dtype=torch.float32, device=dev)
             if need_dvals else None)
    dtable = (torch.zeros(F, D, dtype=torch.float32, device=dev)
              if need_dtable else None)
    if B * K * D == 0 or not (need_dvals or need_dtable):
        if dvals is not None:
            dvals.zero_()
        return dvals, dtable
    ptrs = [t for t in (table, g, dtable) if t is not None]
    with torch.cuda.device(dev):
        err = _launcher("embed_bag_grad_launch", 6, 6)(
            ids.data_ptr(), vals.data_ptr(), table.data_ptr(), g.data_ptr(),
            None if dvals is None else dvals.data_ptr(),
            None if dtable is None else dtable.data_ptr(),
            B, K, F, D, int(square), int(vec4_ok(D, *ptrs)),
            stream_handle(dev))
    if err != 0:
        raise DMLCError(f"embed_bag_grad launch failed: cudaError {err}")
    count_launch("embed_bag_grad")
    return dvals, dtable
