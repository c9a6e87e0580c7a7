"""Ragged CSR gather-accumulate: the CUDA kernels (forward and backward)
and their plain versions.

Counterpart of ``dmlc_core_tpu/ops/ragged_csr.py::_ragged_gather_kernel``
(launched there by ``_gather_pallas_one``/``_gather_pallas``).  For every
entry ``i < nnz_used`` whose segment lies in ``[0, num_rows]``::

    out1[seg[i]] += vals[i] * table[ids[i]]
    out2[seg[i]] += (vals[i] * table[ids[i]]) ** 2     # fm variant

with outputs of shape ``[num_rows + 1, D]`` (the last row is the padded
layout's scratch row).  The JAX package differentiates the same sums
with XLA (and ``ragged_embed_grad``); here the backward is a kernel too,
``ragged_gather_grad.cu``, wired in by a ``torch.autograd.Function``.
:func:`ragged_gather_reference` and :func:`ragged_gather_grad_reference`
are the same functions in plain PyTorch, used on CPU tensors and as the
yardstick on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from ..utils.logging import DMLCError
from . import build
from .common import (check_tensor, clamp_ids, count_launch, float_types,
                     gather_rows, grad_rows, scatter_rows, stream_handle,
                     use_kernel, vec4_ok)

__all__ = ["ragged_gather", "ragged_gather_reference", "ragged_gather_grad",
           "ragged_gather_grad_reference", "ragged_gather_table_grad"]

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


def _check_inputs(ids, vals, segments, nnz_used, num_rows, F, dev,
                  val_types):
    """Checks of the entries, shared by every wrapper; the caller has
    checked the table (or has none) and passes its row count ``F``."""
    check_tensor("ids", ids, torch.int32, 1, dev)
    check_tensor("segments", segments, torch.int32, 1, dev)
    check_tensor("vals", vals, val_types, 1, dev)
    cap = ids.shape[0]
    if segments.shape[0] != cap or vals.shape[0] != cap:
        raise DMLCError(f"ids/vals/segments lengths differ: {cap}, "
                        f"{vals.shape[0]}, {segments.shape[0]}")
    if F < 1 or F >= 2 ** 31:
        raise DMLCError(f"table must have 1..2^31-1 rows, got {F}")
    if num_rows < 0:
        raise DMLCError(f"num_rows must be >= 0, got {num_rows}")
    if isinstance(nnz_used, torch.Tensor):
        if (nnz_used.dtype != torch.int32 or nnz_used.numel() != 1
                or nnz_used.device != dev):
            raise DMLCError("nnz_used must be a one-element int32 tensor "
                            f"on {dev}")


def _check_table(table: torch.Tensor, kernel: bool) -> None:
    check_tensor("table", table, float_types(kernel), 2, table.device)


def _valid(ids: torch.Tensor, segments: torch.Tensor, nnz_used: NnzUsed,
           num_rows: int) -> torch.Tensor:
    """The entries a kernel reads: ``i < nnz_used`` with a segment in
    ``[0, num_rows]``."""
    cap = ids.shape[0]
    live = torch.ones(cap, dtype=torch.bool, device=ids.device)
    if nnz_used is not None:
        used = (nnz_used.reshape(()) if isinstance(nnz_used, torch.Tensor)
                else int(nnz_used))
        live = torch.arange(cap, dtype=torch.int32, device=ids.device) < used
    return live & (segments >= 0) & (segments <= num_rows)


def ragged_gather_reference(ids: torch.Tensor, vals: torch.Tensor,
                            segments: torch.Tensor, nnz_used: NnzUsed,
                            table: torch.Tensor, num_rows: int, fm: bool
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel (:func:`.common.gather_rows`
    + ``index_add_``).  Entries past ``nnz_used`` or with an out-of-range
    segment are routed, with value 0, to a dump row that is cut off, so
    garbage (even NaN) there never reaches the result."""
    D = table.shape[1]
    valid = _valid(ids, segments, nnz_used, num_rows)
    seg = torch.where(valid, segments, num_rows + 1).long()
    vx = gather_rows(table, ids) * vals[:, None]
    vx = torch.where(valid[:, None], vx, 0.0)
    out1 = table.new_zeros(num_rows + 2, D).index_add_(0, seg, vx)
    out2 = (table.new_zeros(num_rows + 2, D).index_add_(0, seg, vx * vx)
            if fm else None)
    return out1[:num_rows + 1], (out2[:num_rows + 1] if fm else None)


def _nnz_tensor(nnz_used: NnzUsed, dev: torch.device
                ) -> Optional[torch.Tensor]:
    if nnz_used is None or isinstance(nnz_used, torch.Tensor):
        return nnz_used
    if torch.cuda.is_current_stream_capturing():
        # the int would cross in a pageable copy, which a capture forbids
        # (and a graph would replay with this call's value forever)
        raise DMLCError("nnz_used given as an int while a CUDA graph is "
                        "capturing: pass it as an int32 tensor on the "
                        "device, or None")
    return torch.tensor([int(nnz_used)], dtype=torch.int32, device=dev)


def _ragged_gather_kernel(ids, vals, segments, nnz_used, table, num_rows,
                          fm):
    dev = table.device
    nnz_used = _nnz_tensor(nnz_used, dev)
    cap = ids.shape[0]
    F, D = table.shape
    # one buffer, so one memset clears both outputs
    buf = torch.zeros(1 + fm, num_rows + 1, D, dtype=torch.float32,
                      device=dev)
    out1, out2 = buf[0], (buf[1] if fm else None)
    if cap == 0:
        return out1, out2
    with torch.cuda.device(dev):
        err = _launcher()(
            ids.data_ptr(), segments.data_ptr(), vals.data_ptr(),
            None if nnz_used is None else nnz_used.data_ptr(),
            table.data_ptr(), out1.data_ptr(),
            None if out2 is None else out2.data_ptr(),
            cap, num_rows, F, D, int(vec4_ok(D, table, *buf)),
            stream_handle(dev))
    if err != 0:
        raise DMLCError(f"ragged_gather launch failed: cudaError {err}")
    count_launch("ragged_gather_fm" if fm else "ragged_gather_embed")
    return out1, out2


# -- backward ---------------------------------------------------------------

_grad_fns = None


def _grad_launcher():
    """``(launch, workspace)``: ``ragged_gather_grad_launch`` and
    ``ragged_gather_grad_workspace`` (the bytes of workspace a launch
    needs)."""
    global _grad_fns
    if _grad_fns is None:
        lib = build.load("ragged_gather_grad")
        fn = lib.ragged_gather_grad_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.ragged_gather_grad_workspace
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_longlong
        _grad_fns = fn, ws
    return _grad_fns


def _grad_reference(ids, vals, segments, nnz_used, table, F, g1, g2,
                    num_rows, need_dvals, need_dtable):
    """The plain backward; ``table`` is read only for ``dvals`` or the fm
    variant and may otherwise be None."""
    valid = _valid(ids, segments, nnz_used, num_rows)
    seg = torch.where(valid, segments, 0).long()
    a = g1.index_select(0, seg)                                 # [cap, D]
    c = g2.index_select(0, seg) if g2 is not None else None
    x = (table.index_select(0, clamp_ids(ids, F))
         if need_dvals or c is not None else None)
    v = torch.where(valid, vals, 0.0)[:, None]
    dvals = None
    if need_dvals:
        t = a * x if c is None else a * x + 2.0 * v * c * x * x
        dvals = torch.where(valid, t.sum(1), 0.0)
    dtable = None
    if need_dtable:
        contrib = v * a if c is None else v * a + 2.0 * v * v * x * c
        rows = torch.where(valid, grad_rows(ids, F), F)
        dtable = scatter_rows(rows, contrib, F)
    return dvals, dtable


def _grad_kernel(ids, vals, segments, nnz_used, table, F, g1, g2, num_rows,
                 need_dvals, need_dtable):
    """Launch ``ragged_gather_grad.cu``; ``table`` as in
    :func:`_grad_reference`.  The launcher writes every element of
    ``dtable`` itself, so it is allocated uninitialised.  The embed
    variant at D = 1 (the linear term) is one cooperative launch that
    zeroes ``dtable`` and scatters into it; a launch that does not fit
    raises, as any failed launch.  Every other instance writes each row
    of ``dtable`` once, from the row's owner, and needs a workspace (16
    bytes an entry: its record; 9 a gradient row: a count, a list head
    and a touched flag), taken here from the caching allocator, so a CUDA
    graph's capture draws it from the graph's pool.  The order of a row's sum varies from call to
    call (its list is built by atomics), so results agree with the plain
    version to rounding, not bit for bit."""
    dev = g1.device
    D = g1.shape[1]
    nnz_used = _nnz_tensor(nnz_used, dev)
    cap = ids.shape[0]
    dvals = (torch.empty(cap, dtype=torch.float32, device=dev)
             if need_dvals else None)
    dtable = (torch.empty(F, D, dtype=torch.float32, device=dev)
              if need_dtable else None)
    if not (need_dvals or need_dtable):
        return dvals, dtable
    if cap == 0:
        return dvals, (dtable.zero_() if dtable is not None else None)
    ptrs = [t for t in (table, g1, g2, dtable) if t is not None]
    launch, workspace = _grad_launcher()
    nwork = workspace(cap, F, D, int(g2 is not None), int(need_dtable))
    work = (torch.empty(nwork, dtype=torch.uint8, device=dev) if nwork
            else None)
    with torch.cuda.device(dev):
        err = launch(
            ids.data_ptr(), segments.data_ptr(), vals.data_ptr(),
            None if nnz_used is None else nnz_used.data_ptr(),
            None if table is None else table.data_ptr(), g1.data_ptr(),
            None if g2 is None else g2.data_ptr(),
            None if dvals is None else dvals.data_ptr(),
            None if dtable is None else dtable.data_ptr(),
            None if work is None else work.data_ptr(),
            cap, num_rows, F, D, int(vec4_ok(D, *ptrs)), stream_handle(dev))
    if err != 0:
        raise DMLCError(f"ragged_gather_grad launch failed: cudaError {err}")
    count_launch("ragged_gather_grad_fm" if g2 is not None
                 else "ragged_gather_grad_embed")
    return dvals, dtable


def _check_grads(g1, g2, num_rows, D, dtype):
    for name, g in (("g1", g1), ("g2", g2)):
        if g is None:
            continue
        check_tensor(name, g, (dtype,), 2, g1.device)
        if tuple(g.shape) != (num_rows + 1, D):
            raise DMLCError(f"{name} must be {(num_rows + 1, D)}, got "
                            f"{tuple(g.shape)}")


def ragged_gather_grad_reference(ids: torch.Tensor, vals: torch.Tensor,
                                 segments: torch.Tensor, nnz_used: NnzUsed,
                                 table: torch.Tensor, g1: torch.Tensor,
                                 g2: Optional[torch.Tensor], num_rows: int,
                                 need_dvals: bool = True,
                                 need_dtable: bool = True
                                 ) -> Tuple[Optional[torch.Tensor],
                                            Optional[torch.Tensor]]:
    """Plain version of the backward kernel: ``(dvals[cap], dtable[F,
    D])`` for upstream gradients ``g1`` (and ``g2``, the fm variant) of
    shape ``[num_rows + 1, D]``; either result is None when not asked
    for.  Entries that are not live (past ``nnz_used``, or with a
    segment outside ``[0, num_rows]``) get ``dvals = 0`` and add nothing;
    ``dtable`` is an explicit ``index_add_`` that drops out-of-range
    ids."""
    return _grad_reference(ids, vals, segments, nnz_used, table,
                           table.shape[0], g1, g2, num_rows, need_dvals,
                           need_dtable)


def ragged_gather_grad(ids: torch.Tensor, vals: torch.Tensor,
                       segments: torch.Tensor, nnz_used: NnzUsed,
                       table: torch.Tensor, g1: torch.Tensor,
                       g2: Optional[torch.Tensor], num_rows: int,
                       need_dvals: bool = True, need_dtable: bool = True,
                       engine: str = "auto"
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """Backward of :func:`ragged_gather`: the kernel of
    ``ragged_gather_grad.cu``, or its plain version, as ``engine`` and
    the device say.  ``g2`` given selects the fm variant."""
    kernel = use_kernel(engine, table.device)
    _check_table(table, kernel)
    F, D = table.shape
    _check_inputs(ids, vals, segments, nnz_used, num_rows, F, table.device,
                  (table.dtype,))
    _check_grads(g1, g2, num_rows, D, table.dtype)
    fn = _grad_kernel if kernel else _grad_reference
    return fn(ids, vals, segments, nnz_used, table, F, g1, g2, num_rows,
              need_dvals, need_dtable)


def ragged_gather_table_grad(ids: torch.Tensor, vals: torch.Tensor,
                             segments: torch.Tensor, nnz_used: NnzUsed,
                             g1: torch.Tensor, num_rows: int,
                             num_features: int, engine: str = "auto"
                             ) -> torch.Tensor:
    """``dtable[num_features, D]`` of the embed variant alone, which
    reads no table row: the backward kernel with no table, no ``g2`` and
    no ``dvals`` (or its plain version).  ``g1`` is ``[num_rows + 1,
    D]``."""
    kernel = use_kernel(engine, g1.device)
    check_tensor("g1", g1, float_types(kernel), 2, g1.device)
    _check_inputs(ids, vals, segments, nnz_used, num_rows, num_features,
                  g1.device, (g1.dtype,))
    _check_grads(g1, None, num_rows, g1.shape[1], g1.dtype)
    fn = _grad_kernel if kernel else _grad_reference
    _, dtable = fn(ids, vals, segments, nnz_used, None, num_features, g1,
                   None, num_rows, False, True)
    return dtable


class _RaggedGather(torch.autograd.Function):
    """Forward and backward both from the engine's choice: the kernels on
    the card, the plain versions on the CPU (or with engine='torch')."""

    @staticmethod
    def forward(ctx, vals, table, ids, segments, nnz_used, num_rows, fm,
                engine):
        fwd = (_ragged_gather_kernel if use_kernel(engine, table.device)
               else ragged_gather_reference)
        out1, out2 = fwd(ids, vals, segments, nnz_used, table, num_rows, fm)
        nnz_t = nnz_used if isinstance(nnz_used, torch.Tensor) else None
        ctx.save_for_backward(vals, table, ids, segments, nnz_t)
        ctx.nnz_int = None if nnz_t is not None else nnz_used
        ctx.num_rows, ctx.fm, ctx.engine = num_rows, fm, engine
        return (out1, out2) if fm else out1

    @staticmethod
    def backward(ctx, g1, g2=None):
        vals, table, ids, segments, nnz_t = ctx.saved_tensors
        nnz_used = nnz_t if nnz_t is not None else ctx.nnz_int
        g1 = g1.contiguous()
        g2 = g2.contiguous() if ctx.fm else None
        dvals, dtable = ragged_gather_grad(
            ids, vals, segments, nnz_used, table, g1, g2, ctx.num_rows,
            need_dvals=ctx.needs_input_grad[0],
            need_dtable=ctx.needs_input_grad[1], engine=ctx.engine)
        return dvals, dtable, None, None, None, None, None, None


def ragged_gather(ids: torch.Tensor, vals: torch.Tensor,
                  segments: torch.Tensor, nnz_used: NnzUsed,
                  table: torch.Tensor, num_rows: int, fm: bool,
                  engine: str = "auto"
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out1, out2)`` of shape ``[num_rows + 1, D]``; ``out2`` is None
    unless ``fm``.  ``nnz_used`` is None (every entry is live), an int,
    or a one-element int32 tensor on the table's device, which the kernel
    reads on the device (no host sync).  Differentiable with respect to
    ``vals`` and ``table``: under autograd the call goes through a
    ``torch.autograd.Function`` whose backward is
    :func:`ragged_gather_grad` on the same engine."""
    kernel = use_kernel(engine, table.device)
    _check_table(table, kernel)
    _check_inputs(ids, vals, segments, nnz_used, num_rows, table.shape[0],
                  table.device, (table.dtype,))
    if torch.is_grad_enabled() and (table.requires_grad
                                    or vals.requires_grad):
        out = _RaggedGather.apply(vals, table, ids, segments, nnz_used,
                                  num_rows, fm, engine)
        return tuple(out) if fm else (out, None)
    if kernel:
        return _ragged_gather_kernel(ids, vals, segments, nnz_used, table,
                                     num_rows, fm)
    return ragged_gather_reference(ids, vals, segments, nnz_used, table,
                                   num_rows, fm)
