"""Decode of the v3 compact wire: the CUDA kernel and its plain version.

No Pallas counterpart: the JAX package decodes the v3 wire in XLA, in
the ``jnp`` branch of ``dmlc_core_tpu/pipeline/device_loader.py::
make_decoder``.  :func:`wire_decode_reference` is that code in plain
PyTorch (a w-bit unpack with two gathers and shifts, the dictionary
gather or the raw f32 values, one ``searchsorted`` for ``segments``);
on the card it is about a dozen launches a batch, so the loader's
decode is one launch of ``wire_decode.cu`` instead.

Both read one int32 v3 buffer (layout in ``wire_decode.cu``) and return
``(ids, vals, segments)``, B entries each, bit for bit the same: the
decode is integer unpacking and copies of bit patterns, with padding
entries (``i >= row_ptr[rows]``) in the scratch row ``rows``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.logging import DMLCError
from . import build
from .common import check_tensor, count_launch, stream_handle, use_kernel

__all__ = ["v3_layout", "wire_decode", "wire_decode_reference"]

_fn = None


def v3_layout(rows: int, nnz: int, w: int, dbits: int
              ) -> Tuple[int, int, int, int]:
    """Word offsets of a v3 buffer: ``(codes, dictionary, raw values,
    row_ptr)``; codes and dictionary are 0 when ``dbits`` is 0, the raw
    values 0 when it is not."""
    iw = (nnz * w + 31) // 32
    if dbits:
        cw = (nnz * dbits + 31) // 32
        return iw, iw + cw, 0, iw + cw + (1 << dbits)
    return 0, 0, iw, iw + nnz


def _unpack_bits(region: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """``n`` fields of ``width`` bits from int32 words, LSB first, as the
    JAX decoder's ``unpack_bits``: two gathers, shifts and a mask (in
    int64, for the unsigned arithmetic)."""
    pu = region.to(torch.int64) & 0xFFFFFFFF
    bitpos = torch.arange(n, dtype=torch.int64, device=region.device) * width
    word = bitpos >> 5
    off = bitpos & 31
    lo = pu[word] >> off
    hi = pu[torch.clamp(word + 1, max=len(region) - 1)] << (32 - off)
    hi = torch.where(off > 0, hi, torch.zeros_like(hi))
    mask = 0xFFFFFFFF if width >= 32 else (1 << width) - 1
    out = (lo | hi) & mask
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def wire_decode_reference(buf: torch.Tensor, rows: int, nnz: int, w: int,
                          dbits: int, segments: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version: ``(ids, vals, segments)`` of a v3 buffer, with
    ``segments`` from one ``searchsorted`` over ``row_ptr`` unless
    given."""
    code_off, dict_off, val_off, rp_off = v3_layout(rows, nnz, w, dbits)
    ids = _unpack_bits(buf[:(nnz * w + 31) // 32], nnz, w)
    if dbits:
        codes = _unpack_bits(buf[code_off:dict_off], nnz, dbits)
        vals = buf[dict_off:rp_off][codes.long()].view(torch.float32)
    else:
        vals = buf[val_off:val_off + nnz].view(torch.float32)
    if segments is None:
        rp = buf[rp_off:rp_off + rows + 1]
        segments = torch.searchsorted(
            rp[1:], torch.arange(nnz, dtype=torch.int32, device=buf.device),
            right=True, out_int32=True)
    return ids, vals, segments


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("wire_decode").wire_decode_v3_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wire_decode(buf: torch.Tensor, rows: int, nnz: int, w: int, dbits: int,
                engine: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ids, vals, segments)`` of the v3 buffer ``buf`` (int32, at least
    the batch's words): the kernel, or its plain version as ``engine``
    and the device say.  The kernel launches on the current stream and
    its outputs come from ``torch.empty``, so it records into a CUDA
    graph."""
    kernel = use_kernel(engine, buf.device)
    check_tensor("buf", buf, torch.int32, 1, buf.device)
    if not 1 <= w <= 32 or not 0 <= dbits <= 16:
        raise DMLCError(f"not a v3 meta: id width {w}, dict bits {dbits}")
    rp_off = v3_layout(rows, nnz, w, dbits)[3]
    if len(buf) < rp_off + 3 * rows + 1:
        raise DMLCError(f"v3 buffer of {len(buf)} words is shorter than its "
                        f"layout ({rp_off + 3 * rows + 1})")
    if not kernel:
        return wire_decode_reference(buf, rows, nnz, w, dbits)
    dev = buf.device
    ids = torch.empty(nnz, dtype=torch.int32, device=dev)
    vals = torch.empty(nnz, dtype=torch.float32, device=dev)
    segs = torch.empty(nnz, dtype=torch.int32, device=dev)
    if nnz == 0:
        return ids, vals, segs
    with torch.cuda.device(dev):
        err = _launcher()(buf.data_ptr(), ids.data_ptr(), vals.data_ptr(),
                          segs.data_ptr(), nnz, rows, w, dbits,
                          *v3_layout(rows, nnz, w, dbits),
                          stream_handle(dev))
    if err != 0:
        raise DMLCError(f"wire_decode launch failed: cudaError {err}")
    count_launch("wire_decode")
    return ids, vals, segs
