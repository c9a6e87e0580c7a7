"""What every kernel wrapper shares: engine choice, input checks, the id
clamp, and the launch counts.

``engine`` is an explicit argument everywhere in the port:

* ``"auto"``   — the kernel on CUDA tensors, the plain PyTorch version on
  CPU tensors;
* ``"kernel"`` — the kernel; raises on CPU tensors;
* ``"torch"``  — the plain version on any device (the reference the
  kernels are held against).

Out-of-range feature ids follow XLA, which the JAX package relies on,
and XLA has two rules:

* the forward gather (:func:`clamp_ids`): a negative id counts from the
  end of the table, then ids are clamped into ``[0, F)``;
* the backward scatter-add (:func:`grad_rows`; what ``jax.grad`` of the
  gather and the custom VJPs' ``.at[ids].add`` do): a negative id wraps
  once, and the entry is dropped unless it then lies in ``[0, F)``.

So an id of ``F + 7`` reads row ``F - 1`` but sends it no gradient.
Kernels (through ``common.cuh``, this module's device-side twin) and
plain versions apply the same rules in the same places, so neither ever
reads or writes outside the table; :func:`gather_rows` is the plain,
differentiable gather with both rules.

No single JAX counterpart: the JAX package resolves engines per module
(``_resolve_engine`` in ``dmlc_core_tpu/ops/ragged_csr.py`` and
``pallas_embed.py``) with environment pins, which the port does not have.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from ..utils.logging import DMLCError

__all__ = ["ENGINES", "use_kernel", "clamp_ids", "grad_rows",
           "scatter_rows", "gather_rows", "check_tensor", "launch_counts",
           "reset_launch_counts", "count_launch", "record_launches",
           "add_launches", "stream_handle", "vec4_ok", "float_types"]

ENGINES = ("auto", "kernel", "torch")

# kernel name -> launches since the last reset; each wrapper adds one
# right where it launches its kernel, and nowhere else.  Wrappers run on
# the batcher's worker thread and autograd's device thread too, hence the
# lock.  A launch into a stream that a CUDA graph is capturing runs at
# each replay, not now: while record_launches() is open it goes to that
# graph's counts, which the graph's owner adds (add_launches) per replay.
_launches: Dict[str, int] = {}
_launches_lock = threading.Lock()
_recording: Optional[Dict[str, int]] = None


def count_launch(name: str) -> None:
    rec = _recording
    target = (rec if rec is not None
              and torch.cuda.is_current_stream_capturing() else _launches)
    with _launches_lock:
        target[name] = target.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _launches_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launches_lock:
        _launches.clear()


@contextlib.contextmanager
def record_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph's capture: yields the dict that collects the
    launches made into capturing streams (from any thread: autograd runs
    backward on its own).  One capture at a time in a process."""
    global _recording
    rec: Dict[str, int] = {}
    with _launches_lock:
        if _recording is not None:
            raise DMLCError("a CUDA graph capture is already recording "
                            "launches")
        _recording = rec
    try:
        yield rec
    finally:
        with _launches_lock:
            _recording = None


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (a captured graph's launches) to the launch counts:
    once per replay of the graph."""
    with _launches_lock:
        for name, n in counts.items():
            _launches[name] = _launches.get(name, 0) + n


def use_kernel(engine: str, device: torch.device) -> bool:
    """True when the call must launch the CUDA kernel."""
    if engine not in ENGINES:
        raise DMLCError(f"unknown engine {engine!r}; expected one of "
                        f"{ENGINES}")
    if engine == "torch":
        return False
    if device.type == "cuda":
        return True
    if engine == "kernel":
        raise DMLCError(f"engine='kernel' needs CUDA tensors, got {device}")
    return False


def float_types(kernel: bool) -> Tuple[torch.dtype, ...]:
    """Value types a call takes: the kernels take float32 only; the plain
    versions float64 too (``torch.autograd.gradcheck`` needs it)."""
    return (torch.float32,) if kernel else (torch.float32, torch.float64)


def check_tensor(name: str, t: torch.Tensor,
                 dtype: Union[torch.dtype, Tuple[torch.dtype, ...]],
                 ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` has the dtype (or one of the dtypes), rank and
    device a kernel takes and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise DMLCError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise DMLCError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise DMLCError(f"{name} must be {ndim}-D, got shape "
                        f"{tuple(t.shape)}")
    if t.device != device:
        raise DMLCError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise DMLCError(f"{name} must be contiguous")


def clamp_ids(ids: torch.Tensor, num_features: int) -> torch.Tensor:
    """XLA's gather rule: negative ids count from the end, then clamp
    into ``[0, num_features)``.  Returns int64 row indices."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + num_features, ids)
    return ids.clamp(0, num_features - 1)


def grad_rows(ids: torch.Tensor, num_features: int) -> torch.Tensor:
    """XLA's scatter-add rule, for gradients: a negative id wraps once;
    an entry still outside ``[0, num_features)`` goes to the dump row
    ``num_features``.  Returns int64 row indices for ``index_add_`` into
    a buffer of ``num_features + 1`` rows whose last row is cut off."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + num_features, ids)
    keep = (ids >= 0) & (ids < num_features)
    return torch.where(keep, ids, num_features)


def scatter_rows(rows: torch.Tensor, contrib: torch.Tensor,
                 num_features: int) -> torch.Tensor:
    """``zeros(num_features, ...)`` with ``contrib[i]`` added into row
    ``rows[i]`` (from :func:`grad_rows`; the dump row is cut off)."""
    out = contrib.new_zeros((num_features + 1,) + tuple(contrib.shape[1:]))
    return out.index_add_(0, rows, contrib)[:num_features]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_features = table.shape[0]
        flat = ids.reshape(-1)
        out = table.index_select(0, clamp_ids(flat, table.shape[0]))
        return out.reshape(tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        F = ctx.num_features
        g = grad.reshape((ids.numel(),) + tuple(grad.shape[ids.dim():]))
        return scatter_rows(grad_rows(ids.reshape(-1), F), g, F), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with XLA's two rules: the forward clamps, the
    backward drops (see the module docstring).  Plain PyTorch; its
    gradient is an explicit ``index_add_``."""
    return _GatherRows.apply(table, ids)


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def vec4_ok(D: int, *tensors: torch.Tensor) -> bool:
    """True when a kernel may load rows as float4: D is a multiple of 4
    and every given tensor starts on a 16-byte boundary."""
    return D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
