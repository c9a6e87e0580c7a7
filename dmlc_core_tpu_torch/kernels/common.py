"""What every kernel wrapper shares: engine choice, input checks, the id
clamp, and the launch counts.

``engine`` is an explicit argument everywhere in the port:

* ``"auto"``   — the kernel on CUDA tensors, the plain PyTorch version on
  CPU tensors;
* ``"kernel"`` — the kernel; raises on CPU tensors;
* ``"torch"``  — the plain version on any device (the reference the
  kernels are held against).

Out-of-range feature ids follow XLA's gather, which the JAX package
relies on: a negative id counts from the end of the table, then ids are
clamped into ``[0, F)``.  Kernels and plain versions apply the same rule
in the same place, so neither ever reads outside the table.

No single JAX counterpart: the JAX package resolves engines per module
(``_resolve_engine`` in ``dmlc_core_tpu/ops/ragged_csr.py`` and
``pallas_embed.py``) with environment pins, which the port does not have.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from ..utils.logging import DMLCError

__all__ = ["ENGINES", "use_kernel", "clamp_ids", "check_tensor",
           "launch_counts", "reset_launch_counts", "count_launch",
           "stream_handle"]

ENGINES = ("auto", "kernel", "torch")

# kernel name -> launches since the last reset; each wrapper adds one
# right where it launches its kernel, and nowhere else.  Wrappers run on
# the batcher's worker thread too, hence the lock.
_launches: Dict[str, int] = {}
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _launches_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _launches_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launches_lock:
        _launches.clear()


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


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, rank and device a kernel takes
    and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise DMLCError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise DMLCError(f"{name} must be {dtype}, got {t.dtype}")
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


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
