"""Fused optimizer steps over every tensor of a model: the CUDA kernels
(``optim.cu``) and their plain versions.

No Pallas counterpart: the JAX package leaves its optimizers to XLA.

* :func:`adam_step` is ``optax.adam``'s update (``scale_by_adam`` +
  ``scale(-lr)`` + ``apply_updates``) in optax's order of operations::

      mu = (1-b1)·g + b1·mu;  nu = (1-b2)·g² + b2·nu;  count += 1
      p += -lr · (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)
                                               + eps_root) + eps)

  with ``count`` an int32 on the device, incremented with saturation.
* :func:`ftrl_step` is ``dmlc_core_tpu/models/ftrl.py:57-66`` element
  for element (``sigma``, ``z``, ``n``, the L1-thresholded ``w``), applied
  as optax applies an update: ``p = w + (w_new - w)``.

Both update their tensors in place.  On CUDA tensors each is one launch
over every tensor (a table of pointers and sizes passed by value, so
nothing is copied from the host and a CUDA graph can capture the step);
on CPU tensors, or with ``engine="torch"``, the plain version below, which
spells out the same operations one PyTorch op at a time.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.logging import DMLCError
from . import build
from .common import (check_tensor, count_launch, float_types, stream_handle,
                     use_kernel)

__all__ = ["adam_step", "adam_step_reference", "ftrl_step",
           "ftrl_step_reference", "empty_launch", "MAX_TENSORS"]

MAX_TENSORS = 24            # tensors one launch takes (kMaxTensors)
_INT32_MAX = 2 ** 31 - 1

_fns = {}

_P = ctypes.c_void_p
_F = ctypes.c_float
_ARGTYPES = {
    "optim_adam_launch": [_P] * 6 + [ctypes.c_int, _P, _P] + [_F] * 7
    + [ctypes.c_int, _P],
    "optim_ftrl_launch": [_P] * 6 + [ctypes.c_int] + [_F] * 4 + [_P],
}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("optim"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python float it meets in
    a float32 expression."""
    return float(np.float32(x))


def _check(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           states: Sequence[Sequence[torch.Tensor]], kernel: bool
           ) -> None:
    n = len(params)
    if len(grads) != n or any(len(s) != n for s in states):
        raise DMLCError(f"params, grads and state lists differ in length: "
                        f"{n}, {len(grads)}, {[len(s) for s in states]}")
    types = float_types(kernel)
    for i, p in enumerate(params):
        dev = p.device
        for name, t in [("param", p), ("grad", grads[i])] + [
                (f"state{j}", s[i]) for j, s in enumerate(states)]:
            check_tensor(f"{name}[{i}]", t, types, t.dim(), dev)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise DMLCError(f"{name}[{i}] is {t.dtype} "
                                f"{tuple(t.shape)}, its param {p.dtype} "
                                f"{tuple(p.shape)}")


def _tables(*lists: Sequence[torch.Tensor]):
    """The launcher's host arrays: one pointer array a list, then the
    sizes and the float4 flags (every tensor of the entry 16-byte
    aligned)."""
    n = len(lists[0])
    ptrs = [(_P * max(n, 1))(*[t.data_ptr() for t in ts]) for ts in lists]
    sizes = (ctypes.c_longlong * max(n, 1))(*[t.numel() for t in lists[0]])
    vec4 = (ctypes.c_int * max(n, 1))(*[
        int(all(ts[i].data_ptr() % 16 == 0 for ts in lists))
        for i in range(n)])
    return ptrs, sizes, vec4


def _launches(n: int) -> int:
    return max(1, -(-n // MAX_TENSORS))


def _device_of(params, count: Optional[torch.Tensor]) -> torch.device:
    if params:
        return params[0].device
    if count is not None:
        return count.device
    raise DMLCError("no tensors: cannot tell the device")


# -- Adam --------------------------------------------------------------------

@torch.no_grad()
def adam_step_reference(params: List[torch.Tensor],
                        grads: List[torch.Tensor], mu: List[torch.Tensor],
                        nu: List[torch.Tensor], count: torch.Tensor, *,
                        lr: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, eps_root: float = 0.0) -> None:
    """Plain version of :func:`adam_step`: optax's operations in optax's
    order, one PyTorch op each, every constant rounded to float32 as JAX
    rounds it."""
    c1 = torch.where(count < _INT32_MAX, count + 1, count)
    cf = c1.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full((), _f32(b1), device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.full((), _f32(b2), device=cf.device), cf)
    omb1, omb2 = _f32(1 - b1), _f32(1 - b2)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_(omb1 * g + _f32(b1) * m)
        v.copy_(omb2 * (g * g) + _f32(b2) * v)
        m_hat = m / bc1.to(m.dtype)
        v_hat = v / bc2.to(v.dtype)
        u = m_hat / (torch.sqrt(v_hat + _f32(eps_root)) + _f32(eps))
        p.copy_(p + _f32(-lr) * u)
    count.copy_(c1)


def _adam_kernel(params, grads, mu, nu, count, ticket, lr, b1, b2, eps,
                 eps_root) -> None:
    dev = _device_of(params, count)
    (p, g, m, v), sizes, vec4 = _tables(params, grads, mu, nu)
    with torch.cuda.device(dev):
        err = _launcher("optim_adam_launch")(
            p, g, m, v, sizes, vec4, len(params), count.data_ptr(),
            ticket.data_ptr(), _f32(lr), _f32(b1), _f32(1 - b1), _f32(b2),
            _f32(1 - b2), _f32(eps), _f32(eps_root), 1, stream_handle(dev))
    if err != 0:
        raise DMLCError(f"optim_adam launch failed: cudaError {err}")
    for _ in range(_launches(len(params))):
        count_launch("adam")


def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor],
              mu: List[torch.Tensor], nu: List[torch.Tensor],
              count: torch.Tensor, ticket: Optional[torch.Tensor], *,
              lr: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, eps_root: float = 0.0,
              engine: str = "auto") -> None:
    """One ``optax.adam`` step, in place, over lists of tensors of one
    device: ``params``, their ``grads`` and the moments ``mu`` / ``nu``
    (each the shape and dtype of its param), and ``count``, a 0-d int32.
    ``ticket`` is the kernel's one-element int32 scratch, zero between
    steps (None for the plain version)."""
    dev = _device_of(params, count)
    kernel = use_kernel(engine, dev)
    _check(params, grads, (mu, nu), kernel)
    check_tensor("count", count, torch.int32, 0, dev)
    if not kernel:
        adam_step_reference(params, grads, mu, nu, count, lr=lr, b1=b1,
                            b2=b2, eps=eps, eps_root=eps_root)
        return
    if ticket is None:
        raise DMLCError("the Adam kernel needs its ticket tensor")
    check_tensor("ticket", ticket, torch.int32, 1, dev)
    _adam_kernel(params, grads, mu, nu, count, ticket, lr, b1, b2, eps,
                 eps_root)


# -- FTRL --------------------------------------------------------------------

@torch.no_grad()
def ftrl_step_reference(params: List[torch.Tensor],
                        grads: List[torch.Tensor], z: List[torch.Tensor],
                        n: List[torch.Tensor], *, alpha: float, beta: float,
                        l1: float, l2: float) -> None:
    """Plain version of :func:`ftrl_step`: the reference's operations in
    its order, one PyTorch op each.  It divides by ``alpha`` as a tensor:
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which rounds otherwise, and next to the L1 threshold
    ``|z| - l1`` magnifies any rounding."""
    beta, l1, l2 = map(_f32, (beta, l1, l2))
    for w, g, zz, nn in zip(params, grads, z, n):
        alpha_t = torch.full((), _f32(alpha), dtype=w.dtype, device=w.device)
        gg = g * g
        sigma = (torch.sqrt(nn + gg) - torch.sqrt(nn)) / alpha_t
        z1 = (zz + g) - sigma * w
        n1 = nn + gg
        den = (beta + torch.sqrt(n1)) / alpha_t + l2
        w1 = torch.where(z1.abs() > l1, -(z1 - torch.sign(z1) * l1) / den,
                         0.0)
        w.copy_(w + (w1 - w))
        zz.copy_(z1)
        nn.copy_(n1)


def _ftrl_kernel(params, grads, z, n, alpha, beta, l1, l2) -> None:
    dev = params[0].device
    (p, g, zp, nq), sizes, vec4 = _tables(params, grads, z, n)
    with torch.cuda.device(dev):
        err = _launcher("optim_ftrl_launch")(
            p, g, zp, nq, sizes, vec4, len(params), _f32(alpha), _f32(beta),
            _f32(l1), _f32(l2), stream_handle(dev))
    if err != 0:
        raise DMLCError(f"optim_ftrl launch failed: cudaError {err}")
    for _ in range(_launches(len(params))):
        count_launch("ftrl")


def ftrl_step(params: List[torch.Tensor], grads: List[torch.Tensor],
              z: List[torch.Tensor], n: List[torch.Tensor], *,
              alpha: float = 0.1, beta: float = 1.0, l1: float = 1.0,
              l2: float = 1.0, engine: str = "auto") -> None:
    """One FTRL-Proximal step, in place, over lists of tensors of one
    device: ``params`` (the weights), their ``grads`` and the state ``z``
    / ``n`` (each the shape and dtype of its param).  ``l1`` and ``l2``
    must be >= 0 and ``alpha`` > 0."""
    if not params:
        return
    if not (alpha > 0 and l1 >= 0 and l2 >= 0):
        raise DMLCError(f"FTRL needs alpha > 0 and l1, l2 >= 0, got "
                        f"alpha={alpha}, l1={l1}, l2={l2}")
    kernel = use_kernel(engine, params[0].device)
    _check(params, grads, (z, n), kernel)
    if kernel:
        _ftrl_kernel(params, grads, z, n, alpha, beta, l1, l2)
    else:
        ftrl_step_reference(params, grads, z, n, alpha=alpha, beta=beta,
                            l1=l1, l2=l2)


# -- a launch with no work -----------------------------------------------------

def empty_launch(which: str, device: torch.device) -> None:
    """Launch the ``"adam"`` or ``"ftrl"`` kernel over no tensors: it
    changes nothing.  The optimizers call it once when they are built, so
    the kernel is built and loaded before any step (and before a CUDA
    graph captures one); timed, it is the floor of a launch."""
    if which not in ("adam", "ftrl"):
        raise DMLCError(f"no optimizer kernel {which!r}")
    empty = (_P * 1)()
    sizes = (ctypes.c_longlong * 1)()
    vec4 = (ctypes.c_int * 1)()
    with torch.cuda.device(device):
        if which == "adam":
            err = _launcher("optim_adam_launch")(
                empty, empty, empty, empty, sizes, vec4, 0, None, None,
                0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, stream_handle(device))
        else:
            err = _launcher("optim_ftrl_launch")(
                empty, empty, empty, empty, sizes, vec4, 0, 1.0, 0.0, 0.0,
                0.0, stream_handle(device))
    if err != 0:
        raise DMLCError(f"optim_{which} launch failed: cudaError {err}")
    count_launch(which)
