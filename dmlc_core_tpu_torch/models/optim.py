"""The port's optimizers: ``Adam`` (``optax.adam``) and, in :mod:`.ftrl`,
``FTRL``.

Counterpart of the optax transformations the JAX package trains with.
Each owns its state as dense tensors beside the parameters, and one step
is one launch of the fused kernel of :mod:`..kernels.optim` over every
parameter (its plain version on the CPU or with ``engine="torch"``).
Nothing of a step reads back to the host, and no step allocates state,
so a CUDA graph can capture ``zero_grad`` / backward / ``step``.

They are not ``torch.optim.Optimizer`` subclasses: building one of those
imports ``torch._dynamo`` the first time, seconds of start-up that a
training run does not need.  The surface a training loop uses is the
same: ``zero_grad(set_to_none=True)`` and ``step()``; a parameter whose
``grad`` is None steps with a zero gradient, as optax steps a leaf whose
gradient is zero.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from ..kernels import optim as kopt
from ..kernels.common import ENGINES, use_kernel
from ..utils.logging import DMLCError

__all__ = ["Adam"]


class _Dense:
    """What both optimizers share: the parameter list, its device, the
    engine choice and the gradients a step reads."""

    def __init__(self, params: Iterable[torch.Tensor], engine: str) -> None:
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise DMLCError("an optimizer needs at least one parameter")
        if engine not in ENGINES:
            raise DMLCError(f"unknown engine {engine!r}; expected one of "
                            f"{ENGINES}")
        self.device = self.params[0].device
        for p in self.params:
            if p.device != self.device:
                raise DMLCError(f"parameters on {p.device} and "
                                f"{self.device}: one device only")
            if not p.is_contiguous():
                raise DMLCError("parameters must be contiguous")
        self.engine = engine
        self.kernel = use_kernel(engine, self.device)

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def _grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None
                else p.grad.contiguous() for p in self.params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drop (``set_to_none``) or zero every parameter's gradient.  A
        kept gradient makes autograd add the next one into it, one more
        pass over it a step."""
        for p in self.params:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.detach_()
                p.grad.zero_()


class Adam(_Dense):
    """``optax.adam(lr, b1, b2, eps, eps_root)`` over ``params``.

    State: ``mu`` and ``nu`` (float32 like each parameter, dense: every
    row moves on every step, as optax moves it) and ``count``, a 0-d
    int32 on the device.  ``engine`` as the models take it: ``"auto"``
    (the kernel on the card, the plain version on the CPU), ``"kernel"``
    or ``"torch"``.  On the card the kernel is built and loaded here."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, engine: str = "auto") -> None:
        super().__init__(params, engine)
        self.lr, self.b1, self.b2 = float(lr), float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)
        self.mu = self._zeros()
        self.nu = self._zeros()
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._ticket: Optional[torch.Tensor] = None
        if self.kernel:
            self._ticket = torch.zeros(1, dtype=torch.int32,
                                       device=self.device)
            kopt.empty_launch("adam", self.device)

    @property
    def state(self) -> Tuple[torch.Tensor, List[torch.Tensor],
                             List[torch.Tensor]]:
        """``(count, mu, nu)``, the optimizer's own tensors, ``mu`` and
        ``nu`` in the order of ``params``."""
        return self.count, self.mu, self.nu

    def step(self) -> None:
        """One Adam step from the parameters' current gradients."""
        kopt.adam_step(self.params, self._grads(), self.mu, self.nu,
                       self.count, self._ticket, lr=self.lr, b1=self.b1,
                       b2=self.b2, eps=self.eps, eps_root=self.eps_root,
                       engine=self.engine)
