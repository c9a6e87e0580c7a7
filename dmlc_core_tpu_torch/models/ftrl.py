"""FTRL-Proximal, the port's counterpart of ``dmlc_core_tpu/models/ftrl.py``
(``ftrl()`` and ``FTRLState``).

Per coordinate (McMahan et al., "Ad Click Prediction: a View from the
Trenches", KDD'13)::

    z += g - (sqrt(n + g²) - sqrt(n)) / alpha * w
    n += g²
    w  = -(z - sign(z)*l1) / ((beta + sqrt(n)) / alpha + l2)   if |z| > l1
         0                                                      otherwise

with the JAX package's defaults.  Its L1 threshold leaves weak
coordinates at exactly 0.  The state ``(z, n)`` lives on the device
beside the parameters; one step is one launch of the fused kernel of
:mod:`..kernels.optim` (its plain version on the CPU).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from ..kernels import optim as kopt
from .optim import _Dense

__all__ = ["FTRL"]


class FTRL(_Dense):
    """``ftrl(alpha, beta, l1, l2)`` over ``params``; state ``z`` and
    ``n``, float32 and dense like each parameter.  ``engine`` as for
    :class:`.optim.Adam`."""

    def __init__(self, params: Iterable[torch.Tensor], alpha: float = 0.1,
                 beta: float = 1.0, l1: float = 1.0, l2: float = 1.0,
                 engine: str = "auto") -> None:
        super().__init__(params, engine)
        self.alpha, self.beta = float(alpha), float(beta)
        self.l1, self.l2 = float(l1), float(l2)
        self.z = self._zeros()
        self.n = self._zeros()
        if self.kernel:
            kopt.empty_launch("ftrl", self.device)

    @property
    def state(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``(z, n)``, the optimizer's own tensors, in the order of
        ``params``."""
        return self.z, self.n

    def step(self) -> None:
        """One FTRL step from the parameters' current gradients."""
        kopt.ftrl_step(self.params, self._grads(), self.z, self.n,
                       alpha=self.alpha, beta=self.beta, l1=self.l1,
                       l2=self.l2, engine=self.engine)
