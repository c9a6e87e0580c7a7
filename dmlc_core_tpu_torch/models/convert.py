"""Carry parameters between the JAX package and the port.

The JAX package keeps a model's parameters as a flat dict of arrays
(``{"w0", "w", "v"}`` for ``FactorizationMachine``, ``{"w", "b"}`` for
``SparseLogReg``); the port's modules use the same names.  These two
functions move such a dict across as numpy, so both packages can compute
with the same weights and share checkpoints.  No JAX counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.logging import DMLCError

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params: Mapping[str, Any],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """``{name: array}`` (numpy, or anything ``np.asarray`` takes) →
    ``{name: tensor}`` on ``device``, shapes and dtypes kept (a 0-d
    bias stays 0-d).  The result loads with ``module.load_state_dict``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if not isinstance(name, str):
            raise DMLCError(f"parameter names must be str, got {name!r}")
        if isinstance(value, Mapping):
            raise DMLCError(f"parameter {name!r} is a nested tree; pass the "
                            f"model's flat param dict")
        if isinstance(value, torch.Tensor):
            out[name] = value.detach().to(dev)
        else:
            out[name] = torch.from_numpy(np.array(value)).to(dev)
    return out


def params_to_numpy(params: Union[nn.Module, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, np.ndarray]:
    """A module's parameters (or a ``{name: tensor}`` dict) → ``{name:
    np.ndarray}``, the JAX package's param-tree layout."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
