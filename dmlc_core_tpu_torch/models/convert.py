"""Carry parameters between the JAX package and the port.

The JAX package keeps a model's parameters as a dict of arrays, nested
where the model has sub-trees (``{"w0", "w", "v"}`` for
``FactorizationMachine``; ``{"w0", "w", "v", "cross": {"w", "b"},
"head": {"w", "b"}}`` for ``DCNv2``).  The port's modules use the same
names, a sub-tree becoming a sub-module, so ``cross.w`` in
``state_dict()`` is ``params["cross"]["w"]`` in the JAX tree.  These two
functions move such a tree across as numpy, so both packages can compute
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
    """A param tree (``{name: array or sub-tree}``; arrays as numpy or
    anything ``np.asarray`` takes) → ``{dotted.name: tensor}`` on
    ``device``, shapes and dtypes kept (a 0-d bias stays 0-d).  The
    result loads with ``module.load_state_dict``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for name, value in tree.items():
            if not isinstance(name, str) or "." in name:
                raise DMLCError(f"parameter names must be str without "
                                f"'.', got {name!r}")
            key = prefix + name
            if isinstance(value, Mapping):
                walk(value, key + ".")
            elif isinstance(value, torch.Tensor):
                out[key] = value.detach().to(dev)
            else:
                out[key] = torch.from_numpy(np.array(value)).to(dev)

    walk(params, "")
    return out


def params_to_numpy(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                    nested: bool = False) -> Dict[str, Any]:
    """A module's parameters (or a ``{dotted.name: tensor}`` dict) →
    ``{name: np.ndarray}``.  With ``nested``, dotted names become
    sub-trees again, the JAX package's param-tree layout
    (``{"cross": {"w": ...}}``); without, names stay dotted."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    flat = {k: v.detach().cpu().numpy() for k, v in params.items()}
    if not nested:
        return flat
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise DMLCError(f"{key!r} nests under a leaf")
        if leaf in node:
            raise DMLCError(f"{key!r} collides with a sub-tree")
        node[leaf] = value
    return tree
