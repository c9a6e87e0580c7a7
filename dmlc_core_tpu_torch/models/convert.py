"""Carry parameters between the JAX package and the port.

The JAX package keeps a model's parameters as a dict of arrays, nested
where the model has sub-trees (``{"w0", "w", "v"}`` for
``FactorizationMachine``; ``{"w0", "w", "v", "cross": {"w", "b"},
"head": {"w", "b"}}`` for ``DCNv2``).  The port's modules use the same
names, a sub-tree becoming a sub-module, so ``cross.w`` in
``state_dict()`` is ``params["cross"]["w"]`` in the JAX tree.
``params_from_jax`` / ``params_to_numpy`` move such a tree across as
numpy, so both packages can compute with the same weights and share
checkpoints.

``adam_state_to_optax`` / ``adam_state_from_optax`` do the same for the
optimizer: a ``torch.optim.Adam`` state against the state of
``optax.adam``, ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
which a checkpoint stores as the tuples ``((count, mu, nu), ())``
(``dmlc_core_tpu/utils/checkpoint.py`` saves a NamedTuple as
``__tuple__``).  ``count`` is Adam's ``step`` as int32; ``mu`` / ``nu``
are param trees of ``exp_avg`` / ``exp_avg_sq``.  So a checkpoint of
either package's ``dmlc-train`` resumes in the other.  No JAX
counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.logging import DMLCError

__all__ = ["params_from_jax", "params_to_numpy", "adam_state_to_optax",
           "adam_state_from_optax"]


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


def adam_state_to_optax(model: nn.Module, optimizer: torch.optim.Adam
                        ) -> Tuple[Tuple[np.ndarray, Dict[str, Any],
                                         Dict[str, Any]], Tuple[()]]:
    """``((count, mu, nu), ())`` of ``optimizer`` over ``model``'s
    parameters, as numpy: the layout ``optax.adam``'s state takes in a
    checkpoint.  A parameter without state yet has zero moments."""
    steps = []
    mu: Dict[str, torch.Tensor] = {}
    nu: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            steps.append(int(st["step"]))
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[name], nu[name] = torch.zeros_like(p), torch.zeros_like(p)
    if len(set(steps)) > 1:
        raise DMLCError(f"parameters disagree on Adam's step: "
                        f"{sorted(set(steps))}")
    count = np.asarray(steps[0] if steps else 0, np.int32)
    return ((count, params_to_numpy(mu, nested=True),
             params_to_numpy(nu, nested=True)), ())


def adam_state_from_optax(model: nn.Module, optimizer: torch.optim.Adam,
                          opt_state: Any) -> None:
    """Load an ``optax.adam`` state, ``((count, mu, nu), ())`` with
    param trees of numpy arrays (as a checkpoint restores it), into
    ``optimizer``, whose parameters are ``model``'s.  ``count`` 0 leaves
    the optimizer fresh."""
    try:
        (count, mu, nu), rest = opt_state
    except (TypeError, ValueError) as e:
        raise DMLCError(f"not an optax.adam state ((count, mu, nu), ()): "
                        f"{e}") from None
    if rest not in ((), []):
        raise DMLCError(f"not an optax.adam state: trailing {rest!r}")
    step = int(np.asarray(count))
    if step == 0:
        return
    mu_t = params_from_jax(mu, "cpu")
    nu_t = params_from_jax(nu, "cpu")
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    state = {}
    for name, p in model.named_parameters():
        for what, tree in (("mu", mu_t), ("nu", nu_t)):
            if name not in tree or tuple(tree[name].shape) != tuple(p.shape):
                raise DMLCError(f"optimizer state {what} has no {name} of "
                                f"shape {tuple(p.shape)}")
        if id(p) not in index:
            raise DMLCError(f"{name} is not a parameter of the optimizer")
        state[index[id(p)]] = {"step": torch.tensor(float(step)),
                               "exp_avg": mu_t[name],
                               "exp_avg_sq": nu_t[name]}
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)
