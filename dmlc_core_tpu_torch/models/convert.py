"""Carry parameters between the JAX package and the port.

The JAX package keeps a model's parameters as a dict of arrays, nested
where the model has sub-trees (``{"w0", "w", "v"}`` for
``FactorizationMachine``; ``{"w0", "w", "v", "cross": {"w", "b"},
"head": {"w", "b"}}`` for ``DCNv2``).  The port's modules use the same
names, a sub-tree becoming a sub-module, so ``cross.w`` in
``state_dict()`` is ``params["cross"]["w"]`` in the JAX tree.
``params_from_jax`` / ``params_to_numpy`` move such a tree across as
numpy, so both packages can compute with the same weights and share
checkpoints.  A model placed on a mesh (:mod:`.sharding`) takes its own
slice of each whole leaf (``params_from_jax(tree, model=model)``), and
gives its whole tree back through :func:`.sharding.gather_params`.

``adam_state_to_optax`` / ``adam_state_from_optax`` do the same for the
optimizer: the port's :class:`.optim.Adam` against the state of
``optax.adam``, ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
which a checkpoint stores as the tuples ``((count, mu, nu), ())``
(``dmlc_core_tpu/utils/checkpoint.py`` saves a NamedTuple as
``__tuple__``): ``count`` an int32 scalar, ``mu`` / ``nu`` param trees.
``ftrl_state_to_optax`` / ``ftrl_state_from_optax`` carry the port's
:class:`.ftrl.FTRL` as ``FTRLState(z, n)``, stored as ``(z, n)``.  So a
checkpoint of either package resumes in the other.  Loading copies into
the optimizer's own tensors, whose addresses a captured CUDA graph may
hold.  No JAX counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.logging import DMLCError
from .ftrl import FTRL
from .optim import Adam
from .sharding import local_shard

__all__ = ["params_from_jax", "params_to_numpy", "params_tree",
           "adam_state_to_optax",
           "adam_state_from_optax", "ftrl_state_to_optax",
           "ftrl_state_from_optax"]


def params_from_jax(params: Mapping[str, Any],
                    device: Optional[Union[str, torch.device]] = None,
                    model: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """A param tree (``{name: array or sub-tree}``; arrays as numpy or
    anything ``np.asarray`` takes) → ``{dotted.name: tensor}`` on
    ``device``, shapes and dtypes kept (a 0-d bias stays 0-d).  The
    result loads with ``module.load_state_dict``.  With ``model``, a
    model placed on a mesh, each whole leaf is cut to this rank's slice
    of it, so the result loads into that model."""
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
    if model is not None:
        out = {k: local_shard(model, k, v).contiguous()
               for k, v in out.items()}
    return out


def params_tree(params: Union[nn.Module, Mapping[str, torch.Tensor]]
                ) -> Dict[str, Any]:
    """A module's parameters (or a ``{dotted.name: tensor}`` dict) as
    the JAX package's nested param tree (``{"cross": {"w": ...}}``) of
    the tensors themselves, detached, where they are: a checkpoint
    (``CheckpointManager.save`` / ``save_async``) writes or snapshots
    them from there."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return _nest({k: v.detach() for k, v in params.items()})


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
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


def params_to_numpy(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                    nested: bool = False) -> Dict[str, Any]:
    """A module's parameters (or a ``{dotted.name: tensor}`` dict) →
    ``{name: np.ndarray}``.  With ``nested``, dotted names become
    sub-trees again, the JAX package's param-tree layout
    (``{"cross": {"w": ...}}``); without, names stay dotted."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    flat = {k: v.detach().cpu().numpy() for k, v in params.items()}
    return _nest(flat) if nested else flat


def _slots(model: nn.Module, optimizer) -> Dict[str, int]:
    """Each of ``model``'s parameter names → its index in
    ``optimizer.params``."""
    index = {id(p): i for i, p in enumerate(optimizer.params)}
    out = {}
    for name, p in model.named_parameters():
        if id(p) not in index:
            raise DMLCError(f"{name} is not a parameter of the optimizer")
        out[name] = index[id(p)]
    return out


def _trees(model: nn.Module, optimizer, *states,
           host: bool = True) -> Tuple[Dict[str, Any], ...]:
    """Per-parameter state lists → nested trees of the param names, of
    numpy arrays (``host``) or of the state tensors themselves."""
    slots = _slots(model, optimizer)
    conv = params_to_numpy if host else params_tree
    kw = {"nested": True} if host else {}
    return tuple(conv({name: st[i] for name, i in slots.items()}, **kw)
                 for st in states)


def _load_trees(model: nn.Module, optimizer, what: Tuple[str, ...],
                trees: Tuple[Any, ...], states) -> None:
    """Copy each tree (``what`` names them) into the optimizer's state
    list beside it, in place, after checking every shape."""
    slots = _slots(model, optimizer)
    flat = [params_from_jax(t, "cpu") for t in trees]
    for name, i in slots.items():
        shape = tuple(optimizer.params[i].shape)
        for label, tree in zip(what, flat):
            if name not in tree or tuple(tree[name].shape) != shape:
                raise DMLCError(f"optimizer state {label} has no {name} "
                                f"of shape {shape}")
    with torch.no_grad():
        for tree, st in zip(flat, states):
            for name, i in slots.items():
                st[i].copy_(tree[name])


def adam_state_to_optax(model: nn.Module, optimizer: Adam,
                        host: bool = True) -> Tuple[Tuple[Any, Dict[str, Any],
                                                          Dict[str, Any]],
                                                    Tuple[()]]:
    """``((count, mu, nu), ())`` of ``optimizer`` over ``model``'s
    parameters: the layout ``optax.adam``'s state takes in a checkpoint.
    As numpy (``host``; ``count`` a 0-d int32), or as the optimizer's
    own tensors, where a checkpoint writes or snapshots them from."""
    mu, nu = _trees(model, optimizer, optimizer.mu, optimizer.nu, host=host)
    count = (np.asarray(int(optimizer.count), np.int32) if host
             else optimizer.count)
    return ((count, mu, nu), ())


def adam_state_from_optax(model: nn.Module, optimizer: Adam,
                          opt_state: Any) -> None:
    """Load an ``optax.adam`` state, ``((count, mu, nu), ())`` with
    param trees of numpy arrays (as a checkpoint restores it), into
    ``optimizer``, whose parameters are ``model``'s, in place."""
    try:
        (count, mu, nu), rest = opt_state
    except (TypeError, ValueError) as e:
        raise DMLCError(f"not an optax.adam state ((count, mu, nu), ()): "
                        f"{e}") from None
    if rest not in ((), []):
        raise DMLCError(f"not an optax.adam state: trailing {rest!r}")
    _load_trees(model, optimizer, ("mu", "nu"), (mu, nu),
                (optimizer.mu, optimizer.nu))
    optimizer.count.fill_(int(np.asarray(count)))


def ftrl_state_to_optax(model: nn.Module, optimizer: FTRL
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(z, n)`` of ``optimizer`` over ``model``'s parameters, as numpy
    param trees: ``FTRLState(z, n)`` as a checkpoint stores it."""
    return _trees(model, optimizer, optimizer.z, optimizer.n)


def ftrl_state_from_optax(model: nn.Module, optimizer: FTRL,
                          opt_state: Any) -> None:
    """Load an ``FTRLState(z, n)`` (or the tuple ``(z, n)`` a checkpoint
    restores) into ``optimizer``, in place."""
    try:
        z, n = opt_state
    except (TypeError, ValueError) as e:
        raise DMLCError(f"not an FTRL state (z, n): {e}") from None
    _load_trees(model, optimizer, ("z", "n"), (z, n),
                (optimizer.z, optimizer.n))
