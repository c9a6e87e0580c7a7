"""Checkpoints in the JAX package's ``DMLCKPT1`` format, local directories.

Counterpart of ``dmlc_core_tpu/utils/checkpoint.py`` (``save_pytree``,
``load_pytree``, ``CheckpointManager.save/restore`` with its
``MANIFEST.json``, ``load_for_inference``).  The byte layout is the same,
so a checkpoint written by either package loads in the other:

    magic "DMLCKPT1", JSON treedef (leaves as {"__leaf__": i}, tuples as
    {"__tuple__": [...]}), u32 leaf count, then per leaf: dtype string,
    u32 ndim, u64 dims, raw little-endian bytes — each string and byte
    run prefixed by its u64 length.

Leaves are numpy arrays or torch tensors on save (tensors are copied to
the host) and numpy arrays on load.  Object stores and asynchronous
saves stay with the JAX package for now.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .logging import DMLCError, check, log_info

__all__ = ["save_pytree", "load_pytree", "CheckpointManager",
           "load_for_inference"]

_MAGIC = b"DMLCKPT1"


def _to_numpy(x) -> Optional[np.ndarray]:
    if isinstance(x, torch.Tensor):
        arr = x.detach().cpu().numpy()
    elif isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
    else:
        return None
    if arr.dtype.hasobject:
        raise DMLCError(f"cannot checkpoint object-dtype array (dtype "
                        f"{arr.dtype}); convert to a numeric dtype first")
    return arr


def _write_blob(stream, b: bytes) -> None:
    stream.write(struct.pack("<Q", len(b)))
    stream.write(b)


def _read_exact(stream, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = stream.read(n - len(out))
        if not chunk:
            raise DMLCError("checkpoint stream truncated")
        out += chunk
    return out


def _read_blob(stream) -> bytes:
    (n,) = struct.unpack("<Q", _read_exact(stream, 8))
    return _read_exact(stream, n)


def save_pytree(stream, tree: Any) -> None:
    """Serialize a nested dict/list/tuple of arrays and scalars."""
    leaves: List[np.ndarray] = []

    def strip(node):
        arr = _to_numpy(node)
        if arr is not None:
            leaves.append(arr)
            return {"__leaf__": len(leaves) - 1}
        if isinstance(node, dict):
            check(all(isinstance(k, str) for k in node),
                  "checkpoint dict keys must be str")
            check("__leaf__" not in node and "__tuple__" not in node,
                  "reserved key in checkpoint tree")
            return {k: strip(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return {"__tuple__": [strip(v) for v in node]}
        if isinstance(node, list):
            return [strip(v) for v in node]
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        raise DMLCError(f"cannot checkpoint {type(node).__name__}")

    treedef = strip(tree)
    stream.write(_MAGIC)
    _write_blob(stream, json.dumps(treedef, indent=2).encode())
    stream.write(struct.pack("<I", len(leaves)))
    for arr in leaves:
        shape = arr.shape            # before ascontiguousarray: keeps 0-d
        arr = np.ascontiguousarray(arr)
        _write_blob(stream, str(arr.dtype).encode())
        stream.write(struct.pack("<I", len(shape)))
        for d in shape:
            stream.write(struct.pack("<Q", d))
        _write_blob(stream, arr.tobytes())


def load_pytree(stream, template: Any = None) -> Any:
    """Deserialize a tree.  With ``template``, a one-element leaf is
    reshaped to the template's shape (old files stored 0-d leaves as
    ``(1,)``) and dict/list/tuple structure is checked against it."""
    magic = _read_exact(stream, len(_MAGIC))
    check(magic == _MAGIC, f"not a dmlc checkpoint (magic {magic!r})")
    treedef = json.loads(_read_blob(stream).decode())
    (nleaves,) = struct.unpack("<I", _read_exact(stream, 4))
    leaves = []
    for _ in range(nleaves):
        dtype = np.dtype(_read_blob(stream).decode())
        (ndim,) = struct.unpack("<I", _read_exact(stream, 4))
        shape = tuple(struct.unpack("<Q", _read_exact(stream, 8))[0]
                      for _ in range(ndim))
        raw = _read_blob(stream)
        leaves.append(np.frombuffer(raw, dtype=dtype).reshape(shape).copy())

    def rebuild(tmpl, node):
        if isinstance(node, dict) and "__leaf__" in node:
            leaf = leaves[node["__leaf__"]]
            tshape = getattr(tmpl, "shape", None)
            if (tshape is not None and leaf.size == 1
                    and int(np.prod(tuple(tshape))) == 1
                    and tuple(tshape) != leaf.shape):
                leaf = leaf.reshape(tuple(tshape))
            return leaf
        if isinstance(node, dict) and "__tuple__" in node:
            children = node["__tuple__"]
            if tmpl is not None:
                check(isinstance(tmpl, tuple) and len(tmpl) == len(children),
                      f"template mismatch: expected {len(children)}-tuple, "
                      f"got {type(tmpl).__name__}")
            return tuple(rebuild(tmpl[i] if tmpl is not None else None, c)
                         for i, c in enumerate(children))
        if isinstance(node, dict):
            if tmpl is not None:
                check(isinstance(tmpl, dict), f"template mismatch: expected "
                      f"dict, got {type(tmpl).__name__}")
            return {k: rebuild(tmpl.get(k) if tmpl is not None else None, v)
                    for k, v in node.items()}
        if isinstance(node, list):
            if isinstance(tmpl, list):
                check(len(tmpl) == len(node), f"template mismatch: list of "
                      f"{len(tmpl)} vs checkpointed {len(node)}")
                return [rebuild(t, v) for t, v in zip(tmpl, node)]
            return [rebuild(None, v) for v in node]
        return node

    return rebuild(template, treedef)


class CheckpointManager:
    """Versioned checkpoints in a local directory, atomic publish (temp
    file + fsync + rename) and bounded retention.

    Layout::

        <dir>/ckpt-<step>.bin     one tree per step
        <dir>/MANIFEST.json       {"latest": step, "steps": [...], "meta": {}}
    """

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        check("://" not in directory,
              f"only local directories are supported, got {directory!r}")
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt-{step}.bin")

    def _publish(self, name: str, write_fn) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=f".{name}-")
        try:
            with os.fdopen(fd, "wb") as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, name))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _read_manifest(self) -> Dict[str, Any]:
        try:
            with open(os.path.join(self.dir, "MANIFEST.json"), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return {"latest": None, "steps": [], "meta": {}}
        try:
            return json.loads(raw.decode())
        except ValueError:
            # torn manifest: the published ckpt files are the truth
            steps = sorted(
                int(f[len("ckpt-"):-len(".bin")])
                for f in os.listdir(self.dir)
                if f.startswith("ckpt-") and f.endswith(".bin")
                and f[len("ckpt-"):-len(".bin")].isdigit())
            log_info("checkpoint: manifest corrupt, rebuilt from %d files",
                     len(steps))
            return {"latest": steps[-1] if steps else None,
                    "steps": steps, "meta": {}}

    @property
    def steps(self) -> List[int]:
        return list(self._read_manifest()["steps"])

    @property
    def latest_step(self) -> Optional[int]:
        return self._read_manifest()["latest"]

    def save(self, step: int, state: Any,
             meta: Optional[Dict[str, Any]] = None) -> str:
        check(step >= 0, "checkpoint step must be >= 0")
        self._publish(f"ckpt-{step}.bin", lambda f: save_pytree(f, state))
        m = self._read_manifest()
        if step not in m["steps"]:
            m["steps"] = sorted(m["steps"] + [step])
        m["latest"] = max(m["steps"])
        if meta:
            m["meta"][str(step)] = meta
        dropped = []
        while len(m["steps"]) > self.max_to_keep:
            drop = m["steps"].pop(0)
            m["meta"].pop(str(drop), None)
            dropped.append(drop)
        blob = json.dumps(m, indent=2).encode()
        self._publish("MANIFEST.json", lambda f: f.write(blob))
        for drop in dropped:         # after the manifest no longer names it
            try:
                os.unlink(self._path(drop))
            except OSError:
                pass
        log_info("checkpoint: saved step %d -> %s", step, self._path(step))
        return self._path(step)

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Tuple[int, Any]:
        """-> (step, state); the latest step by default."""
        m = self._read_manifest()
        if step is None:
            step = m["latest"]
        if step is None:
            raise DMLCError(f"no checkpoints in {self.dir}")
        check(step in m["steps"],
              f"no checkpoint for step {step}; have {m['steps']}")
        try:
            f = open(self._path(step), "rb")
        except FileNotFoundError as e:
            raise DMLCError(f"checkpoint file for step {step} is missing "
                            f"({self._path(step)})") from e
        with f:
            return step, load_pytree(f, template=template)

    def meta(self, step: int) -> Dict[str, Any]:
        return self._read_manifest()["meta"].get(str(step), {})


def load_for_inference(directory: str, step: Optional[int] = None,
                       template: Any = None
                       ) -> Tuple[int, Any, Dict[str, Any]]:
    """``(step, params, meta)`` from a checkpoint directory: the
    ``params`` entry of a training checkpoint (the optimizer state is
    dropped), or the whole tree of a bare-params checkpoint."""
    mgr = CheckpointManager(directory)
    if template is not None and "params" not in template:
        template = {"params": template}
    step, state = mgr.restore(step, template=template)
    params = (state["params"]
              if isinstance(state, dict) and "params" in state else state)
    return step, params, mgr.meta(step)
