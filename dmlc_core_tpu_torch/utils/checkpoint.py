"""Checkpoints in the JAX package's ``DMLCKPT1`` format, in a local
directory or on a remote store.

Counterpart of ``dmlc_core_tpu/utils/checkpoint.py`` (``save_pytree``,
``load_pytree``, ``load_pytree_leaves``, ``flatten_tree``,
``unflatten_like``, ``Serializable``, ``fast_forward``,
``CheckpointManager`` with ``save``, ``save_async``, ``wait``,
``restore`` and ``restore_leaves`` and its ``MANIFEST.json``, and
``load_for_inference``).  The byte layout is the same, so a checkpoint
written by either package loads in the other:

    magic "DMLCKPT1", JSON treedef (leaves as {"__leaf__": i}, tuples as
    {"__tuple__": [...]}), u32 leaf count, then per leaf: dtype string,
    u32 ndim, u64 dims, raw little-endian bytes — each string and byte
    run prefixed by its u64 length.

Leaves are numpy arrays or torch tensors on save and numpy arrays on
load.  A tensor on the card is written through a pinned staging buffer
of at most ``STAGING_BYTES``, chunk by chunk, on the current CUDA
stream, so no host copy of the whole tensor is made.

``save_async`` snapshots the state before it returns and writes it on a
thread: each tensor on the card is cloned on the current stream (the
optimizer's kernel and the replayed k-step graphs update parameters and
moments in place, so a reference would hand the writer a later step's
values), CPU tensors and numpy arrays are copied at once.  The writer
thread copies the clones to the host on a CUDA stream of its own, which
first waits on an event recorded after the clones; the clones live until
the thread has synchronised that stream.  The snapshot costs a second
copy of the state on the card.  One save is in flight at a time;
``wait`` joins it (for at most ``WRITE_TIMEOUT_S``) and raises its
error.

A directory with a scheme other than ``file://`` (``s3://bucket/run``,
``hdfs://namenode:port/ckpt``, ...) is kept on that store through the
I/O layer's filesystems (``_RemoteStore``): each object is published
whole or not at all (S3's single PUT or multipart complete, an abort on
a failed write; on a store with ``rename``, WebHDFS, a temporary name
renamed into place), so the save's stream of pinned staging chunks
feeds the store's write stream (S3's multipart parts) directly.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .logging import DMLCError, check, log_info

__all__ = ["Serializable", "save_pytree", "load_pytree", "CheckpointManager",
           "fast_forward", "load_for_inference", "flatten_tree",
           "unflatten_like", "load_pytree_leaves", "snapshot"]

_MAGIC = b"DMLCKPT1"
STAGING_BYTES = 64 << 20
WRITE_TIMEOUT_S = 3600.0     # wait()'s limit on one background write


class Serializable:
    """The ``save(stream)`` / ``load(stream)`` protocol."""

    def save(self, stream) -> None:
        raise NotImplementedError

    def load(self, stream) -> None:
        raise NotImplementedError


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


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


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


def _write_tensor(stream, t: torch.Tensor) -> None:
    """A card tensor's bytes, through a pinned staging buffer of at most
    ``STAGING_BYTES`` on the current CUDA stream, one chunk at a time."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    n = flat.numel()
    stream.write(struct.pack("<Q", n))
    if n == 0:
        return
    cuda_stream = torch.cuda.current_stream(t.device)
    staging = torch.empty(min(n, STAGING_BYTES), dtype=torch.uint8,
                          pin_memory=True)
    host = staging.numpy()
    for off in range(0, n, len(host)):
        m = min(len(host), n - off)
        staging[:m].copy_(flat[off:off + m], non_blocking=True)
        cuda_stream.synchronize()
        stream.write(memoryview(host[:m]))


def _leaf_meta(leaf) -> Tuple[str, tuple]:
    if isinstance(leaf, torch.Tensor):
        dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
        return str(dtype), tuple(leaf.shape)
    return str(leaf.dtype), leaf.shape


def save_pytree(stream, tree: Any) -> None:
    """Serialize a nested dict/list/tuple of arrays, tensors and
    scalars."""
    leaves: list = []

    def strip(node):
        if _is_leaf(node):
            if isinstance(node, torch.Tensor) and node.is_cuda:
                leaves.append(node)
            else:
                leaves.append(_to_numpy(node))
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
    for leaf in leaves:
        dtype, shape = _leaf_meta(leaf)   # the shape before any reshape:
        _write_blob(stream, dtype.encode())   # a 0-d leaf stays 0-d
        stream.write(struct.pack("<I", len(shape)))
        for d in shape:
            stream.write(struct.pack("<Q", d))
        if isinstance(leaf, torch.Tensor):
            _write_tensor(stream, leaf)
        else:
            _write_blob(stream, np.ascontiguousarray(leaf).tobytes())


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


# -- leaf-granular access ----------------------------------------------------
# A leaf's path joins its dict keys and sequence indices with "/"
# ({"params": {"w": x}} -> "params/w"; a tuple's i-th child -> ".../i").

def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """A tree's array leaves as ``{path: np.ndarray}`` (tensors copied to
    the host); scalars, strings and None are skipped."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path: str) -> None:
        if _is_leaf(node):
            check(path not in out, f"duplicate leaf path {path!r}")
            out[path] = _to_numpy(node)
            return
        if isinstance(node, dict):
            check(all(isinstance(k, str) for k in node),
                  "tree dict keys must be str")
            for k, v in node.items():
                walk(v, _join(path, k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, _join(path, i))
        elif node is None or isinstance(node, (bool, int, float, str)):
            return
        else:
            raise DMLCError(f"cannot flatten {type(node).__name__}")

    walk(tree, "")
    return out


def unflatten_like(template: Any, flat: Dict[str, np.ndarray]) -> Any:
    """A tree shaped like ``template`` from a :func:`flatten_tree`
    mapping; container types (NamedTuples too) come from the template, a
    template leaf missing from ``flat`` raises."""

    def build(node, path: str):
        if _is_leaf(node):
            if path not in flat:
                raise DMLCError(f"unflatten_like: missing leaf {path!r}")
            return flat[path]
        if isinstance(node, dict):
            out = {k: build(v, _join(path, k)) for k, v in node.items()}
            return out if type(node) is dict else type(node)(out)
        if isinstance(node, tuple):
            vals = [build(v, _join(path, i)) for i, v in enumerate(node)]
            if hasattr(node, "_fields"):
                return type(node)(*vals)
            return tuple(vals)
        if isinstance(node, list):
            return [build(v, _join(path, i)) for i, v in enumerate(node)]
        return node

    return build(template, "")


def _treedef_paths(treedef: Any) -> Dict[int, str]:
    """Leaf index -> path of a serialized treedef."""
    out: Dict[int, str] = {}

    def walk(node, path: str) -> None:
        if isinstance(node, dict):
            if "__leaf__" in node:
                out[int(node["__leaf__"])] = path
                return
            if "__tuple__" in node:
                for i, v in enumerate(node["__tuple__"]):
                    walk(v, _join(path, i))
                return
            for k, v in node.items():
                walk(v, _join(path, k))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, _join(path, i))

    walk(treedef, "")
    return out


def _skip_bytes(stream, n: int) -> None:
    try:
        stream.seek(n, 1)
        return
    except (AttributeError, OSError, ValueError):
        pass
    while n > 0:
        chunk = stream.read(min(n, 1 << 20))
        if not chunk:
            raise DMLCError("checkpoint stream truncated")
        n -= len(chunk)


def load_pytree_leaves(stream, paths) -> Dict[str, np.ndarray]:
    """Only the named leaves of a :func:`save_pytree` stream, as
    ``{path: array}`` (absent paths are left out); the other leaves'
    bytes are seeked over."""
    magic = _read_exact(stream, len(_MAGIC))
    check(magic == _MAGIC, f"not a dmlc checkpoint (magic {magic!r})")
    idx2path = _treedef_paths(json.loads(_read_blob(stream).decode()))
    (nleaves,) = struct.unpack("<I", _read_exact(stream, 4))
    want = set(paths)
    out: Dict[str, np.ndarray] = {}
    for i in range(nleaves):
        dtype = np.dtype(_read_blob(stream).decode())
        (ndim,) = struct.unpack("<I", _read_exact(stream, 4))
        shape = tuple(struct.unpack("<Q", _read_exact(stream, 8))[0]
                      for _ in range(ndim))
        (nbytes,) = struct.unpack("<Q", _read_exact(stream, 8))
        path = idx2path.get(i)
        if path in want:
            raw = _read_exact(stream, nbytes)
            out[path] = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            if len(out) == len(want):
                break
        else:
            _skip_bytes(stream, nbytes)
    return out


def snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose leaves no later in-place update can
    reach: tensors cloned (on the card, on the current stream, queued
    behind the work that wrote them), numpy arrays copied; containers
    rebuilt in order (NamedTuples keep their type)."""
    if isinstance(tree, dict):
        out = {k: snapshot(v) for k, v in tree.items()}
        return out if type(tree) is dict else type(tree)(out)
    if isinstance(tree, tuple):
        vals = [snapshot(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone(memory_format=torch.contiguous_format)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _cuda_devices(tree: Any, out: set) -> set:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        out.add(tree.device)
    return out


class _LocalStore:
    """A local directory: temp file + fsync + rename publishes atomically."""

    def __init__(self, directory: str) -> None:
        self.base = directory
        os.makedirs(directory, exist_ok=True)

    def url(self, name: str) -> str:
        return os.path.join(self.base, name)

    def names(self) -> List[str]:
        return os.listdir(self.base)

    def read_bytes(self, name: str) -> Optional[bytes]:
        try:
            with open(self.url(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def open_read(self, name: str):
        try:
            return open(self.url(name), "rb")
        except FileNotFoundError as e:
            raise DMLCError(f"checkpoint object missing: {self.url(name)}"
                            ) from e

    def write_stream(self, name: str, write_fn) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.base, prefix=f".{name}-")
        try:
            with os.fdopen(fd, "wb") as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.url(name))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def delete(self, name: str) -> None:
        try:
            os.unlink(self.url(name))
        except OSError:
            pass


class _RemoteStore:
    """A directory on a remote store, through the I/O layer's filesystems
    (the JAX package's ``_RemoteStore``)."""

    def __init__(self, base_uri: str) -> None:
        from ..io.filesys import get_filesystem
        from ..io.uri import URI
        self.base = base_uri.rstrip("/")
        self._uri = URI
        self._fs = get_filesystem(URI(self.base))

    def url(self, name: str) -> str:
        return f"{self.base}/{name}"

    @staticmethod
    def _is_missing(e: DMLCError) -> bool:
        """A definite not-found, as against a transient failure: a 500 or
        a timeout must propagate, or one blip during a save would rebuild
        the manifest as empty and orphan every earlier checkpoint."""
        msg = str(e)
        return "404" in msg or "no such" in msg.lower()

    def names(self) -> List[str]:
        try:
            infos = self._fs.list_directory(self._uri(self.base))
        except DMLCError as e:
            if self._is_missing(e):
                return []           # the prefix holds nothing yet
            raise
        return [i.path.rstrip("/").rsplit("/", 1)[-1] for i in infos]

    def read_bytes(self, name: str) -> Optional[bytes]:
        uri = self._uri(self.url(name))
        try:
            self._fs.get_path_info(uri)
        except DMLCError as e:
            if self._is_missing(e):
                return None
            raise
        with self._fs.open(uri, "r") as f:
            return f.read()

    def open_read(self, name: str):
        return self._fs.open(self._uri(self.url(name)), "r")

    def write_stream(self, name: str, write_fn) -> None:
        """Publish the whole object or nothing: a store whose write lands
        at close (S3's PUT or multipart complete) is written under the
        final name and aborted on an error; a store with ``rename``
        (WebHDFS, whose appends show at once) is written under a
        temporary name and renamed into place."""
        from uuid import uuid4
        rename = getattr(self._fs, "rename", None)
        target = self.url(name)
        wire = f"{target}.tmp-{uuid4().hex[:8]}" if rename else target
        f = self._fs.open(self._uri(wire), "w")
        try:
            write_fn(f)
        except BaseException:
            abort = getattr(f, "abort", None)
            if abort is not None:
                abort()             # no close: nothing published
            if rename:
                try:
                    f.close()
                    self._fs.delete(self._uri(wire))
                except DMLCError:
                    pass
            raise
        f.close()
        if rename:
            rename(self._uri(wire), self._uri(target))

    def delete(self, name: str) -> None:
        try:
            self._fs.delete(self._uri(self.url(name)))
        except DMLCError as e:
            # the manifest no longer names it, so a restore never reads it
            log_info("checkpoint: could not prune %s (%s)", name, e)


def _store_for(directory: str):
    if directory.startswith("file://"):
        return _LocalStore(directory[len("file://"):])
    if "://" in directory:
        return _RemoteStore(directory)
    return _LocalStore(directory)


class CheckpointManager:
    """Versioned checkpoints with atomic publish and bounded retention,
    in a local directory (a path or ``file://``) or on a remote store
    (any other ``scheme://`` the I/O layer registers).

    Layout::

        <dir>/ckpt-<step>.bin     one tree per step
        <dir>/MANIFEST.json       {"latest": step, "steps": [...], "meta": {}}
    """

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.dir = directory
        self.max_to_keep = max_to_keep
        self._store = _store_for(directory)
        self._pending: Optional[Tuple[threading.Thread, List[Any]]] = None

    def _path(self, step: int) -> str:
        return self._store.url(f"ckpt-{step}.bin")

    def _publish(self, name: str, write_fn) -> None:
        self._store.write_stream(name, write_fn)

    def _read_manifest(self) -> Dict[str, Any]:
        raw = self._store.read_bytes("MANIFEST.json")
        if raw is None:
            return {"latest": None, "steps": [], "meta": {}}
        try:
            return json.loads(raw.decode())
        except ValueError:
            # torn manifest: the published ckpt files are the truth
            steps = sorted(
                int(f[len("ckpt-"):-len(".bin")])
                for f in self._store.names()
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
            self._store.delete(f"ckpt-{drop}.bin")
        log_info("checkpoint: saved step %d -> %s", step, self._path(step))
        return self._path(step)

    def save_async(self, step: int, state: Any,
                   meta: Optional[Dict[str, Any]] = None) -> None:
        """:meth:`save` on a thread; returns once ``state`` is
        snapshotted (:func:`snapshot`), so the caller may update it in
        place right away.  Waits first for the save in flight and raises
        its error.  Call :meth:`wait` before reading the manifest or
        exiting."""
        self.wait()
        snapped = snapshot(state)
        devices = _cuda_devices(snapped, set())
        check(len(devices) <= 1, f"state on several cards: {devices}")
        ready = None
        if devices:
            # the clones are queued on the current stream: the writer's
            # stream waits for them, not for what the caller queues next
            device = devices.pop()
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        box: List[Any] = []               # [path] or [None, error]

        def run() -> None:
            try:
                if ready is None:
                    box.append(self.save(step, snapped, meta))
                    return
                torch.cuda.set_device(device)
                copy_stream = torch.cuda.Stream(device)
                copy_stream.wait_event(ready)
                with torch.cuda.stream(copy_stream):
                    box.append(self.save(step, snapped, meta))
                copy_stream.synchronize()
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                box[:] = [None, e]

        th = threading.Thread(target=run, name=f"ckpt-save-{step}",
                              daemon=True)
        self._pending = (th, box)
        th.start()

    def wait(self) -> Optional[str]:
        """Block until the pending :meth:`save_async` has published; its
        checkpoint path, or None when none was pending.  Raises the
        background save's error, and raises (the save still pending)
        when the write outlasts ``WRITE_TIMEOUT_S``."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        th, box = pending
        th.join(timeout=WRITE_TIMEOUT_S)
        if th.is_alive():
            self._pending = pending
            raise DMLCError(f"checkpoint write still running after "
                            f"{WRITE_TIMEOUT_S:.0f} s")
        if len(box) == 2:
            raise DMLCError(
                f"async checkpoint save failed: {box[1]}") from box[1]
        return box[0]

    def _open_step(self, step: Optional[int]):
        m = self._read_manifest()
        if step is None:
            step = m["latest"]
        if step is None:
            raise DMLCError(f"no checkpoints in {self.dir}")
        check(step in m["steps"],
              f"no checkpoint for step {step}; have {m['steps']}")
        try:
            return step, self._store.open_read(f"ckpt-{step}.bin")
        except DMLCError as e:
            raise DMLCError(f"checkpoint file for step {step} is missing "
                            f"({self._path(step)})") from e

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Tuple[int, Any]:
        """-> (step, state); the latest step by default."""
        step, f = self._open_step(step)
        with f:
            return step, load_pytree(f, template=template)

    def restore_leaves(self, paths, step: Optional[int] = None
                       ) -> Tuple[int, Dict[str, np.ndarray]]:
        """-> (step, {path: array}) for just the named leaves
        (:func:`load_pytree_leaves`)."""
        step, f = self._open_step(step)
        with f:
            return step, load_pytree_leaves(f, paths)

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


def fast_forward(loader, num_batches: int) -> int:
    """Skip ``num_batches`` batches of a fresh loader to resume mid-epoch;
    returns the batches skipped."""
    skipped = 0
    while skipped < num_batches:
        if loader.next_batch() is None:
            break
        skipped += 1
    return skipped
