"""Source and pack-config fingerprints for the packed-page cache.

Counterpart of ``dmlc_core_tpu/pipeline/fingerprint.py``:
:func:`find_file_split`, :func:`source_attr`, :func:`split_files` and
:func:`pack_fingerprint` for the page cache, and :func:`host_shape` and
:func:`autotune_key` for the autotuner's persisted configs.  The dict
carries the JAX package's keys (``wire_compact`` the loader's resolved
wire), so a page file names the same configuration in either package
and each serves the other's pages.

A file of a remote filesystem (``s3://`` and the others) has no
``os.stat``, so its mtime is None, as in the JAX package: the page cache
then keys it by path and size alone, and an object rewritten at the
same size is served stale from the page file (ROADMAP queue C).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

__all__ = ["find_file_split", "source_attr", "split_files",
           "pack_fingerprint", "host_shape", "autotune_key"]


def find_file_split(source) -> Optional[Any]:
    """The file-backed InputSplit under ``source``, or None.

    Walks up to 8 wrapper layers (``.base`` for parsers/ThreadedParser,
    ``.source`` for loaders) looking for an object with a ``files``
    attribute — fingerprinting needs stat-able source identity.
    """
    obj = source
    for _ in range(8):
        if hasattr(obj, "files"):
            return obj
        nxt = getattr(obj, "base", None)
        if nxt is None:
            nxt = getattr(obj, "source", None)
        if nxt is None or nxt is obj:
            return None
        obj = nxt
    return None


def source_attr(source, name: str, default=None):
    """An attribute off ``source``, looking through one wrapper layer
    (``ThreadedParser.base``) — where create_parser hangs format knobs."""
    v = getattr(source, name, None)
    if v is None:
        v = getattr(getattr(source, "base", None), name, None)
    return default if v is None else v


def split_files(split) -> list:
    """``[[path, size, mtime_ns], ...]`` for every file of the split.
    A missing file records ``None`` for mtime (still a distinct value,
    so reappearing files shift the fingerprint)."""
    files = []
    for fi in getattr(split, "files", []):
        try:
            mtime = os.stat(fi.path).st_mtime_ns
        except OSError:
            mtime = None
        files.append([fi.path, int(fi.size), mtime])
    return files


def pack_fingerprint(split, *, page_format: int, batch_rows: int,
                     nnz_cap: int, layout: str, id_mod: int,
                     wire_compact: bool, drop_remainder: bool,
                     ragged: bool, pack_path: str,
                     text_format, csv) -> Optional[Dict[str, Any]]:
    """Source identity (file list + sizes + mtimes) plus the full pack
    config, as one JSON-ready dict.  Returns None when the split has no
    stat-able files (nothing to fingerprint).  Recomputed at every epoch
    start by the loader, so a touched source file, a repartition, or any
    config change shifts the fingerprint and forces a silent rebuild."""
    files = split_files(split)
    if not files:
        return None
    return {
        "page_format": int(page_format),
        "files": files,
        "part": [int(getattr(split, "part_index", 0)),
                 int(getattr(split, "num_parts", 1))],
        "batch_rows": int(batch_rows),
        "nnz_cap": int(nnz_cap),
        "layout": layout,
        "id_mod": int(id_mod),
        "wire_compact": bool(wire_compact),
        "drop_remainder": bool(drop_remainder),
        "ragged": bool(ragged),
        "pack_path": pack_path,
        "text_format": text_format,
        "csv": csv,
    }


def host_shape() -> str:
    """Coarse host-shape tag for tuning keys: core count (the quantity
    every parallelism knob scales against).  Deliberately excludes the
    hostname — identical machines should share a converged config."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    return f"c{cores}"


def autotune_key(fingerprint: Optional[Dict[str, Any]], platform: str,
                 shape: Optional[str] = None) -> str:
    """Stable tuning-config key for (dataset fingerprint, host shape,
    platform).

    Projects the cache fingerprint down to what changes the *optimum*
    rather than the *bytes*: file paths and sizes stay (different data,
    different knobs), mtimes and the page-format version are dropped (a
    touched or re-fetched identical file and a cache-format bump keep
    their tuning).  ``fingerprint=None`` (un-stat-able source) keys by
    host shape + platform alone, so purely synthetic sources still get a
    per-host entry."""
    shape = shape or host_shape()
    relaxed: Dict[str, Any] = {}
    if fingerprint:
        relaxed = {k: v for k, v in fingerprint.items()
                   if k not in ("page_format",)}
        relaxed["files"] = [[p, s] for p, s, _mt in
                            fingerprint.get("files", [])]
    blob = json.dumps(relaxed, sort_keys=True).encode("utf-8")
    digest = hashlib.sha256(blob).hexdigest()[:16]
    return f"{digest}|{shape}|{platform}"
