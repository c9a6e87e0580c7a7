"""Source and pack-config fingerprints for the packed-page cache.

Counterpart of ``dmlc_core_tpu/pipeline/fingerprint.py``, the part the
page cache uses: :func:`find_file_split`, :func:`source_attr`,
:func:`split_files` and :func:`pack_fingerprint`.  The dict carries the
JAX package's keys (``wire_compact`` among them, always False here: the
v3 compact wire is not ported), so a page file names the same
configuration in either package and each serves the other's pages.
``host_shape`` and ``autotune_key`` wait for the autotuner (ROADMAP
A.9).

A file of a remote filesystem (``s3://`` and the others) has no
``os.stat``, so its mtime is None, as in the JAX package: the page cache
then keys it by path and size alone, and an object rewritten at the
same size is served stale from the page file (ROADMAP queue C).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

__all__ = ["find_file_split", "source_attr", "split_files",
           "pack_fingerprint"]


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
