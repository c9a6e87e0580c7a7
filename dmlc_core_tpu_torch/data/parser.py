"""libsvm text → :class:`RowBlock` batches, from a local file or bytes.

Counterpart of ``dmlc_core_tpu/data/py_parsers.py::parse_libsvm`` (the
per-line semantics) and of the local-file part of
``dmlc_core_tpu/data/parser.py`` (``create_parser(path, part, nparts,
"libsvm")`` over a line-aligned byte-range split, as
``io/input_split.py``'s ``InputSplitBase.reset_partition`` and
``LineSplitter`` cut it).  Remote schemes, libfm/csv, the native parser
and the threaded prefetch stay with the JAX package for now.

:func:`parse_libsvm` keeps the JAX fallback parser's rules exactly: a
bad label skips its line, a bad feature token ends its row, a value-less
token ``idx`` has value 1.0.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Union

import numpy as np

from ..utils.logging import DMLCError, check
from .row_block import RowBlock

__all__ = ["parse_libsvm", "LibSVMParser", "create_parser"]

CHUNK_BYTES = 2 << 20            # the JAX InputSplit's default chunk


def _finish(offsets, labels, weights, indices, values, bad) -> Dict:
    return {
        "offsets": np.asarray(offsets, np.int64),
        "labels": np.asarray(labels, np.float32),
        "weights": np.asarray(weights, np.float32),
        "indices": np.asarray(indices, np.uint64),
        "values": np.asarray(values, np.float32),
        "max_index": int(max(indices)) if len(indices) else 0,
        "bad_lines": bad,
    }


def parse_libsvm(data: Union[bytes, memoryview]) -> Dict:
    """One chunk of libsvm text → the CSR arrays of the JAX package's
    parsers (``offsets``, ``labels``, ``weights``, ``indices``,
    ``values``, ``max_index``, ``bad_lines``), equal to its fallback
    parser's output on the same bytes (``py_parsers._parse_sparse``
    without fields)."""
    offsets = [0]
    labels: list = []
    weights: list = []
    indices: list = []
    values: list = []
    bad = 0
    for line in bytes(data).splitlines():
        toks = line.split()
        if not toks:
            continue
        head = toks[0].split(b":")
        try:
            label = float(head[0])
            weight = float(head[1]) if len(head) > 1 else 1.0
        except ValueError:
            bad += 1
            continue
        labels.append(label)
        weights.append(weight)
        n = 0
        for tok in toks[1:]:
            parts = tok.split(b":")
            try:
                indices.append(int(parts[0]))
                # value-less token 'idx' → implicit 1.0
                values.append(float(parts[1]) if len(parts) > 1 else 1.0)
            except ValueError:
                bad += 1
                break
            n += 1
        offsets.append(offsets[-1] + n)
    return _finish(offsets, labels, weights, indices, values, bad)


def _to_block(d: Dict) -> RowBlock:
    return RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                    d["weights"])


class LibSVMParser:
    """Iterates :class:`RowBlock` s, one per chunk of whole lines, over
    part ``part_index`` of ``num_parts`` of a local file (or of ``data``
    bytes).  The byte range is cut as the JAX ``InputSplitBase`` cuts it:
    ``ceil(size / num_parts)`` bytes per part, each end moved forward to
    the next line start."""

    def __init__(self, path: Optional[str] = None, part_index: int = 0,
                 num_parts: int = 1, data: Optional[bytes] = None) -> None:
        check((path is None) != (data is None),
              "pass exactly one of path and data")
        check(0 <= part_index < num_parts,
              f"bad partition {part_index}/{num_parts}")
        self.chunk_bytes = CHUNK_BYTES
        if path is not None:
            with open(path, "rb") as f:
                data = f.read()
        self._data = bytes(data)
        total = len(self._data)
        step = (total + num_parts - 1) // num_parts
        self.begin = self._line_start(min(step * part_index, total))
        self.end = self._line_start(min(step * (part_index + 1), total))
        self.before_first()

    def _line_start(self, pos: int) -> int:
        if pos <= 0 or pos >= len(self._data):
            return min(max(pos, 0), len(self._data))
        d = self._data
        ends = [i for i in (d.find(b"\n", pos), d.find(b"\r", pos)) if i >= 0]
        if not ends:
            return len(d)
        i = min(ends)
        while i < len(d) and d[i] in b"\r\n":
            i += 1
        return i

    def before_first(self) -> None:
        self._cur = self.begin

    def _next_chunk(self) -> Optional[bytes]:
        while self._cur < self.end:
            stop = min(self._cur + self.chunk_bytes, self.end)
            if stop < self.end:
                cut = max(self._data.rfind(b"\n", self._cur, stop),
                          self._data.rfind(b"\r", self._cur, stop))
                if cut < 0:                      # a line longer than a chunk
                    self.chunk_bytes *= 2
                    continue
                stop = cut + 1
            chunk = self._data[self._cur:stop]
            self._cur = stop
            return chunk
        return None

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            chunk = self._next_chunk()
            if chunk is None:
                return
            blk = _to_block(parse_libsvm(chunk))
            if blk.size:
                yield blk

    def close(self) -> None:
        self._data = b""
        self.begin = self.end = self._cur = 0

    def __enter__(self) -> "LibSVMParser":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def create_parser(path: str, part_index: int = 0, num_parts: int = 1,
                  parser_type: str = "libsvm") -> LibSVMParser:
    """The JAX package's ``create_parser`` for a local libsvm file: a
    plain path or a ``file://`` URI."""
    if parser_type not in ("libsvm", "auto"):
        raise DMLCError(f"parser format {parser_type!r} is not ported yet; "
                        f"only 'libsvm' is")
    if path.startswith("file://"):
        path = path[len("file://"):]
    if "://" in path:
        raise DMLCError(f"only local files are supported, got {path!r}")
    if not os.path.isfile(path):
        raise DMLCError(f"no such file: {path}")
    return LibSVMParser(path, part_index, num_parts)
