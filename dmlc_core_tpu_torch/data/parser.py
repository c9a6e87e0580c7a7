"""libsvm text → :class:`RowBlock` batches, from a local file or bytes.

Counterpart of ``dmlc_core_tpu/data/py_parsers.py::parse_libsvm`` (the
per-line semantics) and of the local-file part of
``dmlc_core_tpu/data/parser.py``: ``create_parser(path, part, nparts,
"libsvm")`` over a line-aligned byte-range split (as
``io/input_split.py``'s ``InputSplitBase.reset_partition`` and
``LineSplitter`` cut it), a :class:`TextParser` that parses each chunk
with the native library (:mod:`..native`) or the python
:func:`parse_libsvm`, and a :class:`ThreadedParser` that parses ahead on
a thread.  Remote schemes and libfm/csv stay with the JAX package for
now.

:func:`parse_libsvm` keeps the JAX fallback parser's rules exactly: a
bad label skips its line, a bad feature token ends its row, a value-less
token ``idx`` has value 1.0.  The native parser follows the same rules.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np

from .. import native
from ..utils.logging import DMLCError, check, log_info
from ..utils.threaded_iter import ThreadedIter
from .row_block import RowBlock

__all__ = ["parse_libsvm", "LibSVMParser", "TextParser", "ThreadedParser",
           "create_parser", "resolve_engine", "ENGINES"]

ENGINES = ("auto", "native", "python")

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
    """The line-aligned byte-range split of a local libsvm file (or of
    ``data`` bytes) that a :class:`TextParser` parses: chunks of whole
    lines of part ``part_index`` of ``num_parts`` (the JAX
    ``InputSplit``'s role).  The byte range is cut as the JAX
    ``InputSplitBase`` cuts it: ``ceil(size / num_parts)`` bytes per
    part, each end moved forward to the next line start."""

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

    def next_chunk(self) -> Optional[bytes]:
        """The next chunk of whole lines of this part, or None at its
        end."""
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

    def close(self) -> None:
        self._data = b""
        self.begin = self.end = self._cur = 0

    def __enter__(self) -> "LibSVMParser":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TextParser:
    """Chunk → :class:`RowBlock` parser over a line-aligned split (the JAX
    ``TextParser``): ``source`` has ``next_chunk()``, ``before_first()``
    and ``close()`` (a :class:`LibSVMParser`), and ``parse_fn(chunk)``
    is the native or the python parse kernel.  Chunks whose lines are all
    bad give no block."""

    text_format = "libsvm"

    def __init__(self, source: LibSVMParser,
                 parse_fn: Callable[[bytes], Dict], nthreads: int = 0,
                 engine: str = "python") -> None:
        self.source = source
        self.parse_fn = parse_fn
        self.nthreads = nthreads
        self.engine = engine
        self.bytes_read = 0

    @property
    def chunk_bytes(self) -> int:
        return self.source.chunk_bytes

    @chunk_bytes.setter
    def chunk_bytes(self, n: int) -> None:
        self.source.chunk_bytes = n

    def parse_next(self) -> Optional[RowBlock]:
        while True:
            chunk = self.source.next_chunk()
            if chunk is None:
                return None
            self.bytes_read += len(chunk)
            blk = _to_block(self.parse_fn(chunk))
            if blk.size:
                return blk

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            blk = self.parse_next()
            if blk is None:
                return
            yield blk

    def before_first(self) -> None:
        self.source.before_first()

    def close(self) -> None:
        self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ThreadedParser(TextParser):
    """Parses ahead of its consumer on a thread (the JAX
    ``ThreadedParser``, queue of ``max_capacity`` blocks).  The thread
    starts at the first block asked for, so settings such as
    ``chunk_bytes`` made after construction still apply."""

    def __init__(self, base: TextParser, max_capacity: int = 8) -> None:
        super().__init__(base.source, base.parse_fn, base.nthreads,
                         base.engine)
        self.base = base
        self._capacity = max_capacity
        self._iter: Optional[ThreadedIter] = None

    def _started(self) -> ThreadedIter:
        if self._iter is None:
            self._iter = ThreadedIter(self._capacity)
            self._iter.init(lambda _cell: self.base.parse_next(),
                            self.base.before_first, name="dmlc-parse")
        return self._iter

    def parse_next(self) -> Optional[RowBlock]:
        out = self._started().next()
        self.bytes_read = self.base.bytes_read
        return out

    def before_first(self) -> None:
        if self._iter is None:
            self.base.before_first()
        else:
            self._iter.before_first()

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        self.base.close()


def _default_nthreads() -> int:
    """Parse threads when the caller passes 0: ``DMLC_NUM_THREADS``, then
    ``OMP_NUM_THREADS``, then the cores this process may run on (8 when
    that reads 1: a container quota on a multicore host, where the extra
    threads cost next to nothing), as the JAX package counts them."""
    for var in ("DMLC_NUM_THREADS", "OMP_NUM_THREADS"):
        val = os.environ.get(var, "").strip()
        if val.isdigit() and int(val) > 0:
            return int(val)
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return n if n > 1 else 8


def resolve_engine(engine: str) -> str:
    """``"native"`` or ``"python"``: ``auto`` takes native wherever g++
    exists (a failed build raises) and python only without a compiler;
    ``native`` raises when the library cannot be built."""
    if engine not in ENGINES:
        raise DMLCError(f"bad parse engine {engine!r}; one of {ENGINES}")
    if engine == "python":
        return engine
    if native.available():
        return "native"
    if engine == "native":
        raise DMLCError("engine='native' needs the native library, and it "
                        "cannot be built: g++ not found")
    return "python"


def _make_kernel(engine: str, nthreads: int) -> Callable[[bytes], Dict]:
    if engine == "native":
        return lambda b: native.parse_libsvm(b, nthreads)
    return parse_libsvm


def create_parser(path: str, part_index: int = 0, num_parts: int = 1,
                  parser_type: str = "libsvm", nthreads: int = 0,
                  threaded: bool = True, engine: str = "auto"):
    """The JAX package's ``create_parser`` for a local libsvm file (a
    plain path or a ``file://`` URI): a :class:`TextParser` over part
    ``part_index`` of ``num_parts``, wrapped in a :class:`ThreadedParser`
    unless ``threaded`` is False.  ``engine`` picks the parse kernel
    (``"auto"``, ``"native"`` or ``"python"``); ``nthreads`` is the
    native parser's OpenMP team (0: :func:`_default_nthreads`)."""
    if parser_type not in ("libsvm", "auto"):
        raise DMLCError(f"parser format {parser_type!r} is not ported yet; "
                        f"only 'libsvm' is")
    if path.startswith("file://"):
        path = path[len("file://"):]
    if "://" in path:
        raise DMLCError(f"only local files are supported, got {path!r}")
    if not os.path.isfile(path):
        raise DMLCError(f"no such file: {path}")
    chosen = resolve_engine(engine)
    if nthreads <= 0:
        nthreads = _default_nthreads()
    if engine == "auto":
        log_info("parser: engine %s%s", chosen,
                 f" ({nthreads} threads)" if chosen == "native" else "")
    parser = TextParser(LibSVMParser(path, part_index, num_parts),
                        _make_kernel(chosen, nthreads), nthreads, chosen)
    return ThreadedParser(parser) if threaded else parser
