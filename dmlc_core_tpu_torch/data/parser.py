"""libsvm, libfm and csv text → :class:`RowBlock` batches.

Counterpart of ``dmlc_core_tpu/data/py_parsers.py`` (the per-line
semantics of :func:`parse_libsvm`, :func:`parse_libfm` and
:func:`parse_csv`) and of ``dmlc_core_tpu/data/parser.py``:
``create_parser(uri, part, nparts, fmt)`` over
``create_input_split(uri, part, nparts, "text")`` (:mod:`..io`: a file,
a directory, a ``;`` list or a glob, mapped and cut into line-aligned
parts, with a ``#cachefile`` fragment for the raw-chunk cache), a
:class:`TextParser` that parses each chunk with the native library
(:mod:`..native`) or the python parsers, and a :class:`ThreadedParser`
that parses ahead on a thread.  The format comes from ``parser_type``,
or for ``"auto"`` (the default, as in the JAX package) from the URI's
``?format=`` argument (then libsvm); csv reads ``?label_column=`` and
``?delimiter=`` (:class:`CSVParserParam`).  The parser carries
``text_format``, the csv knobs and ``cache_file`` (the fragment, with
its part suffix) for the loader's fused parse-and-pack and its page
cache.  A remote URI (``s3://``, ``hdfs://``, ``http://``, ...) is read
through its filesystem's streams, and its chunks are ``bytes``, not
views of a map; a ``#cachefile`` fragment still names a local file.

The python parsers keep the JAX fallback parsers' rules exactly: a bad
label skips its line, a bad feature token ends its row, a value-less
libsvm token ``idx`` has value 1.0, a libfm token needs all three of
``field:idx:value``; a csv row with a cell that is not a number is
dropped whole, an empty cell reads 0, and column ``label_column`` (-1:
none, every label 0) is the label.  The native parsers follow the same
rules.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np

from .. import native
from ..io import URISpec, create_input_split
from ..utils.logging import DMLCError, check, log_info
from ..utils.metrics import metrics
from ..utils.parameter import Parameter, field
from ..utils.threaded_iter import ThreadedIter
from .row_block import RowBlock

__all__ = ["parse_libsvm", "parse_libfm", "parse_csv", "CSVParserParam",
           "LibSVMParser", "TextParser", "ThreadedParser", "create_parser",
           "resolve_engine", "ENGINES", "FORMATS"]

ENGINES = ("auto", "native", "python")
FORMATS = ("libsvm", "libfm", "csv")

CHUNK_BYTES = 2 << 20            # the JAX InputSplit's default chunk


class CSVParserParam(Parameter):
    """csv options, read from the path's ``?key=value`` arguments (the
    JAX package's ``CSVParserParam``)."""
    format = field(str, default="csv")
    label_column = field(int, default=-1,
                         help="column index holding the label; -1 = none")
    delimiter = field(str, default=",")


def _finish(offsets, labels, weights, indices, values, fields,
            bad) -> Dict:
    """The parsers' output dict; ``fields`` (libfm only, else None) adds
    ``fields`` and ``max_field``."""
    out = {
        "offsets": np.asarray(offsets, np.int64),
        "labels": np.asarray(labels, np.float32),
        "weights": np.asarray(weights, np.float32),
        "indices": np.asarray(indices, np.uint64),
        "values": np.asarray(values, np.float32),
        "max_index": int(max(indices)) if len(indices) else 0,
        "bad_lines": bad,
    }
    if fields is not None:
        out["fields"] = np.asarray(fields, np.uint32)
        out["max_field"] = int(max(fields)) if fields else 0
    return out


def _parse_sparse(data: Union[bytes, memoryview], with_fields: bool) -> Dict:
    offsets = [0]
    labels: list = []
    weights: list = []
    indices: list = []
    values: list = []
    fields: Optional[list] = [] if with_fields else None
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
                if with_fields:
                    if len(parts) != 3:
                        raise ValueError(tok)
                    # all three parse before any is kept
                    f, i, v = int(parts[0]), int(parts[1]), float(parts[2])
                    fields.append(f)
                    indices.append(i)
                    values.append(v)
                else:
                    indices.append(int(parts[0]))
                    # value-less token 'idx' → implicit 1.0
                    values.append(float(parts[1]) if len(parts) > 1 else 1.0)
            except ValueError:
                bad += 1
                break
            n += 1
        offsets.append(offsets[-1] + n)
    return _finish(offsets, labels, weights, indices, values, fields, bad)


def parse_libsvm(data: Union[bytes, memoryview]) -> Dict:
    """One chunk of libsvm text → the CSR arrays of the JAX package's
    parsers (``offsets``, ``labels``, ``weights``, ``indices``,
    ``values``, ``max_index``, ``bad_lines``), equal to its fallback
    parser's output on the same bytes."""
    return _parse_sparse(data, with_fields=False)


def parse_libfm(data: Union[bytes, memoryview]) -> Dict:
    """One chunk of libfm text (``label[:weight] field:idx:value ...``)
    → :func:`parse_libsvm`'s arrays plus ``fields`` (uint32) and
    ``max_field``."""
    return _parse_sparse(data, with_fields=True)


def parse_csv(data: Union[bytes, memoryview], label_col: int = -1,
              delim: str = ",") -> Dict:
    """One chunk of dense csv → :func:`parse_libsvm`'s arrays: every
    column but ``label_col`` a value, its id its place among them."""
    d = delim.encode()
    offsets = [0]
    labels: list = []
    weights: list = []
    indices: list = []
    values: list = []
    bad = 0
    for line in bytes(data).splitlines():
        if not line.strip():
            continue
        row_vals = []
        label = 0.0
        try:
            for ci, tok in enumerate(line.split(d)):
                v = float(tok) if tok.strip() else 0.0
                if ci == label_col:
                    label = v
                else:
                    row_vals.append(v)
        except ValueError:
            bad += 1
            continue
        labels.append(label)
        weights.append(1.0)
        indices.extend(range(len(row_vals)))
        values.extend(row_vals)
        offsets.append(offsets[-1] + len(row_vals))
    return _finish(offsets, labels, weights, indices, values, None, bad)


def _to_block(d: Dict) -> RowBlock:
    return RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                    d["weights"], d.get("fields"), d.get("max_field", 0),
                    max_index=d["max_index"])


class LibSVMParser:
    """A line-aligned split of text held in memory (``data`` bytes), cut
    into part ``part_index`` of ``num_parts`` as the JAX
    ``InputSplitBase`` cuts a file: ``ceil(size / num_parts)`` bytes per
    part, each end moved forward to the next line start; chunks of whole
    lines.  Files go through :func:`..io.create_input_split`."""

    def __init__(self, data: bytes, part_index: int = 0,
                 num_parts: int = 1) -> None:
        check(0 <= part_index < num_parts,
              f"bad partition {part_index}/{num_parts}")
        self.chunk_size = CHUNK_BYTES
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

    def hint_chunk_size(self, chunk_size: int) -> None:
        self.chunk_size = max(chunk_size, 1 << 10)

    def next_chunk(self) -> Optional[bytes]:
        """The next chunk of whole lines of this part, or None at its
        end."""
        while self._cur < self.end:
            stop = min(self._cur + self.chunk_size, self.end)
            if stop < self.end:
                cut = max(self._data.rfind(b"\n", self._cur, stop),
                          self._data.rfind(b"\r", self._cur, stop))
                if cut < 0:                      # a line longer than a chunk
                    self.chunk_size *= 2
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
    ``TextParser``): ``source`` has ``next_chunk()``, ``before_first()``,
    ``hint_chunk_size()`` and ``close()`` (an InputSplit of :mod:`..io`
    or a :class:`LibSVMParser`), and ``parse_fn(chunk)``
    is the native or the python parse kernel.  Chunks whose lines are all
    bad give no block.  ``text_format`` and, for csv, ``csv_label_col``
    and ``csv_delim`` say what ``parse_fn`` reads, for a loader that
    parses and packs the text in one native pass."""

    def __init__(self, source,
                 parse_fn: Callable[[bytes], Dict], nthreads: int = 0,
                 engine: str = "python", text_format: str = "libsvm",
                 csv_label_col: int = -1, csv_delim: str = ",") -> None:
        self.source = source
        self.parse_fn = parse_fn
        self.nthreads = nthreads
        self.engine = engine
        self.text_format = text_format
        self.csv_label_col = csv_label_col
        self.csv_delim = csv_delim
        self.bytes_read = 0
        self._bind_metrics()

    def _bind_metrics(self) -> None:
        """The JAX parser's metric handles (``parser.chunk`` and
        ``parser.parse`` stage timers, ``parser.bytes`` throughput),
        re-fetched when the registry's generation moves."""
        self._m_gen = metrics.generation
        self._m_chunk = metrics.stage("parser.chunk")
        self._m_parse = metrics.stage("parser.parse")
        self._m_bytes = metrics.throughput("parser.bytes")

    @property
    def chunk_bytes(self) -> int:
        """The split's chunk size in bytes (the innermost split's
        ``chunk_size``); setting it is ``hint_chunk_size``."""
        split = self.source
        while not hasattr(split, "chunk_size"):
            split = split.base
        return split.chunk_size

    @chunk_bytes.setter
    def chunk_bytes(self, n: int) -> None:
        self.source.hint_chunk_size(n)

    def parse_next(self) -> Optional[RowBlock]:
        if self._m_gen != metrics.generation:
            self._bind_metrics()
        while True:
            with self._m_chunk.time():
                chunk = self.source.next_chunk()
            if chunk is None:
                return None
            self.bytes_read += len(chunk)
            self._m_bytes.add(len(chunk))
            with self._m_parse.time():
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
                         base.engine, base.text_format, base.csv_label_col,
                         base.csv_delim)
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


def _make_kernel(fmt: str, engine: str, nthreads: int,
                 csv: CSVParserParam) -> Callable[[bytes], Dict]:
    if fmt == "csv":
        lc, dl = csv.label_column, csv.delimiter
        if engine == "native":
            return lambda b: native.parse_csv(b, lc, dl, nthreads)
        return lambda b: parse_csv(b, lc, dl)
    if engine == "native":
        fn = native.parse_libfm if fmt == "libfm" else native.parse_libsvm
        return lambda b: fn(b, nthreads)
    return parse_libfm if fmt == "libfm" else parse_libsvm


def create_parser(uri: str, part_index: int = 0, num_parts: int = 1,
                  parser_type: str = "auto", nthreads: int = 0,
                  threaded: bool = True, engine: str = "auto"):
    """The JAX package's ``create_parser``: a :class:`TextParser` over
    ``create_input_split(uri, part_index, num_parts, "text",
    threaded=False)`` (a path, or a URI of any registered scheme, of a
    file, a directory, a ``;`` list or a local glob, with optional
    ``?key=value&...`` arguments and a ``#cachefile`` fragment), wrapped
    in a :class:`ThreadedParser` unless ``threaded`` is False.  Unlike
    the JAX factory, the split gets no prefetch thread of its own.
    ``parser_type`` is ``"libsvm"``, ``"libfm"``, ``"csv"`` or
    ``"auto"`` (the ``format=`` argument, else libsvm); csv takes its
    options from the arguments (:class:`CSVParserParam`), read once.
    ``engine`` picks the parse kernel (``"auto"``, ``"native"`` or
    ``"python"``); ``nthreads`` is the native parser's OpenMP team (0:
    :func:`_default_nthreads`).  The parser's ``cache_file`` is the
    fragment with its part suffix (None without one)."""
    spec = URISpec(uri, part_index, num_parts)
    fmt = spec.args.get("format", "libsvm") if parser_type == "auto" \
        else parser_type
    if fmt not in FORMATS:
        raise DMLCError(f"unknown parser format {fmt!r}; one of {FORMATS}")
    chosen = resolve_engine(engine)
    csv = CSVParserParam()              # read once: parse and streampack
    if fmt == "csv":
        csv.init_allow_unknown(spec.args)
    # no prefetch thread under the parser's: its own thread reads the
    # mapped chunks, and a second thread only contends for the
    # interpreter lock (measured with tools/feed_ab.py)
    split = create_input_split(uri, part_index, num_parts, "text",
                               threaded=False)
    if nthreads <= 0:
        nthreads = _default_nthreads()
    if engine == "auto":
        log_info("parser: engine %s%s", chosen,
                 f" ({nthreads} threads)" if chosen == "native" else "")
    parser = TextParser(split, _make_kernel(fmt, chosen, nthreads, csv),
                        nthreads, chosen, fmt, csv.label_column,
                        csv.delimiter)
    if threaded:
        parser = ThreadedParser(parser)
    parser.cache_file = spec.cache_file
    return parser
