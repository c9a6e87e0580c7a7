"""The libfm and csv feeds of the port, held against the JAX package on
the CPU.

Seeded libfm and csv text with the hard cases (label:weight heads, bad
labels, bad and value-less tokens, blank lines, CRLF endings, empty csv
cells, a label column, a ``;`` delimiter) goes through the port's
native and python parsers, the JAX native parser and (where its rules
are sane, see ``test_libfm_bad_index_token``) the JAX fallback parser;
``SpPacker`` for libfm and csv against the JAX ``SpPacker``; the three
packs with ``want_fields`` against JAX ``packing``; ``DeviceLoader``
with ``fields=True`` (flat, row-major, ragged) and the libfm / csv
streampack and two-stage loaders against the JAX ``DeviceLoader``.
Every comparison is ``array_equal`` with the same dtypes (ragged batches
on their live prefix: their tails are garbage by contract).  Each test
that needs the native library skips only where there is no g++.
"""

import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.data import py_parsers as jpy  # noqa: E402
from dmlc_core_tpu.data.row_block import RowBlock as JRowBlock  # noqa: E402
from dmlc_core_tpu.data.row_block import \
    RowBlockContainer as JContainer  # noqa: E402
from dmlc_core_tpu.pipeline import device_loader as jdl  # noqa: E402
from dmlc_core_tpu.pipeline import packing as jpacking  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import (RowBlock, concat_blocks,  # noqa: E402
                                      create_parser, parse_csv, parse_libfm)
from dmlc_core_tpu_torch.pipeline import (DeviceLoader,  # noqa: E402
                                          pack_flat, pack_ragged,
                                          pack_rowmajor)
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

ARRAYS = ("offsets", "labels", "weights", "indices", "values")
NF = 6
ROWS = 32


@pytest.fixture(scope="session")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()
    return native


def libfm_text(rows: int, seed: int, crlf: bool = False,
               messy: bool = True) -> bytes:
    """2-11 ``field:id:value`` tokens a row (fields below NF + 2, so some
    lie past a model's NF fields), label:weight heads on every seventh
    row; with ``messy`` blank lines, bad labels, field-less and
    value-less tokens and a non-numeric field mid-row."""
    rng = np.random.default_rng(seed)
    eol = b"\r\n" if crlf else b"\n"
    lines = []
    for i in range(rows):
        n = int(rng.integers(2, 12))
        idx = np.sort(rng.choice(5000, size=n, replace=False))
        toks = [b"%d:%d:%.5f" % (rng.integers(0, NF + 2), j, rng.random())
                for j in idx.tolist()]
        head = (b"%d" % (i & 1) if i % 7 else
                b"%d:%.3f" % (i & 1, rng.random()))
        lines.append(head + b" " + b" ".join(toks))
        if messy and i % 37 == 5:
            lines.append(b"")
        if messy and i % 41 == 7:
            lines.append(b"bad 1:2:3 3:4:5")            # bad label
        if messy and i % 43 == 9:
            lines.append(b"1 1:5:0.5 7:0.5 2:9:1")      # field-less token
        if messy and i % 47 == 11:
            lines.append(b"0 1:5 2:9:1")                # value-less token
        if messy and i % 53 == 13:
            lines.append(b"1 3:4:1 x:1:2 2:9:1")        # non-numeric field
    return eol.join(lines) + eol


def csv_text(rows: int, seed: int, delim: bytes = b",",
             ncol: int = 8) -> bytes:
    """Seeded dense csv: ``ncol`` columns, an empty cell now and then,
    a bad cell (row dropped) and a blank line."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        cells = [b"%.4f" % v for v in rng.random(ncol)]
        cells[0] = b"%d" % (i & 1)
        if i % 11 == 3:
            cells[int(rng.integers(1, ncol))] = b""
        if i % 29 == 7:
            cells[2] = b"abc"
        lines.append(delim.join(cells))
        if i % 31 == 9:
            lines.append(b"")
    return b"\n".join(lines) + b"\n"


def _assert_parsed(got, want, fields):
    for k in ARRAYS + (("fields",) if fields else ()):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = ("max_index", "bad_lines") + (("max_field",) if fields else ())
    for k in keys:
        assert got[k] == want[k], k


# -- parse ----------------------------------------------------------------

LIBFM_TEXTS = {"plain": dict(rows=60, seed=1),
               "big_crlf": dict(rows=3000, seed=2, crlf=True)}
ENGINES = ("native1", "native4", "python")


def _port_parse(engine, fn_native, fn_python, data, *args):
    if engine == "python":
        return fn_python(data, *args)
    return fn_native(data, *args, nthreads=int(engine[-1]))


@pytest.mark.parametrize("text", sorted(LIBFM_TEXTS))
@pytest.mark.parametrize("engine", ENGINES)
def test_libfm_parse_equals_jax(lib, text, engine):
    data = libfm_text(**LIBFM_TEXTS[text])
    got = _port_parse(engine, lib.parse_libfm, parse_libfm, data)
    want = jnative.parse_libfm(data)
    _assert_parsed(got, want, fields=True)
    _assert_parsed(got, jpy.parse_libfm(data), fields=True)
    assert got["bad_lines"] > 0 and got["max_field"] == NF + 1


def test_libfm_bad_index_token(lib):
    """A token whose field parses but whose id does not ends its row:
    both port parsers agree with the JAX native one.  (The JAX fallback
    parser keeps that token's field, so its ``fields`` run one longer
    than its ``indices``; ROADMAP queue C.)"""
    data = b"1 3:4:1 5:x:2 2:9:1\n0 1:2:3\n"
    want = jnative.parse_libfm(data)
    for got in (native.parse_libfm(data), parse_libfm(data)):
        _assert_parsed(got, want, fields=True)
    assert list(want["offsets"]) == [0, 1, 2]
    jfallback = jpy.parse_libfm(data)
    assert len(jfallback["fields"]) == len(jfallback["indices"]) + 1


CSV_CASES = {"comma": (b",", -1), "label0": (b",", 0),
             "semicolon_label2": (b";", 2)}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("engine", ENGINES)
def test_csv_parse_equals_jax(lib, case, engine):
    delim, label_col = CSV_CASES[case]
    data = csv_text(300, seed=3, delim=delim)
    args = (label_col, delim.decode())
    got = _port_parse(engine, lib.parse_csv, parse_csv, data, *args)
    want = jnative.parse_csv(data, *args)
    _assert_parsed(got, want, fields=False)
    _assert_parsed(got, jpy.parse_csv(data, *args), fields=False)
    assert got["bad_lines"] > 0
    assert (got["values"] == 0).any()                  # the empty cells


# -- SpPacker -------------------------------------------------------------

def _sppack_run(mod, text, chunk, **kw):
    sp = mod.SpPacker(16, 128, **kw)
    out = []
    a = 0
    while a < len(text):
        # whole lines a chunk, as the split hands them over
        b = (text.rfind(b"\n", a, a + chunk) + 1 if a + chunk < len(text)
             else len(text))
        out += [(buf.copy(), meta) for buf, meta in sp.feed_text(text[a:b])]
        a = b
    tail = sp.flush()
    if tail is not None:
        out.append((tail[0].copy(), tail[1]))
    stats = sp.stats()
    sp.close()
    return out, stats


SPPACK_CASES = {
    "libfm": (lambda: libfm_text(400, seed=4), dict(fmt="libfm")),
    "csv": (lambda: csv_text(400, seed=5), dict(fmt="csv")),
    "csv_semicolon_label0": (lambda: csv_text(400, seed=6, delim=b";"),
                             dict(fmt="csv", label_col=0, delim=";")),
}


@pytest.mark.parametrize("case", sorted(SPPACK_CASES))
def test_sppacker_matches_jax(lib, case):
    make, kw = SPPACK_CASES[case]
    text = make()
    got, gst = _sppack_run(lib, text, 1500, **kw)
    # the JAX packer over the text in one piece: batches do not depend on
    # where chunks end
    want, wst = _sppack_run(jnative, text, len(text), **kw)
    assert gst == wst and gst["bad_lines"] > 0
    assert len(got) == len(want) > 4
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm == wm
        words = native.fused_words(16, gm)
        np.testing.assert_array_equal(gb[:words], wb[:words])


def test_sppacker_refuses_an_unknown_format(lib):
    with pytest.raises(DMLCError, match="not in"):
        lib.SpPacker(8, 64, fmt="tsv")


# -- row blocks and packs -------------------------------------------------

def _blocks(text, n_blocks):
    """The parsed text as RowBlocks of both packages, cut into
    ``n_blocks`` pieces."""
    d = jnative.parse_libfm(text)
    rows = len(d["labels"])
    cuts = np.linspace(0, rows, n_blocks + 1).astype(int)
    whole = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                     d["weights"], d["fields"], d["max_field"])
    jwhole = JRowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                       d["weights"], d["fields"], d["max_index"],
                       d["max_field"])
    return ([whole.slice(a, b) for a, b in zip(cuts, cuts[1:])],
            [jwhole.slice(a, b) for a, b in zip(cuts, cuts[1:])])


def test_row_block_slices_and_concat_carry_fields():
    ours, theirs = _blocks(libfm_text(90, seed=7, messy=False), 3)
    cont = JContainer()
    for b in theirs:
        cont.push_block(b)
    want = cont.get_block()
    got = concat_blocks(ours)
    for k in ("offsets", "indices", "values", "fields", "labels"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.fields.dtype == np.uint32
    assert got.max_field == want.max_field == NF + 1
    sub, jsub = got.slice(5, 40), want.slice(5, 40)
    np.testing.assert_array_equal(sub.fields, jsub.fields)
    # a block without fields joins with zeros, as the JAX container does
    bare = RowBlock(ours[1].offsets, ours[1].labels, ours[1].indices,
                    ours[1].values)
    mixed = concat_blocks([ours[0], bare])
    n0 = int(ours[0].offsets[-1] - ours[0].offsets[0])
    assert (mixed.fields[n0:] == 0).all()


PACKS = {
    "flat": (pack_flat, jpacking.pack_flat, 256),
    "flat_truncated": (pack_flat, jpacking.pack_flat, 100),
    "rowmajor": (pack_rowmajor, jpacking.pack_rowmajor, 6),
    "ragged": (pack_ragged, jpacking.pack_ragged, 400),
}


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_field_packs_match_jax(pack):
    ours, theirs = PACKS[pack][:2]
    cap = PACKS[pack][2]
    (blk,), (jblk,) = _blocks(libfm_text(ROWS - 3, seed=8, messy=False), 1)
    got = ours(blk, ROWS, cap, want_fields=True)
    want = theirs(jblk, ROWS, cap, want_fields=True)
    assert list(got) == list(want)
    live = int(want["nnz_used"]) if "nnz_used" in want else None
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if live is not None and k in ("ids", "vals", "segments", "fields"):
            a, b = a[:live], b[:live]
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got["fields"].dtype == np.int32
    # a source without fields raises the JAX message
    bare = RowBlock(blk.offsets, blk.labels, blk.indices, blk.values)
    with pytest.raises(ValueError, match="has no fields"):
        ours(bare, ROWS, cap, want_fields=True)


# -- create_parser and the loaders ----------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("formats")
    libfm, csv = d / "d.libfm", d / "d.csv"
    libfm.write_bytes(libfm_text(200, seed=9))
    csv.write_bytes(csv_text(150, seed=10, delim=b";"))
    return str(libfm), str(csv)


CSV_ARGS = "?label_column=0&delimiter=;"


def _rows(parser):
    out = []
    for b in parser:
        o = np.asarray(b.offsets)
        for r in range(len(o) - 1):
            s = slice(int(o[r]), int(o[r + 1]))
            f = [] if b.fields is None else np.asarray(b.fields)[s].tolist()
            out.append((float(b.labels[r]), np.asarray(b.indices)[s].tolist(),
                        np.asarray(b.values)[s].tolist(), f))
    return out


@pytest.mark.parametrize("fmt", ["libfm", "csv"])
@pytest.mark.parametrize("num_parts", [1, 3])
def test_create_parser_parts_match_jax(lib, files, fmt, num_parts):
    path = files[0] if fmt == "libfm" else files[1] + CSV_ARGS
    got = {"native": [], "python": []}
    want = []
    for part in range(num_parts):
        for engine, rows in got.items():
            p = create_parser(path, part, num_parts, fmt, engine=engine)
            rows += _rows(p)
            p.close()
        jp = jcreate_parser(f"file://{path}", part, num_parts, fmt)
        want += _rows(c.get_block() for c in jp)
        jp.close()
    assert got["native"] == got["python"] == want and len(want) > 100


def test_create_parser_reads_the_uri_arguments(files):
    libfm, csv = files
    p = create_parser(f"file://{libfm}?format=libfm", parser_type="auto",
                      threaded=False)
    assert p.text_format == "libfm"
    p.close()
    p = create_parser(csv + CSV_ARGS + "&format=csv", parser_type="auto")
    assert (p.text_format, p.csv_label_col, p.csv_delim) == ("csv", 0, ";")
    first = p.parse_next()
    assert set(np.unique(first.labels)) <= {0.0, 1.0}
    p.close()
    p = create_parser(libfm, threaded=False)           # libsvm by default
    assert p.text_format == "libsvm" and p.csv_label_col == -1
    p.close()
    with pytest.raises(DMLCError, match="unknown parser format 'tsv'"):
        create_parser(f"{libfm}?format=tsv", parser_type="auto")


def _np(v):
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_batches(got, want):
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        live = int(w["nnz_used"]) if "nnz_used" in w else None
        for k in w:
            a, b = g[k], w[k]
            assert a.dtype == b.dtype and a.shape == b.shape, (i, k)
            if live is not None and k in ("ids", "vals", "segments",
                                          "fields"):
                a, b = a[:live], b[:live]
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i} {k}")


# (port loader knobs, JAX loader knobs, format, parser knobs)
LOADERS = {
    "fields_flat": (dict(fields=True), dict(fields=True), "libfm", {}),
    "fields_rowmajor": (dict(fields=True, layout="rowmajor"),
                        dict(fields=True, layout="rowmajor"), "libfm", {}),
    "fields_ragged": (dict(fields=True, ragged=True),
                      dict(fields=True, ragged=True), "libfm", {}),
    "libfm_streampack": (dict(), dict(), "libfm",
                         dict(threaded=False, nthreads=1)),
    "csv_streampack": (dict(), dict(), "csv",
                       dict(threaded=False, nthreads=1)),
    "csv_native": (dict(), dict(), "csv", {}),
}


@pytest.mark.parametrize("path", sorted(LOADERS))
def test_loader_matches_jax(lib, files, path):
    ours, theirs, fmt, parser = LOADERS[path]
    src = files[0] if fmt == "libfm" else files[1] + CSV_ARGS
    cap = 6 if ours.get("layout") == "rowmajor" else 160
    with DeviceLoader(create_parser(src, parser_type=fmt, **parser), ROWS,
                      cap, device="cpu", **ours) as ld:
        stream = "streampack" in path
        assert ld._use_streampack() == stream
        assert ld._use_native_pack() == (not ours)
        got = [{k: _np(v) for k, v in b.items()} for b in ld]
    jl = jdl.DeviceLoader(jcreate_parser(f"file://{src}", 0, 1, fmt,
                                         **parser),
                          ROWS, cap, prefetch=2, put_threads=1,
                          wire_compact=False, cache=None, **theirs)
    try:
        assert jl._use_streampack() == stream
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jl]
    finally:
        jl.close()
    _assert_batches(got, want)
    if ours.get("fields"):
        assert all(b["fields"].dtype == np.int32 for b in got)


def test_loader_fields_refusals(files):
    with pytest.raises(DMLCError, match="no fields"):
        DeviceLoader(create_parser(files[0], parser_type="libfm"), ROWS, 64,
                     device="cpu", fields=True, emit="host")
    # a libsvm source has no fields: the pack raises the JAX message, and
    # the loader hands it to its consumer
    with DeviceLoader(create_parser(files[0], parser_type="libsvm"), ROWS,
                      64, device="cpu", fields=True) as ld:
        with pytest.raises(DMLCError, match="RowBlock has no fields"):
            ld.next_batch()
