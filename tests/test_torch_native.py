"""The port's native library (its own copy of the JAX package's
``dmlc_native.cpp``, built with g++) and its ``ThreadedIter``, held
against the JAX package on the CPU.

Seeded libsvm text with the hard cases (label:weight heads, bad labels,
value-less tokens, bad tokens mid-row, blank lines, CRLF endings, ids
at and past 2^31) goes through the port's native parser, the JAX native
parser and the JAX fallback parser: every array is ``array_equal``.  The
port's ``Packer`` and ``SpPacker`` emit the same bytes and metas as the
JAX ones.  The JAX package's ``ThreadedIter`` tests run on the port's
class.  Every test skips only where there is no g++.
"""

import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_threaded_iter as jax_threaded_iter_tests  # noqa: E402
from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data.py_parsers import \
    parse_libsvm as jfallback_parse  # noqa: E402
from dmlc_core_tpu.data.row_block import RowBlock as JRowBlock  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import RowBlock, create_parser  # noqa: E402
from dmlc_core_tpu_torch.data import parse_libsvm as py_parse  # noqa: E402
from dmlc_core_tpu_torch.data import parser as parser_mod  # noqa: E402
from dmlc_core_tpu_torch.native import build as native_build  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import (DMLCError,  # noqa: E402
                                               IdOverflowError)
from dmlc_core_tpu_torch.utils.threaded_iter import \
    ThreadedIter  # noqa: E402

ARRAYS = ("offsets", "labels", "weights", "indices", "values")


@pytest.fixture(scope="session")
def lib():
    """The port's library, built once per session (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available()
    return native


def messy_text(rows: int, seed: int, crlf: bool = False,
               wide_ids: bool = False) -> bytes:
    """Seeded libsvm text with every case the parsers must agree on."""
    rng = np.random.default_rng(seed)
    eol = b"\r\n" if crlf else b"\n"
    top = 1 << 33 if wide_ids else 1_000_000
    lines = []
    for i in range(rows):
        n = int(rng.integers(1, 30))
        idx = np.sort(rng.choice(top, size=n, replace=False))
        toks = [b"%d" % j if rng.random() < 0.2 else
                b"%d:%.5f" % (j, rng.random()) for j in idx.tolist()]
        head = (b"%d" % (i & 1) if i % 7 else
                b"%d:%.3f" % (i & 1, rng.random()))
        lines.append(head + b" " + b" ".join(toks))
        if i % 97 == 5:
            lines.append(b"")                        # blank line
        if i % 101 == 7:
            lines.append(b"bad 1:2 3:4")             # bad label
        if i % 103 == 9:
            lines.append(b"1 5:0.5 x:2 9:1")         # bad token mid-row
        if wide_ids and i % 50 == 3:
            lines.append(b"0 %d:1 %d:2" % (2 ** 31 - 1, 2 ** 31))
    return eol.join(lines) + eol


TEXTS = {
    "plain": dict(rows=40, seed=1),
    "big_lf": dict(rows=3000, seed=2),            # > 64 KiB: threads split
    "big_crlf": dict(rows=3000, seed=3, crlf=True),
    "wide_ids": dict(rows=3000, seed=4, wide_ids=True),
}


@pytest.mark.parametrize("nthreads", [1, 4])
@pytest.mark.parametrize("text", sorted(TEXTS))
def test_parse_libsvm_equals_jax_native_and_fallback(lib, text, nthreads):
    data = messy_text(**TEXTS[text])
    got = lib.parse_libsvm(data, nthreads)
    jn = jnative.parse_libsvm(data, nthreads)
    jf = jfallback_parse(data)
    for want in (jn, jf):
        for k in ARRAYS:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["bad_lines"] == want["bad_lines"]
        assert got["max_index"] == want["max_index"]
    assert got["bad_lines"] > 0 or text == "plain"
    py = py_parse(data)
    for k in ARRAYS:
        np.testing.assert_array_equal(got[k], py[k], err_msg=k)


def _blocks(data: bytes, pieces: int):
    """The same rows as port and JAX RowBlocks, cut into ``pieces``."""
    d = py_parse(data)
    ours = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                    d["weights"])
    theirs = JRowBlock(offsets=d["offsets"], labels=d["labels"],
                       indices=d["indices"], values=d["values"],
                       weights=d["weights"])
    cuts = np.linspace(0, ours.size, pieces + 1).astype(int)
    return ([ours.slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])],
            [theirs.slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])])


def _used(buf, rows, meta):
    return np.asarray(buf)[:native.fused_words(rows, int(meta) & 0xFFFFFFFF)]


def _drain(packer, feeds, rows):
    out = []
    for f in feeds:
        out += [(_used(b, rows, m).copy(), m) for b, m in f(packer)]
    tail = packer.flush()
    if tail is not None:
        out.append((_used(tail[0], rows, tail[1]).copy(), tail[1]))
    return out


@pytest.mark.parametrize("rows,cap,id_mod,quantum", [
    (64, 4096, 0, 0),
    (128, 1024, 0, 0),          # batches close early on nnz pressure
    (50, 2048, 997, 100),
    (1, 64, 0, 0),
])
def test_packer_bytes_equal_jax(lib, rows, cap, id_mod, quantum):
    ours, theirs = _blocks(messy_text(700, seed=5), pieces=7)
    p = lib.Packer(rows, cap, id_mod=id_mod, quantum=quantum)
    q = jnative.Packer(rows, cap, id_mod=id_mod, quantum=quantum)
    got = _drain(p, [lambda x, b=b: x.feed(b) for b in ours], rows)
    want = _drain(q, [lambda x, b=b: x.feed(b) for b in theirs], rows)
    assert len(got) == len(want) > 1
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm == wm
        assert gb.tobytes() == wb.tobytes()
    assert p.stats() == q.stats()
    assert p.words_max == q.words_max and p.quantum == q.quantum
    p.close()
    q.close()


@pytest.mark.parametrize("rows,cap,id_mod,chunk", [
    (64, 4096, 0, 5000),
    (128, 1024, 0, 20000),
    (50, 2048, 997, 3000),
])
def test_sppacker_bytes_equal_jax(lib, rows, cap, id_mod, chunk):
    data = messy_text(900, seed=6)
    cuts, pos = [], 0
    while pos < len(data):                  # chunks of whole lines
        end = data.rfind(b"\n", pos, pos + chunk) + 1
        end = len(data) if end <= pos or pos + chunk >= len(data) else end
        cuts.append(data[pos:end])
        pos = end
    p = lib.SpPacker(rows, cap, id_mod=id_mod)
    q = jnative.SpPacker(rows, cap, id_mod=id_mod)
    got = _drain(p, [lambda x, c=c: x.feed_text(c) for c in cuts], rows)
    want = _drain(q, [lambda x, c=c: x.feed_text(c) for c in cuts], rows)
    assert len(got) == len(want) > 1
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm == wm and gb.tobytes() == wb.tobytes()
    assert p.stats() == q.stats()
    p.close()
    q.close()


def test_wide_ids_raise_without_id_mod(lib):
    data = messy_text(200, seed=7, wide_ids=True)
    ours, _ = _blocks(data, pieces=1)
    with pytest.raises(IdOverflowError, match="id_mod"):
        list(lib.Packer(64, 4096).feed(ours[0]))
    with pytest.raises(IdOverflowError, match="id_mod"):
        list(lib.SpPacker(64, 4096).feed_text(data))
    p = lib.Packer(64, 4096, id_mod=1 << 20)
    assert len(list(p.feed(ours[0]))) >= 1
    p.close()


def test_compact_wire_and_other_formats_are_refused(lib):
    with pytest.raises(DMLCError, match="not ported"):
        lib.Packer(8, 64, compact=True)
    with pytest.raises(DMLCError, match="not ported"):
        lib.SpPacker(8, 64, compact=True)
    with pytest.raises(DMLCError, match="not ported"):
        lib.SpPacker(8, 64, fmt="csv")
    assert lib.fused_words(4, 16) == jnative.fused_words(4, 16) == 45


def test_build_is_fresh_and_published_atomically(lib):
    assert native_build.is_fresh()
    ok, report = native_build.build_native()
    assert ok and report == "fresh"
    assert native_build.OUT.startswith(native_build._BUILD)
    # a different flag set would give a different hash: rebuild
    assert (native_build._digest(native_build.FLAGS)
            != native_build._digest(native_build.FLAGS_CONSERVATIVE))


def _no_compiler(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    monkeypatch.setattr(native_build, "is_fresh", lambda: False)


def test_engine_choice_without_a_compiler(lib, tmp_path, monkeypatch):
    path = tmp_path / "d.libsvm"
    path.write_bytes(messy_text(30, seed=8))
    _no_compiler(monkeypatch)
    assert not native.available()
    with pytest.raises(DMLCError, match="g\\+\\+ not found"):
        create_parser(str(path), engine="native")
    p = create_parser(str(path), engine="auto", threaded=False)
    assert p.engine == "python" and p.parse_fn is parser_mod.parse_libsvm
    p.close()


def test_a_failed_build_raises_where_gxx_exists(lib, tmp_path, monkeypatch):
    path = tmp_path / "d.libsvm"
    path.write_bytes(messy_text(30, seed=9))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "is_fresh", lambda: False)
    monkeypatch.setattr(native_build, "build_native",
                        lambda force=False: (False, "g++: planted failure"))
    for engine in ("auto", "native"):
        with pytest.raises(DMLCError, match="planted failure"):
            create_parser(str(path), engine=engine)
    p = create_parser(str(path), engine="python", threaded=False)
    assert p.engine == "python"
    p.close()


@pytest.mark.parametrize("engine", ["native", "python"])
def test_create_parser_engines_give_the_same_rows(lib, tmp_path, engine):
    data = messy_text(500, seed=10)
    path = tmp_path / "d.libsvm"
    path.write_bytes(data)
    want = py_parse(data)
    with create_parser(str(path), engine=engine) as p:
        p.chunk_bytes = 4096                 # several chunks, threaded
        assert p.engine == engine
        blocks = list(p)
    assert len(blocks) > 1
    got_idx = np.concatenate([b.indices for b in blocks])
    got_lab = np.concatenate([b.labels for b in blocks])
    np.testing.assert_array_equal(got_idx, want["indices"])
    np.testing.assert_array_equal(got_lab, want["labels"])
    with pytest.raises(DMLCError, match="engine"):
        create_parser(str(path), engine="fast")


JAX_CASES = sorted(n for n in dir(jax_threaded_iter_tests)
                   if n.startswith("test_"))


@pytest.mark.parametrize("case", JAX_CASES)
def test_threaded_iter_passes_the_jax_cases(case, monkeypatch):
    """Each case of the JAX package's ThreadedIter tests, on the port's
    class and error type."""
    monkeypatch.setattr(jax_threaded_iter_tests, "ThreadedIter",
                        ThreadedIter)
    monkeypatch.setattr(jax_threaded_iter_tests, "DMLCError", DMLCError)
    getattr(jax_threaded_iter_tests, case)()


def test_threaded_iter_delivers_queued_items_before_the_error():
    state = {"i": 0}

    def next_fn(_cell):
        state["i"] += 1
        if state["i"] == 4:
            raise ValueError("fourth item")
        return state["i"]

    it = ThreadedIter(max_capacity=8)
    it.init(next_fn)
    got = [it.next() for _ in range(3)]
    with pytest.raises(DMLCError, match="fourth item"):
        it.next()
    assert got == [1, 2, 3]
    it.destroy()
    assert it._thread is None
