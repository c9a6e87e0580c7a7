"""The port's I/O layer (``dmlc_core_tpu_torch.io`` and the parser over
it), held against the JAX package on the CPU.

* The JAX package's own tests of the InputSplit engine, the recordio
  codec and the indexed split run again on the port's modules (their
  module globals swapped for the port's names).
* ``create_parser`` with no ``parser_type`` over every URI form the JAX
  package reads from local disk (a file with ``?format=`` for csv,
  libfm and libsvm; a directory with an empty file in it; a ``;`` list;
  a glob; a ``#cachefile``), for ``num_parts`` 1, 2, 3 and 7, on the
  native and python engines: the rows of each part ``array_equal`` to
  the JAX parser's.
* recordio frames written by each package read by the other, byte for
  byte; the indexed and the shuffled splits' record order for one seed.
* What is refused: a scheme no filesystem registered (the remote ones
  are held in ``test_torch_remote_filesys.py``), a ``#cachefile`` with
  ``shuffle``, a glob that matches nothing.
"""

import io as _io
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_indexed_recordio as jax_indexed_tests  # noqa: E402
import test_input_split as jax_split_tests  # noqa: E402
import test_recordio as jax_recordio_tests  # noqa: E402
from dmlc_core_tpu import io as jio  # noqa: E402
from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu_torch import io as pio  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.io.single_file_split import \
    SingleFileSplit  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

# fixtures of the replayed JAX tests
from test_indexed_recordio import indexed  # noqa: E402,F401
from test_input_split import text_corpus  # noqa: E402,F401
from test_recordio import corpus  # noqa: E402,F401


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()
    return native


# -- the JAX package's tests, on the port's modules ---------------------------

_PORT_NAMES = {name: getattr(pio, name) for name in pio.__all__}
_PORT_NAMES["DMLCError"] = DMLCError
_PORT_NAMES["SingleFileSplit"] = SingleFileSplit


def _swap(monkeypatch, module):
    for name, value in _PORT_NAMES.items():
        if hasattr(module, name):
            monkeypatch.setattr(module, name, value)


def _cases(module):
    return sorted(n for n in dir(module) if n.startswith("test_"))


@pytest.mark.parametrize("case", _cases(jax_split_tests))
def test_input_split_passes_the_jax_cases(case, monkeypatch, request):
    _swap(monkeypatch, jax_split_tests)
    fn = getattr(jax_split_tests, case)
    fn(**{a: request.getfixturevalue(a)
          for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


@pytest.mark.parametrize("case", _cases(jax_recordio_tests))
def test_recordio_passes_the_jax_cases(case, monkeypatch, request):
    _swap(monkeypatch, jax_recordio_tests)
    fn = getattr(jax_recordio_tests, case)
    fn(**{a: request.getfixturevalue(a)
          for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


@pytest.mark.parametrize("case", _cases(jax_indexed_tests))
def test_indexed_recordio_passes_the_jax_cases(case, monkeypatch, request):
    _swap(monkeypatch, jax_indexed_tests)
    fn = getattr(jax_indexed_tests, case)
    fn(**{a: request.getfixturevalue(a)
          for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


# -- create_parser over every local URI form ----------------------------------

def _libsvm_lines(rng, n, start=0):
    out = []
    for i in range(n):
        ids = np.sort(rng.choice(5000, int(rng.integers(1, 9)), replace=False))
        head = f"{(start + i) % 2}" + (":0.5" if i % 11 == 3 else "")
        out.append(head + " " + " ".join(f"{j}:{rng.random():.4f}"
                                         for j in ids))
    return out


@pytest.fixture(scope="module")
def forms(tmp_path_factory):
    """The files of the URI forms: ``t.csv`` (label in column 0),
    ``t.libfm``, ``d/`` holding ``a.libsvm``, ``b.libsvm`` (CRLF, no
    final newline), ``sub/c.libsvm`` and an empty file, and ``all.libsvm``:
    the three in ``expand_uris``' order."""
    root = tmp_path_factory.mktemp("forms")
    rng = np.random.default_rng(31)
    a, b, c = (_libsvm_lines(rng, n, s) for n, s in ((90, 0), (70, 90),
                                                     (50, 160)))
    d = root / "d"
    (d / "sub").mkdir(parents=True)
    (d / "a.libsvm").write_bytes(("\n".join(a) + "\n").encode())
    (d / "b.libsvm").write_bytes("\r\n".join(b).encode())
    (d / "sub" / "c.libsvm").write_bytes(("\n".join(c) + "\n").encode())
    (d / "empty.libsvm").write_bytes(b"")
    (root / "all.libsvm").write_bytes(
        ("\n".join(a) + "\n" + "\r\n".join(b) + "\n" + "\n".join(c)
         + "\n").encode())
    csv_rows = [",".join([str(i % 2)] + [f"{rng.random():.3f}"
                                         for _ in range(5)])
                for i in range(120)]
    (root / "t.csv").write_bytes(("\n".join(csv_rows) + "\n").encode())
    fm_rows = [f"{i % 2} " + " ".join(
        f"{j % 4}:{j}:{rng.random():.3f}"
        for j in np.sort(rng.choice(300, 4, replace=False)))
        for i in range(110)]
    (root / "t.libfm").write_bytes(("\n".join(fm_rows) + "\n").encode())
    return root


def _uris(root, key, cache_dir):
    d = root / "d"
    return {
        "csv": f"{root}/t.csv?format=csv&label_column=0",
        "libfm": f"file://{root}/t.libfm?format=libfm",
        "libsvm": f"{d}/a.libsvm?format=libsvm",
        "dir": f"{d}",
        "list": f"{d}/a.libsvm;{d}/b.libsvm;{d}/sub/c.libsvm",
        "glob": f"{d}/*.libsvm;{d}/sub/*.libsvm",
        "cache": f"{d}/a.libsvm#{cache_dir}/cache-{key}",
    }[key]


def _rows(blocks):
    out = []
    for b in blocks:
        o = np.asarray(b.offsets)
        for r in range(len(o) - 1):
            s = slice(int(o[r]), int(o[r + 1]))
            out.append((float(b.labels[r]),
                        1.0 if b.weights is None else float(b.weights[r]),
                        np.asarray(b.indices)[s].tolist(),
                        np.asarray(b.values)[s].tolist(),
                        [] if b.fields is None
                        else np.asarray(b.fields)[s].tolist()))
    return out


FORMS = ("csv", "libfm", "libsvm", "dir", "list", "glob", "cache")


@pytest.mark.parametrize("num_parts", [1, 2, 3, 7])
@pytest.mark.parametrize("form", FORMS)
def test_create_parser_reads_every_uri_form_like_jax(lib, forms, tmp_path,
                                                     form, num_parts):
    """No ``parser_type``: the format comes from ``?format=`` (libsvm
    without one), as in the JAX package; each part's rows equal the JAX
    parser's, on both engines, and the parts cover the input once."""
    os.makedirs(tmp_path / "jax")
    whole = []
    for part in range(num_parts):
        jp = jcreate_parser(_uris(forms, form, tmp_path / "jax"), part,
                            num_parts)
        want = _rows(c.get_block() for c in jp)
        jp.close()
        for engine in ("native", "python"):
            os.makedirs(tmp_path / engine, exist_ok=True)
            p = create_parser(_uris(forms, form, tmp_path / engine), part,
                              num_parts, engine=engine)
            p.chunk_bytes = 1024             # several chunks a part
            got = _rows(p)
            p.close()
            assert got == want, (engine, part)
        whole += want
    if form == "csv":
        assert len(whole) == 120 and {r[0] for r in whole} == {0.0, 1.0}
    elif form in ("dir", "list", "glob"):
        jp = jcreate_parser(f"{forms}/all.libsvm")
        assert whole == _rows(c.get_block() for c in jp) and len(whole) == 210
        jp.close()


def test_create_parser_defaults_to_auto_and_reads_csv():
    """The repair of the libsvm default: a csv URI with ``?format=csv``
    and no ``parser_type`` parses as csv (under the old default every
    line failed its label and was skipped without a word)."""
    import inspect
    assert inspect.signature(create_parser).parameters[
        "parser_type"].default == "auto"


def test_csv_uri_reads_its_rows(lib, tmp_path):
    path = tmp_path / "t.csv"
    path.write_bytes(b"1,0.5,2\n0,1.5,3\n")
    uri = f"{path}?format=csv&label_column=0"
    with create_parser(uri) as p:
        blocks = list(p)
    assert sum(b.size for b in blocks) == 2
    np.testing.assert_array_equal(np.concatenate([b.labels for b in blocks]),
                                  [1, 0])
    jp = jcreate_parser(uri)
    assert _rows(blocks) == _rows(c.get_block() for c in jp)
    jp.close()


def test_cachefile_replays_its_raw_chunks(lib, forms, tmp_path):
    """``#cachefile`` with two parts: each part's raw-chunk log lands at
    its ``.split2.partK`` name and the second epoch replays it."""
    uri = f"{forms}/d#{tmp_path}/c"
    for part in range(2):
        p = create_parser(uri, part, 2, threaded=False)
        first = _rows(p)
        p.before_first()
        assert _rows(p) == first and first
        p.close()
        assert os.path.exists(f"{tmp_path}/c.split2.part{part}.done")


def test_split_rejects_what_is_not_ported(tmp_path):
    for bad in ("ftp://host/x", "gopher://h/x", "nfs://server/x"):
        scheme = bad.split(":", 1)[0]
        with pytest.raises(DMLCError,
                           match=f"unknown filesystem scheme '{scheme}'"):
            pio.create_input_split(bad)
        with pytest.raises(DMLCError, match="registered: .*'s3'"):
            create_parser(bad)
    (tmp_path / "a.txt").write_bytes(b"x\n")
    with pytest.raises(DMLCError, match="shuffle"):
        pio.create_input_split(f"{tmp_path}/a.txt#{tmp_path}/c",
                               shuffle=True)
    assert not os.path.exists(f"{tmp_path}/c")      # refused before opening
    with pytest.raises(DMLCError, match="matched no files"):
        pio.create_input_split(f"{tmp_path}/*.none")
    (tmp_path / "e").mkdir()
    (tmp_path / "e" / "z.txt").write_bytes(b"")
    with pytest.raises(DMLCError, match="no non-empty files"):
        pio.create_input_split(str(tmp_path / "e"))
    with pytest.raises(DMLCError, match="no such file"):
        pio.create_input_split(str(tmp_path / "missing"))


def test_expand_uris_matches_jax(forms):
    d = forms / "d"
    for uri in (str(d), f"{d}/*.libsvm", f"{d}/a.libsvm;{d}/sub",
                f"file://{d}/b.libsvm"):
        got = [(f.path, f.size, f.type) for f in pio.expand_uris(uri)]
        want = [(f.path, f.size, f.type) for f in jio.expand_uris(uri)]
        assert got == want and got


def test_mapped_chunks_survive_close_while_held(forms):
    """A chunk is a view of the map: closing the split while a parser
    still holds one must not raise, and the view stays readable."""
    split = pio.create_input_split(f"{forms}/d/a.libsvm", threaded=False)
    chunk = split.next_chunk()
    assert isinstance(chunk, memoryview)
    split.close()
    assert bytes(chunk[:2]) == open(f"{forms}/d/a.libsvm", "rb").read(2)


def test_threaded_split_starts_its_thread_at_first_use(forms):
    import threading
    before = threading.active_count()
    split = pio.create_input_split(f"{forms}/d/a.libsvm")
    assert threading.active_count() == before
    split.hint_chunk_size(1024)
    n = 0
    while split.next_chunk() is not None:
        n += 1
    split.close()
    assert n > 1


# -- recordio across the packages ----------------------------------------------

def _payloads(seed, n=300):
    rng = np.random.default_rng(seed)
    magic = np.uint32(pio.KMAGIC).tobytes()
    out = []
    for _ in range(n):
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 96)),
                                  dtype=np.uint8))
        if len(data) >= 8 and rng.random() < 0.3:      # aligned magic words
            k = int(rng.integers(0, len(data) // 4 - 1)) * 4
            data = data[:k] + magic + data[k + 4:]
        out.append(data)
    return out


def _write(writer_cls, payloads):
    buf = _io.BytesIO()
    w = writer_cls(buf)
    for p in payloads:
        w.write_record(p)
    return buf.getvalue(), w.except_counter


def test_recordio_frames_are_byte_identical_and_cross_read():
    recs = _payloads(5)
    ours, our_escapes = _write(pio.RecordIOWriter, recs)
    theirs, their_escapes = _write(jio.RecordIOWriter, recs)
    assert ours == theirs and our_escapes == their_escapes > 0
    assert list(pio.RecordIOReader(_io.BytesIO(theirs))) == recs
    assert list(jio.RecordIOReader(_io.BytesIO(ours))) == recs
    for k in range(3):
        assert (list(pio.RecordIOChunkReader(theirs, k, 3))
                == list(jio.RecordIOChunkReader(ours, k, 3)))
    for cflag, length in ((0, 0), (1, 17), (3, (1 << 29) - 1)):
        lrec = pio.encode_lrec(cflag, length)
        assert lrec == jio.encode_lrec(cflag, length)
        assert pio.decode_lrec(lrec) == jio.decode_lrec(lrec) == (cflag,
                                                                   length)


@pytest.mark.parametrize("num_parts", [1, 3, 7])
def test_recordio_split_parts_match_jax(tmp_path, num_parts):
    recs = _payloads(6)
    for i, (a, b) in enumerate(((0, 120), (120, 300))):
        (tmp_path / f"r{i}.rec").write_bytes(_write(jio.RecordIOWriter,
                                                    recs[a:b])[0])
    uri = f"{tmp_path}/r0.rec;{tmp_path}/r1.rec"
    whole = []
    for part in range(num_parts):
        with pio.create_input_split(uri, part, num_parts, "recordio") as s:
            got = list(s)
        with jio.create_input_split(uri, part, num_parts, "recordio") as s:
            want = list(s)
        assert got == want
        whole += got
    assert whole == recs


def test_indexed_split_shuffles_like_jax(tmp_path):
    recs = _payloads(7, n=97)
    rec = tmp_path / "d.rec"
    rec.write_bytes(_write(pio.RecordIOWriter, recs)[0])
    n = pio.write_recordio_index(str(rec), str(tmp_path / "p.idx"))
    jio.write_recordio_index(str(rec), str(tmp_path / "j.idx"))
    assert n == 97
    assert (tmp_path / "p.idx").read_bytes() == (tmp_path / "j.idx"
                                                 ).read_bytes()
    for part in range(2):
        ours = pio.create_input_split(
            f"{rec}?index={tmp_path}/p.idx", part, 2, "indexed_recordio",
            shuffle=True, shuffle_seed=11)
        theirs = jio.create_input_split(
            str(rec), part, 2, "indexed_recordio", shuffle=True,
            shuffle_seed=11, index_uri=str(tmp_path / "j.idx"))
        for _ in range(2):                        # a new order each epoch
            assert list(ours) == list(theirs)
            ours.before_first()
            theirs.before_first()
        ours.close()
        theirs.close()


def test_shuffled_text_split_order_matches_jax(text_corpus):  # noqa: F811
    path, lines = text_corpus
    for part in range(2):
        ours = pio.create_input_split(path, part, 2, shuffle=True,
                                      num_shuffle_parts=5, shuffle_seed=3)
        theirs = jio.create_input_split(path, part, 2, shuffle=True,
                                        num_shuffle_parts=5, shuffle_seed=3)
        epochs = []
        for _ in range(3):
            got, want = list(ours), list(theirs)
            assert got == want
            epochs.append(got)
            ours.before_first()
            theirs.before_first()
        assert epochs[0] != epochs[1] and sorted(epochs[0]) == sorted(
            epochs[1])
        ours.close()
        theirs.close()


def test_uri_and_spec_match_jax():
    for raw in ("s3://bucket/a/b", "file:///x/y", "rel/path", "hdfs://nn",
                "x.libsvm?format=csv&label_column=0#cache",
                "a?k#c", "d/*.libfm?format=libfm"):
        for parts in ((0, 1), (2, 3)):
            ours, theirs = pio.URISpec(raw, *parts), jio.URISpec(raw, *parts)
            assert (ours.uri, ours.args, ours.cache_file) == (
                theirs.uri, theirs.args, theirs.cache_file)
        u, v = pio.URI(raw), jio.URI(raw)
        assert (u.protocol, u.host, u.name, u.scheme, u.str_nohost()) == (
            v.protocol, v.host, v.name, v.scheme, v.str_nohost())
