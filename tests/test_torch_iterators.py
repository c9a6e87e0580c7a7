"""The port's serializer, ``RowBlockContainer`` and row-block iterators,
held against the JAX package on the CPU.

* The JAX package's tests of the serializer, ``RowBlock`` /
  ``RowBlockContainer`` and the iterators run again on the port's
  modules (their module globals swapped for the port's names).
* Serializer streams and ``RowBlockContainer.save`` streams are the JAX
  package's byte for byte, and each package loads the other's.
* ``DiskRowIter``: the cache built by either package is replayed by the
  other, with blocks ``array_equal`` to the source's rows; the
  ``#cachefile`` iterator feeds the port's ``DeviceLoader``, whose second
  epoch comes from the cache with the source gone.
"""

import io as _io
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_iterators as jax_iter_tests  # noqa: E402
import test_row_block as jax_block_tests  # noqa: E402
import test_serializer as jax_ser_tests  # noqa: E402
from dmlc_core_tpu import data as jdata  # noqa: E402
from dmlc_core_tpu.utils import memory_io as jmemory_io  # noqa: E402
from dmlc_core_tpu.utils import serializer as jser  # noqa: E402
from dmlc_core_tpu_torch import data as pdata  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.utils import memory_io  # noqa: E402
from dmlc_core_tpu_torch.utils import serializer as ser  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

from test_iterators import libsvm_file  # noqa: E402,F401

_PORT_NAMES = {"ser": ser, "DMLCError": DMLCError,
               **{n: getattr(pdata, n) for n in pdata.__all__}}


def _run_case(module, case, monkeypatch, request):
    for name, value in _PORT_NAMES.items():
        if hasattr(module, name):
            monkeypatch.setattr(module, name, value)
    fn = getattr(module, case)
    params = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":        # every case of the mark
            names = [n.strip() for n in mark.args[0].split(",")]
            params = [dict(p, **dict(zip(names, v if len(names) > 1
                                          else (v,))))
                      for p in params for v in mark.args[1]]
    for given in params:
        fn(**given, **{a: request.getfixturevalue(a)
                       for a in fn.__code__.co_varnames[
                           :fn.__code__.co_argcount] if a not in given})


def _cases(module, skip=()):
    return sorted(n for n in dir(module)
                  if n.startswith("test_") and n not in skip)


@pytest.mark.parametrize("case", _cases(jax_ser_tests))
def test_serializer_passes_the_jax_cases(case, monkeypatch, request):
    _run_case(jax_ser_tests, case, monkeypatch, request)


@pytest.mark.parametrize("case", _cases(jax_block_tests))
def test_row_block_passes_the_jax_cases(case, monkeypatch, request):
    _run_case(jax_block_tests, case, monkeypatch, request)


# the last case drives the JAX DeviceLoader: its port counterpart is
# test_disk_cache_iter_feeds_the_port_loader below
@pytest.mark.parametrize("case", _cases(
    jax_iter_tests, skip=("test_disk_cache_iter_feeds_device_loader",)))
def test_iterators_pass_the_jax_cases(case, monkeypatch, request):
    _run_case(jax_iter_tests, case, monkeypatch, request)


# -- streams across the packages ------------------------------------------------

def _objects():
    rng = np.random.default_rng(3)
    return [None, True, -7, 2 ** 70, -(2 ** 65), 3.25, "naïve", b"\x00\xff",
            [1, (2, 3.5), {"k": [None]}], {"b", "a"},
            {"arr": rng.standard_normal((3, 4)).astype(np.float32),
             "ids": rng.integers(0, 1 << 40, 9, dtype=np.uint64),
             "empty": np.zeros((0, 2), np.int16),
             "big": np.arange(5, dtype=">i4")}]


@pytest.mark.parametrize("index", range(len(_objects())))
def test_serializer_streams_are_the_jax_bytes(index):
    obj = _objects()[index]
    ours, theirs = _io.BytesIO(), _io.BytesIO()
    ser.save(ours, obj)
    jser.save(theirs, obj)
    assert ours.getvalue() == theirs.getvalue()
    back = ser.load(_io.BytesIO(theirs.getvalue()))
    again = jser.load(_io.BytesIO(ours.getvalue()))
    buf = _io.BytesIO()
    ser.save(buf, back)
    assert buf.getvalue() == ours.getvalue()
    buf = _io.BytesIO()
    jser.save(buf, again)
    assert buf.getvalue() == ours.getvalue()


def test_scalar_helpers_and_memory_streams_match_jax():
    for mod, mio in ((ser, memory_io), (jser, jmemory_io)):
        s = mio.MemoryStringStream()
        mod.write_uint32(s, 7)
        mod.write_uint64(s, 1 << 40)
        mod.write_int64(s, -3)
        mod.write_float64(s, 0.5)
        mod.write_string(s, "x")
        mod.write_bytes(s, b"yz")
        if mod is ser:
            ours = s.value
        else:
            assert s.value == ours
    fixed = memory_io.MemoryFixedSizeStream(bytearray(ours))
    assert (ser.read_uint32(fixed), ser.read_uint64(fixed),
            ser.read_int64(fixed), ser.read_float64(fixed),
            ser.read_string(fixed), ser.read_bytes(fixed, 2)) == (
        7, 1 << 40, -3, 0.5, "x", b"yz")
    full = memory_io.MemoryFixedSizeStream(bytearray(4))
    with pytest.raises(DMLCError):
        full.write(b"12345")


def _container(mod, seed, fields: bool, weights: bool):
    rng = np.random.default_rng(seed)
    c = mod.RowBlockContainer()
    for r in range(40):
        k = int(rng.integers(0, 6))
        c.push_row(float(r % 3), rng.integers(0, 900, k).astype(np.uint64),
                   rng.random(k).astype(np.float32) if r % 5 else None,
                   weight=0.5 if weights and r % 4 == 0 else 1.0,
                   fields=(rng.integers(0, 7, k).astype(np.uint32)
                           if fields else None))
    return c


def _block_arrays(b):
    return {k: getattr(b, k) for k in ("offsets", "labels", "indices",
                                       "values", "weights", "fields")} | {
        "max_index": b.max_index, "max_field": b.max_field}


def _assert_blocks_equal(x, y):
    for k, v in _block_arrays(x).items():
        w = _block_arrays(y)[k]
        if isinstance(v, np.ndarray) or isinstance(w, np.ndarray):
            assert v is not None and w is not None, k
            assert v.dtype == w.dtype, k
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            assert v == w, k


@pytest.mark.parametrize("fields", [False, True])
@pytest.mark.parametrize("weights", [False, True])
def test_row_block_container_streams_cross_load(fields, weights):
    ours = _container(pdata, 8, fields, weights)
    theirs = _container(jdata, 8, fields, weights)
    a, b = _io.BytesIO(), _io.BytesIO()
    ours.save(a)
    theirs.save(b)
    assert a.getvalue() == b.getvalue()
    back, jback = pdata.RowBlockContainer(), jdata.RowBlockContainer()
    back.load(_io.BytesIO(b.getvalue()))
    jback.load(_io.BytesIO(a.getvalue()))
    _assert_blocks_equal(back.get_block(), theirs.get_block())
    _assert_blocks_equal(jback.get_block(), ours.get_block())
    blk, jblk = ours.get_block(), theirs.get_block()
    dense = np.random.default_rng(1).standard_normal(901)
    for i in (0, 7, 39):
        assert blk.sdot(i, dense) == jblk.sdot(i, dense)
        assert blk.weight(i) == jblk.weight(i)
    assert (blk.num_values, blk.num_col, blk.memcost_bytes()) == (
        jblk.num_values, jblk.num_col, jblk.memcost_bytes())


def test_push_block_and_from_arrays_match_jax():
    rng = np.random.default_rng(4)
    offsets = np.array([0, 2, 2, 5], np.int64)
    args = (offsets, np.array([1, 0, 1], np.float32),
            rng.integers(0, 50, 5).astype(np.uint64),
            rng.random(5).astype(np.float32))
    ours = pdata.RowBlockContainer.from_arrays(*args)
    theirs = jdata.RowBlockContainer.from_arrays(*args)
    _assert_blocks_equal(ours.get_block(), theirs.get_block())
    ours.push_block(ours.get_block().slice(1, 3))
    theirs.push_block(theirs.get_block().slice(1, 3))
    _assert_blocks_equal(ours.get_block(), theirs.get_block())


# -- DiskRowIter caches across the packages -------------------------------------

@pytest.fixture()
def rows_file(tmp_path):
    rng = np.random.default_rng(12)
    lines = []
    for i in range(1500):
        idx = np.sort(rng.choice(4000, int(rng.integers(1, 12)),
                                 replace=False))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.random():.4f}"
                                            for j in idx))
    path = tmp_path / "r.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _iter_blocks(it):
    return [b for b in it]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_disk_row_iter_cache_replays_in_the_other_package(rows_file,
                                                          tmp_path, writer):
    """The cache (pages of 16 KB) built by one package: byte-identical
    files, and the other package replays blocks equal to its own."""
    built = {}
    for name, mod in (("port", pdata), ("jax", jdata)):
        cache = str(tmp_path / f"{name}.cache")
        with mod.DiskRowIter(mod.create_parser(rows_file), cache,
                             page_size=16 << 10) as it:
            built[name] = _iter_blocks(it)
        assert len(built[name]) > 3
    assert (open(tmp_path / "port.cache", "rb").read()
            == open(tmp_path / "jax.cache", "rb").read())
    assert (open(tmp_path / "port.cache.meta", "rb").read()
            == open(tmp_path / "jax.cache.meta", "rb").read())
    reader = jdata if writer == "port" else pdata
    with reader.DiskRowIter(None, str(tmp_path / f"{writer}.cache")) as it:
        replayed = _iter_blocks(it)
        it.before_first()
        again = _iter_blocks(it)
    assert len(replayed) == len(again) == len(built[writer])
    for x, y, z in zip(replayed, again, built[writer]):
        _assert_blocks_equal(x, z)
        _assert_blocks_equal(y, z)


def test_disk_cache_iter_feeds_the_port_loader(tmp_path):
    """A ``#cachefile`` row-block iterator as a ``DeviceLoader`` source:
    the second epoch comes from the cache, with the source file gone."""
    rng = np.random.default_rng(0)
    path = tmp_path / "d.libsvm"
    with open(path, "w") as f:
        for r in range(300):
            idx = np.sort(rng.choice(500, size=4, replace=False))
            f.write(f"{r} " + " ".join(
                f"{j}:{rng.random():.4f}" for j in idx) + "\n")
    cache = tmp_path / "rows.cache"
    it = pdata.create_row_block_iter(f"file://{path}#{cache}", 0, 1,
                                     "libsvm")
    assert isinstance(it, pdata.DiskRowIter)
    loader = DeviceLoader(it, batch_rows=64, nnz_cap=1024, device="cpu")
    try:
        def labels_of():
            seen = []
            for b in loader:
                w = b["weights"].numpy() > 0
                seen.extend(b["labels"].numpy()[w].astype(int).tolist())
            return sorted(seen)
        assert labels_of() == list(range(300))
        path.unlink()
        loader.before_first()
        assert labels_of() == list(range(300))
        assert loader.cached_page_file() is None    # no file-backed split
    finally:
        loader.close()
    assert os.path.exists(str(cache) + ".meta")
