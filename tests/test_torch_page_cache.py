"""The port's packed-page epoch cache (``pipeline/page_cache.py`` and
``DeviceLoader(cache=...)``), held against the JAX package on the CPU.

* A page file written by either package's loader (native packer on
  both) is served by the other's: a hit, the file untouched, and the
  batches ``array_equal`` to the JAX loader's.
* Epochs from the second on, from the page file, ``array_equal`` to the
  first, for ``emit="device"`` and ``emit="host"``, on the native,
  streampack and python packers, over a directory of files.
* A stale page file (a touched or rewritten source, another pack
  configuration) or a damaged one (truncated, cut short by a close
  mid-epoch) is rebuilt and never served.
* A page view never enters the buffer pool: the pool refuses buffers
  that are not writable, and every buffer the loader hands out is its
  own.
* A build the writer cannot keep up with is dropped, never the epoch:
  with a queue of one page and ``page_cache.write:latency=50ms`` the
  epoch is unchanged, no page file and no ``.tmp`` is left, and the next
  epoch is a miss that rebuilds.

Every loader here that should write a page file gets a writer queue of
``EPOCH_BATCHES`` pages, the batches of the test epoch: the writer's
queue never blocks the epoch, so with the default of 8 a loaded host can
fall behind and drop the build (by design), and a test that counts hits
would read one fewer.
"""

import os
import shutil
import time

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.pipeline import DeviceLoader as JDeviceLoader  # noqa: E402
from dmlc_core_tpu.pipeline import page_cache as jpage_cache  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import page_cache  # noqa: E402
from dmlc_core_tpu_torch.pipeline.loader import _BufPool  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

ROWS = 64
CAP = 1024
EPOCH_BATCHES = 12          # 300 + 250 + 170 rows of data_dir, at 64 a batch


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()
    return native


def _write_libsvm(path, rows, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            idx = np.sort(rng.choice(3000, int(rng.integers(1, 30)),
                                     replace=False))
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.random():.3f}"
                                          for j in idx) + "\n")


@pytest.fixture()
def data_dir(tmp_path):
    d = tmp_path / "d"
    d.mkdir()
    for i, (rows, seed) in enumerate(((300, 1), (250, 2), (170, 3))):
        _write_libsvm(d / f"p{i}.libsvm", rows, seed)
    (d / "zz.libsvm").write_bytes(b"")
    return d


def _epoch(loader):
    return [{k: np.asarray(v).copy() for k, v in b.items()} for b in loader]


def _assert_epochs_equal(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _port_loader(uri, **kw):
    parser = kw.pop("parser", {})
    kw.setdefault("engine", "native")
    kw.setdefault("cache_queue_pages", EPOCH_BATCHES)
    return DeviceLoader(create_parser(uri, engine=kw["engine"], **parser),
                        ROWS, CAP, id_mod=2048, device="cpu", **kw)


def _jax_loader(uri):
    return JDeviceLoader(jcreate_parser(uri), ROWS, CAP, id_mod=2048,
                         put_threads=1, wire_compact=False, prefetch=1,
                         cache_queue_pages=EPOCH_BATCHES)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_page_file_is_served_by_the_other_package(lib, data_dir, tmp_path,
                                                  writer):
    uri = f"{data_dir}#{tmp_path}/c"
    pages = f"{tmp_path}/c.pages"
    first = _jax_loader(uri) if writer == "jax" else _port_loader(uri)
    try:
        built = _epoch(first)
    finally:
        first.close()
    assert page_cache.page_file_info(pages)["pages"] == len(built)
    stamp = os.stat(pages).st_mtime_ns
    if writer == "jax":
        ld = _port_loader(uri)
        try:
            served = _epoch(ld)
            assert ld.cache_stats["hits"] == 1 and ld.cache_stats[
                "misses"] == 0 and ld.cache_stats["bytes_read"] > 0
        finally:
            ld.close()
    else:
        jl = _jax_loader(uri)
        try:
            served = _epoch(jl)
            assert jl.cached_page_file() == pages
        finally:
            jl.close()
    assert os.stat(pages).st_mtime_ns == stamp       # served, not rebuilt
    _assert_epochs_equal(built, served)
    # both against a loader with no cache at all
    ref = _port_loader(str(data_dir), cache=None)
    try:
        _assert_epochs_equal(_epoch(ref), served)
    finally:
        ref.close()


PACKERS = {
    "native": {},
    "streampack": {"parser": {"threaded": False, "nthreads": 1}},
    "python": {"engine": "python"},
}


@pytest.mark.parametrize("packer", sorted(PACKERS))
def test_cached_epochs_equal_the_first(lib, data_dir, tmp_path, packer):
    ld = _port_loader(f"{data_dir}#{tmp_path}/c", **dict(PACKERS[packer]))
    try:
        epochs = [_epoch(ld)]
        assert ld.cache_stats["misses"] == 1
        for _ in range(3):
            ld.before_first()
            epochs.append(_epoch(ld))
        assert ld.cache_stats["hits"] == 3
        assert ld.cache_stats["bytes_read"] == 3 * ld.cache_stats[
            "bytes_written"] > 0
        assert ld.cached_page_file() == f"{tmp_path}/c.pages"
    finally:
        ld.close()
    for e in epochs[1:]:
        _assert_epochs_equal(epochs[0], e)
    ref = _port_loader(str(data_dir), cache=None, **dict(PACKERS[packer]))
    try:
        _assert_epochs_equal(_epoch(ref), epochs[0])
    finally:
        ref.close()


def test_host_items_from_pages_are_the_loaders_own_buffers(lib, data_dir,
                                                          tmp_path):
    """``emit="host"`` (the k-step trainer's feed): cached items equal the
    first epoch's, and each buffer is a writable pool buffer, never a
    view of the mapped page file; recycling them keeps the pool
    writable."""
    ld = _port_loader(f"{data_dir}#{tmp_path}/c", emit="host")
    try:
        epochs = []
        for e in range(3):
            if e:
                ld.before_first()
            items = []
            for kind, buf, meta, rows in ld:
                assert kind == "fused" and buf.flags.writeable
                items.append((buf.copy(), int(meta), rows))
                ld.recycle(buf)
            epochs.append(items)
        assert ld.cache_stats["hits"] == 2
        assert all(b.flags.writeable for b in ld._pool._bufs)
    finally:
        ld.close()
    for items in epochs[1:]:
        assert len(items) == len(epochs[0])
        for (a, ma, ra), (b, mb, rb) in zip(items, epochs[0]):
            assert ma == mb and ra == rb
            words = native.fused_words(ROWS, ma & 0xFFFFFFFF)
            np.testing.assert_array_equal(a[:words], b[:words])


def test_pool_refuses_a_read_only_view():
    pool = _BufPool(cap=4, pinned=False)
    raw = np.arange(16, dtype=np.int32)
    view = np.frombuffer(raw.tobytes(), dtype=np.int32)      # read-only
    assert not view.flags.writeable
    pool.put(view)
    own = np.empty(16, np.int32)
    pool.put(own)
    assert pool._bufs == [own]
    assert pool.get(16) is own


def test_touched_or_rewritten_source_rebuilds(lib, data_dir, tmp_path):
    uri = f"{data_dir}#{tmp_path}/c"
    pages = f"{tmp_path}/c.pages"
    with _port_loader(uri) as ld:
        first = _epoch(ld)
    stamp = os.stat(pages).st_mtime_ns
    src = data_dir / "p1.libsvm"
    st = os.stat(src)
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    with _port_loader(uri) as ld:
        again = _epoch(ld)
        assert ld.cache_stats == dict(ld.cache_stats, hits=0, misses=1)
    assert os.stat(pages).st_mtime_ns != stamp        # rebuilt
    _assert_epochs_equal(first, again)
    # new content under the same name: the raw-chunk log of the fragment
    # replays the old text (the JAX rule), so drop it with the pages
    _write_libsvm(src, 99, 9)
    os.unlink(f"{tmp_path}/c.done")
    with _port_loader(uri) as ld:
        fresh = _epoch(ld)
        assert ld.cache_stats["misses"] == 1
    with _port_loader(str(data_dir), cache=None) as ref:
        _assert_epochs_equal(_epoch(ref), fresh)


def test_another_pack_configuration_rebuilds(lib, data_dir, tmp_path):
    uri = f"{data_dir}#{tmp_path}/c"
    with _port_loader(uri) as ld:
        _epoch(ld)
    with DeviceLoader(create_parser(uri, engine="native"), ROWS, CAP,
                      id_mod=4096, device="cpu") as ld:
        got = _epoch(ld)
        assert ld.cache_stats["misses"] == 1 and ld.cache_stats["hits"] == 0
    with DeviceLoader(create_parser(str(data_dir), engine="native"), ROWS,
                      CAP, id_mod=4096, device="cpu", cache=None) as ref:
        _assert_epochs_equal(_epoch(ref), got)


@pytest.mark.parametrize("damage", ["truncate", "footer", "garbage"])
def test_damaged_page_file_is_rebuilt_never_served(lib, data_dir, tmp_path,
                                                   damage):
    uri = f"{data_dir}#{tmp_path}/c"
    pages = f"{tmp_path}/c.pages"
    with _port_loader(uri) as ld:
        first = _epoch(ld)
    size = os.path.getsize(pages)
    with open(pages, "r+b") as f:
        if damage == "truncate":
            f.truncate(size // 2)
        elif damage == "footer":
            f.seek(size - 8)
            f.write(b"XXXXXXXX")
        else:
            f.seek(0)
            f.write(b"NOTAPAGE")
    assert page_cache.page_file_info(pages) is None
    assert jpage_cache.page_file_info(pages) is None
    with _port_loader(uri) as ld:
        assert ld.cached_page_file() is None
        again = _epoch(ld)
        assert ld.cache_stats["hits"] == 0 and ld.cache_stats["misses"] == 1
    _assert_epochs_equal(first, again)
    assert page_cache.page_file_info(pages)["pages"] == len(first)


def test_close_mid_epoch_leaves_no_part_of_a_page_file(lib, data_dir,
                                                      tmp_path):
    uri = f"{data_dir}#{tmp_path}/c"
    ld = _port_loader(uri)
    assert ld.next_batch() is not None
    ld.close()
    deadline = time.monotonic() + 10
    while (any(".tmp." in n for n in os.listdir(tmp_path))
           and time.monotonic() < deadline):
        time.sleep(0.05)
    names = os.listdir(tmp_path)
    # 12 batches, at most 6 packed ahead of the consumer: the epoch was
    # cut short, and its build must not be sealed under the real name
    assert "c.pages" not in names and not any(".tmp." in n for n in names)


def test_cache_resolution_rules(lib, data_dir, tmp_path):
    """``auto`` caches only the fused path and only with a fragment; an
    explicit path on another path raises; None turns it off."""
    uri = f"{data_dir}#{tmp_path}/c"
    cases = [
        (dict(), f"{tmp_path}/c.pages"),
        (dict(cache=None), None),
        (dict(cache=False), None),
        (dict(cache=str(tmp_path / "x.pages")), str(tmp_path / "x.pages")),
        (dict(layout="rowmajor"), None),
        (dict(ragged=True), None),
    ]
    for kw, want in cases:
        with _port_loader(uri, **kw) as ld:
            assert ld._cache_path == want, kw
    with _port_loader(str(data_dir)) as ld:
        assert ld._cache_path is None
    with pytest.raises(DMLCError, match="fused path"):
        _port_loader(uri, layout="rowmajor", cache=str(tmp_path / "y"))


def test_a_dropped_build_leaves_nothing_and_the_next_epoch_rebuilds(
        lib, data_dir, tmp_path, monkeypatch):
    """A writer queue of one page (two slots, the floor) and 50 ms of
    injected latency before each page write: the writer falls behind and
    the build is dropped on purpose.  The epoch it was offered from is
    the uncached epoch, no page file and no ``.tmp`` is left, and the
    next epoch is a miss that rebuilds (and the one after it a hit)."""
    from dmlc_core_tpu_torch.utils.metrics import metrics
    uri = f"{data_dir}#{tmp_path}/c"
    delays = metrics.counter("faults.page_cache.write.delays")
    before = delays.value
    offer = page_cache.PageCacheWriter.offer

    def first_page_taken(self, *args):
        # the writer takes the first page before the next offers: on a
        # loaded host its thread could otherwise start after the queue
        # filled, and drop the build before any write (and any delay)
        ok = offer(self, *args)
        deadline = time.monotonic() + 30
        while (self.pages == 1 and not self._q.empty()
               and time.monotonic() < deadline):
            time.sleep(0.001)
        return ok
    monkeypatch.setattr(page_cache.PageCacheWriter, "offer",
                        first_page_taken)
    monkeypatch.setenv("DMLC_FAULT_SPEC", "page_cache.write:latency=50ms")
    with _port_loader(uri, cache_queue_pages=1) as ld:
        dropped = _epoch(ld)
        stats = dict(ld.cache_stats)
    assert delays.value > before                  # the latency fired
    assert stats["misses"] == 1 and stats["drops"] == 1
    assert stats["hits"] == 0 and len(dropped) == EPOCH_BATCHES
    # the raw-chunk log of the fragment ("c", "c.done") and the data
    assert sorted(os.listdir(tmp_path)) == ["c", "c.done", "d"]
    with _port_loader(str(data_dir), cache=None) as ref:
        _assert_epochs_equal(_epoch(ref), dropped)
    monkeypatch.delenv("DMLC_FAULT_SPEC")
    monkeypatch.setattr(page_cache.PageCacheWriter, "offer", offer)
    with _port_loader(uri) as ld:
        rebuilt = _epoch(ld)
        assert ld.cache_stats == dict(ld.cache_stats, hits=0, misses=1,
                                      drops=0)
        ld.before_first()
        served = _epoch(ld)
        assert ld.cache_stats["hits"] == 1
    assert page_cache.page_file_info(
        f"{tmp_path}/c.pages")["pages"] == EPOCH_BATCHES
    _assert_epochs_equal(dropped, rebuilt)
    _assert_epochs_equal(dropped, served)


def test_writer_drops_a_build_it_cannot_keep_up_with(tmp_path):
    """A full queue drops the whole build (the epoch goes on); nothing is
    left under the page file's name."""
    path = str(tmp_path / "w.pages")
    w = page_cache.PageCacheWriter(path, {"k": 1}, queue_pages=2)
    w.abort()
    assert not w.active
    assert not w.offer(np.zeros(8, np.int32), 8, None, 8)
    assert not w.finalize()
    assert not os.path.exists(path)
    w = page_cache.PageCacheWriter(path, {"k": 1}, queue_pages=2)
    assert w.offer(np.arange(8, dtype=np.int32), 3, 5, 8)
    assert w.finalize()
    r = page_cache.open_reader(path, {"k": 1})
    (meta, rows, view), = list(r.pages())
    assert (meta, rows) == (3, 5) and not view.flags.writeable
    np.testing.assert_array_equal(view, np.arange(8))
    del view
    r.close()
    assert page_cache.open_reader(path, {"k": 2}) is None     # stale
    jr = jpage_cache.open_reader(path, {"k": 1})              # JAX reads it
    assert jr is not None and jr.npages == 1
    jr.close()
