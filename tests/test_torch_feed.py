"""The port's host feed: ``DeviceLoader``'s native, streampack, python,
ragged and ``emit="host"`` paths, its pack and transfer threads and the
fused wire's decoder, held against the JAX ``DeviceLoader`` on the CPU.

The same seeded libsvm file goes through both loaders with the same
knobs; every batch is ``array_equal`` with the same keys, shapes and
dtypes (ragged batches on their live prefix: their tails are garbage by
contract, in both packages).  Every join has a timeout, so no test can
hang.  Each test skips only where there is no g++.
"""

import shutil
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.pipeline import device_loader as jdl  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.pipeline import (DeviceLoader,  # noqa: E402
                                          fused_words, make_decoder)
from dmlc_core_tpu_torch.pipeline import loader as loader_mod  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

ROWS = 128


@pytest.fixture(scope="session")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()
    return native


def libsvm_text(rows: int, seed: int) -> bytes:
    """chip_smoke's shape, narrower: 5-39 sorted distinct ids per row,
    values U[0,1), a label:weight head on every ninth row."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(5, 40))
        idx = np.sort(rng.choice(1_000_000, size=n, replace=False))
        toks = b" ".join(b"%d:%.4f" % (j, v) for j, v in
                         zip(idx.tolist(), rng.random(n).tolist()))
        head = b"%d" % (i & 1) if i % 9 else b"%d:0.5" % (i & 1)
        lines.append(head + b" " + toks)
    return b"\n".join(lines) + b"\n"


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("feed") / "d.libsvm"
    p.write_bytes(libsvm_text(1037, seed=5))     # not a multiple of ROWS
    return str(p)


def _np(v):
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.asarray(v)


def port_batches(path, cap, parser=None, epochs=1, **kw):
    with DeviceLoader(create_parser(path, **(parser or {})), ROWS, cap,
                      device="cpu", **kw) as ld:
        out = []
        for e in range(epochs):
            if e:
                ld.before_first()
            out += [{k: _np(v) for k, v in b.items()} for b in ld]
    return out


def jax_batches(path, cap, parser=None, **kw):
    jl = jdl.DeviceLoader(jcreate_parser(f"file://{path}", 0, 1, "libsvm",
                                         **(parser or {})),
                          ROWS, cap, prefetch=2, put_threads=1,
                          wire_compact=False, cache=None, **kw)
    try:
        return [{k: np.asarray(v) for k, v in b.items()} for b in jl]
    finally:
        jl.close()


def assert_same(got, want):
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        live = int(w["nnz_used"]) if "nnz_used" in w else None
        for k in w:
            assert g[k].dtype == w[k].dtype, (i, k)
            assert g[k].shape == w[k].shape, (i, k)
            a, b = g[k], w[k]
            if live is not None and k in ("ids", "vals", "segments"):
                a, b = a[:live], b[:live]
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i} {k}")


# (name, port knobs, JAX knobs, use the JAX python pack path)
PATHS = {
    "native": (dict(), dict(), False),
    "native_drop": (dict(drop_remainder=True), dict(drop_remainder=True),
                    False),
    "streampack": (dict(parser=dict(threaded=False, nthreads=1)),
                   dict(parser=dict(threaded=False, nthreads=1)), False),
    "python_flat": (dict(engine="python"), dict(), True),
    "rowmajor": (dict(layout="rowmajor"), dict(layout="rowmajor"), False),
    "ragged": (dict(ragged=True), dict(ragged=True), False),
    "ragged_drop": (dict(ragged=True, drop_remainder=True),
                    dict(ragged=True, drop_remainder=True), False),
}


@pytest.mark.parametrize("cap", [4096, 2048])    # 2048: early closes
@pytest.mark.parametrize("name", sorted(PATHS))
def test_batches_equal_jax_device_loader(lib, path, monkeypatch, name, cap):
    ours, theirs, jax_python = PATHS[name]
    if name == "rowmajor":
        cap = cap // 64                     # k_cap 64 or 32 (truncates)
    if jax_python:
        monkeypatch.setattr(jnative, "has_packer", lambda: False)
    assert_same(port_batches(path, cap, **ours),
                jax_batches(path, cap, **theirs))


def test_streampack_is_taken_only_for_one_unthreaded_parse_thread(lib,
                                                                  path):
    cases = [(dict(threaded=False, nthreads=1), {}, True),
             (dict(threaded=False, nthreads=2), {}, False),
             (dict(threaded=True, nthreads=1), {}, False),
             (dict(threaded=False, nthreads=1), dict(streampack=False),
              False),
             (dict(threaded=False, nthreads=1), dict(engine="python"),
              False)]
    for parser, kw, want in cases:
        with DeviceLoader(create_parser(path, **parser), ROWS, 4096,
                          device="cpu", **kw) as ld:
            assert ld._use_streampack() is want, (parser, kw)


def test_bucketed_shapes_are_few(lib, path):
    shapes = {b["ids"].shape for b in port_batches(path, 4096)}
    assert 1 <= len(shapes) <= 8
    assert all(s[0] % (4096 // 8) == 0 for s in shapes)


def test_emit_host_items_equal_jax(lib, path):
    def items(make):
        ld = make()
        out = []
        try:
            for kind, buf, meta, rows in ld:
                words = fused_words(ROWS, int(meta) & 0xFFFFFFFF)
                out.append((kind, np.asarray(buf)[:words].copy(), int(meta),
                            rows))
                ld.recycle(buf)
        finally:
            ld.close()
        return out

    got = items(lambda: DeviceLoader(create_parser(path), ROWS, 4096,
                                     device="cpu", emit="host"))
    want = items(lambda: jdl.DeviceLoader(
        jcreate_parser(f"file://{path}"), ROWS, 4096, emit="host",
        wire_compact=False, cache=None))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g[0] == w[0] == "fused" and g[2] == w[2] and g[3] == w[3]
        assert g[1].tobytes() == w[1].tobytes()


@pytest.mark.parametrize("name", ["native", "python_flat", "rowmajor",
                                  "ragged"])
def test_put_threads_keep_batch_order(lib, path, name):
    ours = dict(PATHS[name][0])
    cap = 64 if name == "rowmajor" else 4096
    one = port_batches(path, cap, epochs=2, put_threads=1, **ours)
    pool = port_batches(path, cap, epochs=2, put_threads=3, **ours)
    assert len(one) == len(pool) == 18
    for a, b in zip(one, pool):
        assert set(a) == set(b)
        for k in a:
            if "nnz_used" in a and k in ("ids", "vals", "segments"):
                n = int(a["nnz_used"])
                a_k, b_k = a[k][:n], b[k][:n]
            else:
                a_k, b_k = a[k], b[k]
            np.testing.assert_array_equal(a_k, b_k)


def test_decoder_matches_host_segments_and_jax(lib, path):
    ld = DeviceLoader(create_parser(path), ROWS, 4096, device="cpu",
                      emit="host")
    try:
        items = [(np.asarray(b).copy(), m) for _, b, m, _ in ld]
    finally:
        ld.close()
    for buf, meta in items:
        words = fused_words(ROWS, meta)
        via_search = make_decoder(ROWS, meta)(torch.from_numpy(buf[:words]))
        on_host = loader_mod._decode_on_host(buf, ROWS, meta)
        want = jdl.make_decoder(ROWS, meta)(jax.numpy.asarray(buf[:words]))
        for k in want:
            a, b = _np(via_search[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
            np.testing.assert_array_equal(_np(on_host[k]), b, err_msg=k)
    with pytest.raises(DMLCError, match="not ported"):
        make_decoder(ROWS, 100 | (17 << 32))


class _Boom:
    """A source whose third block raises."""

    def __init__(self, path):
        self.parser = create_parser(path, threaded=False)
        self.parser.chunk_bytes = 4096

    def __iter__(self):
        for i, blk in enumerate(self.parser):
            if i == 2:
                raise ValueError("planted parse failure")
            yield blk


@pytest.mark.parametrize("put_threads", [1, 2])
def test_pack_stage_exception_reaches_the_consumer(lib, path, put_threads):
    ld = DeviceLoader(_Boom(path), ROWS, 4096, device="cpu",
                      put_threads=put_threads)
    try:
        with pytest.raises(DMLCError, match="planted parse failure"):
            for _ in ld:
                pass
    finally:
        ld.close()


@pytest.mark.parametrize("put_threads", [1, 2])
def test_transfer_exception_reaches_the_consumer(lib, path, monkeypatch,
                                                 put_threads):
    def failing(self, item, sync):
        raise RuntimeError("injected transfer failure")

    monkeypatch.setattr(DeviceLoader, "_transfer_item", failing)
    ld = DeviceLoader(create_parser(path), ROWS, 4096, device="cpu",
                      put_threads=put_threads)
    try:
        with pytest.raises(DMLCError, match="injected transfer failure"):
            for _ in ld:
                pass
    finally:
        ld.close()


def _loader_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("dmlc-") and t.is_alive()}


@pytest.mark.parametrize("kw", [dict(), dict(put_threads=3),
                                dict(emit="host"), dict(ragged=True),
                                dict(layout="rowmajor")])
def test_close_mid_epoch_leaves_no_thread(lib, path, kw):
    before = _loader_threads()
    cap = 64 if kw.get("layout") == "rowmajor" else 4096
    ld = DeviceLoader(create_parser(path), ROWS, cap, device="cpu",
                      prefetch=1, **kw)
    assert ld.next_batch() is not None
    assert _loader_threads() - before            # pack, transfer, parse
    ld.close()
    deadline = time.monotonic() + 10
    while _loader_threads() - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not (_loader_threads() - before)


def test_loader_checks_its_knobs(lib, path):
    with pytest.raises(DMLCError, match="flat layout"):
        DeviceLoader(create_parser(path), ROWS, 64, layout="rowmajor",
                     ragged=True, device="cpu")
    with pytest.raises(DMLCError, match="emit='host'"):
        DeviceLoader(create_parser(path), ROWS, 4096, ragged=True,
                     emit="host", device="cpu")
    with pytest.raises(DMLCError, match="flat layout"):
        DeviceLoader(create_parser(path), ROWS, 64, layout="rowmajor",
                     emit="host", device="cpu")
    with pytest.raises(DMLCError, match="engine"):
        DeviceLoader(create_parser(path), ROWS, 64, engine="fast",
                     device="cpu")


def test_native_engine_without_a_compiler_raises(lib, path, monkeypatch):
    from dmlc_core_tpu_torch.native import build as native_build
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    monkeypatch.setattr(native_build, "is_fresh", lambda: False)
    src = create_parser(path, engine="python", threaded=False)
    with pytest.raises(DMLCError, match="g\\+\\+ not found"):
        DeviceLoader(src, ROWS, 4096, device="cpu", engine="native")
    with DeviceLoader(src, ROWS, 4096, device="cpu") as ld:
        assert ld.engine == "python"
        assert next(iter(ld))["ids"].shape == (4096,)


def test_stats_count_every_row(lib, path):
    for kw in (dict(), dict(engine="python"), dict(ragged=True),
               dict(parser=dict(threaded=False, nthreads=1))):
        parser = kw.pop("parser", {})
        with DeviceLoader(create_parser(path, **parser), ROWS, 4096,
                          device="cpu", **kw) as ld:
            n = sum(int((b["weights"] > 0).sum()) for b in ld)
            assert n == ld.stats.rows == 1037, kw
