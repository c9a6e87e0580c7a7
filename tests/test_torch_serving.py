"""The PyTorch port's serving layer and checkpoints, held against the JAX
package on the CPU.

Engines of both packages serve the same weights (carried over by
``params_from_jax``, or through one checkpoint) and the same requests;
scores agree to ``rtol = atol = 1e-5`` (float32 sums in different
orders).  Ladder selection and request padding must be identical.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu.serving import engine as jengine  # noqa: E402
from dmlc_core_tpu.utils import checkpoint as jckpt  # noqa: E402
from dmlc_core_tpu_torch.models import (FactorizationMachine,  # noqa: E402
                                        SparseLogReg, params_from_jax)
from dmlc_core_tpu_torch.serving import (BucketLadder,  # noqa: E402
                                         DeadlineExceeded, InferenceEngine,
                                         MicroBatcher, Overloaded,
                                         RequestTooLarge, Shutdown)
from dmlc_core_tpu_torch.serving import engine as tengine  # noqa: E402
from dmlc_core_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

F, D = 3000, 8
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = [(8, 128), (16, 256), (32, 512)]


def _fm_params(seed):
    rng = np.random.default_rng(seed)
    return {"w0": np.asarray(0.1 * seed, np.float32),
            "w": (rng.normal(size=F) * 0.3).astype(np.float32),
            "v": (rng.normal(size=(F, D)) * 0.2).astype(np.float32)}


def _req(rng, rows, max_per_row):
    counts = rng.integers(0, max_per_row + 1, rows)
    ids = rng.integers(0, F, int(counts.sum())).astype(np.int32)
    vals = rng.random(len(ids)).astype(np.float32)
    return ids, vals, np.concatenate([[0], np.cumsum(counts)]).astype(
        np.int64)


def _port_engine(params, **kw):
    model = FactorizationMachine(F, D, device="cpu")
    return InferenceEngine(model, params, device="cpu", **kw)


def _jax_engine(params, **kw):
    return jengine.InferenceEngine(
        jsparse.FactorizationMachine(F, D),
        {k: jnp.asarray(v) for k, v in params.items()}, **kw)


# ---------------------------------------------------------------------------
# ladder and padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["default", "ragged_default", "custom"])
def test_best_fit_identical_to_jax(kind):
    if kind == "custom":
        tl, jl = BucketLadder(SMALL + [(4, 2048)]), jengine.BucketLadder(
            SMALL + [(4, 2048)])
    else:
        tl = getattr(BucketLadder, kind)()
        jl = getattr(jengine.BucketLadder, kind)()
    assert list(tl) == [tuple(b) for b in jl] and len(tl) == len(jl)
    for rows in list(range(1, 20)) + [31, 32, 33, 64, 100, 128, 129]:
        for nnz in (1, 7, 64, 100, 255, 256, 257, 511, 600, 1024, 2048,
                    4096, 4097, 8192, 8193):
            try:
                want = tuple(jl.best_fit(rows, nnz))
            except jengine.RequestTooLarge:
                with pytest.raises(RequestTooLarge):
                    tl.best_fit(rows, nnz)
                continue
            assert tuple(tl.best_fit(rows, nnz)) == want


@pytest.mark.parametrize("ragged", [False, True])
def test_padding_identical_to_jax(ragged):
    rng = np.random.default_rng(1)
    ids, vals, rp = _req(rng, 5, 9)
    bucket = tengine.ShapeBucket(8, 128)
    name = "_pad_to_capacity" if ragged else "_pad_to_bucket"
    got = getattr(tengine, name)(bucket, ids, vals, rp)
    want = getattr(jengine, name)(jengine.ShapeBucket(8, 128), ids, vals,
                                  rp)
    assert set(got) == set(want)
    n = len(ids)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape
        if ragged and k in ("ids", "vals", "segments"):
            g, w = g[:n], w[:n]           # tails are garbage by contract
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("postprocess", ["none", "sigmoid"])
def test_engine_scores_match_jax_engine(ragged, postprocess):
    p = _fm_params(1)
    kw = dict(buckets=BucketLadder(SMALL), postprocess=postprocess,
              ragged=ragged)
    port = _port_engine(params_from_jax(p, "cpu"), **kw)
    ref = _jax_engine(p, buckets=jengine.BucketLadder(SMALL),
                      postprocess=postprocess, ragged=ragged)
    rng = np.random.default_rng(2)
    for rows in (1, 3, 8, 17, 32):
        ids, vals, rp = _req(rng, rows, 12)
        got = port.predict(ids, vals, rp)
        assert got.shape == (rows,) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref.predict(ids, vals, rp), **TOL)


def test_padded_and_ragged_engines_give_the_same_bits():
    p = _fm_params(3)
    pad = _port_engine(p, buckets=BucketLadder(SMALL))
    rag = _port_engine(p, buckets=BucketLadder(SMALL), ragged=True)
    rng = np.random.default_rng(4)
    for rows in (1, 5, 16, 30):
        req = _req(rng, rows, 15)
        assert np.array_equal(pad.predict(*req), rag.predict(*req))


def test_engine_prepares_each_bucket_at_most_once():
    eng = _port_engine(_fm_params(1), buckets=BucketLadder(SMALL))
    rng = np.random.default_rng(5)
    for _ in range(60):
        eng.predict(*_req(rng, int(rng.integers(1, 33)), 15))
    assert 1 <= eng.compile_count <= len(eng.ladder)
    eng.warmup_all()
    assert eng.compile_count == len(eng.ladder)
    with pytest.raises(RequestTooLarge):
        eng.predict(*_req(rng, 33, 1))


def test_engine_reload_swaps_and_refuses_mismatch():
    p1, p2 = _fm_params(1), _fm_params(2)
    eng = _port_engine(p1, buckets=BucketLadder(SMALL))
    req = _req(np.random.default_rng(6), 4, 10)
    before = eng.predict(*req)
    eng.reload(p2)
    assert eng.params_version == 1
    np.testing.assert_allclose(
        eng.predict(*req),
        _jax_engine(p2, buckets=jengine.BucketLadder(SMALL)).predict(*req),
        **TOL)
    assert not np.allclose(before, eng.predict(*req))
    bad = dict(p2, v=np.zeros((F, D + 1), np.float32))
    with pytest.raises(DMLCError, match="hot-reload refused"):
        eng.reload(bad)
    with pytest.raises(DMLCError, match="do not match"):
        _port_engine({"w": p1["w"], "b": np.float32(0)})


def test_engine_defaults_to_the_card(monkeypatch):
    model = SparseLogReg(F, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        InferenceEngine(model)


# ---------------------------------------------------------------------------
# checkpoints shared with the JAX package
# ---------------------------------------------------------------------------

def test_jax_checkpoint_served_by_the_port(tmp_path):
    p = _fm_params(4)
    mgr = jckpt.CheckpointManager(str(tmp_path))
    mgr.save(5, {"params": {k: jnp.asarray(v) for k, v in p.items()},
                 "opt_state": {"count": jnp.int32(3)}},
             meta={"model": "fm"})
    eng = _port_engine(_fm_params(9), buckets=BucketLadder(SMALL),
                       postprocess="sigmoid")
    assert eng.reload_from_checkpoint(str(tmp_path)) == 5
    ref = _jax_engine(p, buckets=jengine.BucketLadder(SMALL),
                      postprocess="sigmoid")
    rng = np.random.default_rng(7)
    for rows in (2, 9, 20):
        req = _req(rng, rows, 10)
        np.testing.assert_allclose(eng.predict(*req), ref.predict(*req),
                                   **TOL)


def test_port_checkpoint_loads_in_jax(tmp_path):
    p = _fm_params(5)
    tree = {"params": params_from_jax(p, "cpu"),
            "extra": (np.arange(3, dtype=np.int64), [1.5, None, "x"])}
    tckpt.CheckpointManager(str(tmp_path)).save(2, tree, meta={"model": "fm"})
    step, params, meta = jckpt.load_for_inference(str(tmp_path))
    assert step == 2 and meta == {"model": "fm"}
    for k in p:
        assert params[k].shape == p[k].shape
        np.testing.assert_array_equal(params[k], p[k])
    _, full = jckpt.CheckpointManager(str(tmp_path)).restore()
    assert full["extra"][1] == [1.5, None, "x"]
    np.testing.assert_array_equal(full["extra"][0], np.arange(3))
    # and back: the port reads what it wrote, 0-d leaves kept
    step, params, _ = tckpt.load_for_inference(str(tmp_path))
    assert params["w0"].shape == () and step == 2


def test_checkpoint_manager_retention_and_manifest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"params": {"w": np.full(4, s, np.float32)}})
    assert mgr.steps == [2, 3] and mgr.latest_step == 3
    assert not (tmp_path / "ckpt-1.bin").exists()
    assert jckpt.CheckpointManager(str(tmp_path)).steps == [2, 3]
    (tmp_path / "MANIFEST.json").write_text("{torn")
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step == 3
    with pytest.raises(DMLCError):
        mgr.restore(1)


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

class _StubEngine:
    """Scores = per-row nnz, optionally slow; records its calls."""

    def __init__(self, delay=0.0, ladder=None):
        self.ladder = ladder or BucketLadder([(64, 1024)])
        self.delay = delay
        self.calls = []

    def predict(self, ids, vals, row_ptr):
        self.calls.append(len(row_ptr) - 1)
        time.sleep(self.delay)
        return np.diff(row_ptr).astype(np.float32)


def test_batcher_answers_concurrent_submits_with_engine_scores():
    eng = _port_engine(_fm_params(1), buckets=BucketLadder(SMALL))
    rng = np.random.default_rng(8)
    reqs = [_req(rng, int(rng.integers(1, 6)), 10) for _ in range(40)]
    want = [eng.predict(*r) for r in reqs]
    got = [None] * len(reqs)
    with MicroBatcher(eng, max_delay_s=0.005) as b:
        def client(k):
            for j in range(k, len(reqs), 4):
                got[j] = b.submit(*reqs[j]).result(timeout=30)
        ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        assert b.batches <= len(reqs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_batcher_overloaded_at_max_queue():
    eng = _StubEngine(delay=0.3)
    b = MicroBatcher(eng, max_delay_s=0.0, max_queue=2)
    try:
        first = b.submit(np.zeros(1), np.ones(1))
        time.sleep(0.1)                   # worker is now inside predict
        queued = [b.submit(np.zeros(1), np.ones(1)) for _ in range(2)]
        with pytest.raises(Overloaded):
            b.submit(np.zeros(1), np.ones(1)).result(timeout=5)
        assert first.result(timeout=5).tolist() == [1.0]
        for f in queued:
            assert f.result(timeout=5).tolist() == [1.0]
    finally:
        b.close()


def test_batcher_size_trigger_deadline_and_oversize():
    eng = _StubEngine()
    with MicroBatcher(eng, max_delay_s=5.0, max_batch_rows=4) as b:
        fs = [b.submit(np.zeros(2), np.ones(2), np.array([0, 1, 2]))
              for _ in range(2)]              # 4 rows: size trigger
        assert [f.result(timeout=2).tolist() for f in fs] == [[1, 1]] * 2
        with pytest.raises(RequestTooLarge):
            b.submit(np.zeros(5), np.ones(5),
                     np.arange(6)).result(timeout=1)
        with pytest.raises(DMLCError, match="malformed"):
            b.submit(np.zeros(2), np.ones(3)).result(timeout=1)
    slow = _StubEngine(delay=0.3)
    with MicroBatcher(slow, max_delay_s=0.0) as b:
        b.submit(np.zeros(1), np.ones(1))
        time.sleep(0.05)
        late = b.submit(np.zeros(1), np.ones(1), deadline_s=0.01)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=5)


@pytest.mark.parametrize("drain", [True, False])
def test_batcher_close(drain):
    eng = _StubEngine(delay=0.2)
    b = MicroBatcher(eng, max_delay_s=0.0)
    b.submit(np.zeros(1), np.ones(1))
    time.sleep(0.05)
    queued = b.submit(np.zeros(1), np.ones(1))
    b.close(drain=drain)
    if drain:
        assert queued.result(timeout=5).tolist() == [1.0]
    else:
        with pytest.raises(Shutdown):
            queued.result(timeout=5)
    with pytest.raises(Shutdown):
        b.submit(np.zeros(1), np.ones(1)).result(timeout=1)
