"""The port's sharded embedding table (``embed/table.py``,
``embed/exchange.py``) and ``pipeline/packing.dedup_ids`` (ROADMAP A.8)
against the JAX package, on the CPU.

* ``reference_rows``, ``dedup_ids``, the shard layout and the partition
  math are ``array_equal`` / equal to the JAX ones.
* ``lookup`` and the accumulated row gradients match the JAX table's on
  the same seeded batch (rtol 1e-5, atol 1e-6, the JAX test's
  tolerance); a flush applies the same SGD (rtol 1e-5).
* The JAX test file's cases on the port's table: cache and eviction,
  replica failover, the snapshot budget and plan, ``adopt_restored``,
  and the collective flush over a real tracker, bit-identical across
  ranks.
* The ``DMEB1`` wire mixes: a port client reads rows and blocks from a
  JAX ``ShardServer`` and sends it updates, and a JAX client does the
  same against a port one.

Every table runs the plain path (``device="cpu"``); the card's kernels
are held against it in ``tests/test_torch_cuda.py``."""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from dmlc_core_tpu.embed import ShardedEmbeddingTable as JaxTable  # noqa
from dmlc_core_tpu.embed import exchange as jexchange  # noqa: E402
from dmlc_core_tpu.parallel import row_owners as jrow_owners  # noqa: E402
from dmlc_core_tpu.pipeline.packing import dedup_ids as jdedup  # noqa: E402
from dmlc_core_tpu_torch.embed import ShardedEmbeddingTable  # noqa: E402
from dmlc_core_tpu_torch.embed import exchange  # noqa: E402
from dmlc_core_tpu_torch.parallel import (RabitContext,  # noqa: E402
                                          RabitTracker, row_owners,
                                          row_partition)
from dmlc_core_tpu_torch.pipeline.packing import dedup_ids  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def Table(*a, **kw):
    """A port table on the plain path."""
    return ShardedEmbeddingTable(*a, device="cpu", **kw)


def _counter(name):
    return metrics.counter(name).value


def _ragged(ids, vals, segments, rows, nnz_cap=0, garbage=False):
    """A ragged batch dict (the ``pack_ragged`` contract) from live
    arrays; tails past ``nnz_used`` are zeros, or garbage."""
    nnz = len(ids)
    cap = max(nnz, nnz_cap)
    fill = np.random.default_rng(99) if garbage else None
    out = {"ids": np.zeros(cap, np.int32), "vals": np.zeros(cap, np.float32),
           "segments": np.zeros(cap, np.int32),
           "row_ptr": np.zeros(rows + 1, np.int32),
           "labels": np.zeros(rows, np.float32),
           "weights": np.ones(rows, np.float32),
           "nnz_used": np.int32(nnz), "rows_used": np.int32(rows)}
    if fill is not None:
        out["ids"][:] = fill.integers(-5, 10 ** 6, cap)
        out["vals"][:] = fill.standard_normal(cap)
        out["segments"][:] = fill.integers(-3, rows + 5, cap)
    out["ids"][:nnz] = ids
    out["vals"][:nnz] = vals
    out["segments"][:nnz] = segments
    return out


def _identity_batch(num_rows):
    return _ragged(np.arange(num_rows), np.ones(num_rows),
                   np.arange(num_rows), num_rows)


def _seeded_batch(seed, n, rows, nnz, cap, garbage=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, nnz)
    vals = rng.random(nnz).astype(np.float32)
    segs = np.sort(rng.integers(0, rows - 2, nnz))   # last 2 rows padded
    return _ragged(ids, vals, segs, rows, nnz_cap=cap, garbage=garbage)


# ---------------------------------------------------------------------------
# the pieces equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, d, seed", [(100, 3, 5), (4099, 4, 0),
                                        (48, 8, 9)])
def test_reference_rows_equal_the_jax_ones(n, d, seed):
    got = ShardedEmbeddingTable.reference_rows(n, d, seed=seed)
    assert np.array_equal(got, JaxTable.reference_rows(n, d, seed=seed))
    assert got.dtype == np.float32
    for world in (1, 2, 3, 7):
        union = np.concatenate([
            Table(n, d, rank=r, world=world, seed=seed,
                  replicas=0).read_block(s, e)
            for r, (s, e) in enumerate(row_partition(n, world)) if s < e])
        assert union.tobytes() == got.tobytes(), world


@pytest.mark.parametrize("seed", range(6))
def test_dedup_ids_equals_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 300))
    ids = rng.integers(0, int(rng.integers(1, 50)), cap).astype(np.int32)
    nnz = int(rng.integers(0, cap + 1))
    uniq, pos = dedup_ids(ids, nnz)
    juniq, jpos = jdedup(ids, nnz)
    assert np.array_equal(uniq, juniq) and uniq.dtype == juniq.dtype
    assert np.array_equal(pos, jpos) and pos.dtype == jpos.dtype
    assert (uniq[pos] == ids[:nnz].astype(np.int64)).all()


def test_dedup_ids_contract():
    ids = np.array([7, 3, 7, 7, 3, 9, 999], np.int32)   # 999 is dead tail
    uniq, pos = dedup_ids(ids, nnz_used=6)
    assert uniq.tolist() == [3, 7, 9] and uniq.dtype == np.int64
    assert pos.dtype == np.int32
    u0, p0 = dedup_ids(np.array([], np.int32), 0)
    assert u0.size == 0 and p0.size == 0


@pytest.mark.parametrize("n, world", [(1, 1), (7, 3), (48, 5), (1000, 13),
                                      (2, 4)])
def test_row_owners_equal_the_jax_ones(n, world):
    rows = np.arange(n, dtype=np.int64)
    assert np.array_equal(row_owners(n, world, rows),
                          jrow_owners(n, world, rows))
    with pytest.raises(DMLCError):
        row_owners(n, world, np.array([n]))


@pytest.mark.parametrize("n, world, replicas", [(48, 3, 1), (48, 3, 5),
                                                (8, 1, 3), (50, 4, 2)])
def test_the_layout_equals_the_jax_tables(n, world, replicas):
    for rank in range(world):
        t = Table(n, 4, rank=rank, world=world, replicas=replicas)
        j = JaxTable(n, 4, rank=rank, world=world, replicas=replicas)
        assert t.replicas == j.replicas
        assert t.partition == j.partition
        assert t._held_intervals() == j._held_intervals()
        assert [t.holders_of(s) for s in range(world)] == \
            [j.holders_of(s) for s in range(world)]
        assert t.resident_bytes == j.resident_bytes
        assert t.leaf == j.leaf


def test_holders_and_replica_clamp():
    t = Table(48, 4, rank=1, world=3, replicas=1)
    assert t.holders_of(0) == [0, 1]
    assert t.holders_of(2) == [2, 0]
    t5 = Table(48, 4, rank=0, world=3, replicas=5)
    assert t5.replicas == 2
    assert t5.holders_of(1) == [1, 2, 0]
    solo = Table(8, 2, replicas=3)
    assert solo.replicas == 0 and solo.holders_of(0) == [0]


def test_the_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(DMLCError, match="device='cpu'"):
        ShardedEmbeddingTable(8, 2)


# ---------------------------------------------------------------------------
# numerics against the JAX table (world 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed, n, d, rows, nnz, cap, garbage", [
    (3, 64, 4, 6, 40, 64, False),
    (4, 64, 4, 6, 40, 64, True),
    (5, 300, 8, 32, 200, 256, True),
    (6, 5000, 16, 64, 1000, 1500, False),
])
def test_lookup_and_row_grads_match_the_jax_table(seed, n, d, rows, nnz,
                                                  cap, garbage):
    batch = _seeded_batch(seed, n, rows, nnz, cap, garbage=garbage)
    t = Table(n, d, seed=1)
    j = JaxTable(n, d, seed=1)
    got = t.lookup(batch)
    want = np.asarray(j.lookup(batch))
    assert got.dtype == np.float32 and got.shape == (rows, d)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[-2:] == 0).all()                     # padded rows exact 0
    g = np.random.default_rng(seed + 100).standard_normal(
        (rows, d)).astype(np.float32)
    for _ in range(2):                               # accumulates
        assert t.backward(batch, g) == j.backward(batch, g)
    assert sorted(t._pending) == sorted(j._pending)
    for k in j._pending:
        np.testing.assert_allclose(t._pending[k], j._pending[k], rtol=RTOL,
                                   atol=ATOL, err_msg=str(k))


def test_backward_takes_a_tensor_and_flush_applies_sgd():
    import torch
    n, d, rows = 32, 4, 4
    t = Table(n, d, seed=2, lr=0.5)
    j = JaxTable(n, d, seed=2, lr=0.5)
    ref = ShardedEmbeddingTable.reference_rows(n, d, seed=2)
    # row 5 appears twice with vals 2 and 3 in segments 0 and 1
    batch = _ragged(np.array([5, 5, 9]), np.array([2.0, 3.0, 1.0]),
                    np.array([0, 1, 2]), rows)
    g = np.zeros((rows, d), np.float32)
    g[0], g[1], g[2] = 1.0, 10.0, 7.0
    assert t.backward(batch, torch.from_numpy(g)) == 2
    assert j.backward(batch, g) == 2
    assert t.flush_direct() == j.flush_direct() == 2
    np.testing.assert_allclose(
        t.read_block(5, 6)[0], ref[5] - 0.5 * (2.0 * g[0] + 3.0 * g[1]),
        rtol=1e-5)
    np.testing.assert_allclose(t.read_block(0, n), j.read_block(0, n),
                               rtol=1e-5)
    assert t.read_block(6, 7)[0].tobytes() == ref[6].tobytes()  # untouched
    assert t.version == j.version == 1


def test_out_of_range_ids_are_refused():
    t = Table(16, 2)
    with pytest.raises(DMLCError, match="outside"):
        t.lookup(_ragged(np.array([3, 16]), np.ones(2), np.array([0, 1]), 2))


# ---------------------------------------------------------------------------
# exchange plane: tables in one process wired by address injection
# ---------------------------------------------------------------------------

def test_remote_lookup_cache_and_eviction():
    n, d = 32, 4
    ta = Table(n, d, rank=0, world=2, replicas=0, serve=True, cache_rows=8)
    tb = Table(n, d, rank=1, world=2, replicas=0, serve=True)
    try:
        ta.set_addresses({1: ("127.0.0.1", tb.server.port)})
        assert ta.addresses[1][1] == tb.server.port
        ref = ShardedEmbeddingTable.reference_rows(n, d)
        remote = np.arange(16, 32)
        batch = _ragged(remote, np.ones(16), np.arange(16), 16)
        misses0, hits0 = _counter("embed.cache_misses"), _counter(
            "embed.cache_hits")
        np.testing.assert_allclose(ta.lookup(batch), ref[16:32], rtol=1e-5)
        assert _counter("embed.cache_misses") == misses0 + 16
        # LRU keeps only cache_rows=8 of them: a re-lookup hits 8
        np.testing.assert_allclose(ta.lookup(batch), ref[16:32], rtol=1e-5)
        assert _counter("embed.cache_hits") == hits0 + 8
        # a local apply invalidates the cache (rows may be stale)
        ta.apply_update(np.array([0]), np.ones((1, d), np.float32))
        np.testing.assert_allclose(ta.lookup(batch), ref[16:32], rtol=1e-5)
        assert _counter("embed.cache_hits") == hits0 + 8
    finally:
        ta.close()
        tb.close()


def test_replica_failover_when_primary_dies():
    n, d, world = 48, 4, 3
    tables = [Table(n, d, rank=r, world=world, replicas=1, serve=True,
                    cache_rows=0) for r in range(world)]
    try:
        addrs = {r: ("127.0.0.1", t.server.port)
                 for r, t in enumerate(tables)}
        for t in tables:
            t.set_addresses(addrs)
        ref = ShardedEmbeddingTable.reference_rows(n, d)
        s1, e1 = tables[0].partition[1]
        shard1 = np.arange(s1, e1)
        batch = _ragged(shard1, np.ones(len(shard1)),
                        np.arange(len(shard1)), len(shard1))
        tables[1].close()                 # primary of shard 1 dies
        fo0 = _counter("embed.failovers")
        np.testing.assert_allclose(tables[0].lookup(batch), ref[s1:e1],
                                   rtol=1e-5)
        assert _counter("embed.failovers") > fo0
        # rank 2 holds the replica locally — no wire at all
        np.testing.assert_allclose(tables[2].lookup(batch), ref[s1:e1],
                                   rtol=1e-5)
        tables[2].close()
        with pytest.raises(DMLCError, match="no live holder"):
            tables[0].lookup(batch)
    finally:
        for t in tables:
            t.close()


def test_direct_flush_reaches_every_holder():
    n, d, world = 48, 4, 3
    tables = [Table(n, d, rank=r, world=world, replicas=1, serve=True,
                    lr=0.5, cache_rows=0) for r in range(world)]
    try:
        addrs = {r: ("127.0.0.1", t.server.port)
                 for r, t in enumerate(tables)}
        for t in tables:
            t.set_addresses(addrs)
        ref = ShardedEmbeddingTable.reference_rows(n, d)
        full = _identity_batch(n)
        tables[0].backward(full, np.ones((n, d), np.float32))
        assert tables[0].flush_direct() == n * 2 // 3     # its own blocks
        for r, t in enumerate(tables):
            for s, e in t._held_intervals():
                np.testing.assert_allclose(t.read_block(s, e),
                                           ref[s:e] - 0.5, rtol=1e-6,
                                           err_msg=str(r))
    finally:
        for t in tables:
            t.close()


def test_snapshot_budget_and_plan(monkeypatch):
    t = Table(64, 8, rank=0, world=2, replicas=1)
    assert t.plan(t.leaf, (64, 8)) == t.partition[0]
    assert t.plan("dense/w1", (3, 3)) is None
    snap = t.build_snapshot({"dense": {"w": np.ones(3, np.float32)}})
    assert sorted(s for s, _, _ in snap.pieces[t.leaf]) == [0, 32]
    assert snap.schema[t.leaf] == ((64, 8), "float32")
    assert "dense/w" in snap.pieces
    monkeypatch.setenv("DMLC_RESHARD_MAX_BYTES", "64")
    skipped0 = _counter("reshard.snapshot_skipped")
    assert t.build_snapshot() is None
    assert _counter("reshard.snapshot_skipped") == skipped0 + 1


def test_adopt_restored_keeps_wanted_replicas():
    t = Table(48, 4, rank=0, world=3, replicas=1, seed=9)
    ref = ShardedEmbeddingTable.reference_rows(48, 4, seed=9)
    s, e = t.partition[0]
    rs, re_ = t.partition[2]              # rank 0 replicates shard 2
    fresh = ref[s:e] + 1.0
    v0 = t.version
    t.adopt_restored({t.leaf: fresh})
    np.testing.assert_allclose(t.read_block(s, e), fresh)
    assert t.read_block(rs, re_).tobytes() == ref[rs:re_].tobytes()
    assert t.rebuild_replicas() == 0      # nothing missing to refetch
    assert t.version == v0 + 1
    t.adopt_restored(None)                # a non-holder's round: no change
    np.testing.assert_allclose(t.read_block(s, e), fresh)


def test_a_resized_layout_rebuilds_its_replica_from_a_peer():
    """Shrink 3 → 2 ranks: rank 0 adopts its new primary and refetches
    the replica interval it does not hold from the new primary."""
    n, d = 48, 4
    ref = ShardedEmbeddingTable.reference_rows(n, d, seed=3)
    a = Table(n, d, rank=0, world=3, replicas=1, seed=3, serve=True)
    b = Table(n, d, rank=1, world=2, replicas=1, seed=3, serve=True)
    try:
        a.set_layout(0, 2)
        s, e = a.partition[0]
        a.adopt_restored({a.leaf: ref[s:e].copy()})
        a.set_addresses({1: ("127.0.0.1", b.server.port)})
        moved = a.rebuild_replicas()
        rs, re_ = a.partition[1]
        assert moved == (re_ - rs) * d * 4
        assert a.read_block(rs, re_).tobytes() == ref[rs:re_].tobytes()
        assert a.resident_bytes == n * d * 4
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the DMEB1 wire, mixed with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_a_client_of_either_package_reads_the_others_server(server_side):
    n, d = 40, 4
    if server_side == "jax":
        srv = JaxTable(n, d, rank=1, world=2, replicas=0, seed=6, serve=True)
        cli = Table(n, d, rank=0, world=2, replicas=0, seed=6, cache_rows=0)
        x = exchange
    else:
        srv = Table(n, d, rank=1, world=2, replicas=0, seed=6, serve=True)
        cli = JaxTable(n, d, rank=0, world=2, replicas=0, seed=6,
                       cache_rows=0)
        x = jexchange
    try:
        addr = ("127.0.0.1", srv.server.port)
        ref = ShardedEmbeddingTable.reference_rows(n, d, seed=6)
        s, e = srv.partition[1]
        ids = np.array([e - 1, s, s + 3, s + 3], np.int64)
        assert np.array_equal(x.fetch_rows(addr, ids), ref[ids])
        assert np.array_equal(x.fetch_block(addr, s, e), ref[s:e])
        with pytest.raises(DMLCError if x is exchange else Exception,
                           match="cannot serve"):
            x.fetch_rows(addr, np.array([0], np.int64))
        grads = np.ones((2, d), np.float32)
        assert x.send_update(addr, ids[:2], grads, 0.25) == 2
        assert srv.version == 1
        want = ref[ids[:2]] - 0.25
        np.testing.assert_allclose(x.fetch_rows(addr, ids[:2]), want,
                                   rtol=1e-6)
        # the client table's own lookup goes over the wire too
        cli.set_addresses({1: addr})
        batch = _ragged(ids[:2], np.ones(2), np.arange(2), 2)
        np.testing.assert_allclose(np.asarray(cli.lookup(batch)), want,
                                   rtol=1e-6)
    finally:
        srv.close()
        cli.close()


def test_a_mixed_cohort_fails_over_to_a_jax_replica():
    """Shard 1's port primary is gone; a port client reads it from the
    JAX replica holder (rank 2)."""
    n, d, world = 48, 4, 3
    port0 = Table(n, d, rank=0, world=world, replicas=1, cache_rows=0)
    jax2 = JaxTable(n, d, rank=2, world=world, replicas=1, serve=True)
    try:
        port0.set_addresses({1: ("127.0.0.1", 1),       # nobody listens
                             2: ("127.0.0.1", jax2.server.port)})
        ref = ShardedEmbeddingTable.reference_rows(n, d)
        s1, e1 = port0.partition[1]
        rows = np.arange(s1, e1)
        batch = _ragged(rows, np.ones(len(rows)), np.arange(len(rows)),
                        len(rows))
        np.testing.assert_allclose(port0.lookup(batch), ref[s1:e1],
                                   rtol=1e-6)
    finally:
        port0.close()
        jax2.close()


# ---------------------------------------------------------------------------
# real tracker cohort: remote lookup + collective flush determinism
# ---------------------------------------------------------------------------

def _cohort(world, fn, timeout=90):
    tracker = RabitTracker(num_workers=world, host_ip="127.0.0.1")
    tracker.start()
    env = tracker.worker_envs()
    results, errors = [None] * world, [None] * world

    def worker(i):
        ctx = None
        try:
            ctx = RabitContext(env["DMLC_TRACKER_URI"],
                               int(env["DMLC_TRACKER_PORT"]), jobid=f"w{i}",
                               heartbeat_interval=0)
            results[ctx.rank] = fn(ctx, ctx.rank)
        except Exception as e:  # noqa: BLE001
            errors[i] = e
        finally:
            if ctx is not None:
                try:
                    ctx.shutdown()
                except Exception:  # noqa: BLE001
                    pass

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    tracker.join(timeout=30)
    return results, [e for e in errors if e is not None]


@pytest.fixture
def log_context():
    yield
    from dmlc_core_tpu_torch.utils.logging import set_log_context
    set_log_context(rank=None)


def test_cohort_lookup_flush_bit_identical(log_context):
    """3 ranks over a real tracker: every rank looks up the WHOLE table
    (two thirds remote), contributes rank-dependent grads, and after one
    collective flush all ranks observe a bit-identical table equal to
    rank-ordered SGD; every holder's copy of each shard is the same."""
    n, d, world, lr = 48, 4, 3, 0.5
    ref = ShardedEmbeddingTable.reference_rows(n, d, seed=4)

    def fn(ctx, rank):
        t = Table(n, d, rank=rank, world=world, seed=4, lr=lr, replicas=1,
                  serve=True)
        try:
            t.sync_addresses(ctx)
            full = _identity_batch(n)
            pooled = t.lookup(full)
            np.testing.assert_allclose(pooled, ref, rtol=RTOL, atol=ATOL)
            g = np.full((n, d), float(rank + 1), np.float32)
            t.backward(full, g)
            t.flush(ctx)
            after = t.lookup(full)        # cache was dropped by the apply
            blocks = {(s, e): t.read_block(s, e).tobytes()
                      for s, e in t._held_intervals()}
            ctx.allreduce(np.zeros(1, np.float32), "sum")  # pre-close sync
            return after.tobytes(), t.resident_bytes, blocks
        finally:
            t.close()

    results, errors = _cohort(world, fn)
    assert not errors, errors
    assert len({r[0] for r in results}) == 1   # bit-identical across ranks
    after = np.frombuffer(results[0][0], np.float32).reshape(n, d)
    np.testing.assert_allclose(after, ref - lr * 6.0, rtol=1e-5, atol=1e-5)
    total = ref.nbytes
    for _, resident, _ in results:
        assert resident == total * 2 // 3
    held = {}
    for _, _, blocks in results:
        for iv, b in blocks.items():
            held.setdefault(iv, set()).add(b)
    assert len(held) == world and all(len(v) == 1 for v in held.values())
