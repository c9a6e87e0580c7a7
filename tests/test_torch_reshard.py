"""The port's resharder (``parallel/reshard.py``) held against the JAX
package's: JAX ``tests/test_reshard.py``'s cases run on the port, each
result compared with the JAX package's on the same numpy inputs.

* The snapshot: schema and pieces equal to JAX ``snapshot_tree``'s (0-d
  leaves as one ``(1,)`` row), CPU tensors copied once to numpy, and the
  budget demotion (``reshard.snapshot_skipped``).
* Rebirth: rank 2 of 3 holds nothing and receives every leaf from the
  survivors, ``array_equal`` to the JAX cohort's restored state, with
  the same stats; zero checkpoint reads.
* Shrink 3 -> 2 without a checkpoint: survivors re-partition a
  row-sharded table from each other's shards.
* The checkpoint fallback: a leaf no survivor holds comes from a
  checkpoint the JAX ``CheckpointManager`` wrote, and only that leaf.
* The cohort-wide raise: a gap with no holder and no checkpoint raises
  on every rank (``reshard.failures``).
* Mixed cohorts: JAX and port contexts on one tracker (the pattern of
  ``tests/test_torch_rabit.py``), each running its own package's
  ``redistribute``: JAX survivors serve a reborn port rank and port
  survivors a reborn JAX rank, over the same ``DMRS1`` wire; the
  restored states are ``array_equal``.

Exact equality throughout: nothing is computed, only moved.  Ranks are
threads; every tracker binds 127.0.0.1 and is stopped."""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.parallel import rabit as jrabit  # noqa: E402
from dmlc_core_tpu.parallel import reshard as jreshard  # noqa: E402
from dmlc_core_tpu.utils import logging as jlogging  # noqa: E402
from dmlc_core_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from dmlc_core_tpu_torch.parallel import rabit, reshard, tracker  # noqa: E402
from dmlc_core_tpu_torch.parallel.mesh import row_partition  # noqa: E402
from dmlc_core_tpu_torch.utils import logging as tlogging  # noqa: E402
from dmlc_core_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager, flatten_tree)
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402

CONTEXTS = {"port": rabit.RabitContext, "jax": jrabit.RabitContext}
RESHARD = {"port": reshard, "jax": jreshard}


@pytest.fixture(autouse=True)
def _log_context():
    """Registration stamps ``rank`` on the process's log context: put both
    packages' back."""
    yield
    tlogging.set_log_context(rank=None)
    jlogging.set_log_context(rank=None)


def _cohort(kinds, fn, timeout=60.0):
    """The port's tracker and a context a thread, of the package
    ``kinds[i]``; ``fn(ctx, rank, mod)`` with ``mod`` that package's
    reshard module.  Returns ``(results by rank, errors)``."""
    world = len(kinds)
    t = tracker.RabitTracker(num_workers=world, host_ip="127.0.0.1")
    t.start()
    results, errors = [None] * world, []

    def worker(i):
        ctx = None
        try:
            ctx = CONTEXTS[kinds[i]]("127.0.0.1", t.port, jobid=f"w{i}",
                                     heartbeat_interval=0)
            results[ctx.rank] = fn(ctx, ctx.rank, RESHARD[kinds[i]])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            if ctx is not None:
                try:
                    ctx.shutdown()
                except Exception:  # noqa: BLE001
                    pass

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    t.stop()
    return results, errors


def _equal_trees(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _stats(stats):
    d = stats.as_dict()
    d.pop("wall_s")
    return d


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

TREE = {"w": np.arange(12, dtype=np.float32).reshape(4, 3),
        "b": np.float64(3.5), "step": np.int32(7)}


def test_snapshot_tree_equals_the_jax_snapshot():
    got, want = reshard.snapshot_tree(TREE), jreshard.snapshot_tree(TREE)
    assert got.schema == want.schema
    assert got.schema["b"] == ((), "float64")        # 0-d: one (1,) row
    assert got.nbytes == want.nbytes
    for path in want.pieces:
        (s, e, a), = got.pieces[path]
        (js, je, ja), = want.pieces[path]
        assert (s, e) == (js, je)
        np.testing.assert_array_equal(a, ja)


def test_snapshot_copies_tensors_once_to_numpy():
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(3, 2),
         "n": np.arange(3)}
    snap = reshard.snapshot_tree(t)
    (_, _, w), = snap.pieces["w"]
    (_, _, n), = snap.pieces["n"]
    assert isinstance(w, np.ndarray) and w.dtype == np.float32
    t["w"].add_(100)                      # in-place updates after the copy
    t["n"] += 100
    np.testing.assert_array_equal(w, np.arange(6, dtype=np.float32)
                                  .reshape(3, 2))
    np.testing.assert_array_equal(n, np.arange(3))
    assert snap.schema == jreshard.snapshot_tree(
        {"w": np.zeros((3, 2), np.float32), "n": np.arange(3)}).schema


def test_snapshot_budget_demotes_to_non_holder():
    before = metrics.counter("reshard.snapshot_skipped").value
    big = {"w": np.zeros((1024, 1024), np.float32)}       # 4 MiB
    assert reshard.snapshot_tree(big, max_bytes=1 << 20) is None
    assert jreshard.snapshot_tree(big, max_bytes=1 << 20) is None
    assert metrics.counter("reshard.snapshot_skipped").value == before + 1
    assert reshard.snapshot_tree(big, max_bytes=1 << 23) is not None


def test_host_snapshot_schema_conflict_raises():
    snap = reshard.HostSnapshot()
    snap.add("t", np.zeros((2, 3), np.float32), start=0, global_rows=4)
    with pytest.raises(DMLCError, match="schema conflict"):
        snap.add("t", np.zeros((2, 3), np.float64), start=2, global_rows=4)


# ---------------------------------------------------------------------------
# the cohort protocol, each case against the JAX cohort's outcome
# ---------------------------------------------------------------------------

STATE = {"params": {"w": np.arange(24, dtype=np.float32).reshape(6, 4),
                    "b": np.float64(1.25)},
         "step": np.int32(7)}


def _rebirth(ctx, rank, mod):
    snap = mod.snapshot_tree(STATE) if rank != 2 else None
    return mod.redistribute(ctx, snap, template=STATE, generation=1)


def test_redistribute_rebirth_equals_the_jax_cohort():
    got, errors = _cohort(["port"] * 3, _rebirth)
    assert not errors, errors
    want, errors = _cohort(["jax"] * 3, _rebirth)
    assert not errors, errors
    for rank, ((restored, stats), (jrestored, jstats)) in enumerate(
            zip(got, want)):
        _equal_trees(restored, jrestored)
        _equal_trees(restored, STATE)
        assert restored["params"]["b"].shape == ()       # 0-d survives
        assert _stats(stats) == _stats(jstats)
        assert stats.leaves_from_checkpoint == 0
        if rank == 2:
            assert stats.leaves_from_peers == 3
            assert stats.bytes_moved == 24 * 4 + 8 + 4
        else:
            assert stats.leaves_local == 3 and stats.bytes_moved == 0


def _shrink(ctx, rank, mod):
    table = np.arange(27, dtype=np.float32).reshape(9, 3)
    old, new = row_partition(9, 3), row_partition(9, 2)
    snap = mod.HostSnapshot()
    s, e = old[rank]
    snap.add("table", table[s:e], start=s, global_rows=9)

    def plan(path, gshape):
        return new[rank] if rank < 2 else (0, 0)

    return mod.redistribute(ctx, snap, plan=plan, generation=1)


@pytest.mark.parametrize("kinds", [["port"] * 3, ["jax", "port", "jax"],
                                   ["port", "jax", "port"]])
def test_redistribute_shrink_without_checkpoint(kinds):
    got, errors = _cohort(kinds, _shrink)
    assert not errors, errors
    want, errors = _cohort(["jax"] * 3, _shrink)
    assert not errors, errors
    table = np.arange(27, dtype=np.float32).reshape(9, 3)
    for rank in (0, 1):
        restored, stats = got[rank]
        s, e = row_partition(9, 2)[rank]
        np.testing.assert_array_equal(restored["table"], table[s:e])
        np.testing.assert_array_equal(restored["table"],
                                      want[rank][0]["table"])
        assert stats.leaves_from_checkpoint == 0
        assert stats.bytes_moved == want[rank][1].bytes_moved > 0
    restored, stats = got[2]                             # departing rank
    assert restored is None and want[2][0] is None
    assert stats.leaves_from_checkpoint == 0


def test_redistribute_falls_back_to_a_jax_checkpoint(tmp_path):
    """A leaf NO survivor holds comes from the checkpoint the JAX
    package wrote — and only that leaf."""
    held = {"kept": np.full((4, 2), 3.0, np.float32)}
    lost = {"kept": held["kept"], "lost": np.arange(5, dtype=np.float64)}
    JCheckpointManager(str(tmp_path)).save(3, lost)

    def fn(ctx, rank, mod):
        snap = mod.snapshot_tree(held)
        if rank == 0:
            snap.schema["lost"] = ((5,), "float64")      # advertised, empty
        mgr = (CheckpointManager if mod is reshard else
               JCheckpointManager)(str(tmp_path))
        return mod.redistribute(ctx, snap, checkpoint=mgr, generation=2)

    for kinds in (["port", "port"], ["jax", "port"]):
        got, errors = _cohort(kinds, fn)
        assert not errors, errors
        for restored, stats in got:
            np.testing.assert_array_equal(restored["lost"],
                                          np.arange(5, dtype=np.float64))
            assert stats.leaves_from_checkpoint == 1
            np.testing.assert_array_equal(restored["kept"], held["kept"])


def test_redistribute_unrecoverable_raises_cohort_wide():
    held = {"w": np.ones((2, 2), np.float32)}

    def fn(ctx, rank, mod):
        snap = mod.snapshot_tree(held)
        if rank == 0:
            snap.schema["ghost"] = ((3,), "float32")     # nobody has it
        return mod.redistribute(ctx, snap, generation=3)

    before = metrics.counter("reshard.failures").value
    _, errors = _cohort(["port", "port"], fn)
    assert len(errors) == 2
    assert all(isinstance(e, DMLCError) for e in errors)
    assert all("unrecoverable" in str(e) for e in errors)
    assert metrics.counter("reshard.failures").value >= before + 2


# ---------------------------------------------------------------------------
# mixed cohorts: a survivor of one package serves a reborn rank of the other
# ---------------------------------------------------------------------------

def _mixed_state():
    rng = np.random.default_rng(11)
    return {"params": {"v": rng.standard_normal((64, 8)).astype(np.float32),
                       "w": rng.standard_normal(64).astype(np.float32),
                       "w0": np.float32(0.5)},
            "opt_state": ((np.int32(3),
                           {"v": rng.random((64, 8)).astype(np.float32)}),
                          ())}


@pytest.mark.parametrize("kinds,reborn", [
    (["jax", "jax", "port"], "port"),
    (["port", "port", "jax"], "jax"),
    (["jax", "port", "port"], "port"),
])
def test_a_survivor_serves_a_reborn_rank_of_the_other_package(kinds,
                                                              reborn):
    state = _mixed_state()

    def fn(ctx, rank, mod):
        snap = mod.snapshot_tree(state) if rank != 2 else None
        restored, stats = mod.redistribute(ctx, snap, template=state,
                                           generation=1)
        return restored, stats, mod is reshard

    got, errors = _cohort(kinds, fn)
    assert not errors, errors
    restored, stats, is_port = got[2]
    assert is_port == (reborn == "port")
    _equal_trees(restored, state)
    assert stats.leaves_from_peers == 5 and stats.leaves_from_checkpoint == 0
    assert stats.bytes_moved == sum(a.nbytes for a in
                                    flatten_tree(state).values())
    for r in (0, 1):
        _equal_trees(got[r][0], state)
        assert got[r][1].leaves_local == 5
