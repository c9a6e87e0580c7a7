"""The port's asynchronous checkpoints and leaf-granular restore
(``utils/checkpoint.py``), held against the JAX package on the CPU.

* ``save_async`` writes the bytes ``save`` writes for the same state (a
  FactorizationMachine's params and its Adam state as the CLI builds
  them: the tensors themselves), is unchanged by an in-place update made
  right after the call (the writer held back until the update is done),
  and the JAX ``CheckpointManager`` restores it with ``optax.adam``'s
  template; a JAX ``save_async`` checkpoint restores in the port.
* One save in flight at a time; a failed background save is raised by
  ``wait()`` and by the next ``save_async``.
* On the fake S3 (the JAX package's, on loopback): ``save_async`` writes
  the bytes of a local ``save`` through multipart parts and the JAX
  manager restores them; a part that fails past its retries mid-write
  publishes nothing, and the manifest keeps the last checkpoint.
* ``flatten_tree``, ``unflatten_like``, ``load_pytree_leaves``,
  ``restore_leaves`` and ``fast_forward`` against the JAX functions, and
  the JAX package's own checkpoint tests on the port's module.
"""

import io
import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import test_checkpoint as jax_ckpt_tests  # noqa: E402
from dmlc_core_tpu.models import FactorizationMachine as JFM  # noqa: E402
from dmlc_core_tpu.utils import checkpoint as jckpt  # noqa: E402
from dmlc_core_tpu_torch.models import (FactorizationMachine,  # noqa: E402
                                        adam, adam_state_to_optax,
                                        make_train_step, params_to_numpy)
from dmlc_core_tpu_torch.models.convert import params_tree  # noqa: E402
from dmlc_core_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from test_torch_remote_filesys import S3, s3_server  # noqa: E402,F401

F, D = 512, 4

# the cases that drive jax arrays, the JAX model and loader, orbax, a
# mesh, or patch the JAX module's internals have port counterparts below
_NOT_REPLAYED = ("test_pytree_jax_arrays_roundtrip_as_numpy",
                 "test_train_interrupt_resume", "test_orbax_interop_roundtrip",
                 "test_checkpoint_of_mesh_sharded_params",
                 "test_async_save_matches_sync",
                 "test_async_save_serializes_and_surfaces_errors",
                 "test_manager_crash_safety")
CASES = sorted(n for n in dir(jax_ckpt_tests)
               if n.startswith("test_") and n not in _NOT_REPLAYED)


@pytest.mark.parametrize("case", CASES)
def test_checkpoint_passes_the_jax_cases(case, monkeypatch, request):
    for name in ("CheckpointManager", "fast_forward", "load_pytree",
                 "save_pytree", "DMLCError"):
        monkeypatch.setattr(jax_ckpt_tests, name, getattr(ckpt, name, None)
                            or DMLCError)
    fn = getattr(jax_ckpt_tests, case)
    fn(**{a: request.getfixturevalue(a)
          for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


def _trained_fm(steps=3):
    """A FactorizationMachine after ``steps`` Adam steps on a seeded
    batch, and its optimizer."""
    gen = torch.Generator().manual_seed(0)
    model = FactorizationMachine(num_features=F, dim=D, device="cpu",
                                 generator=gen)
    opt = adam(model, 1e-2)
    rng = np.random.default_rng(1)
    nnz, rows = 40, 8
    batch = {
        "ids": torch.from_numpy(rng.integers(0, F, nnz).astype(np.int32)),
        "vals": torch.from_numpy(rng.random(nnz).astype(np.float32)),
        "segments": torch.from_numpy(np.sort(rng.integers(0, rows, nnz))
                                     .astype(np.int32)),
        "labels": torch.from_numpy((rng.random(rows) < .5)
                                   .astype(np.float32)),
        "weights": torch.ones(rows),
    }
    batch["row_ptr"] = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(batch["segments"].numpy(),
                                    minlength=rows))]).astype(np.int32))
    step = make_train_step(model, opt)
    for _ in range(steps):
        step(batch)
    return model, opt


def _state(model, opt):
    return {"params": params_tree(model),
            "opt_state": adam_state_to_optax(model, opt, host=False)}


def test_save_async_writes_the_bytes_of_save(tmp_path):
    model, opt = _trained_fm()
    sync = ckpt.CheckpointManager(str(tmp_path / "sync"))
    sync.save(3, _state(model, opt), meta={"model": "fm"})
    asy = ckpt.CheckpointManager(str(tmp_path / "async"))
    asy.save_async(3, _state(model, opt), meta={"model": "fm"})
    assert asy.wait() == str(tmp_path / "async" / "ckpt-3.bin")
    assert asy.wait() is None                      # nothing in flight
    a = (tmp_path / "sync" / "ckpt-3.bin").read_bytes()
    b = (tmp_path / "async" / "ckpt-3.bin").read_bytes()
    assert a == b
    # the numpy form of the same state writes the same bytes too
    buf = io.BytesIO()
    ckpt.save_pytree(buf, {"params": params_to_numpy(model, nested=True),
                           "opt_state": adam_state_to_optax(model, opt)})
    assert buf.getvalue() == a


def test_save_async_is_a_snapshot_of_the_call(tmp_path, monkeypatch):
    """The writer is held back until the parameters and moments have
    been updated in place after the call: the checkpoint still holds the
    state at the call."""
    model, opt = _trained_fm()
    ref = ckpt.CheckpointManager(str(tmp_path / "ref"))
    ref.save(3, _state(model, opt))
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    go = threading.Event()
    real = ckpt.CheckpointManager.save

    def held(self, *a, **kw):
        assert go.wait(30)
        return real(self, *a, **kw)

    monkeypatch.setattr(ckpt.CheckpointManager, "save", held)
    mgr.save_async(3, _state(model, opt))
    with torch.no_grad():                       # in place, as Adam writes
        for p in model.parameters():
            p.add_(1.0)
        for m in opt.mu + opt.nu:
            m.mul_(-2.0)
        opt.count.add_(5)
    go.set()
    mgr.wait()
    assert ((tmp_path / "ck" / "ckpt-3.bin").read_bytes()
            == (tmp_path / "ref" / "ckpt-3.bin").read_bytes())


@pytest.fixture
def small_parts(monkeypatch):
    """4 KiB multipart parts (S3's own floor is 5 MiB) and millisecond
    backoff, so a small state spans several parts and retries are
    quick."""
    from dmlc_core_tpu_torch.io import remote_filesys as rfs
    monkeypatch.setattr(rfs._s3_fs, "_part_size", 4096)
    monkeypatch.setenv("DMLC_IO_BACKOFF_BASE", "0.001")
    monkeypatch.setenv("DMLC_IO_BACKOFF_MAX", "0.01")


def test_save_async_to_s3_writes_the_bytes_of_save(tmp_path, s3_server,
                                                   small_parts):
    model, opt = _trained_fm()
    ckpt.CheckpointManager(str(tmp_path / "sync")).save(
        3, _state(model, opt), meta={"model": "fm"})
    mgr = ckpt.CheckpointManager("s3://bkt/run")
    mgr.save_async(3, _state(model, opt), meta={"model": "fm"})
    assert mgr.wait() == "s3://bkt/run/ckpt-3.bin"
    want = (tmp_path / "sync" / "ckpt-3.bin").read_bytes()
    assert S3.objects["bkt/run/ckpt-3.bin"] == want
    assert len(want) > 4 * 4096 and max(S3.part_attempts) == \
        -(-len(want) // 4096) and S3.uploads == {}
    jmgr = jckpt.CheckpointManager("s3://bkt/run")
    step, state = jmgr.restore()
    assert step == 3 and jmgr.meta(3) == {"model": "fm"}
    a = ckpt.flatten_tree(state)
    b = ckpt.flatten_tree(_state(model, opt))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_part_fault_mid_write_publishes_nothing(s3_server, small_parts):
    model, opt = _trained_fm()
    mgr = ckpt.CheckpointManager("s3://bkt/run")
    mgr.save(1, _state(model, opt))
    manifest = S3.objects["bkt/run/MANIFEST.json"]
    S3.part_attempts.clear()
    S3.fail_next = ["part"] * 5            # the first part, past retries
    mgr.save_async(2, _state(model, opt))
    with pytest.raises(DMLCError, match="async checkpoint save failed"):
        mgr.wait()
    assert S3.part_attempts == [1, 1, 1]   # three tries of part 1
    assert "bkt/run/ckpt-2.bin" not in S3.objects
    assert S3.uploads == {}                # the upload was aborted
    assert S3.objects["bkt/run/MANIFEST.json"] == manifest
    assert mgr.steps == [1] and mgr.restore()[0] == 1


def test_save_async_restores_in_jax_and_back(tmp_path):
    model, opt = _trained_fm()
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"))
    mgr.save_async(3, _state(model, opt), meta={"model": "fm"})
    mgr.wait()
    jm = JFM(F, D)
    params = jm.init(jax.random.PRNGKey(0))
    template = {"params": params, "opt_state": optax.adam(1e-2).init(params)}
    step, state = jckpt.CheckpointManager(str(tmp_path / "port")).restore(
        template=template)
    assert step == 3
    adam_state, _ = state["opt_state"]
    assert type(adam_state).__name__ == "ScaleByAdamState"
    assert int(adam_state.count) == 3 and adam_state.count.dtype == np.int32
    want = ckpt.flatten_tree(_state(model, opt))
    got = jckpt.flatten_tree(state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a JAX save_async checkpoint of that state restores in the port
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save_async(3, state, meta={"model": "fm"})
    jmgr.wait()
    step, back = ckpt.CheckpointManager(str(tmp_path / "jax")).restore()
    assert step == 3
    assert ckpt.flatten_tree(back).keys() == want.keys()
    for k, v in ckpt.flatten_tree(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_save_async_serializes_and_raises_what_failed(tmp_path,
                                                      monkeypatch):
    m = ckpt.CheckpointManager(str(tmp_path / "ck"))
    for step in (1, 2, 3):
        m.save_async(step, {"x": torch.full((1000,), float(step))})
    m.wait()
    assert m.steps == [1, 2, 3]
    for step in (1, 2, 3):
        assert m.restore(step)[1]["x"][0] == step
    bad = ckpt.CheckpointManager(str(tmp_path / "bad"))

    def boom(name, write_fn):
        raise OSError("store write refused")

    monkeypatch.setattr(bad, "_publish", boom)
    bad.save_async(1, {"x": np.zeros(2)})
    with pytest.raises(DMLCError, match="async checkpoint save failed"):
        bad.wait()
    bad.save_async(2, {"x": np.zeros(2)})
    with pytest.raises(DMLCError, match="async checkpoint save failed"):
        bad.save_async(3, {"x": np.zeros(2)})
    assert bad.steps == []
    with pytest.raises(DMLCError, match="cannot checkpoint"):
        m.save_async(4, {"x": object()})
        m.wait()


def test_failed_save_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.ones(3)})
    real = ckpt.save_pytree

    def exploding(stream, tree):
        real(stream, {"partial": np.ones(1)})
        raise RuntimeError("disk died")

    monkeypatch.setattr(ckpt, "save_pytree", exploding)
    with pytest.raises(RuntimeError):
        mgr.save(2, {"w": np.zeros(3)})
    mgr.save_async(2, {"w": np.zeros(3)})
    with pytest.raises(DMLCError, match="disk died"):
        mgr.wait()
    monkeypatch.setattr(ckpt, "save_pytree", real)
    assert mgr.latest_step == 1
    np.testing.assert_array_equal(mgr.restore()[1]["w"], np.ones(3))
    assert all(not f.startswith(".ckpt") for f in os.listdir(tmp_path))


def _tree():
    rng = np.random.default_rng(2)
    return {"params": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                       "b": np.float64(2.5),
                       "cross": {"w": torch.arange(6.0).reshape(2, 3)}},
            "opt": ((np.int32(4), [np.ones(3, np.int64)]), ()),
            "step": 9, "name": "fm", "none": None}


def test_flatten_and_unflatten_match_jax():
    tree = _tree()
    ours = ckpt.flatten_tree(tree)
    theirs = jckpt.flatten_tree({**tree, "params": {
        **tree["params"], "cross": {"w": tree["params"]["cross"]["w"]
                                    .numpy()}}})
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    back = ckpt.unflatten_like(tree, ours)
    jback = jckpt.unflatten_like(tree, theirs)
    assert ckpt.flatten_tree(back).keys() == ours.keys()
    assert back["step"] == jback["step"] == 9 and back["none"] is None
    assert isinstance(back["opt"], tuple) and back["opt"][1] == ()
    with pytest.raises(DMLCError, match="missing leaf"):
        ckpt.unflatten_like(tree, {})
    with pytest.raises(DMLCError, match="duplicate"):
        ckpt.flatten_tree({"a/b": np.ones(1), "a": {"b": np.ones(1)}})


def test_leaves_restore_across_the_packages(tmp_path):
    tree = _tree()
    paths = ["params/w", "opt/0/1/0", "params/cross/w", "absent"]
    for writer, reader in ((ckpt, jckpt), (jckpt, ckpt)):
        d = tmp_path / writer.__name__.split(".")[0]
        t = tree if writer is ckpt else jckpt.unflatten_like(
            tree, ckpt.flatten_tree(tree))
        writer.CheckpointManager(str(d)).save(7, t)
        step, got = reader.CheckpointManager(str(d)).restore_leaves(paths)
        assert step == 7 and sorted(got) == sorted(paths[:3])
        for k in got:
            np.testing.assert_array_equal(got[k],
                                          ckpt.flatten_tree(tree)[k])
        with open(d / "ckpt-7.bin", "rb") as f:
            assert reader.load_pytree_leaves(f, ["params/b"])[
                "params/b"].shape == ()


class _Batches:
    def __init__(self, n):
        self.n, self.i = n, 0

    def next_batch(self):
        if self.i >= self.n:
            return None
        self.i += 1
        return self.i


@pytest.mark.parametrize("n,skip", [(5, 3), (5, 9), (0, 2)])
def test_fast_forward_matches_jax(n, skip):
    ours, theirs = _Batches(n), _Batches(n)
    assert ckpt.fast_forward(ours, skip) == jckpt.fast_forward(theirs, skip)
    assert ours.next_batch() == theirs.next_batch()


def test_serializable_protocol():
    class Thing(ckpt.Serializable):
        pass
    with pytest.raises(NotImplementedError):
        Thing().save(io.BytesIO())
    with pytest.raises(NotImplementedError):
        Thing().load(io.BytesIO())
