"""The port's k-step trainer (``FusedTrainer``, ``make_train_step_fused``,
``make_train_step_kbatch``, ``stack_batches``, ``fit_stream``'s routing)
held against the JAX package's on the CPU, where the k steps run eagerly
(the CUDA graphs are held against eager steps on the card, in
``test_torch_cuda.py``).

The files and parameters are those of the JAX package's own fused-trainer
tests (``tests/test_models.py``): FM(60 features, dim 4), Adam(0.05),
1100 rows in 128-row batches (9 steps, a short tail) and a 600-row file
whose nnz swings between packer buckets (10 steps, meta changes).  The
JAX model's ``init(PRNGKey(7))`` is carried over with
``params_from_jax``.  Both packages' native packers cut the same batches,
so both trainers build the same ``(meta, group length)`` graphs.

Tolerances: parameters at ``rtol = 1e-4, atol = 1e-5`` and losses at
``1e-4`` against JAX (Adam trajectories over the same float32 terms summed
in other orders; at lr 0.05 a rounding difference in a gradient near 0
moves a parameter by up to a few 1e-6 a step); the port's k-step
trainer against its own per-step loop exactly (the same operations on
the same values, in the same order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
jnp = jax.numpy

from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.models import FactorizationMachine as JFM  # noqa: E402
from dmlc_core_tpu.models import train as jtrain  # noqa: E402
from dmlc_core_tpu.pipeline import DeviceLoader as JDeviceLoader  # noqa: E402
from dmlc_core_tpu_torch import (DMLCError, FactorizationMachine,  # noqa: E402
                                 FusedTrainer, adam, create_parser)
from dmlc_core_tpu_torch.kernels import common  # noqa: E402
from dmlc_core_tpu_torch.models import (fit_stream,  # noqa: E402
                                        make_train_step,
                                        make_train_step_fused,
                                        make_train_step_kbatch,
                                        params_from_jax, stack_batches)
from dmlc_core_tpu_torch.pipeline import DeviceLoader, pack_flat  # noqa: E402

PARAMS = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = 1e-4
F, DIM, LR = 60, 4, 0.05


def _linear_file(path, n=1100, f=F, seed=3):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=f)
    with open(path, "w") as fh:
        for _ in range(n):
            idx = np.sort(rng.choice(f, size=10, replace=False))
            x = rng.random(10)
            y = 1 if (w_true[idx] * x).sum() > 0 else 0
            fh.write(f"{y} " + " ".join(
                f"{j}:{v:.4f}" for j, v in zip(idx, x)) + "\n")
    return str(path)


def _swinging_file(path, seed=4):
    """Blocks of 64 rows alternate 2 and 30 values a row, so consecutive
    batches fall in other nnz buckets."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(600):
            nnz = 2 if (i // 64) % 2 == 0 else 30
            idx = np.sort(rng.choice(F, size=nnz, replace=False))
            fh.write(f"{i % 2} " + " ".join(
                f"{j}:{v:.3f}" for j, v in zip(idx, rng.random(nnz)))
                + "\n")
    return str(path)


def _jax_fused(path, rows, cap, k, lr=LR):
    model = JFM(num_features=F, dim=DIM)
    loader = JDeviceLoader(jcreate_parser(path), batch_rows=rows,
                           nnz_cap=cap, emit="host")
    try:
        tr = jtrain.FusedTrainer(model, optax.adam(lr), loader, k=k, seed=7)
        loss = tr.run_epoch()
    finally:
        loader.close()
    init = model.init(jax.random.PRNGKey(7))
    return tr, loss, jax.tree_util.tree_map(np.asarray, init)


def _port_model(init):
    model = FactorizationMachine(F, DIM, device="cpu")
    model.load_state_dict(params_from_jax(init, "cpu"))
    return model


def _port_fused(path, rows, cap, k, init, lr=LR):
    model = _port_model(init)
    with DeviceLoader(create_parser(path), rows, cap, device="cpu",
                      emit="host") as loader:
        tr = FusedTrainer(model, adam(model, lr), loader, k=k)
        loss = tr.run_epoch()
    return tr, loss, model


def _assert_params(model, jparams, tol=PARAMS):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_fused_trainer_matches_jax(tmp_path, k):
    path = _linear_file(tmp_path / "lin.libsvm")
    jtr, jloss, init = _jax_fused(path, 128, 2048, k)
    tr, loss, model = _port_fused(path, 128, 2048, k, init)
    assert tr.steps == jtr.steps == 9      # ceil(1100 / 128)
    assert tr.rows_dispatched == jtr.rows_dispatched
    assert set(tr._kstep_cache) == set(jtr._kstep_cache)
    _assert_params(model, jtr.params)
    assert abs(loss - jloss) < LOSS_TOL
    np.testing.assert_allclose(tr.losses.numpy(), np.asarray(jtr.losses),
                               rtol=LOSS_TOL)
    assert tr.params["v"] is model.v and tr.opt_state[0] is \
        tr.optimizer.count


# The swinging file's labels are random: at lr 0.05 Adam's steps on its
# near-zero gradients amplify the packages' rounding differences, and the
# port's per-step loop already sits up to 1e-4 (0.6 % of a factor) from
# JAX's there.  At lr 1e-3 the usual tolerance holds.
SWING_TOL = {0.05: dict(rtol=1e-2, atol=2e-4), 1e-3: PARAMS}


@pytest.mark.parametrize("lr", sorted(SWING_TOL))
def test_fused_trainer_meta_change_matches_jax(tmp_path, lr):
    path = _swinging_file(tmp_path / "var.libsvm")
    jtr, _, init = _jax_fused(path, 64, 64 * 32, 4, lr)
    tr, _, model = _port_fused(path, 64, 64 * 32, 4, init, lr)
    assert tr.steps == jtr.steps == 10     # ceil(600 / 64)
    metas = {meta for meta, _ in tr._kstep_cache}
    assert len(metas) > 1                  # the stream changed buckets
    assert set(tr._kstep_cache) == set(jtr._kstep_cache)
    _assert_params(model, jtr.params, SWING_TOL[lr])


@pytest.mark.parametrize("k", [3, 16])
def test_fused_trainer_is_the_per_step_loop(tmp_path, k):
    """Same batches, same operations in the same order: exactly the
    per-step loop's parameters and losses."""
    path = _swinging_file(tmp_path / "var.libsvm")
    _, _, init = _jax_fused(path, 64, 64 * 32, 1)
    tr, _, model = _port_fused(path, 64, 64 * 32, k, init)
    twin = _port_model(init)
    step = make_train_step(twin, adam(twin, LR))
    with DeviceLoader(create_parser(path), 64, 64 * 32,
                      device="cpu") as loader:
        losses = [step(b) for b in loader]
    assert tr.steps == len(losses) == 10
    assert float(tr.losses[-1]) == float(losses[-1])
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 twin.named_parameters()):
        assert torch.equal(p, q), name
    assert int(tr.optimizer.count) == 10


def test_make_train_step_fused_matches_jax(tmp_path):
    """One k-step call over a stack of wire buffers, against the JAX
    ``make_train_step_fused`` on the same stack."""
    path = _linear_file(tmp_path / "lin.libsvm", n=512)
    with DeviceLoader(create_parser(path), 128, 2048, device="cpu",
                      emit="host") as loader:
        items = list(loader)
    metas = {meta for _, _, meta, _ in items}
    assert len(items) == 4 and len(metas) == 1
    meta = metas.pop()
    from dmlc_core_tpu_torch.pipeline.loader import _fused_words_meta, \
        _decode_meta
    words = _fused_words_meta(128, meta)
    bufs = np.stack([b[:words] for _, b, _, _ in items])
    jm = JFM(num_features=F, dim=DIM)
    jp = jm.init(jax.random.PRNGKey(7))
    opt = optax.adam(LR)
    from dmlc_core_tpu.pipeline.device_loader import _host_segments
    segs = np.stack([_host_segments(b, 128, _decode_meta(meta)[0], words)
                     for b in bufs])
    jkstep = jtrain.make_train_step_fused(jm, opt, rows=128, meta=meta, k=4,
                                          with_segments=True, donate=False)
    jp2, _, jlosses = jkstep(jp, opt.init(jp), jnp.asarray(bufs),
                             jnp.asarray(segs))
    model = _port_model(jax.tree_util.tree_map(np.asarray, jp))
    kstep = make_train_step_fused(model, adam(model, LR), rows=128,
                                  meta=meta, k=4)
    losses = kstep(torch.from_numpy(bufs))
    assert losses.shape == (4,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_TOL)
    _assert_params(model, jax.tree_util.tree_map(np.asarray, jp2))


def _flat_batches(path, n):
    from dmlc_core_tpu_torch.data import RowBlock, parse_libsvm
    with open(path, "rb") as f:
        d = parse_libsvm(f.read())
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"])
    out = []
    for lo in range(0, 128 * n, 128):
        b = pack_flat(blk.slice(lo, lo + 128), 128, 2048)
        b.pop("row_ptr")
        out.append(b)
    return out


def test_kbatch_matches_jax(tmp_path):
    path = _linear_file(tmp_path / "lin.libsvm", n=512)
    batches = _flat_batches(path, 4)
    jm = JFM(num_features=F, dim=DIM)
    jp = jm.init(jax.random.PRNGKey(7))
    opt = optax.adam(LR)
    jkstep = jtrain.make_train_step_kbatch(jm, opt, donate=False)
    st = opt.init(jp)
    jlosses = []
    for part in (batches[:3], batches[3:]):        # k = 3, then k = 1
        jp, st, ls = jkstep(jp, st, jtrain.stack_batches(part))
        jlosses.extend(np.asarray(ls).tolist())
    model = _port_model(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(7))))
    kstep = make_train_step_kbatch(model, adam(model, LR))
    losses = []
    for part in (batches[:3], batches[3:]):
        stacked = stack_batches(part, "cpu")
        assert stacked["ids"].shape == (len(part), 2048)
        losses.extend(kstep(stacked).tolist())
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL)
    _assert_params(model, jax.tree_util.tree_map(np.asarray, jp))
    # tensor leaves stack where they are
    t = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    assert torch.equal(stack_batches(t)["vals"],
                       stack_batches(batches, "cpu")["vals"])
    with pytest.raises(DMLCError, match="disagree on k"):
        kstep({"ids": torch.zeros(2, 3), "vals": torch.zeros(3, 3)})


def test_fit_stream_routes_host_loaders_through_the_fused_trainer(tmp_path):
    path = _linear_file(tmp_path / "lin.libsvm")
    init = jax.tree_util.tree_map(
        np.asarray, JFM(num_features=F, dim=DIM).init(jax.random.PRNGKey(7)))
    model = _port_model(init)
    opt = adam(model, LR)
    with DeviceLoader(create_parser(path), 128, 2048, device="cpu",
                      emit="host") as loader:
        hist = fit_stream(model, loader, epochs=2, optimizer=opt, kstep=4,
                          log_every=1)
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert int(opt.count) == 18             # every batch, both epochs
    twin = _port_model(init)
    with DeviceLoader(create_parser(path), 128, 2048, device="cpu") as ld:
        fit_stream(twin, ld, epochs=2, optimizer=adam(twin, LR),
                   log_every=0)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 twin.named_parameters()):
        assert torch.equal(p, q), name
    with DeviceLoader(create_parser(path), 128, 2048, device="cpu") as ld:
        with pytest.raises(DMLCError, match="kstep requires a loader"):
            fit_stream(twin, ld, kstep=4)


def test_fused_trainer_checks(tmp_path):
    path = _linear_file(tmp_path / "lin.libsvm", n=200)
    model = FactorizationMachine(F, DIM, device="cpu")
    with DeviceLoader(create_parser(path), 128, 2048, device="cpu",
                      emit="host") as loader:
        with pytest.raises(DMLCError, match="k must be >= 1"):
            FusedTrainer(model, adam(model), loader, k=0)
        tr = FusedTrainer(model, adam(model), loader, k=2)
        with pytest.raises(DMLCError, match="fused host items"):
            tr.feed(("arrays", {}, 0, None))
        assert tr.finish() == 0.0 and tr.steps == 0
        tr.run_epoch()
        assert tr.steps == 2 and tr.rows_dispatched == 256  # padded rows


def test_launches_recorded_under_capture_go_to_replays(monkeypatch):
    """A launch made while a stream captures is counted into the open
    recording and reaches the counts only through add_launches (once a
    replay); one recording at a time."""
    common.reset_launch_counts()
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    with common.record_launches() as rec:
        common.count_launch("adam")                 # not capturing: now
        capturing[0] = True
        common.count_launch("adam")
        common.count_launch("ragged_gather_fm")
        with pytest.raises(DMLCError, match="already recording"):
            with common.record_launches():
                pass
    capturing[0] = False
    assert rec == {"adam": 1, "ragged_gather_fm": 1}
    assert common.launch_counts() == {"adam": 1}
    common.add_launches(rec)
    common.add_launches(rec)
    assert common.launch_counts() == {"adam": 3, "ragged_gather_fm": 2}
    capturing[0] = True
    common.count_launch("adam")          # capturing but nothing recording
    assert common.launch_counts()["adam"] == 4
    common.reset_launch_counts()
