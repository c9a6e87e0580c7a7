"""The port's DCNv2, training loop, evaluation and checkpoints, held
against the JAX package on the CPU.

Batches are packed once (the port's packing is bit-equal to the JAX
package's, see ``test_torch_pipeline.py``) and handed to both packages;
JAX-initialised parameters are carried across with ``params_from_jax``.
The JAX DCNv2 runs with ``engine="pallas"``, so its row-major gather is
the Pallas embed-bag kernel in interpret mode with its custom VJP.

Tolerances: ``rtol = 1e-5, atol = 1e-6`` for forward values and one
step's gradients (the same float32 terms summed in other orders);
``rtol = 1e-4`` for 5-step Adam loss trajectories, whose rounding
differences grow step by step; final parameters at ``rtol = 1e-4,
atol = 1e-6``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
jnp = jax.numpy

from dmlc_core_tpu.models import dcn as jdcn  # noqa: E402
from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu.models import train as jtrain  # noqa: E402
from dmlc_core_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from dmlc_core_tpu_torch import CheckpointManager  # noqa: E402
from dmlc_core_tpu_torch.data import RowBlock, parse_libsvm  # noqa: E402
from dmlc_core_tpu_torch.models import (DCNv2,  # noqa: E402
                                        FactorizationMachine, adam,
                                        auc_from_histograms, evaluate_stream,
                                        fit_stream, make_eval_step,
                                        make_train_step, params_from_jax,
                                        params_to_numpy, streaming_auc)
from dmlc_core_tpu_torch.pipeline import (pack_flat,  # noqa: E402
                                          pack_rowmajor)

F = 4096
D = 8
L = 2
ROWS, CAP, K_CAP = 16, 128, 8
TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_engine_pin(monkeypatch):
    monkeypatch.delenv("DMLC_EMBED_ENGINE", raising=False)


def _text(rows: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(2, 9))
        idx = np.sort(rng.choice(F + 8, size=n, replace=False))
        idx[0] = F + 3 if i % 5 == 0 else idx[0]  # an id past the table
        toks = b" ".join(b"%d:%.4f" % (j, v) for j, v in
                         zip(idx.tolist(), rng.random(n).tolist()))
        lines.append(b"%d " % (i & 1) + toks)
    return b"\n".join(lines) + b"\n"


def _batches(layout: str, n: int, seed: int = 0):
    d = parse_libsvm(_text(ROWS * n - 3, seed))       # last batch padded
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"])
    out = []
    for lo in range(0, blk.size, ROWS):
        piece = blk.slice(lo, min(lo + ROWS, blk.size))
        if layout == "flat":
            b = pack_flat(piece, ROWS, CAP)
            b.pop("row_ptr")
        else:
            b = pack_rowmajor(piece, ROWS, K_CAP)
        out.append(b)
    return out


def _to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _dcn_pair(l2=1e-4, seed=0):
    jm = jdcn.DCNv2(F, D, L, l2=l2, engine="pallas")
    jp = jm.init(jax.random.PRNGKey(seed))
    # a non-zero linear term and biases, so every parameter is exercised
    rng = np.random.default_rng(seed)
    jp = _np_tree(jp)
    jp["w"] = (rng.normal(size=F) * 0.1).astype(np.float32)
    jp["cross"]["b"] = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
    jp["w0"] = np.float32(0.05)
    tm = DCNv2(F, D, L, l2=l2, device="cpu")
    tm.load_state_dict(params_from_jax(jp, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, jp), tm


def _fm_pair(seed=0):
    jm = jsparse.FactorizationMachine(F, D, l2=1e-4)
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    jp["w"] = (np.random.default_rng(seed).normal(size=F) * 0.1
               ).astype(np.float32)
    tm = FactorizationMachine(F, D, l2=1e-4, device="cpu")
    tm.load_state_dict(params_from_jax(jp, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, jp), tm


# ---------------------------------------------------------------------------
# DCNv2
# ---------------------------------------------------------------------------

def test_dcn_parameter_names_map_onto_the_jax_tree():
    jm, jp, tm = _dcn_pair()
    sd = tm.state_dict()
    want = dict(_flat_items(_np_tree(jp)))
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_dcn_forward_matches_jax(layout):
    jm, jp, tm = _dcn_pair()
    b = _batches(layout, 1)[0]
    want = jm.forward(jp, _to_jax(b))
    got = tm(_to_torch(b))
    assert got.shape == (ROWS,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_dcn_loss_grads_match_jax(layout):
    jm, jp, tm = _dcn_pair()
    b = _batches(layout, 1)[0]
    jloss, jg = jax.value_and_grad(jm.loss)(jp, _to_jax(b))
    loss = tm.loss(_to_torch(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(_flat_items(_np_tree(jg)))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], **TOL,
                                   err_msg=name)


def test_dcn_init_draws_from_the_generator():
    a = DCNv2(F, D, L, device="cpu",
              generator=torch.Generator().manual_seed(3))
    b = DCNv2(F, D, L, device="cpu",
              generator=torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    assert abs(float(a.v.detach().std()) - 0.01) < 1e-3
    assert abs(float(a.cross.w.detach().std()) - D ** -0.5) < 0.1
    assert float(a.w.detach().abs().sum()) == 0.0 and a.head.b.shape == ()


# ---------------------------------------------------------------------------
# Adam trajectories
# ---------------------------------------------------------------------------

def test_adam_matches_optax_including_eps():
    """Gradients of very different sizes, with some far below eps, so a
    wrong place for eps (inside the square root) would show."""
    g = np.array([1e-12, 3e-9, -1e-8, 2e-3, -0.5, 40.0], np.float32)
    p0 = np.linspace(-1, 1, 6).astype(np.float32)
    opt = optax.adam(1e-3)
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = adam(torch.nn.ParameterList([tp]), 1e-3)
    for k in range(4):
        gk = g * (k + 1)
        upd, st = opt.update(jnp.asarray(gk), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(gk.copy())
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-9)


def _trajectory(jm, jp, tm, batches, steps=5):
    opt = optax.adam(1e-3)
    jstep = jtrain.make_train_step(jm, opt, donate=False)
    st = opt.init(jp)
    tstep = make_train_step(tm, adam(tm, 1e-3))
    jl, tl = [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        jp, st, loss = jstep(jp, st, _to_jax(b))
        jl.append(float(loss))
        loss_t = tstep(_to_torch(b))
        assert loss_t.dim() == 0 and not loss_t.requires_grad
        tl.append(float(loss_t))
    return np.array(jl), np.array(tl), jp


@pytest.mark.parametrize("model,layout", [("dcn", "flat"),
                                          ("dcn", "rowmajor"),
                                          ("fm", "flat")])
def test_adam_trajectory_matches_jax(model, layout):
    jm, jp, tm = _dcn_pair() if model == "dcn" else _fm_pair()
    jl, tl, jp = _trajectory(jm, jp, tm, _batches(layout, 3))
    np.testing.assert_allclose(tl, jl, **TRAJ)
    assert jl[-1] < jl[0]
    want = dict(_flat_items(_np_tree(jp)))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   **PARAMS, err_msg=name)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def test_streaming_auc_and_histograms_match_jax():
    rng = np.random.default_rng(1)
    scores = rng.normal(size=200).astype(np.float32) * 3
    labels = rng.integers(0, 2, 200).astype(np.float32)
    weights = rng.random(200).astype(np.float32)
    jpos, jneg = jtrain.streaming_auc(*map(jnp.asarray,
                                           (scores, labels, weights)))
    pos, neg = streaming_auc(*map(torch.from_numpy,
                                  (scores, labels, weights)))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(jneg), **TOL)
    np.testing.assert_allclose(float(auc_from_histograms(pos, neg)),
                               float(jtrain.auc_from_histograms(jpos, jneg)),
                               **TOL)


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_evaluate_stream_matches_jax(layout):
    jm, jp, tm = _dcn_pair()
    batches = _batches(layout, 3, seed=4)
    want = jtrain.evaluate_stream(jm, jp, [_to_jax(b) for b in batches])
    got = evaluate_stream(tm, [_to_torch(b) for b in batches])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], **TOL)
    np.testing.assert_allclose(got["weight"], want["weight"], **TOL)
    np.testing.assert_allclose(got["auc"], want["auc"], **TOL)
    c, t = make_eval_step(tm)(_to_torch(batches[0]))
    jc, jt = jtrain.make_eval_step(jm)(jp, _to_jax(batches[0]))
    assert float(c) == float(jc) and float(t) == float(jt)


class _ListLoader:
    def __init__(self, batches):
        self.batches, self.rewinds = batches, 0

    def __iter__(self):
        return iter(self.batches)

    def before_first(self):
        self.rewinds += 1


def test_fit_stream_runs_the_per_step_loop():
    _, _, tm = _dcn_pair()
    batches = [_to_torch(b) for b in _batches("rowmajor", 2)]
    before = float(tm.loss(batches[0]).detach())
    loader = _ListLoader(batches)
    hist = fit_stream(tm, loader, epochs=3, optimizer=adam(tm, 1e-2),
                      log_every=2)
    assert loader.rewinds == 3 and len(hist) == 3
    assert float(tm.loss(batches[0]).detach()) < before


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_nested_params_roundtrip():
    _, jp, tm = _dcn_pair()
    tree = params_to_numpy(tm, nested=True)
    assert set(tree) == {"w0", "w", "v", "cross", "head"}
    assert set(tree["cross"]) == {"w", "b"} and tree["head"]["b"].shape == ()
    back = DCNv2(F, D, L, device="cpu")
    back.load_state_dict(params_from_jax(tree, "cpu"))
    for (k, x), (_, y) in zip(tm.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(x, y), k
    assert set(params_to_numpy(tm)) == set(tm.state_dict())


def test_port_dcn_checkpoint_restores_in_jax(tmp_path):
    jm, jp, tm = _dcn_pair()
    b = _batches("rowmajor", 1)[0]
    make_train_step(tm, adam(tm, 1e-2))(_to_torch(b))    # moved off init
    CheckpointManager(str(tmp_path)).save(
        7, {"params": params_to_numpy(tm, nested=True)},
        meta={"model": "dcn"})
    mgr = JCheckpointManager(str(tmp_path))
    step, state = mgr.restore(template={"params": jp})
    assert step == 7 and mgr.meta(7) == {"model": "dcn"}
    restored = state["params"]
    want = dict(_flat_items(restored))
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
    np.testing.assert_allclose(
        np.asarray(jm.forward(jax.tree_util.tree_map(jnp.asarray, restored),
                              _to_jax(b))),
        tm(_to_torch(b)).detach().numpy(), **TOL)
