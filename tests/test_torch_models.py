"""The PyTorch port's sparse models, held against the JAX package on the
CPU with the same weights (carried over by ``params_from_jax``).

Tolerance ``rtol = atol = 1e-5`` on scores and losses: both packages sum
the same float32 terms in different orders.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu_torch.models import (FactorizationMachine,  # noqa: E402
                                        SparseLogReg, params_from_jax,
                                        params_to_numpy, task_loss,
                                        weighted_bce, weighted_mse)
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

F = 2048
TOL = dict(rtol=1e-5, atol=1e-5)


def _fm_params(rng, D):
    return {"w0": np.asarray(0.25, np.float32),
            "w": (rng.normal(size=F) * 0.3).astype(np.float32),
            "v": (rng.normal(size=(F, D)) * 0.2).astype(np.float32)}


def _batch(rng, layout, labels, rows=12, K=6, cap=96):
    """One batch in both layouts' conventions: flat pads at the scratch
    row, row-major pads with id 0 / value 0; the last two rows are
    padding rows of weight 0."""
    counts = rng.integers(0, K + 1, rows)
    lab = rng.integers(0, 2, rows).astype(np.float32)
    if labels == "pm1":
        lab = 2 * lab - 1
    elif labels == "real":
        lab = rng.normal(size=rows).astype(np.float32)
    weights = np.ones(rows, np.float32)
    weights[-2:] = 0.0
    if layout == "rowmajor":
        ids = np.zeros((rows, K), np.int32)
        vals = np.zeros((rows, K), np.float32)
        for r, c in enumerate(counts):
            ids[r, :c] = rng.integers(0, F, c)
            vals[r, :c] = rng.normal(size=c)
        return {"ids": ids, "vals": vals, "labels": lab, "weights": weights}
    nnz = int(counts.sum())
    ids = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    segs = np.full(cap, rows, np.int32)
    ids[:nnz] = rng.integers(0, F, nnz)
    vals[:nnz] = rng.normal(size=nnz)
    segs[:nnz] = np.repeat(np.arange(rows), counts)
    return {"ids": ids, "vals": vals, "segments": segs, "labels": lab,
            "weights": weights}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
@pytest.mark.parametrize("D", [8, 32])
def test_fm_forward_matches_jax(layout, D):
    rng = np.random.default_rng(D)
    p = _fm_params(rng, D)
    jb, tb = _both(_batch(rng, layout, "01"))
    want = jsparse.FactorizationMachine(F, D).forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jb)
    model = FactorizationMachine(F, D, device="cpu")
    model.load_state_dict(params_from_jax(p, "cpu"))
    with torch.no_grad():
        got = model(tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
@pytest.mark.parametrize("labels,task", [("01", "binary"),
                                         ("pm1", "binary"),
                                         ("real", "regression")])
def test_fm_loss_matches_jax(layout, labels, task):
    rng = np.random.default_rng(3)
    D = 8
    p = _fm_params(rng, D)
    jb, tb = _both(_batch(rng, layout, labels))
    want = jsparse.FactorizationMachine(F, D, l2=1e-3, task=task).loss(
        {k: jnp.asarray(v) for k, v in p.items()}, jb)
    model = FactorizationMachine(F, D, l2=1e-3, task=task, device="cpu")
    model.load_state_dict(params_from_jax(p, "cpu"))
    got = model.loss(tb)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()                    # the plain path is differentiable
    assert model.v.grad is not None and torch.isfinite(model.v.grad).all()


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
@pytest.mark.parametrize("labels", ["01", "pm1"])
def test_logreg_forward_and_loss_match_jax(layout, labels):
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=F).astype(np.float32),
         "b": np.asarray(-0.5, np.float32)}
    jb, tb = _both(_batch(rng, layout, labels))
    jm = jsparse.SparseLogReg(F, l2=1e-3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    model = SparseLogReg(F, l2=1e-3, device="cpu")
    model.load_state_dict(params_from_jax(p, "cpu"))
    with torch.no_grad():
        np.testing.assert_allclose(model(tb).numpy(),
                                   np.asarray(jm.forward(jp, jb)), **TOL)
        np.testing.assert_allclose(float(model.loss(tb)),
                                   float(jm.loss(jp, jb)), **TOL)


@pytest.mark.parametrize("fn", ["weighted_bce", "weighted_mse"])
def test_weighted_losses_match_jax(fn):
    rng = np.random.default_rng(6)
    out = rng.normal(size=32).astype(np.float32) * 4
    lab = np.sign(rng.normal(size=32)).astype(np.float32)
    w = rng.random(32).astype(np.float32)
    w[:5] = 0
    want = getattr(jsparse, fn)(jnp.asarray(out), jnp.asarray(lab),
                                jnp.asarray(w))
    port = {"weighted_bce": weighted_bce, "weighted_mse": weighted_mse}[fn]
    got = port(torch.from_numpy(out), torch.from_numpy(lab),
               torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # all-zero weights stay finite (the 1e-9 floor)
    zero = port(torch.from_numpy(out), torch.from_numpy(lab),
                torch.zeros(32))
    assert float(zero) == 0.0


def test_task_loss_l2_matches_jax():
    rng = np.random.default_rng(8)
    out = rng.normal(size=8).astype(np.float32)
    batch = {"labels": rng.integers(0, 2, 8).astype(np.float32),
             "weights": np.ones(8, np.float32)}
    regs = [rng.normal(size=5).astype(np.float32),
            rng.normal(size=(3, 2)).astype(np.float32)]
    want = jsparse.task_loss(jnp.asarray(out),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             "binary", 0.01, *map(jnp.asarray, regs))
    got = task_loss(torch.from_numpy(out),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    "binary", 0.01, *map(torch.from_numpy, regs))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_params_roundtrip_keeps_names_shapes_and_dtypes():
    rng = np.random.default_rng(9)
    p = _fm_params(rng, 8)
    tp = params_from_jax(p, "cpu")
    assert tp["w0"].shape == () and tp["v"].dtype == torch.float32
    model = FactorizationMachine(F, 8, device="cpu")
    model.load_state_dict(tp)
    back = params_to_numpy(model)
    assert set(back) == set(p)
    for k in p:
        assert back[k].shape == p[k].shape and back[k].dtype == p[k].dtype
        np.testing.assert_array_equal(back[k], p[k])
    # JAX-initialised params load as they are
    jp = jsparse.FactorizationMachine(F, 8).init(jax.random.PRNGKey(0))
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    with pytest.raises(DMLCError, match="nested"):
        params_from_jax({"params": p}, "cpu")


def test_fm_init_draws_from_the_generator():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = FactorizationMachine(F, 8, init_scale=0.01, device="cpu",
                             generator=g1)
    b = FactorizationMachine(F, 8, init_scale=0.01, device="cpu",
                             generator=g2)
    assert torch.equal(a.v, b.v)
    assert abs(float(a.v.detach().std()) - 0.01) < 1e-3
    assert float(a.w.detach().abs().sum()) == 0.0 and a.w0.shape == ()


@pytest.mark.parametrize("cls", [FactorizationMachine, SparseLogReg])
def test_models_default_to_the_card(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        cls(F)
