"""The port's ``FieldAwareFM`` and ``dmlc-train model=ffm`` /
``format=csv`` on the CPU, held against the JAX package.

The same seeded parameters and batches (made with numpy) go through the
JAX ``FieldAwareFM`` and the port's on both layouts: forward, loss and
``jax.grad`` against autograd at ``rtol = 1e-5, atol = 1e-6`` (float32
sums in another order), with fields past ``num_fields`` (clipped),
out-of-range and negative ids (XLA's forward clamp, backward drop), and
padding.  Three Adam steps against ``optax.adam``; both loaders' libfm
batches through both models; the CLIs of both packages on libfm and
csv text, checkpoints crossing both ways (the ``[F, nf, d]`` leaf and
its Adam moments), predictions within ``2e-6`` (both print ``%.6f``),
an epoch resumed in the other package within ``1e-3`` of how far it
moved each parameter (see ``test_cli_ffm_across_packages``).
"""

import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.models import cli as jcli  # noqa: E402
from dmlc_core_tpu.models.ffm import FieldAwareFM as JFFM  # noqa: E402
from dmlc_core_tpu.pipeline import device_loader as jdl  # noqa: E402
from dmlc_core_tpu_torch import FieldAwareFM, adam  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.models import (adam_state_from_optax,  # noqa: E402
                                        adam_state_to_optax, cli,
                                        params_from_jax, params_to_numpy)
from dmlc_core_tpu_torch.ops.ragged_csr import mask_batch  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.utils import CheckpointManager  # noqa: E402

F, NF, D, B, K = 512, 5, 4, 12, 7
TOL = dict(rtol=1e-5, atol=1e-6)
PREDICT_TOL = 2e-6
PARAMS = dict(rtol=1e-4, atol=1e-6)
MOVED_TOL = 1e-3


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w0": np.float32(0.1),
            "w": (rng.standard_normal(F) * 0.1).astype(np.float32),
            "v": (rng.standard_normal((F, NF, D)) * 0.3).astype(np.float32)}


def _rowmajor(case, seed=1):
    """ids / vals / fields ``[B, K]``, 3-7 entries a row then padding (id
    0, value 0, field 0); ``case`` adds fields past NF - 1 (``clip``) or
    ids out of range in row 0 (``bad_ids``)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    vals = rng.random((B, K), dtype=np.float32) + 0.1
    fields = rng.integers(0, NF, (B, K)).astype(np.int32)
    if case == "clip":
        fields[::2, 1] = NF + 2
        fields[1, 0] = 3 * NF
    if case == "bad_ids":
        ids[0, :4] = [-1, F, F + 7, -F - 3]
    pad = np.arange(K)[None, :] >= rng.integers(3, K + 1, B)[:, None]
    ids[pad], vals[pad], fields[pad] = 0, 0.0, 0
    labels = (rng.random(B) > 0.5).astype(np.float32)
    return {"ids": ids, "vals": vals, "fields": fields, "labels": labels,
            "weights": np.where(np.arange(B) < B - 2, 1.0,
                                0.0).astype(np.float32)}


def _flat(rm, extra=6):
    """The same rows as a flat batch: live entries in row order, then
    ``extra`` padding slots on the scratch row."""
    live = rm["vals"] != 0
    n = int(live.sum())
    out = {k: np.zeros(n + extra, rm[k].dtype) for k in ("ids", "vals",
                                                         "fields")}
    for k in out:
        out[k][:n] = rm[k][live]
    out["segments"] = np.full(n + extra, B, np.int32)
    out["segments"][:n] = np.nonzero(live)[0]
    return {**out, "labels": rm["labels"], "weights": rm["weights"]}


def _batch(case, layout):
    rm = _rowmajor(case)
    return rm if layout == "rowmajor" else _flat(rm)


def _models(l2=0.01):
    p = _params()
    jm = JFFM(F, NF, D, l2=l2)
    m = FieldAwareFM(F, NF, D, l2=l2, device="cpu")
    m.load_state_dict(params_from_jax(p, "cpu"))
    return jm, {k: jnp.asarray(v) for k, v in p.items()}, m


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
@pytest.mark.parametrize("case", ["plain", "clip", "bad_ids"])
def test_forward_loss_and_grads_match_jax(layout, case):
    jm, jp, m = _models()
    b = _batch(case, layout)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    np.testing.assert_allclose(m(_t(b)).detach().numpy(),
                               np.asarray(jm.forward(jp, jb)), **TOL)
    loss = m.loss(_t(b))
    loss.backward()
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(m, k).grad.numpy(),
                                   np.asarray(jg[k]), **TOL, err_msg=k)
    if case == "bad_ids":
        # id F + 7 reads row F - 1 but sends it nothing; -1 is row F - 1
        # both ways, so that row's gradient is -1's alone
        assert np.abs(np.asarray(jg["v"])[F - 1]).max() > 0


def test_missing_fields_raise_the_jax_key_error():
    jm, jp, m = _models()
    b = _batch("plain", "flat")
    del b["fields"]
    with pytest.raises(KeyError) as theirs:
        jm.forward(jp, {k: jnp.asarray(v) for k, v in b.items()})
    with pytest.raises(KeyError) as ours:
        m(_t(b))
    assert str(ours.value) == str(theirs.value)
    assert "fields=True" in str(ours.value)


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_adam_trajectory_matches_optax(layout):
    jm, jp, m = _models()
    opt = optax.adam(1e-2)
    state = opt.init(jp)
    ours = adam(m, 1e-2)
    for step in range(3):
        b = _batch("clip", layout) if step != 1 else _batch("bad_ids", layout)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = jax.grad(jm.loss)(jp, jb)
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        ours.zero_grad()
        m.loss(_t(b)).backward()
        ours.step()
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(m, k).detach().numpy(),
                                   np.asarray(jp[k]), **PARAMS, err_msg=k)
    # the optax layout carries FFM's 3-D moments both ways
    (count, mu, nu), rest = adam_state_to_optax(m, ours)
    assert int(count) == 3 and rest == () and mu["v"].shape == (F, NF, D)
    np.testing.assert_allclose(nu["v"], np.asarray(state[0].nu["v"]),
                               **PARAMS)
    fresh = FieldAwareFM(F, NF, D, device="cpu")
    fresh.load_state_dict(params_from_jax(params_to_numpy(m, nested=True),
                                          "cpu"))
    fresh_opt = adam(fresh, 1e-2)
    adam_state_from_optax(fresh, fresh_opt, ((count, mu, nu), ()))
    np.testing.assert_array_equal(fresh_opt.mu[2].numpy(), mu["v"])


def _libfm(path, rows, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            n = int(rng.integers(2, 9))
            idx = np.sort(rng.choice(F + 8, size=n, replace=False))
            toks = " ".join(f"{rng.integers(0, NF + 1)}:{j}:{v:.4f}"
                            for j, v in zip(idx.tolist(),
                                            rng.random(n).tolist()))
            f.write(f"{int(rng.random() < 0.5)} {toks}\n")
    return str(path)


@pytest.mark.parametrize("path", ["flat", "rowmajor", "ragged"])
def test_the_slice_from_libfm_text(tmp_path, path):
    """libfm text → both packages' parser and loader (``fields=True``)
    → both models: the same scores on every batch (a ragged batch
    through ``mask_batch``, as every flat model takes one)."""
    data = _libfm(tmp_path / "d.libfm", 50, seed=3)
    kw = dict(layout="rowmajor") if path == "rowmajor" else \
        dict(ragged=True) if path == "ragged" else {}
    cap = 8 if path == "rowmajor" else 96
    jm, jp, m = _models()
    jl = jdl.DeviceLoader(jcreate_parser(f"file://{data}", 0, 1, "libfm"),
                          16, cap, fields=True, put_threads=1,
                          wire_compact=False, cache=None, **kw)
    try:
        want = [np.asarray(jm.forward(jp, b if path != "ragged" else
                                      _jax_masked(b)))
                for b in jl]
    finally:
        jl.close()
    with DeviceLoader(create_parser(data, parser_type="libfm"), 16, cap,
                      device="cpu", fields=True, **kw) as ld:
        with torch.no_grad():
            got = [m(mask_batch(b) if path == "ragged" else b).numpy()
                   for b in ld]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _jax_masked(b):
    from dmlc_core_tpu.ops.ragged_csr import mask_batch as jmask
    return jmask(b)


# -- the CLI ----------------------------------------------------------------

CLI = [f"features={F}", f"fields={NF}", f"dim={D}", "batch_rows=16",
       "nnz_cap=96", "lr=0.01", "log_every=1", "eval_auc=false"]


@pytest.fixture
def port_log():
    """The messages the port logs during the test."""
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = logging.getLogger("dmlc_core_tpu_torch")
    logger.addHandler(handler)
    yield messages
    logger.removeHandler(handler)


@pytest.fixture
def libfm_files(tmp_path):
    return (_libfm(tmp_path / "train.libfm", 40, 1),
            _libfm(tmp_path / "eval.libfm", 21, 2))


def _ckpt_params(directory, step=None):
    step, state = CheckpointManager(str(directory)).restore(step)
    return step, {k: np.asarray(v) for k, v in state["params"].items()}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_cli_ffm_across_packages(tmp_path, libfm_files, capsys, port_log,
                                 first):
    """``model=ffm`` (libfm implied): one epoch in one package, scores
    from its checkpoint in both (within 2e-6), then ``resume=true`` in
    the other lands where two epochs in the first land.  The port's
    ``kstep=4`` is ignored for ffm, with one log line."""
    port = lambda *a: cli.main(["model=ffm", "device=cpu", *CLI,  # noqa
                                *a])
    jaxc = lambda *a: jcli.main(["model=ffm", *CLI, *a])  # noqa: E731
    run_first, run_second = (jaxc, port) if first == "jax" else (port, jaxc)
    train, evalf = libfm_files
    a, b = tmp_path / "a", tmp_path / "b"
    assert run_first(f"data={train}", f"ckpt_dir={a}", "kstep=4") == 0
    assert "trained ffm: 3 steps" in capsys.readouterr().out
    assert (first == "port") == any("kstep=4 ignored for model=ffm" in m
                                    for m in port_log)
    preds = {}
    for name, run in (("jax", jaxc), ("port", port)):
        preds[name] = tmp_path / f"{name}.txt"
        assert run("mode=predict", f"data={evalf}", f"ckpt_dir={a}",
                   f"output={preds[name]}") == 0
    got, want = np.loadtxt(preds["port"]), np.loadtxt(preds["jax"])
    assert got.shape == want.shape == (21,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDICT_TOL)
    assert np.ptp(got) > 1e-4
    assert run_second(f"data={train}", f"ckpt_dir={a}", "resume=true") == 0
    assert f"resumed from step 3 in {a}" in capsys.readouterr().out
    assert run_first(f"data={train}", f"ckpt_dir={b}", "epochs=2") == 0
    (step_a, pa), (step_b, pb) = _ckpt_params(a), _ckpt_params(b)
    _, p3 = _ckpt_params(a, step=3)
    assert step_a == step_b == 6 and pa["v"].shape == (F, NF, D)
    for k in pb:
        # each parameter within MOVED_TOL of how far the second epoch
        # moved it: Adam turns the rounding residue of a gradient that is
        # zero in exact arithmetic (an entry's own pair in the cross term,
        # which the diagonal term cancels) into a step of its own, so an
        # elementwise tolerance would test the residue, not the model
        moved = np.linalg.norm(pb[k] - p3[k])
        assert np.linalg.norm(pa[k] - pb[k]) <= MOVED_TOL * moved, k


def test_cli_fm_on_csv_matches_jax(tmp_path, capsys, monkeypatch):
    """``model=fm`` on csv text with a label column and a ``;``
    delimiter from the URI: the port predicts from the JAX CLI's
    checkpoint what the JAX CLI predicts, within 2e-6."""
    monkeypatch.setattr(jnative, "has_packer", lambda: False)
    rng = np.random.default_rng(4)
    path = tmp_path / "train.csv"
    rows = [";".join([str(i & 1)] + [f"{v:.4f}" if v > 0.1 else ""
                                      for v in rng.random(12)])
            for i in range(40)]
    path.write_text("\n".join(rows) + "\n")
    uri = f"{path}?label_column=0&delimiter=;"
    base = ["model=fm", "features=64", f"dim={D}", "batch_rows=16",
            "nnz_cap=256", "lr=0.05", "log_every=1", "eval_auc=false"]
    ck = tmp_path / "ck"
    assert jcli.main(base + [f"data={uri}", f"ckpt_dir={ck}"]) == 0
    assert cli.main(base + ["device=cpu", f"data={uri}"]) == 0
    assert "trained fm: 3 steps" in capsys.readouterr().out
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "port.txt"
    assert jcli.main(base + ["mode=predict", f"data={uri}",
                             f"ckpt_dir={ck}", f"output={out_j}"]) == 0
    assert cli.main(base + ["device=cpu", "mode=predict", f"data={uri}",
                            f"ckpt_dir={ck}", f"output={out_t}"]) == 0
    got, want = np.loadtxt(out_t), np.loadtxt(out_j)
    assert got.shape == want.shape == (40,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDICT_TOL)
    assert np.ptp(got) > 1e-4
