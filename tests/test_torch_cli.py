"""The port's ``dmlc-train`` (``dmlc_core_tpu_torch.models.cli``) on the
CPU, held against the JAX package's CLI.

Both CLIs run in-process on the same small libsvm files (DeepFM,
features 4096, dim 8, 2 layers, 16-row batches).  The JAX CLI's
DeviceLoader is held to its python packer (the native one sizes flat
batches to an nnz bucket, not to ``nnz_cap``), so both packages see the
same batches.  Checkpoints cross in both directions: predictions from a
JAX checkpoint, and a run resumed by the other package's CLI, with the
optimizer state carried in ``optax.adam``'s layout.

Tolerances: predictions within ``2e-6`` (both print ``%.6f``; the models
agree to float32 rounding); parameters after two resumed epochs at
``rtol = 1e-4, atol = 1e-6`` (Adam trajectories whose rounding
differences grow step by step, as in ``test_torch_train.py``).  ``kstep``
runs the same steps in the same order as ``kstep=1`` on the CPU, so
their checkpoints' parameters and moments are equal.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.models import cli as jcli  # noqa: E402
from dmlc_core_tpu.models import deep as jdeep  # noqa: E402
from dmlc_core_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from dmlc_core_tpu_torch.models import cli  # noqa: E402
from dmlc_core_tpu_torch.utils import CheckpointManager  # noqa: E402
from test_torch_remote_filesys import S3, s3_server  # noqa: E402,F401

F, D, L = 4096, 8, 2
MODEL = ["model=deepfm", f"features={F}", f"dim={D}", f"layers={L}",
         "batch_rows=16", "nnz_cap=128", "lr=0.01", "l2=0.0001",
         "log_every=1"]
PREDICT_TOL = 2e-6
PARAMS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _python_packer(monkeypatch):
    monkeypatch.setattr(jnative, "has_packer", lambda: False)
    monkeypatch.delenv("DMLC_EMBED_ENGINE", raising=False)


def _write(path, rows, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            n = int(rng.integers(2, 9))
            idx = np.sort(rng.choice(F + 8, size=n, replace=False))
            toks = " ".join(f"{j}:{v:.4f}" for j, v in
                            zip(idx.tolist(), rng.random(n).tolist()))
            f.write(f"{int(rng.random() < 0.5)} {toks}\n")
    return str(path)


@pytest.fixture
def data(tmp_path):
    return (_write(tmp_path / "train.libsvm", 40, 1),
            _write(tmp_path / "eval.libsvm", 21, 2))


def _port(*args):
    return cli.main(MODEL + ["device=cpu", "eval_auc=false", *args])


def _jax(*args):
    return jcli.main(MODEL + ["eval_auc=false", *args])


def _params(directory):
    step, state = CheckpointManager(str(directory)).restore()
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(state["params"])
    return step, flat, state


def test_config_file_and_overrides(tmp_path, data, capsys):
    conf = tmp_path / "train.conf"
    conf.write_text(f'# DeepFM\nmodel = deepfm\ndim = 4  # overridden\n'
                    f'data = "{data[0]}"\nlayers=3\nepochs = 2\n')
    got = cli._parse_argv([str(conf), "dim=8", "device=cpu"])
    assert got == {"model": "deepfm", "dim": "8", "data": data[0],
                   "layers": "3", "epochs": "2", "device": "cpu"}
    p = cli.TrainParams()
    p.init(got)
    assert (p.model, p.dim, p.layers, p.epochs, p.batch_rows) == \
        ("deepfm", 8, 3, 2, 4096)
    assert cli.main([str(conf), "dim=8", "device=cpu", "features=4096",
                     "batch_rows=16", "nnz_cap=128"]) == 0
    out = capsys.readouterr().out
    assert "trained deepfm: 6 steps, final loss " in out
    assert "train AUC " in out
    # the JAX CLI reads the same file the same way
    assert jcli._parse_argv([str(conf), "dim=8"]) == \
        {k: v for k, v in got.items() if k != "device"}


@pytest.mark.parametrize("args,message", [
    (["model=deepfm", "bogus=1"], "unknown parameter 'bogus'"),
    (["model=xgb"], "expected one of"),
    (["dim=2.5"], "not integral"),
    (["dim=0"], "below lower bound"),
    (["model=fm"], "required parameters ['data']"),
    (["model=ffm", "workers=h1:9000"], "workers= "),
    (["format=libfm", "data=ftp://host/train.libfm"],
     "unknown filesystem scheme 'ftp'"),
    (["format=csv", "data=missing.csv"], "no such file"),
    (["data=train.csv?format=tsv"], "unknown parser format 'tsv'"),
    (["model=ffm", "ckpt_dir=nfs://nn/ckpt"],
     "unknown filesystem scheme 'nfs'"),
    (["workers=h1"], "workers= "),
    (["kstep=4", "workers=h1:port"], "workers= "),
    (["data=gopher://host/train.libsvm"],
     "unknown filesystem scheme 'gopher'"),
    (["ckpt_dir=ftp://nn/ckpt"], "unknown filesystem scheme 'ftp'"),
    (["ckpt_every=5"], "ckpt_every needs ckpt_dir"),
    (["resume=true"], "resume=true needs ckpt_dir"),
    (["mode=predict"], "predict mode needs ckpt_dir and output"),
    (["device=tpu"], "expected one of ['cuda', 'cpu']"),
])
def test_loud_errors(data, capsys, args, message):
    argv = ["device=cpu", f"data={data[0]}", "features=64"] + args
    if "model=fm" in args and "required" in message:
        argv = [a for a in argv if not a.startswith("data=")]
    assert cli.main(argv) == 2
    assert message in capsys.readouterr().err


def test_no_card_exits_2_and_never_falls_back(data, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert cli.main([f"data={data[0]}", "features=64"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_help(capsys):
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "python -m dmlc_core_tpu_torch.models.cli" in out
    assert "Parameters of TrainParams" in out
    for key in jcli.TrainParams.__param_fields__:
        assert f"\n{key} : " in out, key
    assert "\ndevice : str (default='cuda')" in out


def test_ckpt_every_saves_at_the_jax_steps(tmp_path, data, capsys):
    ck = tmp_path / "ck"
    assert _port(f"data={data[0]}", f"ckpt_dir={ck}", "ckpt_every=2",
                 "epochs=2") == 0
    out = capsys.readouterr().out
    # 3 batches an epoch: saves at steps 2, 4, 6 and nothing more at the end
    mgr = CheckpointManager(str(ck))
    assert mgr.steps == [2, 4, 6]
    assert out.count("checkpoint step 6 -> ") == 1
    assert "epoch 1 step 6 loss " in out


def test_port_predicts_from_a_jax_checkpoint(tmp_path, data, capsys):
    ck = tmp_path / "ck"
    assert _jax(f"data={data[0]}", f"ckpt_dir={ck}") == 0
    assert "trained deepfm: 3 steps" in capsys.readouterr().out
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "port.txt"
    assert _jax("mode=predict", f"data={data[1]}", f"ckpt_dir={ck}",
                f"output={out_j}") == 0
    assert _port("mode=predict", f"data={data[1]}", f"ckpt_dir={ck}",
                 f"output={out_t}") == 0
    assert "wrote 21 predictions from step 3 -> " in \
        capsys.readouterr().out
    want = np.loadtxt(out_j)
    got = np.loadtxt(out_t)
    assert got.shape == want.shape == (21,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDICT_TOL)
    assert np.ptp(got) > 1e-4                 # the model is not constant
    # a checkpoint of another model is refused
    assert cli.main(["model=fm", "device=cpu", f"features={F}",
                     f"dim={D}", "mode=predict", f"data={data[1]}",
                     f"ckpt_dir={ck}", f"output={out_t}"]) == 2
    assert "trained as 'deepfm'" in capsys.readouterr().err


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(tmp_path, data, capsys, first):
    """One epoch in one package, then ``resume=true`` for one more in
    the other, lands where two epochs in the first package land."""
    run_first, run_second = (_jax, _port) if first == "jax" else (_port,
                                                                   _jax)
    a, b = tmp_path / "a", tmp_path / "b"
    assert run_first(f"data={data[0]}", f"ckpt_dir={a}") == 0
    assert run_second(f"data={data[0]}", f"ckpt_dir={a}", "resume=true") == 0
    out = capsys.readouterr().out
    assert f"resumed from step 3 in {a}" in out
    assert "trained deepfm: 6 steps" in out
    assert run_first(f"data={data[0]}", f"ckpt_dir={b}", "epochs=2") == 0
    step_a, got, state_a = _params(a)
    step_b, want, state_b = _params(b)
    assert step_a == step_b == 6
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAMS, err_msg=k)
    (count_a, mu_a, _), _ = state_a["opt_state"]
    (count_b, mu_b, _), _ = state_b["opt_state"]
    assert int(count_a) == int(count_b) == 6
    np.testing.assert_allclose(mu_a["v"], mu_b["v"], **PARAMS)


def test_port_opt_state_restores_with_the_jax_template(tmp_path, data,
                                                        capsys):
    ck = tmp_path / "ck"
    assert _port(f"data={data[0]}", f"ckpt_dir={ck}", "epochs=2") == 0
    jm = jdeep.DeepFM(F, D, L)
    params = jm.init(jax.random.PRNGKey(0))
    template = {"params": params, "opt_state": optax.adam(1e-2).init(params)}
    step, state = JCheckpointManager(str(ck)).restore(template=template)
    assert step == 6
    adam_state, empty = state["opt_state"]
    assert type(adam_state).__name__ == "ScaleByAdamState"
    assert type(empty).__name__ == "EmptyState"
    assert adam_state.count.dtype == np.int32 and int(adam_state.count) == 6
    _, flat, ours = _params(ck)
    (count, mu, nu), _ = ours["opt_state"]
    np.testing.assert_array_equal(np.asarray(adam_state.mu["tower"]["w"]),
                                  mu["tower"]["w"])
    np.testing.assert_array_equal(np.asarray(adam_state.nu["v"]), nu["v"])
    assert np.abs(nu["v"]).max() > 0
    assert os.path.isfile(ck / "MANIFEST.json")


def test_kstep_trains_the_kstep_1_trajectory(tmp_path, data, capsys):
    """kstep=4 (groups of the same nnz bucket, flushed at each epoch's
    end) lands on kstep=1's parameters and Adam state; logs and
    checkpoints fire at group ends."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert _port(f"data={data[0]}", f"ckpt_dir={a}", "epochs=2") == 0
    capsys.readouterr()
    assert _port(f"data={data[0]}", f"ckpt_dir={b}", "epochs=2",
                 "kstep=4", "ckpt_every=2", "eval_auc=true") == 0
    out = capsys.readouterr().out
    assert "trained deepfm: 6 steps" in out and "train AUC " in out
    logged = [int(ln.split(" step ")[1].split()[0]) for ln in
              out.splitlines() if ln.startswith("epoch ") and " loss " in ln]
    steps_b = CheckpointManager(str(b)).steps
    assert logged[-1] == 6 and set(steps_b) <= set(logged)
    assert steps_b[-1] == 6
    step_a, got, state_a = _params(a)
    step_b, want, state_b = _params(b)
    assert step_a == step_b == 6 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    (count_a, mu_a, _), _ = state_a["opt_state"]
    (count_b, mu_b, _), _ = state_b["opt_state"]
    assert int(count_a) == int(count_b) == 6
    np.testing.assert_array_equal(mu_a["v"], mu_b["v"])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_kstep_checkpoint_resumes_across_packages(tmp_path, data, capsys,
                                                  first):
    """One epoch with kstep=4 in one package, resumed (kstep=4) for one
    more in the other, lands where two per-step epochs of the first
    package land (each package initialises from its own generator)."""
    run_first, run_second = (_jax, _port) if first == "jax" else (_port,
                                                                   _jax)
    a, b = tmp_path / "a", tmp_path / "b"
    assert run_first(f"data={data[0]}", f"ckpt_dir={a}", "kstep=4") == 0
    assert run_second(f"data={data[0]}", f"ckpt_dir={a}", "resume=true",
                      "kstep=4") == 0
    out = capsys.readouterr().out
    assert f"resumed from step 3 in {a}" in out
    assert run_first(f"data={data[0]}", f"ckpt_dir={b}", "epochs=2") == 0
    _, got, state_a = _params(a)
    _, want, _ = _params(b)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAMS, err_msg=k)
    (count, _, _), _ = state_a["opt_state"]
    assert int(count) == 6


def test_resume_loads_params_in_place():
    """A resume loads the checkpoint's params into the model's own
    tensors, whose addresses a captured k-step graph holds."""
    from dmlc_core_tpu_torch.models import DeepFM, params_to_numpy
    model = DeepFM(F, D, L, device="cpu")
    ptrs = [p.data_ptr() for p in model.parameters()]
    other = DeepFM(F, D, L, device="cpu",
                   generator=torch.Generator().manual_seed(9))
    cli._load_params(model, params_to_numpy(other, nested=True),
                     torch.device("cpu"))
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    for (k, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), k


# -- the I/O layer: directories, caches and asynchronous checkpoints ---------

def _split_into_dir(src, directory):
    """``src`` cut into three files (and an empty one) under
    ``directory``, whose ``expand_uris`` order is the file's order."""
    lines = open(src, "rb").read().splitlines(keepends=True)
    os.makedirs(directory / "sub")
    parts = ((directory / "a.libsvm", lines[:13]),
             (directory / "b.libsvm", lines[13:30]),
             (directory / "sub" / "c.libsvm", lines[30:]))
    for path, chunk in parts:
        path.write_bytes(b"".join(chunk))
    (directory / "empty.libsvm").write_bytes(b"")


@pytest.mark.parametrize("kstep", [1, 4])
def test_directory_with_cache_trains_like_the_file(tmp_path, data, capsys,
                                                   kstep):
    """``data=<dir>#cache epochs=2``: the second epoch comes from the
    page file, and the run lands on the parameters of the same run over
    the concatenated file, exactly."""
    d = tmp_path / "d"
    _split_into_dir(data[0], d)
    a, b = tmp_path / "a", tmp_path / "b"
    assert _port(f"data={d}#{tmp_path}/cache", f"ckpt_dir={a}", "epochs=2",
                 f"kstep={kstep}", "ckpt_every=2") == 0
    assert os.path.isfile(tmp_path / "cache.pages")
    assert _port(f"data={data[0]}", f"ckpt_dir={b}", "epochs=2",
                 f"kstep={kstep}") == 0
    out = capsys.readouterr().out
    assert out.count("trained deepfm: 6 steps") == 2
    step_a, got, state_a = _params(a)
    step_b, want, state_b = _params(b)
    assert step_a == step_b == 6 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(state_a["opt_state"][0][2]["v"],
                                  state_b["opt_state"][0][2]["v"])
    # the glob and ; list forms read the same rows
    out_g, out_l = tmp_path / "g.txt", tmp_path / "l.txt"
    assert _port("mode=predict", f"data={d}/*.libsvm;{d}/sub",
                 f"ckpt_dir={a}", f"output={out_g}") == 0
    assert _port("mode=predict",
                 f"data={d}/a.libsvm;{d}/b.libsvm;{d}/sub/c.libsvm",
                 f"ckpt_dir={a}", f"output={out_l}") == 0
    assert _port("mode=predict", f"data={d}#{tmp_path}/cache",
                 f"ckpt_dir={a}", f"output={tmp_path / 'c.txt'}") == 0
    assert capsys.readouterr().out.count("wrote 40 predictions") == 3
    assert (out_g.read_bytes() == out_l.read_bytes()
            == (tmp_path / "c.txt").read_bytes())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_from_an_async_checkpoint_across_packages(tmp_path, data,
                                                         capsys, first):
    """``ckpt_every=3`` over a 3-step epoch: the only checkpoint is the
    asynchronous one; the other package resumes from it for one more
    epoch and lands where two epochs of the first package land."""
    run_first, run_second = (_jax, _port) if first == "jax" else (_port,
                                                                   _jax)
    a, b = tmp_path / "a", tmp_path / "b"
    assert run_first(f"data={data[0]}", f"ckpt_dir={a}", "ckpt_every=3") == 0
    assert CheckpointManager(str(a)).steps == [3]
    assert run_second(f"data={data[0]}", f"ckpt_dir={a}", "resume=true",
                      "ckpt_every=3") == 0
    out = capsys.readouterr().out
    assert f"resumed from step 3 in {a}" in out
    assert run_first(f"data={data[0]}", f"ckpt_dir={b}", "epochs=2") == 0
    _, got, state_a = _params(a)
    _, want, _ = _params(b)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAMS, err_msg=k)
    (count, _, _), _ = state_a["opt_state"]
    assert int(count) == 6


def test_failed_background_checkpoint_exits_non_zero(tmp_path, data, capsys,
                                                     monkeypatch):
    real = CheckpointManager._publish

    def flaky(self, name, write_fn):
        if name == "ckpt-2.bin":
            raise OSError("no space left on device")
        return real(self, name, write_fn)

    monkeypatch.setattr(CheckpointManager, "_publish", flaky)
    ck = tmp_path / "ck"
    assert _port(f"data={data[0]}", f"ckpt_dir={ck}", "ckpt_every=2") == 2
    err = capsys.readouterr().err
    assert "background checkpoint failed" in err and "no space" in err
    assert CheckpointManager(str(ck)).steps == [3]    # the final one


def test_cli_refuses_remote_uris_naming_the_roadmap(tmp_path, data, capsys,
                                                    s3_server):
    """Remote URIs are no longer refused: ``data=``, ``valid=``,
    ``ckpt_dir=`` and ``output=`` on the fake S3 train, checkpoint and
    predict as the same run on local files does (the same batches, so
    the same checkpoint and scores within PREDICT_TOL), and the JAX CLI
    predicts from the port's checkpoint on the store."""
    for name, path in zip(("train.libsvm", "eval.libsvm"), data):
        with open(path, "rb") as f:
            S3.objects[f"bkt/in/{name}"] = f.read()
    ck, out = tmp_path / "ck", tmp_path / "pred.txt"
    assert _port(f"data={data[0]}", f"valid={data[1]}",
                 f"ckpt_dir={ck}") == 0
    assert _port("mode=predict", f"data={data[1]}", f"ckpt_dir={ck}",
                 f"output={out}") == 0
    local = capsys.readouterr().out
    assert _port("data=s3://bkt/in/train.libsvm",
                 "valid=s3://bkt/in/eval.libsvm",
                 "ckpt_dir=s3://bkt/ck") == 0
    assert _port("mode=predict", "data=s3://bkt/in/eval.libsvm",
                 "ckpt_dir=s3://bkt/ck", "output=s3://bkt/out/pred.txt") == 0
    remote = capsys.readouterr().out
    assert "checkpoint step 3 -> s3://bkt/ck" in remote
    assert "wrote 21 predictions from step 3 -> s3://bkt/out/pred.txt" \
        in remote
    # the validation lines read the same from either source
    assert [ln for ln in local.splitlines() if "valid" in ln] == \
        [ln for ln in remote.splitlines() if "valid" in ln]
    assert CheckpointManager("s3://bkt/ck").steps == [3]
    want = np.loadtxt(out)
    got = np.array(S3.objects["bkt/out/pred.txt"].split(), np.float64)
    assert got.shape == want.shape == (21,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDICT_TOL)
    assert _jax("mode=predict", f"data={data[1]}", "ckpt_dir=s3://bkt/ck",
                "output=s3://bkt/out/jax.txt") == 0
    np.testing.assert_allclose(
        np.array(S3.objects["bkt/out/jax.txt"].split(), np.float64), want,
        rtol=0, atol=PREDICT_TOL)


@pytest.mark.parametrize("data_uri,model,want", [
    ("s3://bkt/day/train.csv?label_column=0", "fm", "csv"),
    ("hdfs://nn:9870/logs/part-0.libfm", "fm", "libfm"),
    ("https://host/a/b.libsvm", "fm", "libsvm"),
    ("s3://bkt/day/", "fm", "libsvm"),
    ("s3://bkt/x.csv?format=libfm", "fm", "libfm"),
    ("s3://bkt/x.csv", "ffm", "libfm"),
])
def test_format_from_a_remote_uri_suffix(data_uri, model, want):
    """``_resolve_format`` reads a remote URI's path suffix as a local
    one's (no request is made)."""
    p = cli.TrainParams()
    p.init({"data": data_uri, "model": model})
    assert cli._resolve_format(p) == want


def test_cli_still_refuses_workers(data, tmp_path, capsys):
    """``workers=`` trains from ingest workers (port workers in threads,
    one part, so the batches are the local run's): the checkpoint and the
    predictions equal the local run's (2e-6), per step and with kstep;
    ``model=ffm workers=`` still exits 2 with the JAX CLI's message."""
    from test_torch_ingest import start_port_worker

    def scores(name, *args):
        ck = tmp_path / name
        assert _port(*args, f"ckpt_dir={ck}") == 0
        out = tmp_path / f"{name}.txt"
        assert _port("mode=predict", f"data={data[1]}", f"ckpt_dir={ck}",
                     f"output={out}") == 0
        return np.loadtxt(out), _params(ck)[1]

    for kstep in ("kstep=1", "kstep=4"):
        local, p_local = scores(f"local{kstep}", f"data={data[0]}", kstep)
        # the worker hashes ids as the local loader does (id_mod=features)
        port = start_port_worker(data[0], 0, 1, batch_rows=16, nnz_cap=128,
                                 id_mod=F, max_epochs=3)
        remote, p_remote = scores(f"remote{kstep}", f"data={data[0]}",
                                  kstep, f"workers=127.0.0.1:{port}")
        assert "trained deepfm: 3 steps" in capsys.readouterr().out
        np.testing.assert_allclose(remote, local, rtol=0, atol=PREDICT_TOL)
        for k in p_local:
            np.testing.assert_array_equal(p_remote[k], p_local[k], err_msg=k)
    assert _port(f"data={data[0]}", "model=ffm",
                 "workers=127.0.0.1:1") == 2
    assert "workers= (fused wire) does not carry libfm fields" in \
        capsys.readouterr().err