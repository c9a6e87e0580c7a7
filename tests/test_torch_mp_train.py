"""Model parallelism of the port (``mp`` table sharding, both modes) on
gloo meshes of CPU processes, held against the JAX package's sharded
runs: ``make_train_step(mesh=)`` with ``param_shardings(table_shard=)``
on the union batch over a ``("dp", "mp")`` mesh of the same shape (8
virtual CPU devices).

One cohort a mesh shape runs every case of that shape: ``mp=2`` (world
2) and ``dp=2,mp=2`` (world 4).  Each rank (``torch_dp_worker.py``, no
JAX imported) steps on its dp slice's 64-row batch at 2^12 features;
the ranks of an ``mp`` line share their slice.  Parameters start from
the JAX init (``w`` drawn too, so the linear term's shards matter) and
are gathered whole (``gather_params``) for the comparison; each rank's
own shapes show the split.  JAX's DCNv2 and DeepFM run their plain XLA
path (the Pallas kernels are held on the dp meshes by
``test_torch_dp_train.py``).

Tolerances, as ``test_torch_dp_train.py``: losses ``rtol = 1e-4``
against JAX after 3 Adam steps (the same float32 terms summed in other
orders, per shard and then across ranks), parameters ``rtol = 1e-4,
atol = 1e-5`` (Adam moves an element whose gradient is near rounding
level by a rounding-sized share of the learning rate); the ranks'
gathered parameters ``array_equal`` to each other (a replicated
parameter's gradient is all-reduced over every rank, so every replica
steps on the same bits); evaluation sums ``rtol = 1e-5``; the k-step
call runs eagerly over gloo, the per-step loop's operations:
``array_equal``, and so does ``fit_stream`` on an unplaced model (it
places the model and runs the same steps); checkpoints: ``array_equal``.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
jnp = jax.numpy
from jax.sharding import Mesh  # noqa: E402

from dmlc_core_tpu.models import dcn as jdcn  # noqa: E402
from dmlc_core_tpu.models import deep as jdeep  # noqa: E402
from dmlc_core_tpu.models import ffm as jffm  # noqa: E402
from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu.models import train as jtrain  # noqa: E402
from dmlc_core_tpu.utils import CheckpointManager as JaxCheckpoints  # noqa
from dmlc_core_tpu_torch.data import RowBlock, parse_libfm  # noqa: E402
from dmlc_core_tpu_torch.pipeline import (pack_flat,  # noqa: E402
                                          pack_rowmajor)
from torch_dp_worker import run_cohort  # noqa: E402

F, D, L, NF = 1 << 12, 8, 2, 4
FFM_D = 4
ROWS, CAP, K_CAP = 64, 512, 8
STEPS, LR = 3, 0.01
TRAJ = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=1e-4, atol=1e-5)
EVAL = dict(rtol=1e-5, atol=1e-7)


def _case(model, mode, layout, l2=1e-3, **kw):
    return dict(model=model, table_shard=mode, layout=layout, l2=l2, **kw)


CASES = {
    "fm_dim_flat": _case("fm", "dim", "flat", eval=True, fit=True),
    "fm_dim_rowmajor": _case("fm", "dim", "rowmajor", kbatch=True),
    "fm_rows_flat": _case("fm", "rows", "flat", kbatch=True, eval=True,
                          checkpoint=True),
    "fm_rows_rowmajor": _case("fm", "rows", "rowmajor"),
    "dcn_dim_flat": _case("dcn", "dim", "flat"),
    "dcn_dim_rowmajor": _case("dcn", "dim", "rowmajor"),
    "dcn_rows_flat": _case("dcn", "rows", "flat"),
    "deepfm_dim_flat": _case("deepfm", "dim", "flat", restore=True),
    "deepfm_dim_rowmajor": _case("deepfm", "dim", "rowmajor", fit=True),
    "deepfm_rows_flat": _case("deepfm", "rows", "flat"),
    "deepfm_rows_rowmajor": _case("deepfm", "rows", "rowmajor"),
    "ffm_dim_flat": _case("ffm", "dim", "flat"),
    "ffm_dim_rowmajor": _case("ffm", "dim", "rowmajor"),
    "ffm_rows_flat": _case("ffm", "rows", "flat"),
    "ffm_rows_rowmajor": _case("ffm", "rows", "rowmajor"),
    # l2 large enough to dominate: counted once a shard or once a rank,
    # it would show
    "fm_dim_l2": _case("fm", "dim", "flat", l2=0.1),
    "fm_rows_l2": _case("fm", "rows", "flat", l2=0.1),
}
#: each mesh's cases
MESHES = {
    "mp=2": list(CASES),
    "dp=2,mp=2": ["fm_dim_flat", "fm_rows_flat", "dcn_dim_flat",
                  "deepfm_dim_rowmajor", "deepfm_rows_rowmajor",
                  "ffm_dim_flat", "ffm_rows_rowmajor", "fm_rows_l2"],
}


def shape(spec: str) -> dict:
    """``{"dp": n, <the other axis>: m}`` of a spec of this file's."""
    sizes = {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}
    return {"dp": sizes.pop("dp", 1), **sizes}


def _text(rows: int, seed: int, fields: bool) -> bytes:
    """libfm text (libsvm's tokens with a field first where ``fields``;
    the port's libfm parser reads both).  Ids reach past F, so the id
    rules of the sharded gathers are exercised."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(2, 9))
        idx = np.sort(rng.choice(F + 8, size=n, replace=False))
        fs = rng.integers(0, NF, n)
        toks = b" ".join(
            (b"%d:" % f if fields else b"0:") + b"%d:%.4f" % (j, v)
            for f, j, v in zip(fs.tolist(), idx.tolist(),
                               rng.random(n).tolist()))
        lines.append(b"%d " % int(rng.integers(0, 2)) + toks)
    return b"\n".join(lines) + b"\n"


def _batch(case: dict, seed: int) -> dict:
    ffm = case["model"] == "ffm"
    d = parse_libfm(_text(ROWS, seed, ffm))
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"], d["fields"] if ffm else None,
                   int(d["max_field"]))
    if case["layout"] == "flat":
        b = pack_flat(blk, ROWS, CAP, want_fields=ffm)
        b.pop("row_ptr")
        return b
    return pack_rowmajor(blk, ROWS, K_CAP, want_fields=ffm)


def union(batches: list) -> dict:
    """The global batch of the dp slices' batches, in dp order."""
    keys = [k for k in batches[0] if k != "segments"]
    out = {k: np.concatenate([b[k] for b in batches]) for k in keys}
    if "segments" in batches[0]:
        rows = sum(len(b["labels"]) for b in batches)
        segs, at = [], 0
        for b in batches:
            n, s = len(b["labels"]), b["segments"]
            segs.append(np.where((s >= 0) & (s < n), s + at, rows)
                        .astype(np.int32))
            at += n
        out["segments"] = np.concatenate(segs)
    return out


def _jax_model(case: dict, mesh=None):
    kind, l2 = case["model"], case["l2"]
    if kind == "fm":
        return jsparse.FactorizationMachine(F, D, l2=l2)
    if kind == "dcn":
        return jdcn.DCNv2(F, D, L, l2=l2, engine="xla")
    if kind == "ffm":
        return jffm.FieldAwareFM(F, NF, FFM_D, l2=l2)
    model = jdeep.DeepFM(F, D, L, l2=l2, engine="xla")
    if case.get("microbatches"):
        model = model.with_pipelined_tower(mesh, "pp",
                                           case["microbatches"])
    return model


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _init(case: dict, seed: int = 0):
    tree = jax.tree_util.tree_map(
        np.asarray, _jax_model(dict(case, microbatches=0)).init(
            jax.random.PRNGKey(seed)))
    tree["w"] = (np.random.default_rng(seed).normal(size=F) * 0.1
                 ).astype(np.float32)
    return tree


def jax_mesh(spec: str) -> Mesh:
    sizes = shape(spec)
    n = int(np.prod(list(sizes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(sizes.values())),
                tuple(sizes))


def jax_train(case: dict, init, steps_batches: list, spec: str):
    """JAX ``make_train_step(mesh=)`` with the case's placements over the
    union batches."""
    mesh = jax_mesh(spec)
    model = _jax_model(case, mesh)
    opt = optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    params = jtrain.shard_params(params, jtrain.param_shardings(
        model, params, mesh, table_shard=case.get("table_shard", "dim")))
    state = opt.init(params)
    step = jtrain.make_train_step(model, opt, mesh, donate=False)
    losses = []
    for batch in steps_batches:
        params, state, loss = step(params, state,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        losses.append(float(loss))
    return dict(_flat(jax.tree_util.tree_map(np.asarray, params))), losses


def inputs(spec: str, cases_table: dict, names: list, tmp) -> tuple:
    dp = shape(spec)["dp"]
    arrays, cases = {}, []
    for i, name in enumerate(names):
        case = dict(cases_table[name], name=name, F=F, D=D, L=L, nf=NF,
                    lr=LR, steps=STEPS)
        if case["model"] == "ffm":
            case["D"] = FFM_D
        if case.pop("checkpoint", False):
            case["checkpoint"] = str(tmp / f"ck_{name}")
        if case.pop("restore", False):
            case["restore"] = str(tmp / f"jax_{name}")
            JaxCheckpoints(case["restore"]).save(
                1, {"params": _init(case, seed=7), "step": 1})
        cases.append(case)
        for k, v in _flat(_init(case)):
            arrays[f"{name}/init/{k}"] = v
        for r in range(dp):
            for s in range(STEPS):
                b = _batch(case, 1000 * i + 10 * s + r)
                for k, v in b.items():
                    arrays[f"{name}/r{r}/s{s}/{k}"] = v
    return arrays, cases


def cohort(tmp_path_factory, spec: str, cases_table: dict, names: list,
           task: str = "train", **extra) -> tuple:
    world = int(np.prod(list(shape(spec).values())))
    d = tmp_path_factory.mktemp(spec.replace("=", "").replace(",", "_"))
    arrays, cases = inputs(spec, cases_table, names, d)
    arrays.update(extra)
    np.savez(d / "in.npz", **arrays)
    ranks = run_cohort(d, world, task, inputs=str(d / "in.npz"),
                       cases=cases, spec=spec)
    return arrays, {c["name"]: c for c in cases}, ranks


def cohorts(tmp_path_factory, cases_table: dict, meshes: dict, **kw):
    """``get(spec)``: the cohort of ``spec``, run once at its first use."""
    done: dict = {}

    def get(spec):
        if spec not in done:
            done[spec] = cohort(tmp_path_factory, spec, cases_table,
                                meshes[spec], **kw)
        return done[spec]
    return get


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cohorts(tmp_path_factory, CASES, MESHES)


def steps_batches(arrays, name, dp):
    return [union([{k.split("/")[-1]: arrays[k] for k in arrays
                    if k.startswith(f"{name}/r{r}/s{s}/")}
                   for r in range(dp)]) for s in range(STEPS)]


def check_against_jax(spec, arrays, cases, ranks, name):
    case = cases[name]
    want, jlosses = jax_train(case, _init(case),
                              steps_batches(arrays, name,
                                            shape(spec)["dp"]), spec)
    np.testing.assert_allclose(ranks[0][f"{name}/losses"], jlosses, **TRAJ)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][f"{name}/params/{k}"], v,
                                   err_msg=k, **PARAMS)
    return jlosses


def check_ranks_equal(ranks, name):
    keys = [k for k in ranks[0] if k.startswith(f"{name}/params/")]
    assert keys
    for out in ranks[1:]:
        np.testing.assert_array_equal(out[f"{name}/losses"],
                                      ranks[0][f"{name}/losses"])
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


def check_fit_stream(spec, arrays, cases, ranks, name):
    """``fit_stream(mesh=)`` on an unplaced model: with an optimizer built
    before the placing it refuses and leaves the model unplaced; with
    none it places the model (dim mode), builds Adam(1e-2) (this file's
    ``LR``) and takes the steps JAX takes, the per-step loop's bits."""
    case = cases[name]
    for out in ranks:
        assert "before building the optimizer" in str(
            out[f"{name}/fit/refused"])
        assert not bool(out[f"{name}/fit/placed_after_refusal"])
    want, jlosses = jax_train(case, _init(case),
                              steps_batches(arrays, name,
                                            shape(spec)["dp"]), spec)
    np.testing.assert_allclose(ranks[0][f"{name}/fit/losses"], jlosses,
                               **TRAJ)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][f"{name}/fit/params/{k}"], v,
                                   err_msg=k, **PARAMS)
    for out in ranks:
        np.testing.assert_array_equal(out[f"{name}/fit/losses"],
                                      ranks[0][f"{name}/losses"])
        for k in want:
            np.testing.assert_array_equal(out[f"{name}/fit/params/{k}"],
                                          ranks[0][f"{name}/params/{k}"],
                                          err_msg=k)


PAIRS = [(s, n) for s, names in MESHES.items() for n in names]


@pytest.mark.parametrize("spec,name", PAIRS)
def test_mp_steps_match_jax_sharded_steps(runs, spec, name):
    arrays, cases, ranks = runs(spec)
    check_against_jax(spec, arrays, cases, ranks, name)


@pytest.mark.parametrize("spec,name", PAIRS)
def test_replicas_bit_equal_and_tables_split(runs, spec, name):
    arrays, cases, ranks = runs(spec)
    check_ranks_equal(ranks, name)
    case = cases[name]
    shapes = json.loads(str(ranks[0][f"{name}/shapes"]))
    full = {k: list(v.shape) for k, v in arrays.items()
            if k.startswith(f"{name}/init/")}
    v = full[f"{name}/init/v"]
    if case["table_shard"] == "dim":
        assert shapes["v"] == v[:-1] + [v[-1] // 2]
        assert shapes["w"] == [F]
    else:
        assert shapes["v"] == [F // 2] + v[1:]
        assert shapes["w"] == [F // 2]


@pytest.mark.parametrize("spec,name", [(s, n) for s, n in PAIRS
                                       if n.endswith("_l2")])
def test_l2_is_counted_once(runs, spec, name):
    """At l2 = 0.1 the penalty dominates the loss: counted once a rank or
    a shard would show at the first step."""
    arrays, cases, ranks = runs(spec)
    init = _init(cases[name])
    jlosses = check_against_jax(spec, arrays, cases, ranks, name)
    pen = 0.1 * sum(float(np.sum(np.asarray(v, np.float64) ** 2))
                    for k, v in init.items() if k in ("w", "v"))
    assert pen > 0.5 * jlosses[0]
    np.testing.assert_allclose(ranks[0][f"{name}/losses"][0], jlosses[0],
                               rtol=1e-5)


@pytest.mark.parametrize("spec,name", [(s, n) for s, n in PAIRS
                                       if CASES[n].get("fit")])
def test_fit_stream_places_an_unplaced_model(runs, spec, name):
    arrays, cases, ranks = runs(spec)
    check_fit_stream(spec, arrays, cases, ranks, name)


@pytest.mark.parametrize("spec", sorted(MESHES))
def test_kbatch_equals_k_sequential_mp_steps(runs, spec):
    _, _, ranks = runs(spec)
    names = [n for n in MESHES[spec] if CASES[n].get("kbatch")]
    assert names
    for name in names:
        for out in ranks:
            assert str(out[f"{name}/kbatch_route"]) == "eager"   # gloo
            np.testing.assert_array_equal(out[f"{name}/kbatch_losses"],
                                          out[f"{name}/losses"])
            for k in [k for k in out if k.startswith(f"{name}/params/")]:
                np.testing.assert_array_equal(
                    out[k.replace("/params/", "/kbatch/")], out[k],
                    err_msg=k)


@pytest.mark.parametrize("spec", sorted(MESHES))
def test_evaluate_stream_on_mp_equals_jax(runs, spec):
    arrays, cases, ranks = runs(spec)
    names = [n for n in MESHES[spec] if CASES[n].get("eval")]
    assert names
    dp = shape(spec)["dp"]
    for name in names:
        model = _jax_model(cases[name])
        pre = f"{name}/params/"
        params = _nest({k[len(pre):]: jnp.asarray(v)
                        for k, v in ranks[0].items() if k.startswith(pre)})
        batches = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in steps_batches(arrays, name, dp)]
        mesh = jax_mesh(spec)
        want = jtrain.evaluate_stream(model, params, batches, mesh=mesh)
        c, t = jtrain.make_eval_step(model, mesh)(params, batches[0])
        for out in ranks:
            np.testing.assert_allclose(
                out[f"{name}/eval"], [want["accuracy"], want["weight"],
                                      want["auc"]], **EVAL)
            np.testing.assert_allclose(out[f"{name}/eval_step"],
                                       [float(c), float(t)], **EVAL)


def test_mp_checkpoint_restores_in_the_jax_package(runs):
    """A DMLCKPT1 checkpoint saved from a rows-sharded FM holds the whole
    tree: the JAX CheckpointManager restores it, equal to the gathered
    parameters."""
    arrays, cases, ranks = runs("mp=2")
    name = "fm_rows_flat"
    step, got = JaxCheckpoints(cases[name]["checkpoint"]).restore()
    assert step == STEPS and int(got["step"]) == STEPS
    for k, v in _flat(got["params"]):
        np.testing.assert_array_equal(np.asarray(v),
                                      ranks[0][f"{name}/params/{k}"])
        assert np.asarray(v).shape == arrays[f"{name}/init/{k}"].shape


def test_jax_checkpoint_restores_into_a_sharded_model(runs):
    """A tree the JAX package saved loads into a dim-sharded DeepFM
    through ``params_from_jax(model=)``: each rank holds its columns of
    ``v`` and the whole of every replicated leaf."""
    arrays, cases, ranks = runs("mp=2")
    name = "deepfm_dim_flat"
    _, got = JaxCheckpoints(cases[name]["restore"]).restore()
    tree = dict(_flat(got["params"]))
    for r, out in enumerate(ranks):
        for k, v in tree.items():
            mine = out[f"{name}/restored/{k}"]
            if k == "v":
                half = v.shape[1] // 2
                v = v[:, r * half:(r + 1) * half]
            np.testing.assert_array_equal(mine, v, err_msg=k)


# -- the contract, in this process -------------------------------------------

def _mp_mesh():
    """A world-1 ``mp`` mesh object, for checks that run no collective."""
    from dmlc_core_tpu_torch.parallel.mesh import Mesh as TMesh
    return TMesh({"mp": 1}, 0, 1, torch.device("cpu"), "gloo", None, 60.0,
                 False)


def test_mesh_step_refuses_an_unplaced_model_or_a_stale_optimizer():
    """A model the mesh splits must be placed before its step, and its
    optimizer built after: one built before holds the whole ``v`` that
    the placing replaced, whose gradient stays None, and would never move
    the shard."""
    from dmlc_core_tpu_torch.models import (FactorizationMachine, MeshStep,
                                            adam, shard_params)
    from dmlc_core_tpu_torch.utils import DMLCError
    mesh = _mp_mesh()
    model = FactorizationMachine(64, 8, device="cpu")
    early = adam(model)
    with pytest.raises(DMLCError, match="shard_params"):
        MeshStep(model, early, mesh)
    shard_params(model, mesh)
    with pytest.raises(DMLCError, match="build it after"):
        MeshStep(model, early, mesh)
    MeshStep(model, adam(model), mesh)


def test_gather_params_of_an_unplaced_model_is_its_parameters():
    from dmlc_core_tpu_torch.models import FactorizationMachine, gather_params
    model = FactorizationMachine(64, 8, device="cpu")
    got = gather_params(model)
    assert list(got) == [k for k, _ in model.named_parameters()]
    for k, p in model.named_parameters():
        assert got[k].data_ptr() == p.data_ptr() and not got[k].requires_grad


# -- the sharded fields loader ---------------------------------------------

def test_sharded_fields_loader_equals_the_jax_loader(tmp_path):
    """``DeviceLoader(fields=True, sharding=)`` over partition (r, 2): its
    batches are array_equal to the JAX DeviceLoader's over the same
    partition, both layouts."""
    from dmlc_core_tpu.data import create_parser as jparser
    from dmlc_core_tpu.pipeline import DeviceLoader as JLoader
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.parallel.mesh import DataSharding
    from dmlc_core_tpu_torch.pipeline import DeviceLoader
    path = tmp_path / "t.libfm"
    path.write_bytes(_text(100, 5, True))
    for layout in ("flat", "rowmajor"):
        for r in range(2):
            sh = DataSharding(r, 2, torch.device("cpu"))
            with DeviceLoader(create_parser(str(path), r, 2, "libfm"), 16,
                              128 if layout == "flat" else 8, layout=layout,
                              fields=True, sharding=sh) as ld:
                mine = [{k: v.numpy() for k, v in b.items()} for b in ld]
            jl = JLoader(jparser(str(path), r, 2, "libfm"), batch_rows=16,
                         nnz_cap=128 if layout == "flat" else 8,
                         layout=layout, fields=True)
            theirs = [{k: np.asarray(v) for k, v in b.items()} for b in jl]
            jl.close()
            assert len(mine) == len(theirs) > 1
            for a, b in zip(mine, theirs):
                assert "fields" in a
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
