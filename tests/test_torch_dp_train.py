"""Data-parallel training of the port (``models/train.py`` with
``mesh=``) on gloo meshes of 2 and 4 CPU processes, held against the
JAX package's ``make_train_step(mesh=)`` on the union batch over a dp
mesh of the same size (8 virtual CPU devices).

Each rank (``torch_dp_worker.py``, no JAX imported) steps on its own
64-row batch at 2^12 features, dim 8; step ``s`` of the JAX reference
takes the ranks' step-``s`` batches laid end to end (a flat batch's
segments moved to the union's rows, padding to its scratch row).
Parameters start from the JAX init, carried across by the dotted names
of ``params_from_jax``; ranks other than 0 start elsewhere and take rank
0's by ``shard_params``.

Tolerances: the ranks' parameters are ``array_equal`` to each other
(every rank runs the same update on the same all-reduced sums); losses
``rtol = 1e-4`` against JAX after 3 Adam steps (as
``test_torch_train.py``: the same float32 terms summed in other orders,
per rank and then across ranks), parameters ``rtol = 1e-4, atol =
1e-5``: Adam divides each element's gradient by its running RMS, so an
element whose gradient is near rounding level moves by a rounding-sized
share of the learning rate (0.01), and summing over ranks rounds
differently from JAX's one reduction (at ``atol = 1e-6``, one element
of 32,768 in FM's ``v`` was 1.55e-6 off); evaluation sums ``rtol =
1e-5``.  The k-step call runs eagerly over
gloo, the same operations as the per-step loop: ``array_equal``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
jnp = jax.numpy
from jax.sharding import Mesh  # noqa: E402

from dmlc_core_tpu.models import dcn as jdcn  # noqa: E402
from dmlc_core_tpu.models import deep as jdeep  # noqa: E402
from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu.models import train as jtrain  # noqa: E402
from dmlc_core_tpu_torch.data import RowBlock, parse_libsvm  # noqa: E402
from dmlc_core_tpu_torch.pipeline import (pack_flat,  # noqa: E402
                                          pack_rowmajor)
from torch_dp_worker import run_cohort  # noqa: E402

F, D, L = 1 << 12, 8, 2
ROWS, CAP, K_CAP = 64, 512, 8
STEPS, LR = 3, 0.01
TRAJ = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=1e-4, atol=1e-5)
EVAL = dict(rtol=1e-5, atol=1e-7)

CASES = {
    "fm_flat": dict(model="fm", layout="flat", l2=1e-3, kbatch=True,
                    eval=True),
    "dcn_flat": dict(model="dcn", layout="flat", l2=1e-3),
    "deepfm_rowmajor": dict(model="deepfm", layout="rowmajor", l2=1e-3),
    # l2 large enough to dominate: counted W times it would show
    "fm_l2": dict(model="fm", layout="flat", l2=0.1),
}
WORLD_CASES = {2: list(CASES), 4: ["fm_flat"]}


def _text(rows: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(2, 9))
        idx = np.sort(rng.choice(F + 8, size=n, replace=False))
        toks = b" ".join(b"%d:%.4f" % (j, v) for j, v in
                         zip(idx.tolist(), rng.random(n).tolist()))
        lines.append(b"%d " % int(rng.integers(0, 2)) + toks)
    return b"\n".join(lines) + b"\n"


def _batch(layout: str, seed: int, rows: int = ROWS) -> dict:
    d = parse_libsvm(_text(rows, seed))
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"])
    if layout == "flat":
        b = pack_flat(blk, ROWS, CAP)
        b.pop("row_ptr")
        return b
    return pack_rowmajor(blk, ROWS, K_CAP)


def _jax_model(case: dict):
    kind = case["model"]
    if kind == "fm":
        return jsparse.FactorizationMachine(F, D, l2=case["l2"])
    if kind == "dcn":
        return jdcn.DCNv2(F, D, L, l2=case["l2"], engine="pallas")
    return jdeep.DeepFM(F, D, L, l2=case["l2"], engine="pallas")


def _init(case: dict, seed: int = 0):
    tree = jax.tree_util.tree_map(
        np.asarray, _jax_model(case).init(jax.random.PRNGKey(seed)))
    tree["w"] = (np.random.default_rng(seed).normal(size=F) * 0.1
                 ).astype(np.float32)
    return tree


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def union(batches: list) -> dict:
    """The global batch of the ranks' batches, in rank order."""
    if batches[0]["ids"].ndim == 2:
        return {k: np.concatenate([b[k] for b in batches])
                for k in ("ids", "vals", "labels", "weights")}
    rows = sum(len(b["labels"]) for b in batches)
    segs, at = [], 0
    for b in batches:
        n = len(b["labels"])
        s = b["segments"]
        segs.append(np.where((s >= 0) & (s < n), s + at, rows)
                    .astype(np.int32))
        at += n
    out = {k: np.concatenate([b[k] for b in batches])
           for k in ("ids", "vals", "labels", "weights")}
    out["segments"] = np.concatenate(segs)
    return out


def _jax_mesh(world: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:world]), ("dp",))


def jax_train(case: dict, init, steps_batches: list, world: int):
    """JAX ``make_train_step(mesh=)`` over the union batches."""
    model, mesh = _jax_model(case), _jax_mesh(world)
    opt = optax.adam(case.get("lr", LR))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    params = jtrain.shard_params(
        params, jtrain.param_shardings(model, params, mesh))
    state = opt.init(params)
    step = jtrain.make_train_step(model, opt, mesh, donate=False)
    losses = []
    for batch in steps_batches:
        params, state, loss = step(params, state,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        losses.append(float(loss))
    return dict(_flat(jax.tree_util.tree_map(np.asarray, params))), losses


def _inputs(world: int) -> dict:
    arrays, cases = {}, []
    for i, name in enumerate(WORLD_CASES[world]):
        case = dict(CASES[name], name=name, F=F, D=D, L=L, lr=LR,
                    steps=STEPS)
        cases.append(case)
        for k, v in _flat(_init(case)):
            arrays[f"{name}/init/{k}"] = v
        for r in range(world):
            for s in range(STEPS):
                b = _batch(case["layout"], 1000 * i + 10 * s + r)
                for k, v in b.items():
                    arrays[f"{name}/r{r}/s{s}/{k}"] = v
    return arrays, cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in WORLD_CASES:
        d = tmp_path_factory.mktemp(f"dp{world}")
        arrays, cases = _inputs(world)
        np.savez(d / "in.npz", **arrays)
        ranks = run_cohort(d, world, "train", inputs=str(d / "in.npz"),
                           cases=cases)
        out[world] = (arrays, {c["name"]: c for c in cases}, ranks)
    return out


def _steps_batches(arrays, name, world):
    return [union([{k.split("/")[-1]: arrays[k] for k in arrays
                    if k.startswith(f"{name}/r{r}/s{s}/")}
                   for r in range(world)]) for s in range(STEPS)]


PAIRS = [(w, n) for w, names in WORLD_CASES.items() for n in names]


@pytest.mark.parametrize("world,name", PAIRS)
def test_dp_steps_match_jax_on_the_union_batch(runs, world, name):
    arrays, cases, ranks = runs[world]
    case = cases[name]
    init = _init(case)
    want, jlosses = jax_train(case, init, _steps_batches(arrays, name,
                                                         world), world)
    np.testing.assert_allclose(ranks[0][f"{name}/losses"], jlosses, **TRAJ)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][f"{name}/params/{k}"], v,
                                   err_msg=k, **PARAMS)


@pytest.mark.parametrize("world,name", PAIRS)
def test_ranks_hold_bit_equal_parameters(runs, world, name):
    ranks = runs[world][2]
    keys = [k for k in ranks[0] if k.startswith(f"{name}/params/")]
    assert keys
    for out in ranks[1:]:
        np.testing.assert_array_equal(out[f"{name}/losses"],
                                      ranks[0][f"{name}/losses"])
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("world", sorted(WORLD_CASES))
def test_shard_params_starts_every_rank_from_rank_0(runs, world):
    arrays, _, ranks = runs[world]
    name = WORLD_CASES[world][0]
    want = np.concatenate([arrays[k].reshape(-1) for k in arrays
                           if k.startswith(f"{name}/init/")])
    for out in ranks:
        np.testing.assert_array_equal(np.sort(out[f"{name}/start"]),
                                      np.sort(want))


def test_l2_is_counted_once(runs):
    """At l2 = 0.1 the penalty dominates the loss: counted once per rank
    it would be twice JAX's."""
    arrays, cases, ranks = runs[2]
    init = _init(cases["fm_l2"])
    _, jlosses = jax_train(cases["fm_l2"], init,
                           _steps_batches(arrays, "fm_l2", 2), 2)
    pen = 0.1 * sum(float(np.sum(np.asarray(v, np.float64) ** 2))
                    for k, v in init.items() if k in ("w", "v"))
    assert pen > 0.5 * jlosses[0]
    np.testing.assert_allclose(ranks[0]["fm_l2/losses"][0], jlosses[0],
                               rtol=1e-5)


@pytest.mark.parametrize("world", sorted(WORLD_CASES))
def test_kbatch_equals_k_sequential_mesh_steps(runs, world):
    ranks = runs[world][2]
    for out in ranks:
        assert str(out["fm_flat/kbatch_route"]) == "eager"   # gloo
        np.testing.assert_array_equal(out["fm_flat/kbatch_losses"],
                                      out["fm_flat/losses"])
        for k in [k for k in out if k.startswith("fm_flat/params/")]:
            np.testing.assert_array_equal(
                out[k.replace("/params/", "/kbatch/")], out[k], err_msg=k)


def _port_params_as_jax(out, name):
    pre = f"{name}/params/"
    flat = {k[len(pre):]: out[k] for k in out if k.startswith(pre)}
    return {k: jnp.asarray(v) for k, v in flat.items()}


@pytest.mark.parametrize("world", sorted(WORLD_CASES))
def test_evaluate_stream_equals_jax(runs, world):
    arrays, cases, ranks = runs[world]
    model = _jax_model(cases["fm_flat"])
    params = _port_params_as_jax(ranks[0], "fm_flat")
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _steps_batches(arrays, "fm_flat", world)]
    want = jtrain.evaluate_stream(model, params, batches,
                                  mesh=_jax_mesh(world))
    for out in ranks:
        acc, weight, auc = out["fm_flat/eval"]
        np.testing.assert_allclose([acc, weight, auc],
                                   [want["accuracy"], want["weight"],
                                    want["auc"]], **EVAL)
        c, t = jtrain.make_eval_step(model, _jax_mesh(world))(params,
                                                              batches[0])
        np.testing.assert_allclose(out["fm_flat/eval_step"],
                                   [float(c), float(t)], **EVAL)


# -- uneven partitions: fit_stream over files cut by bytes -------------------
# (two ranks, one with twice the other's rows; four ranks over three rows,
# one with no batch at all: it steps on an empty row of weight 0)

FIT_ROWS, FIT_CAP = 16, 128


def _uneven_file(path) -> str:
    """Short lines first, long ones after: cut in two by bytes, the
    first half holds twice the rows of the second."""
    rng = np.random.default_rng(3)
    lines = []
    for i in range(88):
        n = 2 if i < 56 else 8
        idx = np.sort(rng.choice(F, size=n, replace=False))
        lines.append(f"{int(rng.integers(0, 2))} " + " ".join(
            f"{j}:{v:.4f}" for j, v in zip(idx, rng.random(n))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _tiny_file(path) -> str:
    """Three rows: cut in four by bytes, one partition is empty."""
    path.write_text("1 3:0.5 70:1.0\n0 5:0.25\n1 7:1.0 9:0.5\n")
    return str(path)


#: (world, the file): uneven partitions, and one rank with no batch at all
FITS = {"uneven": (2, _uneven_file), "empty": (4, _tiny_file)}


@pytest.fixture(scope="module", params=sorted(FITS))
def fit_run(request, tmp_path_factory):
    world, make = FITS[request.param]
    d = tmp_path_factory.mktemp(f"fit_{request.param}")
    case = dict(CASES["fm_l2"], name="fit", F=F, D=D, L=L, lr=LR,
                l2=1e-3, uri=make(d / "t.libsvm"), rows=FIT_ROWS,
                cap=FIT_CAP, epochs=1)
    np.savez(d / "in.npz", **{f"fit/init/{k}": v
                              for k, v in _flat(_init(case))})
    return request.param, case, run_cohort(
        d, world, "fit", inputs=str(d / "in.npz"), fit=case)


def test_uneven_partitions_neither_hang_nor_drop_a_step(fit_run):
    what, case, ranks = fit_run
    counts = [int(o["fit/batches"]) for o in ranks]
    assert len(set(counts)) > 1, counts
    assert (min(counts) == 0) == (what == "empty"), counts
    for o in ranks:
        assert len(o["fit/history"]) == max(counts)
    for o in ranks[1:]:
        np.testing.assert_array_equal(o["fit/history"],
                                      ranks[0]["fit/history"])
        for k in [k for k in ranks[0] if k.startswith("fit/params/")]:
            np.testing.assert_array_equal(o[k], ranks[0][k])


def test_uneven_partitions_match_jax(fit_run):
    _, case, ranks = fit_run
    counts = [int(o["fit/batches"]) for o in ranks]
    steps = []
    for s in range(max(counts)):
        live = []
        for r, o in enumerate(ranks):
            if s < counts[r]:
                b = {k.split("/")[-1]: o[k] for k in o
                     if k.startswith(f"fit/b{s}/")}
                b.pop("row_ptr", None)
                live.append(b)
        steps.append(union(live))
    want, jlosses = jax_train(case, _init(case), steps, len(ranks))
    np.testing.assert_allclose(ranks[0]["fit/history"], jlosses, **TRAJ)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][f"fit/params/{k}"], v,
                                   err_msg=k, **PARAMS)
