"""Pipeline parallelism of the port (``parallel/pipeline.py`` and
``DeepFM.with_pipelined_tower``) on gloo meshes of CPU processes, held
against the JAX package: ``make_pipeline`` over ``pp`` virtual CPU
devices for the schedule, and ``make_train_step(mesh=)`` of the JAX
pipelined DeepFM on the union batch over a ``("dp", "pp")`` mesh for
training.

Cohorts, each running every case of its mesh: ``pp=4`` (the schedule at
S = 4, M = 5, as ``test_pipeline_pp.py``), ``pp=2`` (DeepFM, both
layouts, and the schedule at S = 2, M = 3) and ``dp=2,pp=2`` (DeepFM,
both layouts).  Batches, inits and the JAX reference are
``test_torch_mp_train.py``'s; JAX's DeepFM runs its plain XLA path.

Tolerances: the schedule's outputs and gradients ``rtol = atol = 2e-5``
against JAX (float32 matmuls and tanh in another order; the JAX test
holds its own pipeline to its sequential run at 2e-5 for the forward);
training as ``test_torch_mp_train.py``: losses ``rtol = 1e-4``,
parameters ``rtol = 1e-4, atol = 1e-5``, the ranks' gathered parameters
``array_equal``, the k-step call ``array_equal`` to the per-step loop,
evaluation ``rtol = 1e-5``, checkpoints ``array_equal``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy
from jax.sharding import Mesh  # noqa: E402

from dmlc_core_tpu.models import train as jtrain  # noqa: E402
from dmlc_core_tpu.parallel import pipeline as jpipe  # noqa: E402
from dmlc_core_tpu.utils import CheckpointManager as JaxCheckpoints  # noqa
from dmlc_core_tpu_torch.models import DeepFM  # noqa: E402
from dmlc_core_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dmlc_core_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from test_torch_mp_train import (EVAL, STEPS, _case, _flat,  # noqa: E402
                                 _jax_model, _nest, check_against_jax,
                                 check_fit_stream, check_ranks_equal,
                                 cohort, jax_mesh, shape, steps_batches)

SCHED = dict(rtol=2e-5, atol=2e-5)
MB = 4                     # microbatches of DeepFM's 64-row batches

CASES = {
    "deepfm_pp_flat": _case("deepfm", "dim", "flat", microbatches=MB,
                            eval=True, checkpoint=True, fit=True),
    "deepfm_pp_rowmajor": _case("deepfm", "dim", "rowmajor",
                                microbatches=MB, kbatch=True),
}
MESHES = {"pp=2": list(CASES), "dp=2,pp=2": list(CASES), "pp=4": []}
#: (S, M) of the schedule each mesh runs beside its cases
SCHEDULES = {"pp=2": (2, 3), "pp=4": (4, 5)}
FEAT, MB_ROWS = 8, 2


def _schedule_inputs(S: int, M: int) -> dict:
    rng = np.random.default_rng(S * 10 + M)
    return {"w": (rng.standard_normal((S, FEAT, FEAT)) / np.sqrt(FEAT)
                  ).astype(np.float32),
            "b": (rng.standard_normal((S, FEAT)) * 0.1).astype(np.float32),
            "xs": rng.standard_normal((M, MB_ROWS, FEAT)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    done: dict = {}

    def get(spec):
        if spec not in done:
            extra = (_schedule_inputs(*SCHEDULES[spec])
                     if spec in SCHEDULES else {})
            task = "train,pipeline" if extra else "train"
            done[spec] = cohort(tmp_path_factory, spec, CASES,
                                MESHES[spec], task=task, **extra)
        return done[spec]
    return get


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("spec", sorted(SCHEDULES))
def test_pipeline_forward_and_gradients_match_jax(runs, spec):
    S, M = SCHEDULES[spec]
    arrays, _, ranks = runs(spec)
    mesh = Mesh(np.array(jax.devices()[:S]), ("pp",))
    run = jpipe.make_pipeline(mesh, "pp", _stage)
    stacked = {k: jnp.asarray(arrays[k]) for k in ("w", "b")}
    xs = jnp.asarray(arrays["xs"])
    want = np.asarray(run(jax.device_put(
        stacked, jpipe.stage_sharding(mesh, "pp")), xs))
    gp, gx = jax.grad(lambda p, x: jnp.sum(run(p, x) ** 2),
                      argnums=(0, 1))(stacked, xs)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["ys"], want, **SCHED)
        np.testing.assert_allclose(out["gw"], np.asarray(gp["w"])[r:r + 1],
                                   **SCHED)
        np.testing.assert_allclose(out["gb"], np.asarray(gp["b"])[r:r + 1],
                                   **SCHED)
        # xs is replicated over pp: every rank holds its whole gradient
        np.testing.assert_allclose(out["gxs"], np.asarray(gx), **SCHED)


@pytest.mark.parametrize("spec", sorted(SCHEDULES))
def test_pipeline_forward_runs_one_handoff_a_tick(runs, spec):
    """The forward's collectives, as ``record_collectives`` lists them:
    an all-gather of one microbatch a tick but the last (M + S − 2),
    then the all-reduce that replicates the last stage's outputs."""
    import json
    S, M = SCHEDULES[spec]
    mb = MB_ROWS * FEAT
    want = [["allgather", "pp", mb]] * (M + S - 2) + [["allreduce", "pp",
                                                       M * mb]]
    for out in runs(spec)[2]:
        assert json.loads(str(out["forward_collectives"])) == want


PAIRS = [(s, n) for s, names in MESHES.items() for n in names]


@pytest.mark.parametrize("spec,name", PAIRS)
def test_pp_steps_match_jax_pipelined_steps(runs, spec, name):
    arrays, cases, ranks = runs(spec)
    check_against_jax(spec, arrays, cases, ranks, name)


@pytest.mark.parametrize("spec,name", PAIRS)
def test_pp_replicas_bit_equal_and_stages_split(runs, spec, name):
    import json
    _, _, ranks = runs(spec)
    check_ranks_equal(ranks, name)
    shapes = json.loads(str(ranks[0][f"{name}/shapes"]))
    assert shapes["tower.w"][0] == 1 and shapes["tower.b"][0] == 1
    assert ranks[0][f"{name}/params/tower.w"].shape[0] == 2


@pytest.mark.parametrize("spec", ["pp=2", "dp=2,pp=2"])
def test_fit_stream_places_an_unplaced_pipelined_model(runs, spec):
    arrays, cases, ranks = runs(spec)
    check_fit_stream(spec, arrays, cases, ranks, "deepfm_pp_flat")


@pytest.mark.parametrize("spec", ["pp=2", "dp=2,pp=2"])
def test_kbatch_equals_k_sequential_pp_steps(runs, spec):
    _, _, ranks = runs(spec)
    name = "deepfm_pp_rowmajor"
    for out in ranks:
        assert str(out[f"{name}/kbatch_route"]) == "eager"   # gloo
        np.testing.assert_array_equal(out[f"{name}/kbatch_losses"],
                                      out[f"{name}/losses"])
        for k in [k for k in out if k.startswith(f"{name}/params/")]:
            np.testing.assert_array_equal(
                out[k.replace("/params/", "/kbatch/")], out[k], err_msg=k)


@pytest.mark.parametrize("spec", ["pp=2", "dp=2,pp=2"])
def test_evaluate_stream_on_pp_equals_jax(runs, spec):
    arrays, cases, ranks = runs(spec)
    name = "deepfm_pp_flat"
    mesh = jax_mesh(spec)
    model = _jax_model(cases[name], mesh)
    pre = f"{name}/params/"
    params = _nest({k[len(pre):]: jnp.asarray(v)
                    for k, v in ranks[0].items() if k.startswith(pre)})
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in steps_batches(arrays, name, shape(spec)["dp"])]
    want = jtrain.evaluate_stream(model, params, batches, mesh=mesh)
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}/eval"],
                                   [want["accuracy"], want["weight"],
                                    want["auc"]], **EVAL)


def test_pp_checkpoint_restores_in_the_jax_package(runs):
    arrays, cases, ranks = runs("pp=2")
    name = "deepfm_pp_flat"
    step, got = JaxCheckpoints(cases[name]["checkpoint"]).restore()
    assert step == STEPS
    for k, v in _flat(got["params"]):
        np.testing.assert_array_equal(np.asarray(v),
                                      ranks[0][f"{name}/params/{k}"])
        assert np.asarray(v).shape == arrays[f"{name}/init/{k}"].shape


# -- the contract, in this process --------------------------------------------

def _pp_mesh(n: int) -> tmesh.Mesh:
    """A mesh object for the checks that run before any collective."""
    return tmesh.Mesh({"pp": n}, 0, n, torch.device("cpu"), "gloo", None,
                      60.0, False)


def test_pipelined_tower_refuses_as_jax():
    with pytest.raises(ValueError, match="layers == mesh"):
        DeepFM(64, 8, layers=3, device="cpu").with_pipelined_tower(
            _pp_mesh(2), "pp")
    model = DeepFM(64, 8, layers=2, device="cpu").with_pipelined_tower(
        _pp_mesh(2), "pp", microbatches=4)
    with pytest.raises(ValueError, match="not divisible"):
        model._tower(torch.zeros(6, 8))


def test_mesh_step_refuses_an_unplaced_pipelined_model():
    """Unplaced, each stage would take its layer from the whole stack
    and the step would scale the tower's gradient by 1/pp: refused."""
    from dmlc_core_tpu_torch.models import MeshStep, adam
    from dmlc_core_tpu_torch.utils import DMLCError
    mesh = _pp_mesh(2)
    model = DeepFM(64, 8, layers=2, device="cpu").with_pipelined_tower(
        mesh, "pp")
    with pytest.raises(DMLCError, match="shard_params"):
        MeshStep(model, adam(model), mesh)


def test_pipelining_a_placed_model_is_refused():
    from dmlc_core_tpu_torch.models import shard_params
    from dmlc_core_tpu_torch.utils import DMLCError
    mesh = _pp_mesh(1)
    model = DeepFM(64, 8, layers=1, device="cpu").with_pipelined_tower(
        mesh, "pp")
    shard_params(model, mesh)
    with pytest.raises(DMLCError, match="before placing"):
        model.with_pipelined_tower(mesh, "pp")


def test_pipelined_tower_shares_the_parameters():
    base = DeepFM(64, 8, layers=2, device="cpu")
    pp = base.with_pipelined_tower(_pp_mesh(2), "pp")
    assert {k: id(p) for k, p in base.named_parameters()} == {
        k: id(p) for k, p in pp.named_parameters()}
    assert base._pipeline is None and pp._pipeline.axis == "pp"
    # the clone is a DeepFM with every attribute of the model's
    assert {k: v for k, v in vars(pp).items() if not k.startswith("_")
            } == {k: v for k, v in vars(base).items()
                  if not k.startswith("_")}
    # replacing a parameter of one (as placing does) leaves the other's
    pp.tower.w = torch.nn.Parameter(pp.tower.w[:1].clone())
    pp.v = torch.nn.Parameter(pp.v[:, :4].clone())
    assert base.tower.w.shape[0] == 2 and base.v.shape == (64, 8)


@pytest.mark.parametrize("B,M", [(12, 3), (12, 5), (8, 1)])
def test_split_microbatches_equals_jax(B, M):
    x = np.arange(B * 2, dtype=np.float32).reshape(B, 2)
    if B % M:
        with pytest.raises(ValueError):
            jpipe.split_microbatches(jnp.asarray(x), M)
        with pytest.raises(ValueError):
            tpipe.split_microbatches(torch.from_numpy(x), M)
        return
    np.testing.assert_array_equal(
        tpipe.split_microbatches(torch.from_numpy(x), M).numpy(),
        np.asarray(jpipe.split_microbatches(jnp.asarray(x), M)))


def test_stack_stage_params_and_placement_equal_jax():
    rng = np.random.default_rng(0)
    per = [{"w": rng.random((3, 3), dtype=np.float32),
            "b": rng.random(3, dtype=np.float32)} for _ in range(4)]
    want = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in
                                      p.items()} for p in per])
    got = tpipe.stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                     p.items()} for p in per])
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jmesh = Mesh(np.array(jax.devices()[:4]), ("pp",))
    assert jpipe.stage_sharding(jmesh, "pp").spec[0] == "pp"
    assert tpipe.stage_sharding(_pp_mesh(4), "pp") == "pp:0"
