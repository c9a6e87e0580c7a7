"""The port's collectives (``dmlc_core_tpu_torch.parallel.collectives``)
on gloo meshes of 2 and 4 CPU processes, held against the JAX package's
on a dp mesh of the same size over the 8 virtual CPU devices.

Each rank runs in a process of its own (``torch_dp_worker.py``, which
imports no JAX) and passes its own block; the JAX side stacks the
blocks and runs ``MeshCollectives`` or the in-jit functions under
``shard_map``.  Sums of a few float32 values may round differently in
the two reductions: ``rtol = 1e-6``; everything else is exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from dmlc_core_tpu.parallel import collectives as jcoll  # noqa: E402
from dmlc_core_tpu.utils.jax_compat import shard_map  # noqa: E402
from torch_dp_worker import run_cohort  # noqa: E402

WORLDS = (2, 4)
TOL = dict(rtol=1e-6, atol=1e-7)


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(world)
    return {"x": rng.normal(size=(world, 3, 4)).astype(np.float32),
            "a2a": rng.normal(size=(world, world, 3)).astype(np.float32),
            "rs": rng.normal(size=(world, 2 * world, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"coll{world}")
        np.savez(d / "in.npz", **_inputs(world))
        out[world] = run_cohort(d, world, "collectives",
                                inputs=str(d / "in.npz"))
    return out


def _mesh(world: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:world]), ("dp",))


def _per_rank(world: int, body, blocks: np.ndarray) -> list:
    """``body`` under shard_map over a dp mesh, each rank's block in;
    each rank's output block out."""
    mesh = _mesh(world)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"),
                           out_specs=P("dp"), check_vma=False))
    glob = np.concatenate(list(blocks), axis=0)
    out = np.asarray(fn(glob))
    return np.split(out, world, axis=0)


def _jax_expected(world: int, name: str) -> list:
    """Each rank's expected result, from the JAX package."""
    inp = _inputs(world)
    coll = jcoll.MeshCollectives(_mesh(world), "dp")
    x, a2a, rs = inp["x"], inp["a2a"], inp["rs"]
    if name.startswith("allreduce_"):
        return [coll.allreduce(x, op=name.split("_")[1])] * world
    if name.startswith("fn_allreduce_"):
        op = name.split("_")[2]
        return _per_rank(world, lambda b: jcoll.allreduce(b, "dp", op), x)
    if name == "broadcast":
        return [coll.broadcast(x, root=world - 1)] * world
    if name == "fn_broadcast":
        return _per_rank(world, lambda b: jcoll.broadcast(b, "dp", 1), x)
    if name == "allgather":
        return [coll.allgather(x)] * world
    if name == "fn_allgather":
        return _per_rank(world, lambda b: jcoll.allgather(b, "dp"), x)
    if name == "fn_allgather_stacked":
        return _per_rank(world, lambda b: jcoll.allgather(
            b, "dp", axis=1, tiled=False), x)
    if name in ("all_to_all", "all_to_all_twice"):
        got = np.asarray(coll.all_to_all(a2a))
        if name == "all_to_all_twice":
            got = np.asarray(coll.all_to_all(got))
        return list(got)
    if name == "fn_all_to_all":
        return _per_rank(world, lambda b: jcoll.all_to_all(
            b, "dp", split_axis=0, concat_axis=1), a2a)
    if name == "fn_reduce_scatter":
        return _per_rank(world, lambda b: jcoll.reduce_scatter(b, "dp"), rs)
    if name == "int_allreduce":
        ints = np.stack([np.arange(5, dtype=np.int32) * (r + 1)
                         for r in range(world)])
        return [coll.allreduce(ints)] * world
    raise KeyError(name)


NAMES = ("allreduce_sum", "allreduce_max", "allreduce_min",
         "fn_allreduce_sum", "fn_allreduce_max", "fn_allreduce_min",
         "broadcast", "fn_broadcast", "allgather", "fn_allgather",
         "fn_allgather_stacked", "all_to_all", "all_to_all_twice",
         "fn_all_to_all", "fn_reduce_scatter", "int_allreduce")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_collective_equals_the_jax_mesh(cohorts, world, name):
    ranks = cohorts[world]
    want = _jax_expected(world, name)
    for r, out in enumerate(ranks):
        got = out[name]
        w = np.asarray(want[r])
        assert got.shape == w.shape
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, w)
        else:
            np.testing.assert_allclose(got, w, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gets_the_same_reduction(cohorts, world):
    """Rabit's contract: an allreduce leaves every rank with the same
    bits."""
    ranks = cohorts[world]
    for name in ("allreduce_sum", "fn_allreduce_sum", "allgather",
                 "broadcast"):
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[name], ranks[0][name])


def test_all_to_all_is_an_involution(cohorts):
    for out, r in zip(cohorts[4], range(4)):
        np.testing.assert_array_equal(out["all_to_all_twice"],
                                      _inputs(4)["a2a"][r])
