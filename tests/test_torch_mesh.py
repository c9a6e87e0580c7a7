"""The port's process meshes (``dmlc_core_tpu_torch.parallel.mesh``) and
the data-parallel loader's contract, on the CPU.

The pure layout helpers are held against the JAX package's on a grid of
``(n_rows, parts)``; the axis rules against the JAX ``make_mesh`` over
the same number of virtual devices.  Meshes of processes run in
``torch_dp_worker.py`` processes (gloo, no JAX imported): built from an
explicit rendezvous, from torchrun's environment, from the reference's
``DMLC_TASK_ID``/``DMLC_NUM_WORKER`` and alone (world 1 over a file
store).  Every refusal is checked for its reason.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.parallel import mesh as jmesh  # noqa: E402
from dmlc_core_tpu_torch.models import param_shardings  # noqa: E402
from dmlc_core_tpu_torch.models import FactorizationMachine  # noqa: E402
from dmlc_core_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dmlc_core_tpu_torch.utils import DMLCError  # noqa: E402
from torch_dp_worker import run_cohort  # noqa: E402

GRID = [(n, p) for n in (0, 1, 5, 7, 64, 1000, 1 << 20)
        for p in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("spec", ["dp=4,mp=2", "dp=-1", " dp = 2 ,", "",
                                  "dp=-1,mp=2"])
def test_parse_mesh_spec_equals_jax(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["dp", "dp=-1,mp=-1"])
def test_parse_mesh_spec_refuses_as_jax(spec):
    with pytest.raises(Exception):
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(DMLCError):
        tmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("n_rows,parts", GRID)
def test_row_partition_and_owners_equal_jax(n_rows, parts):
    assert tmesh.row_partition(n_rows, parts) == \
        jmesh.row_partition(n_rows, parts)
    rows = np.unique(np.linspace(0, max(n_rows - 1, 0), 97).astype(
        np.int64)) if n_rows else np.zeros(0, np.int64)
    np.testing.assert_array_equal(tmesh.row_owners(n_rows, parts, rows),
                                  jmesh.row_owners(n_rows, parts, rows))


@pytest.mark.parametrize("n_rows,parts", GRID)
def test_remaps_equal_jax(n_rows, parts):
    for new in (1, 2, 3, 5):
        assert tmesh.remap_rows(n_rows, parts, new) == \
            jmesh.remap_rows(n_rows, parts, new)
        assert tmesh.remap_deltas(n_rows, parts, new) == \
            jmesh.remap_deltas(n_rows, parts, new)


def test_row_owners_refuses_rows_outside():
    with pytest.raises(DMLCError):
        tmesh.row_owners(10, 2, [10])


@pytest.mark.parametrize("spec,item", [
    ("dp=2,mp=2", None), ("mp=2", None), ("dp=-1,pp=2", None),
    ("sp=4", "A.10"), ("dp=2,xx=2", "unknown axis"), ("dp=2,sp=2", "A.10"),
    ("mp=2,sp=-1", "A.10"), ("pp=2,sp=2", "A.10")])
def test_make_mesh_refuses_axes_not_ported(spec, item):
    """``sp`` and unknown axes are refused, naming their queue item;
    ``mp`` and ``pp`` are taken, with JAX's axis sizes (over the
    processes the spec needs)."""
    if item is not None:
        with pytest.raises(DMLCError, match=item):
            tmesh.make_mesh(spec, device="cpu")
        return
    axes = tmesh.parse_mesh_spec(spec)
    tmesh.refuse_axes(axes)
    n = 4
    want = dict(jmesh.make_mesh(spec, jax.devices()[:n]).shape)
    assert tmesh._axis_sizes(dict(axes), n) == want


def test_make_mesh_refuses_nccl_on_the_cpu():
    with pytest.raises(DMLCError, match="NCCL runs on CUDA"):
        tmesh.make_mesh(device="cpu", backend="nccl")


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is there")
    with pytest.raises(DMLCError, match="no CUDA device"):
        tmesh.make_mesh()


def _jax_spec(sharding) -> str:
    """A JAX NamedSharding as the port's placement string."""
    spec = tuple(sharding.spec)
    split = [(i, a) for i, a in enumerate(spec) if a is not None]
    return "replicated" if not split else f"{split[0][1]}:{split[0][0]}"


def test_param_shardings_replicate_on_dp_and_refuse_mp():
    """Replicated on a dp mesh; on an mp mesh, the JAX recipe's
    placements in both table modes; a bad mode and an uneven rows split
    refused."""
    from dmlc_core_tpu.models import sparse as jsparse
    from dmlc_core_tpu.models import train as jtrain
    from jax.sharding import Mesh as JMesh
    model = FactorizationMachine(64, 4, device="cpu")
    dp = tmesh.Mesh({"dp": 1}, 0, 1, torch.device("cpu"), "gloo", None,
                    60.0, False)
    assert param_shardings(model, dp) == {
        "w0": "replicated", "w": "replicated", "v": "replicated"}
    assert param_shardings(model, None) is None
    mp = tmesh.Mesh({"dp": 1, "mp": 2}, 0, 2, torch.device("cpu"), "gloo",
                    None, 60.0, False)
    jm = JMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "mp"))
    jmodel = jsparse.FactorizationMachine(64, 4)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    for mode in ("dim", "rows"):
        want = jtrain.param_shardings(jmodel, jparams, jm, table_shard=mode)
        assert param_shardings(model, mp, mode) == {
            k: _jax_spec(v) for k, v in want.items()}
    with pytest.raises(ValueError):
        param_shardings(model, mp, "bogus")
    with pytest.raises(DMLCError, match="pad num_features"):
        param_shardings(FactorizationMachine(63, 4, device="cpu"), mp,
                        "rows")


@pytest.mark.parametrize("world,spec", [(4, "dp=-1"), (4, "dp=2"),
                                        (2, "dp=2"), (4, "dp=1")])
def test_axis_sizes_follow_the_jax_rules(tmp_path, world, spec):
    """-1 takes the world; unused capacity folds into the first axis."""
    ranks = run_cohort(tmp_path, world, "info", spec=spec)
    want = dict(jmesh.make_mesh(spec, jax.devices()[:world]).shape)
    for out in ranks:
        assert json.loads(str(out["shape"])) == want


def test_a_mesh_that_leaves_processes_out_is_refused():
    # JAX builds a 3-device mesh over 4 devices; a process cannot idle
    assert dict(jmesh.make_mesh("dp=3", jax.devices()[:4]).shape) == \
        {"dp": 3}
    with pytest.raises(DMLCError, match="outside it"):
        tmesh._axis_sizes({"dp": 3}, 4)


@pytest.mark.parametrize("launcher,world", [("torchrun", 2), ("dmlc", 2),
                                            ("alone", 1), ("tcp", 4)])
def test_make_mesh_from_each_launcher(tmp_path, monkeypatch, launcher,
                                     world):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    ranks = run_cohort(tmp_path, world, "info", launcher=launcher)
    # a world-1 mesh's store file goes with its group
    assert not list(tmp.glob("dmlc-mesh-*"))
    assert sorted(int(o["rank"]) for o in ranks) == list(range(world))
    for o in ranks:
        info = json.loads(str(o["info"]))
        assert info["process_count"] == world
        assert info["global_device_count"] == world
        assert info["process_index"] == int(o["rank"])
        assert set(info) == set(jmesh.process_mesh_info())


def test_process_mesh_info_without_a_group():
    info = tmesh.process_mesh_info()
    assert set(info) == set(jmesh.process_mesh_info())
    assert info["process_index"] == 0 and info["process_count"] == 1


def _libsvm(path, rows: int = 64) -> str:
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(rows):
            idx = np.sort(rng.choice(64, 3, replace=False))
            f.write(f"{i & 1} " + " ".join(f"{j}:1" for j in idx) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    d = tmp_path_factory.mktemp("refusals")
    return run_cohort(d, 2, "refusals", uri=_libsvm(d / "t.libsvm"))


@pytest.mark.parametrize("what,reason", [
    ("wrong_partition", r"reads partition \(1, 2\), but this is rank 0"),
    ("ragged", "ragged=True cannot shard"),
    ("fields", None),
    ("blocks", "cannot tell which partition"),
    ("emit_host", "single-card"),
    ("unsharded", "needs a loader built with sharding"),
    ("nccl_on_cpu", "NCCL runs on CUDA"),
    ("timeout_again", "its own timeout applies")])
def test_refusals_name_their_reason(refusals, what, reason):
    """Each refusal names its reason; ``fields`` (None) is taken now: a
    sharded libfm loader with fields builds on every rank."""
    import re
    said = str(refusals[0][what])
    if reason is None:
        assert said == "" and str(refusals[1][what]) == "", said
        return
    assert re.search(reason, said), said
    assert str(refusals[1][what]), f"rank 1 did not refuse {what}"


@pytest.mark.parametrize("spec", ["dp=2,mp=2", "dp=2,pp=2", "mp=4",
                                  "pp=2,mp=2"])
def test_axis_lines_follow_the_jax_device_layout(spec):
    """Ranks lie row-major over the spec's axes, as the JAX package
    reshapes its device list: each line along an axis is a row of the
    JAX mesh's device ids moved to that axis."""
    jm = jmesh.make_mesh(spec, jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    sizes = tmesh._axis_sizes(tmesh.parse_mesh_spec(spec), 4)
    for at, axis in enumerate(jm.axis_names):
        want = np.moveaxis(ids, at, -1).reshape(-1, ids.shape[at])
        assert tmesh.axis_lines(sizes, axis) == want.tolist()


@pytest.mark.parametrize("spec", ["dp=2,mp=2", "dp=2,pp=2"])
def test_each_axis_reduces_over_its_line(tmp_path, spec):
    """On a 4-rank mesh every rank's coordinates, line and group along
    each axis: the sum and the gather of the ranks over the group."""
    ranks = run_cohort(tmp_path, 4, "axes,info", spec=spec)
    sizes = tmesh._axis_sizes(tmesh.parse_mesh_spec(spec), 4)
    for out in ranks:
        r = int(out["rank"])
        coords = json.loads(str(out["coords"]))
        assert list(coords.values()) == list(
            np.unravel_index(r, tuple(sizes.values())))
        for axis in sizes:
            line = [ln for ln in tmesh.axis_lines(sizes, axis) if r in ln][0]
            assert out[f"axis/{axis}/line"].tolist() == line
            assert float(out[f"axis/{axis}/sum"][0]) == sum(line)
            assert out[f"axis/{axis}/gather"].tolist() == [float(x)
                                                           for x in line]


def test_a_sharded_loader_stays_on_its_device(tmp_path):
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.pipeline import DeviceLoader
    sharding = tmesh.DataSharding(0, 1, torch.device("cuda", 0))
    with pytest.raises(DMLCError, match="stay on its own device"):
        DeviceLoader(create_parser(_libsvm(tmp_path / "t.libsvm"),
                                   threaded=False), 8, 64,
                     device="cpu", sharding=sharding)


def test_a_second_mesh_reuses_the_group(refusals):
    for r, out in enumerate(refusals):
        assert json.loads(str(out["again"])) == [r, 2, "gloo", None]
