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
    ("dp=2,mp=2", "A.7.a2"), ("mp=2", "A.7.a2"), ("dp=-1,pp=2", "A.7.a2"),
    ("sp=4", "A.10"), ("dp=2,xx=2", "unknown axis")])
def test_make_mesh_refuses_axes_not_ported(spec, item):
    with pytest.raises(DMLCError, match=item):
        tmesh.make_mesh(spec, device="cpu")


def test_make_mesh_refuses_nccl_on_the_cpu():
    with pytest.raises(DMLCError, match="NCCL runs on CUDA"):
        tmesh.make_mesh(device="cpu", backend="nccl")


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is there")
    with pytest.raises(DMLCError, match="no CUDA device"):
        tmesh.make_mesh()


def test_param_shardings_replicate_on_dp_and_refuse_mp():
    model = FactorizationMachine(64, 4, device="cpu")
    dp = tmesh.Mesh({"dp": 1}, 0, 1, torch.device("cpu"), "gloo", None,
                    60.0, False)
    assert param_shardings(model, dp) == {
        "w0": "replicated", "w": "replicated", "v": "replicated"}
    assert param_shardings(model, None) is None
    mp = tmesh.Mesh({"dp": 1, "mp": 2}, 0, 1, torch.device("cpu"), "gloo",
                    None, 60.0, False)
    with pytest.raises(DMLCError, match="A.7.a2"):
        param_shardings(model, mp)


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
    ("fields", "fields=True is not ported with a sharding"),
    ("blocks", "cannot tell which partition"),
    ("emit_host", "single-card"),
    ("unsharded", "needs a loader built with sharding"),
    ("nccl_on_cpu", "NCCL runs on CUDA"),
    ("timeout_again", "its own timeout applies")])
def test_refusals_name_their_reason(refusals, what, reason):
    import re
    said = str(refusals[0][what])
    assert re.search(reason, said), said
    assert str(refusals[1][what]), f"rank 1 did not refuse {what}"


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
