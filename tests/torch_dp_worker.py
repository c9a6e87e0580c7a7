"""One rank of the port's mesh CPU tests (dp, mp and pp).

    python tests/torch_dp_worker.py JOB.json

``JOB.json`` holds ``rank``, ``world``, ``init`` (``tcp://host:port``),
``spec`` (the mesh, ``dp=-1`` by default), ``task``, ``inputs`` (an
``.npz``) and ``out`` (where this rank writes its ``.npz``).  The
process imports torch, numpy and the port, and nothing of JAX: the
tests hold what it writes against the JAX package in their own process.
Each task runs over a gloo mesh on the CPU.  A training case may name
``table_shard`` (``"dim"`` or ``"rows"``) and ``microbatches`` (DeepFM's
tower pipelined over ``pp``); parameters are written whole
(``gather_params``), each rank's own shapes beside them.

With ``launcher="tracker"`` the ranks come from the port's rabit
tracker instead: each process registers with ``RabitContext.from_env()``
(``DMLC_TASK_ID`` its job id), rank 0 broadcasts the gloo rendezvous over
rabit, and the mesh is ``data_parallel_mesh`` at the tracker's rank and
world; the ``rabit`` task then agrees over rabit what ``train`` did.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.models import (DCNv2, DeepFM,  # noqa: E402
                                        FactorizationMachine, FieldAwareFM,
                                        adam, batch_sharding,
                                        evaluate_stream, fit_stream,
                                        gather_params, make_eval_step,
                                        make_train_step,
                                        make_train_step_kbatch,
                                        params_from_jax, params_to_numpy,
                                        shard_params, stack_batches)
from dmlc_core_tpu_torch.parallel import (MeshCollectives,  # noqa: E402
                                          RabitContext, RabitTracker,
                                          allgather, allreduce, all_to_all,
                                          broadcast, data_parallel_mesh,
                                          make_mesh, process_mesh_info,
                                          reduce_scatter)
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.parallel.collectives import (  # noqa: E402
    record_collectives)
from dmlc_core_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pipeline)
from dmlc_core_tpu_torch.utils import (CheckpointManager,  # noqa: E402
                                       DMLCError)

MODELS = {"fm": lambda c: FactorizationMachine(c["F"], c["D"], l2=c["l2"],
                                               device="cpu"),
          "dcn": lambda c: DCNv2(c["F"], c["D"], c["L"], l2=c["l2"],
                                 device="cpu"),
          "deepfm": lambda c: DeepFM(c["F"], c["D"], c["L"], l2=c["l2"],
                                     device="cpu"),
          "ffm": lambda c: FieldAwareFM(c["F"], c["nf"], c["D"], l2=c["l2"],
                                        device="cpu")}


def _batch(inp, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(inp[k].copy())
            for k in inp.files if k.startswith(prefix)}


def _params(model) -> dict:
    """The whole parameters, gathered over the mesh."""
    return {k: v.numpy().copy() for k, v in gather_params(model).items()}


def _model(inp, case: dict, mesh, rank: int, place: bool = True):
    model = MODELS[case["model"]](case)
    init = {k[len(case["name"]) + 6:]: torch.from_numpy(inp[k].copy())
            for k in inp.files if k.startswith(case["name"] + "/init/")}
    model.load_state_dict(init)
    if rank != 0:
        # the other ranks start elsewhere: rank 0's broadcast must fix it
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    if case.get("microbatches"):
        model = model.with_pipelined_tower(mesh, "pp",
                                           case["microbatches"])
    if place:
        shard_params(model, mesh, case.get("table_shard", "dim"))
    return model


#: each training case's trained model, by name, for the ``rabit`` task
_TRAINED: dict = {}


class _Batches:
    """A device loader's surface over a list of batches."""
    emit = "device"

    def __init__(self, batches, layout: str, sharding) -> None:
        self.batches, self.layout, self.sharding = batches, layout, sharding

    def __iter__(self):
        return iter(self.batches)

    def before_first(self) -> None:
        pass


def _said(fn) -> str:
    """``fn``'s refusal message, or '' where nothing was refused."""
    try:
        fn()
    except DMLCError as e:
        return str(e)
    return ""


def task_collectives(job, mesh, inp, out):
    me, coll = mesh.rank, MeshCollectives(mesh, "dp")
    x = torch.from_numpy(inp["x"][me].copy())
    for op in ("sum", "max", "min"):
        out[f"allreduce_{op}"] = coll.allreduce(x, op).numpy()
        out[f"fn_allreduce_{op}"] = allreduce(x, mesh, "dp", op).numpy()
    out["broadcast"] = coll.broadcast(inp["x"][me], root=mesh.world - 1
                                      ).numpy()
    out["fn_broadcast"] = broadcast(x, mesh, root=1).numpy()
    out["allgather"] = coll.allgather(x).numpy()
    out["fn_allgather"] = allgather(x, mesh).numpy()
    out["fn_allgather_stacked"] = allgather(x, mesh, axis=1,
                                            tiled=False).numpy()
    a2a = torch.from_numpy(inp["a2a"][me].copy())
    out["all_to_all"] = coll.all_to_all(a2a).numpy()
    out["all_to_all_twice"] = coll.all_to_all(coll.all_to_all(a2a)).numpy()
    out["fn_all_to_all"] = all_to_all(a2a, mesh, split_axis=0,
                                      concat_axis=1).numpy()
    out["fn_reduce_scatter"] = reduce_scatter(
        torch.from_numpy(inp["rs"][me].copy()), mesh).numpy()
    out["int_allreduce"] = coll.allreduce(
        torch.arange(5, dtype=torch.int32) * (me + 1)).numpy()


def task_train(job, mesh, inp, out):
    me = mesh.rank
    part = mesh.coord("dp")        # the ranks of a dp slice share its batches
    for case in job["cases"]:
        name, steps = case["name"], case["steps"]
        model = _model(inp, case, mesh, me)
        out[f"{name}/start"] = np.concatenate(
            [v.reshape(-1) for v in _params(model).values()])
        opt = adam(model, case["lr"], engine="torch")
        step = make_train_step(model, opt, mesh)
        losses = [float(step(_batch(inp, f"{name}/r{part}/s{s}/")))
                  for s in range(steps)]
        out[f"{name}/losses"] = np.array(losses, np.float32)
        for k, v in _params(model).items():
            out[f"{name}/params/{k}"] = v
        _TRAINED[name] = model
        out[f"{name}/shapes"] = np.array(json.dumps(
            {k: list(p.shape) for k, p in model.named_parameters()}))
        if case.get("checkpoint"):
            # the whole tree, from every rank's gather, saved by rank 0
            tree = params_to_numpy(gather_params(model), nested=True)
            if me == 0:
                CheckpointManager(case["checkpoint"]).save(
                    steps, {"params": tree, "step": steps})
        if case.get("restore"):
            # a whole tree the JAX package saved, cut to this rank's slices
            _, got = CheckpointManager(case["restore"]).restore()
            fresh = _model(inp, case, mesh, me)
            fresh.load_state_dict(params_from_jax(got["params"], "cpu",
                                                  model=fresh))
            for k, v in fresh.state_dict().items():
                out[f"{name}/restored/{k}"] = v.numpy().copy()
        if case.get("kbatch"):
            # the same steps again from the same start, as one k-step call
            model2 = _model(inp, case, mesh, me)
            opt2 = adam(model2, case["lr"], engine="torch")
            kstep = make_train_step_kbatch(model2, opt2, mesh)
            batches = [{k: v.numpy() for k, v in
                        _batch(inp, f"{name}/r{part}/s{s}/").items()}
                       for s in range(steps)]
            got = kstep(stack_batches(batches,
                                      sharding=batch_sharding(mesh)))
            out[f"{name}/kbatch_route"] = np.array(kstep.route)
            out[f"{name}/kbatch_losses"] = got.numpy()
            for k, v in _params(model2).items():
                out[f"{name}/kbatch/{k}"] = v
        if case.get("fit"):
            # fit_stream on an unplaced model: an optimizer built before
            # the placing is refused, the model left as it was; with none
            # it places the model, builds Adam(1e-2), and steps
            model3 = _model(inp, case, mesh, me, place=False)
            loader = _Batches([_batch(inp, f"{name}/r{part}/s{s}/")
                               for s in range(steps)], case["layout"],
                              batch_sharding(mesh))
            early = adam(model3, case["lr"])
            out[f"{name}/fit/refused"] = np.array(_said(lambda: fit_stream(
                model3, loader, optimizer=early, mesh=mesh)))
            out[f"{name}/fit/placed_after_refusal"] = np.array(
                getattr(model3, "_mesh_plan", None) is not None)
            out[f"{name}/fit/losses"] = np.array(fit_stream(
                model3, loader, mesh=mesh, log_every=1), np.float32)
            for k, v in _params(model3).items():
                out[f"{name}/fit/params/{k}"] = v
        if case.get("eval"):
            batches = [_batch(inp, f"{name}/r{part}/s{s}/")
                       for s in range(steps)]
            ev = evaluate_stream(model, batches, mesh=mesh)
            out[f"{name}/eval"] = np.array([ev["accuracy"], ev["weight"],
                                            ev["auc"]])
            c, t = make_eval_step(model, mesh)(batches[0])
            out[f"{name}/eval_step"] = np.array([float(c), float(t)])


def task_rabit(job, mesh, inp, out):
    """After ``train``, over the tracker's rabit links: each case's
    ``[sum of w * bce, sum of w, steps]`` over this rank's batches at the
    trained parameters (float64), all-reduced by rabit and by the mesh;
    a float64 digest of the parameters, all-gathered; rank 0's digest
    and a picklable object broadcast."""
    rc = job["rabit"]
    part = mesh.coord("dp")
    for case in job["cases"]:
        name = case["name"]
        model = _TRAINED[name]
        loss = wsum = 0.0
        with torch.no_grad():
            for s in range(case["steps"]):
                b = _batch(inp, f"{name}/r{part}/s{s}/")
                z = model(b).double()
                y = (b["labels"] > 0).double()
                w = b["weights"].double()
                per = -(y * F.logsigmoid(z) + (1.0 - y) * F.logsigmoid(-z))
                loss += float((per * w).sum())
                wsum += float(w.sum())
        mine = np.array([loss, wsum, float(case["steps"])])
        out[f"{name}/rabit_sums"] = rc.allreduce(mine)
        out[f"{name}/mesh_sums"] = allreduce(torch.from_numpy(mine),
                                             mesh).numpy()
        flat = np.concatenate([v.reshape(-1) for v in
                               _params(model).values()]).astype(np.float64)
        digest = np.array([flat.sum(), np.abs(flat).sum(),
                           (flat * flat).sum()])
        out[f"{name}/digests"] = rc.allgather(digest)
        out[f"{name}/root_digest"] = rc.broadcast(
            digest if rc.rank == 0 else None, root=0)
    out["rabit_rank"] = np.array(rc.rank)
    out["rabit_world"] = np.array(rc.world_size)


def task_fit(job, mesh, inp, out):
    """fit_stream over this rank's partition of a libsvm file."""
    case = job["fit"]
    me, world = mesh.rank, mesh.world
    model = _model(inp, case, mesh, me)
    opt = adam(model, case["lr"], engine="torch")
    parser = create_parser(case["uri"], me, world, "libsvm")
    seen = []

    class Recorder:
        """The loader, keeping each batch it hands over."""
        def __init__(self, loader):
            self.inner = loader
            self.emit, self.layout = loader.emit, loader.layout
            self.sharding = loader.sharding

        def __iter__(self):
            for b in self.inner:
                seen.append({k: v.numpy().copy() for k, v in b.items()})
                yield b

        def before_first(self):
            self.inner.before_first()

    with DeviceLoader(parser, case["rows"], case["cap"], layout="flat",
                      sharding=batch_sharding(mesh), engine="python",
                      put_threads=1, wire_compact=False) as loader:
        history = fit_stream(model, Recorder(loader), optimizer=opt,
                             mesh=mesh, epochs=case["epochs"], log_every=1)
    out["fit/history"] = np.array(history, np.float32)
    out["fit/batches"] = np.array(len(seen))
    for i, b in enumerate(seen):
        for k, v in b.items():
            out[f"fit/b{i}/{k}"] = v
    for k, v in _params(model).items():
        out[f"fit/params/{k}"] = v


def task_refusals(job, mesh, inp, out):
    """Each refusal's message, or '' where nothing was refused."""
    said = _said
    me, world = mesh.rank, mesh.world
    uri = job["uri"]
    sh = batch_sharding(mesh)
    other = (me + 1) % world
    out["wrong_partition"] = np.array(said(lambda: DeviceLoader(
        create_parser(uri, other, world, "libsvm"), 8, 64, sharding=sh)))
    out["ragged"] = np.array(said(lambda: DeviceLoader(
        create_parser(uri, me, world, "libsvm"), 8, 64, ragged=True,
        sharding=sh)))
    out["fields"] = np.array(said(lambda: DeviceLoader(
        create_parser(uri, me, world, "libfm"), 8, 64, fields=True,
        sharding=sh)))
    out["blocks"] = np.array(said(lambda: DeviceLoader(
        [], 8, 64, sharding=sh)))
    model = FactorizationMachine(64, 4, device="cpu")
    host = DeviceLoader(create_parser(uri, me, world, "libsvm"), 8, 64,
                        emit="host", device="cpu")
    out["emit_host"] = np.array(said(lambda: fit_stream(
        model, host, mesh=mesh)))
    host.close()
    plain = DeviceLoader(create_parser(uri, me, world, "libsvm"), 8, 64,
                         device="cpu")
    out["unsharded"] = np.array(said(lambda: fit_stream(
        model, plain, mesh=mesh)))
    plain.close()
    out["nccl_on_cpu"] = np.array(said(lambda: make_mesh(
        device="cpu", backend="nccl")))
    out["timeout_again"] = np.array(said(lambda: make_mesh(
        "dp=-1", device="cpu", timeout_s=5)))
    again = make_mesh("dp=-1", device="cpu")   # the existing group
    out["again"] = np.array(json.dumps([again.rank, again.world,
                                        again.backend, again.timeout_s]))


def task_pipeline(job, mesh, inp, out):
    """``make_pipeline`` over the ``pp`` axis: the forward of the stacked
    stages on ``xs`` and the gradients of ``sum(ys ** 2)`` with respect
    to this rank's stage and to ``xs``."""
    s = mesh.coord("pp")
    stage = {k: torch.from_numpy(inp[k][s:s + 1].copy()).requires_grad_()
             for k in ("w", "b")}
    xs = torch.from_numpy(inp["xs"].copy()).requires_grad_()
    run = make_pipeline(mesh, "pp",
                        lambda p, x: torch.tanh(x @ p["w"] + p["b"]))
    with record_collectives() as forward:
        ys = run(stage, xs)
    out["forward_collectives"] = np.array(json.dumps(forward))
    (ys ** 2).sum().backward()
    out["ys"] = ys.detach().numpy()
    out["gw"] = stage["w"].grad.numpy()
    out["gb"] = stage["b"].grad.numpy()
    out["gxs"] = xs.grad.numpy()


def task_axes(job, mesh, inp, out):
    """Along each axis: the sum and the gather of the ranks, over the
    axis's group."""
    x = torch.tensor([float(mesh.rank)])
    for axis in mesh.axis_names:
        out[f"axis/{axis}/sum"] = allreduce(x, mesh, axis).numpy()
        out[f"axis/{axis}/gather"] = allgather(x, mesh, axis).numpy()
        out[f"axis/{axis}/line"] = np.array(mesh.line(axis))


def task_info(job, mesh, inp, out):
    out["info"] = np.array(json.dumps(process_mesh_info()))


#: how a cohort's ranks find each other: an explicit ``init_method``,
#: torchrun's environment, the reference launcher's, none (world 1), or
#: the port's rabit tracker
LAUNCHERS = ("tcp", "torchrun", "dmlc", "alone", "tracker")


def _launch_env(launcher: str, rank: int, world: int, port: int) -> dict:
    master = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    if launcher == "torchrun":
        return {"RANK": str(rank), "WORLD_SIZE": str(world), **master}
    if launcher == "dmlc":
        return {"DMLC_TASK_ID": str(rank), "DMLC_NUM_WORKER": str(world),
                **master}
    if launcher == "tracker":
        return {"DMLC_TASK_ID": str(rank)}
    return {}


def run_cohort(tmp, world: int, task: str, timeout: float = 240.0,
               launcher: str = "tcp", **job) -> list:
    """Run ``task`` on ``world`` ranks of this script, each a process of
    its own over a gloo rendezvous on a free loopback port; returns each
    rank's outputs.  Every process is killed if the cohort outlives
    ``timeout`` seconds, and the test fails with their output."""
    assert launcher in LAUNCHERS, launcher
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT", "DMLC_TASK_ID", "DMLC_NUM_WORKER")}
    base.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    tracker = None
    if launcher == "tracker":
        tracker = RabitTracker(num_workers=world, host_ip="127.0.0.1")
        tracker.start()
        base.update(tracker.worker_envs())
    procs = []
    for r in range(world):
        path = os.path.join(str(tmp), f"job{r}.json")
        init = f"tcp://127.0.0.1:{port}" if launcher == "tcp" else None
        with open(path, "w") as f:
            json.dump({"rank": r, "world": world, "task": task,
                       "init": init, "out": str(tmp), "launcher": launcher,
                       **job}, f)
        env = dict(base, **_launch_env(launcher, r, world, port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{task} on world {world} outlived "
                             f"{timeout:.0f}s")
    finally:
        if tracker is not None:
            tracker.stop()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"{task} on world {world}: ranks failed "
                             f"{bad}:\n" + "\n".join(
                                 log[-3000:] for log in logs))
    return [dict(np.load(os.path.join(str(tmp), f"rank{r}.npz")))
            for r in range(world)]


def _tracker_mesh(job):
    """The tracker's rank and world, then the gloo rendezvous that rank 0
    broadcasts over rabit: ``(rabit context, mesh)``."""
    rc = RabitContext.from_env(heartbeat_interval=0)
    init = None
    if rc.rank == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
        s.close()
    init = rc.broadcast(init, root=0)
    mesh = data_parallel_mesh(device="cpu", init_method=init, rank=rc.rank,
                              world_size=rc.world_size, timeout_s=60)
    return rc, mesh


def main(path: str) -> int:
    with open(path) as f:
        job = json.load(f)
    rc = None
    if job.get("launcher") == "tracker":
        rc, mesh = _tracker_mesh(job)
        job["rabit"] = rc
    elif job.get("init"):
        mesh = make_mesh(job.get("spec", "dp=-1"), device="cpu",
                         init_method=job["init"], rank=job["rank"],
                         world_size=job["world"], timeout_s=60)
    else:
        mesh = make_mesh(job.get("spec", "dp=-1"), device="cpu",
                         timeout_s=60)
    inp = np.load(job["inputs"]) if job.get("inputs") else None
    out = {"rank": np.array(mesh.rank), "world": np.array(mesh.world),
           "shape": np.array(json.dumps(mesh.shape)),
           "coords": np.array(json.dumps({a: mesh.coord(a)
                                          for a in mesh.axis_names}))}
    for task in job["task"].split(","):
        globals()[f"task_{task}"](job, mesh, inp, out)
    np.savez(os.path.join(job["out"], f"rank{mesh.rank}.npz"), **out)
    mesh.close()
    if rc is not None:
        rc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
