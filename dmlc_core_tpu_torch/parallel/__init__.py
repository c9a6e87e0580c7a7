"""Distributed layer of the port (counterpart of
``dmlc_core_tpu/parallel``): named process meshes, their collectives and
the pipeline schedule (ROADMAP A.7.a), and the control plane of
``dmlc-submit`` (A.7.b): the rendezvous tracker (:mod:`.tracker`,
``python -m dmlc_core_tpu_torch.parallel.tracker``) and the rabit client
(:mod:`.rabit`), whose tree collectives run between processes over
sockets; elastic rejoin with live resharding (A.7.c1): the
generation-addressed mesh (:mod:`.elastic`), the resharder
(:mod:`.reshard`, with ``transport/plan.py``) and the launcher
(:mod:`.launcher`: ``python -m
dmlc_core_tpu_torch.parallel.launcher.submit``, clusters ``local`` and
``gpu``).  The launcher's cluster backends without a card (ssh, slurm,
sge, mpi, yarn, mesos) wait for A.7.c2.
"""

from .collectives import (OPS, MeshCollectives, all_to_all,  # noqa: F401
                          allgather, allreduce, broadcast, gather_dim,
                          reduce_scatter, sum_partials)
from .mesh import (DataSharding, Mesh, axis_lines,  # noqa: F401
                   data_parallel_mesh, make_mesh, parse_mesh_spec,
                   process_mesh_info, remap_deltas, remap_rows, row_owners,
                   row_partition)
from .pipeline import (make_pipeline, split_microbatches,  # noqa: F401
                       stack_stage_params, stage_sharding)
from .elastic import ElasticTorchMesh, ResyncResult  # noqa: F401
from .rabit import RabitContext  # noqa: F401
from .reshard import (HostSnapshot, ReshardStats, StateHandle,  # noqa: F401
                      redistribute, snapshot_tree)
from .tracker import (PSTracker, RabitTracker, compute_ring,  # noqa: F401
                      compute_tree)

__all__ = ["Mesh", "DataSharding", "make_mesh", "data_parallel_mesh",
           "parse_mesh_spec", "process_mesh_info", "row_partition",
           "axis_lines", "remap_rows", "remap_deltas", "row_owners",
           "allreduce", "broadcast", "allgather", "reduce_scatter",
           "all_to_all", "sum_partials", "gather_dim", "MeshCollectives",
           "OPS", "make_pipeline", "split_microbatches",
           "stack_stage_params", "stage_sharding", "RabitTracker",
           "PSTracker", "compute_tree", "compute_ring", "RabitContext",
           "ElasticTorchMesh", "ResyncResult", "StateHandle",
           "ReshardStats", "HostSnapshot", "snapshot_tree", "redistribute"]
