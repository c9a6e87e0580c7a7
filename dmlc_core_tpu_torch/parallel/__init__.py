"""Distributed layer of the port (counterpart of
``dmlc_core_tpu/parallel``): named process meshes and their collectives.

Only the data-parallel half is ported (ROADMAP A.7.a): :mod:`.mesh` and
:mod:`.collectives`.  The tracker, rabit, reshard and elastic modules
wait for A.7.b–c, and no name of theirs is exported here.
"""

from .collectives import (OPS, MeshCollectives, all_to_all,  # noqa: F401
                          allgather, allreduce, broadcast, reduce_scatter)
from .mesh import (DataSharding, Mesh, make_mesh,  # noqa: F401
                   parse_mesh_spec, process_mesh_info, remap_deltas,
                   remap_rows, row_owners, row_partition)

__all__ = ["Mesh", "DataSharding", "make_mesh", "parse_mesh_spec",
           "process_mesh_info", "row_partition",
           "remap_rows", "remap_deltas", "row_owners", "allreduce",
           "broadcast", "allgather", "reduce_scatter", "all_to_all",
           "MeshCollectives", "OPS"]
