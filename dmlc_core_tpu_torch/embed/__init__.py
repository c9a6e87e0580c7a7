"""Sharded embedding tables: distributed lookup/update over the elastic mesh.

Counterpart of ``dmlc_core_tpu/embed`` (ROADMAP A.8).  The recommendation
workload keys on ``(num_rows, dim)`` tables that outgrow one host.
:class:`ShardedEmbeddingTable` partitions such a table by rows across
the rabit cohort (``row_partition`` interval math), routes ragged CSR
lookups to owning ranks through a deduped fan-out exchange with a
hot-row cache, pools and differentiates each batch on the card through
the ragged-gather kernels, applies sparse updates so only touched rows
cross the network, and registers its shards as elastic state so
checkpoint-free resharding moves them live on generation bumps.
"""

from .exchange import ShardServer  # noqa: F401
from .table import ShardedEmbeddingTable  # noqa: F401

__all__ = ["ShardedEmbeddingTable", "ShardServer"]
