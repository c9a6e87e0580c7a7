"""The serving fleet's control plane (counterpart of
``dmlc_core_tpu/serving/fleet``): a JSON-line registry owns membership,
liveness and the stable checkpoint pointers while the data plane stays on
the serving wire.

* :mod:`registry`: :class:`ReplicaRegistry` (auto-registration,
  heartbeat liveness, the multi-model map, a journal with fencing and a
  warm standby) and :class:`ReplicaAgent` (runs inside a replica:
  registers, heartbeats, applies reload directives); :func:`fleet_rpc`.
* :mod:`rollout`: :class:`RolloutManager`, canary checkpoint rollouts:
  a hot-reload staged on a subset, baked against SLO and p99 deltas, then
  promoted fleet-wide or rolled back, each transition in a bounded
  ledger served at ``/rollouts`` and attached to flight bundles.

The routing front-end (the JAX ``ServingRouter``) and its reactor are
ROADMAP queue A.11.b.  Importing this package starts no thread.
"""

from .registry import ReplicaAgent, ReplicaRegistry, fleet_rpc  # noqa: F401
from .rollout import RolloutManager  # noqa: F401

__all__ = ["ReplicaRegistry", "ReplicaAgent", "fleet_rpc", "RolloutManager"]
