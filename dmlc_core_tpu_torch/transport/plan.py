"""Round-structured transfer planner of the resharder.

Counterpart of ``dmlc_core_tpu/transport/plan.py``, copied as it is.
Fetching every remote segment at once would leave the bytes in flight
unbounded (peak memory on both ends) and let a hot holder serve every
fetcher at once.  As a *planned collective schedule* (arxiv 2112.01075)
the transfers are grouped into rounds where

* the sum of in-flight bytes per round is bounded
  (``DMLC_RESHARD_MAX_BYTES`` — the same budget that sizes snapshots);
* no holder serves more than ``per_holder`` transfers in one round.

The planner is a pure function over transfer descriptors — deterministic
(first-fit-decreasing over a stable sort), so every rank computes the
identical schedule from the identical manifests without coordination,
as a rank of the JAX package does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = ["Transfer", "plan_rounds"]


class Transfer:
    """One planned fetch: rows ``[start, stop)`` of ``path`` from
    ``owner`` (with ``alts`` as failover holders), ``nbytes`` on the
    wire, ``tag`` = caller's opaque handle (assembly index)."""

    __slots__ = ("path", "start", "stop", "owner", "alts", "nbytes", "tag")

    def __init__(self, path: str, start: int, stop: int, owner: int,
                 alts: Sequence[int] = (), nbytes: int = 0,
                 tag: Optional[object] = None) -> None:
        self.path = path
        self.start = start
        self.stop = stop
        self.owner = owner
        self.alts = tuple(alts)
        self.nbytes = int(nbytes)
        self.tag = tag

    def __repr__(self) -> str:
        return (f"Transfer({self.path!r}, [{self.start}:{self.stop}) "
                f"from {self.owner}, {self.nbytes}B)")


def plan_rounds(transfers: Sequence[Transfer], *,
                max_bytes: Optional[int] = None,
                per_holder: int = 2) -> List[List[Transfer]]:
    """Group ``transfers`` into holder-balanced, byte-bounded rounds.

    First-fit-decreasing by ``nbytes`` over a deterministic order
    (``-nbytes, path, start``): each transfer lands in the earliest
    round whose byte budget and per-holder slot cap both admit it.  A
    single transfer larger than ``max_bytes`` still gets a round of its
    own (the budget bounds *concurrency*, it cannot shrink a leaf).
    ``max_bytes=None`` disables the byte bound (holder balance only);
    ``per_holder <= 0`` disables the slot cap.
    """
    order = sorted(transfers,
                   key=lambda t: (-t.nbytes, t.path, t.start, t.owner))
    rounds: List[List[Transfer]] = []
    budgets: List[int] = []           # bytes remaining per round
    holders: List[dict] = []          # owner → transfers already placed
    for t in order:
        placed = False
        for i, rnd in enumerate(rounds):
            if max_bytes is not None and t.nbytes > budgets[i] \
                    and len(rnd) > 0:
                continue
            if per_holder > 0 and holders[i].get(t.owner, 0) >= per_holder:
                continue
            rnd.append(t)
            budgets[i] -= t.nbytes
            holders[i][t.owner] = holders[i].get(t.owner, 0) + 1
            placed = True
            break
        if not placed:
            rounds.append([t])
            budgets.append((max_bytes if max_bytes is not None else 0)
                           - t.nbytes)
            holders.append({t.owner: 1})
    return rounds
