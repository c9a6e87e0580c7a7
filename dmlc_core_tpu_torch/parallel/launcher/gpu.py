"""`--cluster gpu`: a ``torch.distributed`` job over this host's cards.

Counterpart of ``dmlc_core_tpu/parallel/launcher/tpu.py``.  Where the
JAX package hands its processes the coordination service's address
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``), this launcher hands each worker torchrun's
contract:

* ``MASTER_ADDR`` / ``MASTER_PORT`` — rank 0's store (a free port);
* ``RANK`` / ``WORLD_SIZE`` — the worker's task id and the worker count;
* ``LOCAL_RANK`` — the rank modulo this host's cards (the rank itself on
  a host without one), so each rank picks its card;

beside the ``DMLC_*`` contract of the rabit tracker (the control
plane).  :func:`initialize_torch_from_env` is the worker's half.

A crashed worker is respawned with a bumped ``DMLC_NUM_ATTEMPT`` only
under ``--elastic``: a plain process group cannot admit a reborn
process, so without :class:`~..elastic.ElasticTorchMesh` in the worker a
respawn would hang.  Elastic jobs also get ``DMLC_ELASTIC_BASE_PORT``,
the first of a run of 8 consecutive free ports (generation ``g`` binds
``base + g``), drawn below the host's ephemeral range.
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import threading
from typing import Any, Dict, Optional

from ...utils.logging import log_info
from ...utils.parameter import get_env

__all__ = ["submit", "torch_rendezvous_env", "initialize_torch_from_env",
           "card_count"]


def _free_port() -> int:
    """A free port for a store that binds it later (``MASTER_PORT``):
    drawn below the ephemeral range, as :func:`_free_port_run`."""
    return _free_port_run(0)


def card_count() -> int:
    """The cards this host's workers can see (0 without CUDA)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def torch_rendezvous_env(world_size: int, host_ip: str = "127.0.0.1",
                         port: int = 0) -> Dict[str, str]:
    """The rendezvous every worker shares: rank 0's store address and
    the world."""
    return {"MASTER_ADDR": host_ip, "MASTER_PORT": str(port or _free_port()),
            "WORLD_SIZE": str(world_size)}


def initialize_torch_from_env(spec: str = "dp=-1", **kw: Any):
    """Worker-side bootstrap: the :class:`~..mesh.Mesh` of this launcher's
    (or torchrun's) environment, ``make_mesh(spec, **kw)`` over
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, its
    card ``cuda:LOCAL_RANK`` unless ``device=`` says otherwise; None for
    a single process (no ``MASTER_ADDR``).  The counterpart of
    ``initialize_jax_from_env``."""
    if not os.environ.get("MASTER_ADDR"):
        return None
    from ..mesh import make_mesh
    return make_mesh(spec, rank=get_env("RANK", get_env("DMLC_TASK_ID", 0)),
                     world_size=get_env("WORLD_SIZE", 1), **kw)


#: where the kernel draws outgoing connections' ports
_PORT_RANGE_FILE = "/proc/sys/net/ipv4/ip_local_port_range"
#: the lowest base drawn where the range leaves room (above the ports of
#: common local services)
_RUN_FLOOR = 10000


def _ephemeral_low() -> int:
    """The low end of the host's ephemeral port range; Linux's default,
    32768, where the file cannot be read."""
    try:
        with open(_PORT_RANGE_FILE) as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _free_port_run(length: int, tries: int = 50) -> int:
    """A base port with ``length`` CONSECUTIVE free ports above it,
    ``base .. base + length`` all probed free.  Elastic generation g
    binds base+g seconds or minutes after this returns, so the run is
    drawn at random BELOW the ephemeral range: a port the kernel hands
    to any outgoing connection in the meantime (as a port-0 bind's
    would be) cannot take it."""
    hi = _ephemeral_low() - length - 1
    lo = _RUN_FLOOR if hi > 2 * _RUN_FLOOR else 1024
    if hi < lo:
        raise OSError(f"no room for a run of {length + 1} ports below the "
                      f"ephemeral range")
    rng = random.SystemRandom()
    for _ in range(tries):
        base = rng.randint(lo, hi)
        socks = []
        try:
            for i in range(length + 1):
                s = socket.socket()
                socks.append(s)
                s.bind(("", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise OSError(f"no run of {length + 1} consecutive free ports found")


def worker_env(args, tracker_envs: Dict[str, str], rank: int,
               rendezvous: Dict[str, str], cards: int,
               elastic_base: Optional[str]) -> Dict[str, str]:
    """The environment of worker ``rank`` (without ``DMLC_NUM_ATTEMPT``,
    which each attempt sets)."""
    env = dict(os.environ)
    env.update(tracker_envs)
    env.update(rendezvous)
    env.update(args.extra_env)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_TASK_ID": str(rank),
        "RANK": str(rank),
        "LOCAL_RANK": str(rank % cards if cards else rank),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_JOB_CLUSTER": "gpu",
    })
    if elastic_base:
        env["DMLC_ELASTIC_BASE_PORT"] = elastic_base
    return env


def submit(args, tracker_envs: Dict[str, str]) -> int:
    n = args.num_workers
    rendezvous = torch_rendezvous_env(n, host_ip=args.host_ip or "127.0.0.1")
    elastic = bool(getattr(args, "elastic", False))
    # elastic retry is OPT-IN (see the module's docstring); with it,
    # reserve a consecutive port run for the generations' stores
    max_attempts = max(1, getattr(args, "max_attempts", 1)) if elastic else 1
    elastic_base = str(_free_port_run(8)) if elastic else ""
    cards = card_count()
    results = [0] * n
    threads = []
    for i in range(n):
        env = worker_env(args, tracker_envs, i, rendezvous, cards,
                         elastic_base)

        def run(env=env, slot=i):
            # per-slot retry with a bumped attempt counter — the launcher
            # half of elastic rejoin: the reborn process registers rabit
            # `recover` and (through ElasticTorchMesh) drags the cohort to
            # a fresh process-group generation at its sync point
            attempt = 0
            while True:
                env_try = dict(env, DMLC_NUM_ATTEMPT=str(attempt))
                rc = subprocess.call(args.command, env=env_try)
                if rc == 0:
                    results[slot] = 0
                    return
                attempt += 1
                log_info("gpu worker %d exited rc=%d (attempt %d/%d)",
                         slot, rc, attempt, max_attempts)
                if attempt >= max_attempts:
                    results[slot] = rc
                    return

        t = threading.Thread(target=run, daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    rc = next((r for r in results if r), 0)
    log_info("gpu job finished rc=%d", rc)
    return rc
