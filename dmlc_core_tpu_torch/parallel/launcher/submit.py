"""`dmlc-submit` of the port — capability parity with reference
``tracker/dmlc-submit`` + ``dmlc_tracker/submit.py``: boot the rendezvous
tracker, dispatch to the cluster backend, join until shutdown
(`submit.py:42-53`, `tracker.py:410-433`).

Counterpart of ``dmlc_core_tpu/parallel/launcher/submit.py``:
``python -m dmlc_core_tpu_torch.parallel.launcher.submit --cluster
local|ssh|slurm|sge|mpi|yarn|mesos|gpu -n N [options] -- command``.  The
backends are the JAX package's (``gpu`` in ``tpu``'s place), with its
dispatch and dry runs; ``tpu`` is refused with a :class:`DMLCError`
naming ``gpu`` before the tracker starts, on a dry run too."""

from __future__ import annotations

import sys
from typing import List, Optional

from ...utils.logging import DMLCError, log_info
from ..tracker import RabitTracker
from .opts import get_opts

__all__ = ["main", "submit", "refuse_cluster"]


def refuse_cluster(cluster: str) -> None:
    """Raise for the one cluster of the parser the port does not launch,
    ``tpu``, naming its counterpart."""
    if cluster == "tpu":
        raise DMLCError("--cluster tpu launches JAX processes onto TPU "
                        "hosts; the port's counterpart is --cluster gpu "
                        "(torch.distributed over this host's cards)")


def submit(argv: Optional[List[str]] = None) -> int:
    args = get_opts(argv)
    fh = None
    if args.log_file:
        # mirror launcher logs to a file, stderr stays on (reference
        # opts.py:98-100 --log-file); detached in the finally below so
        # repeated submit() calls don't accumulate handlers/fds
        import logging as _pylogging
        from ...utils.logging import get_logger
        fh = _pylogging.FileHandler(args.log_file)
        fh.setFormatter(_pylogging.Formatter(
            "[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S"))
        get_logger().addHandler(fh)
    try:
        return _submit_job(args)
    finally:
        if fh is not None:
            from ...utils.logging import get_logger
            get_logger().removeHandler(fh)
            fh.close()


def _submit_job(args) -> int:
    refuse_cluster(args.cluster)
    # a single-host job must rendezvous over loopback: the auto-detected
    # "routable" address may not be reachable from inside containers or
    # network namespaces
    host_ip = args.host_ip or ("127.0.0.1" if args.cluster in ("local",
                                                                "gpu")
                               else None)
    tracker = RabitTracker(num_workers=args.num_workers, host_ip=host_ip)
    tracker.start()
    envs = tracker.worker_envs()

    ps_tracker = None
    if args.num_servers > 0:
        # parameter-server mode: launch the user command locally as the
        # SCHEDULER (DMLC_ROLE=scheduler) and hand every process the same
        # rendezvous env — the reference passes the job command as pscmd
        # whenever nserver > 0 (reference local.py:72, tracker.py:410-425);
        # without a scheduler the PS root port has no listener and
        # server/worker rendezvous hangs
        from ..tracker import PSTracker
        ps_tracker = PSTracker(host_ip=host_ip or tracker.host_ip,
                               pscmd=list(args.command),
                               extra_env={
                                   "DMLC_NUM_WORKER": str(args.num_workers),
                                   "DMLC_NUM_SERVER": str(args.num_servers),
                                   **args.extra_env,
                               })
        envs.update(ps_tracker.worker_envs())

    if args.dry_run and args.cluster in ("local", "ssh", "gpu"):
        # direct-spawn backends have no scheduler command to preview:
        # show the resolved job spec and stop before launching anything
        # (incl. the PS scheduler — ps_tracker.start() runs user code)
        log_info("%s (dry run): %d workers + %d servers, env %s, cmd: %s",
                 args.cluster, args.num_workers, args.num_servers,
                 envs, " ".join(args.command))
        tracker.stop()
        if ps_tracker is not None:
            ps_tracker.stop()
        return 0

    if ps_tracker is not None:
        ps_tracker.start()

    if args.cluster == "local":
        from . import local as backend
        rc = backend.submit(args, envs)
    elif args.cluster == "ssh":
        from . import ssh as backend
        rc = backend.submit(args, envs)
    elif args.cluster == "slurm":
        from .batch import submit_slurm
        rc = submit_slurm(args, envs)
    elif args.cluster == "sge":
        from .batch import submit_sge
        rc = submit_sge(args, envs)
    elif args.cluster == "mpi":
        from .batch import submit_mpi
        rc = submit_mpi(args, envs)
    elif args.cluster == "yarn":
        from .yarn import submit_yarn
        rc = submit_yarn(args, envs)
    elif args.cluster == "mesos":
        from .mesos import submit_mesos
        rc = submit_mesos(args, envs)
    else:
        from . import gpu as backend
        rc = backend.submit(args, envs)

    tracker.stop()
    if ps_tracker is not None:
        ps_tracker.stop()
    return rc


def main() -> None:
    try:
        rc = submit()
    except DMLCError as e:
        print(f"dmlc-submit: {e}", file=sys.stderr)
        rc = 2
    sys.exit(rc)


if __name__ == "__main__":
    main()
