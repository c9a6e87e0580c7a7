"""Mesos launcher — capability parity with reference
``tracker/dmlc_tracker/mesos.py``.

The reference submits one task per worker either through pymesos or by
shelling out to ``mesos-execute`` (`mesos.py:16-50`). pymesos is not in this
image, so the ``mesos-execute`` path is the implementation. The full env
contract and worker command are **inlined into the ``--command`` string**
(``mesos-execute`` does not ship local files to agents, so a wrapper script
on the submitting host would not exist on the agent); ``DMLC_TASK_ID`` is
baked per task exactly as the reference builds one TaskInfo per rank.

``--files``/``--archives`` on this backend assume the submit-host paths are
reachable from the agents over a shared filesystem (same assumption as the
slurm/sge wrappers); the inlined staging aborts the attempt loudly if the
copy fails rather than running in an empty scratch dir.

Counterpart of ``dmlc_core_tpu/parallel/launcher/mesos.py``, copied as it
is.
"""

from __future__ import annotations

import os
import shlex
import subprocess
from typing import Dict, List

from ...utils.logging import DMLCError, log_info
from .wrapper import job_env, retry_loop

__all__ = ["submit_mesos", "build_mesos_commands"]


def _inline_command(args, tracker_envs: Dict[str, str], task_id: int) -> str:
    from .filecache import stage_snippet
    env = job_env(args, tracker_envs, "mesos")
    env["DMLC_TASK_ID"] = str(task_id)
    env["DMLC_ROLE"] = ("server" if task_id < args.num_servers else "worker")
    exports = "; ".join(f"export {k}={shlex.quote(v)}"
                        for k, v in env.items())
    staging = stage_snippet(getattr(args, "cache_files", None) or [],
                            getattr(args, "cache_archives", None) or [])
    staging = staging.replace("\n", "; ") + "; " if staging else ""
    cmd = " ".join(shlex.quote(c) for c in args.command)
    return f"{exports}; {staging}{retry_loop(cmd, oneline=True)}"


def build_mesos_commands(args, tracker_envs: Dict[str, str]) -> List[List[str]]:
    """One ``mesos-execute`` invocation per task (reference `mesos.py:16-50`)."""
    master = (getattr(args, "mesos_master", None)
              or os.environ.get("MESOS_MASTER", "127.0.0.1:5050"))
    nproc = args.num_workers + args.num_servers
    cmds = []
    for tid in range(nproc):
        name = f"{args.jobname or 'dmlc'}-task-{tid}"
        cmds.append([
            "mesos-execute",
            f"--master={master}",
            f"--name={name}",
            f"--command={_inline_command(args, tracker_envs, tid)}",
            f"--resources=cpus:{args.worker_cores};"
            f"mem:{args.worker_memory_mb}",
        ])
    return cmds


def submit_mesos(args, tracker_envs: Dict[str, str]) -> int:
    cmds = build_mesos_commands(args, tracker_envs)
    if args.dry_run:
        for c in cmds:
            log_info("mesos (dry run): %s", " ".join(c))
        return 0
    procs = []
    try:
        for c in cmds:
            log_info("mesos: %s", " ".join(c))
            procs.append(subprocess.Popen(c))
    except OSError as e:
        # any mid-loop spawn failure (missing binary, EMFILE, perms) must
        # not leak the tasks already submitted
        for p in procs:
            p.terminate()
        raise DMLCError(f"mesos submit failed: {e}") from e
    rc = 0
    for p in procs:
        rc = p.wait() or rc
    return rc
