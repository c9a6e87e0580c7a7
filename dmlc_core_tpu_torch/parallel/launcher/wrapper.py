"""Shared wrapper-script generation for scheduler-based launchers.

One home for the DMLC_* env contract so slurm/sge/mpi/yarn/mesos cannot
drift (reference equivalent: the env assembly in
``tracker/dmlc_tracker/tracker.py:410-433`` shared by every submit backend).

Counterpart of ``dmlc_core_tpu/parallel/launcher/wrapper.py``, copied as
it is: the ``DMLC_*`` contract and the wrapper's bytes are the JAX
package's, so a job submitted by either package runs the same script.
"""

from __future__ import annotations

import os
import shlex
import stat
import tempfile
from typing import Dict

__all__ = ["job_env", "render_exports", "retry_loop", "wrapper_body",
           "write_wrapper_script"]


def job_env(args, tracker_envs: Dict[str, str], cluster: str) -> Dict[str, str]:
    """The launch env contract common to every backend."""
    env = dict(tracker_envs)
    env.update(args.extra_env)
    env.update({
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(args.num_servers),
        "DMLC_JOB_CLUSTER": cluster,
        "DMLC_MAX_ATTEMPT": str(args.max_attempts),
        # resource asks ride the env so role-aware runtimes can see them
        # (reference forwards worker/server cores+memory per role,
        # opts.py:85-90 → yarn AM container requests)
        "DMLC_WORKER_CORES": str(getattr(args, "worker_cores", 1)),
        "DMLC_WORKER_MEMORY_MB": str(getattr(args, "worker_memory_mb", 1024)),
        "DMLC_SERVER_CORES": str(getattr(args, "server_cores", 1)),
        "DMLC_SERVER_MEMORY_MB": str(getattr(args, "server_memory_mb", 1024)),
        "DMLC_HDFS_TEMPDIR": str(getattr(args, "hdfs_tempdir", "/tmp")),
    })
    return env


def render_exports(env: Dict[str, str]) -> str:
    return "\n".join(f"export {k}={shlex.quote(v)}" for k, v in env.items())


def retry_loop(cmd: str, *, oneline: bool = False) -> str:
    """The in-place retry protocol, shared by every scheduler backend: the
    task id (= rabit jobid) stays stable across attempts while
    ``DMLC_NUM_ATTEMPT`` increments, so on attempt > 0 the rabit client
    sends ``recover`` and the tracker re-issues the same rank with fresh
    neighbor addresses (``RabitContext.from_env`` + ``parallel.tracker``,
    the analog of reference `tracker.py:279-291` / the YARN AM's
    maxNumAttempt restart, `ApplicationMaster.java:210`)."""
    body = [
        f'DMLC_NUM_ATTEMPT="$attempt" {cmd}',
        'rc=$?',
        '[ "$rc" -eq 0 ] && exit 0',
        'attempt=$((attempt + 1))',
        'echo "dmlc: task ${DMLC_TASK_ID} exited rc=$rc'
        ' (attempt $attempt/${DMLC_MAX_ATTEMPT})" >&2',
        '[ "$attempt" -ge "${DMLC_MAX_ATTEMPT}" ] && exit "$rc"',
    ]
    if oneline:
        return f'attempt=0; while :; do {"; ".join(body)}; done'
    inner = "\n".join("  " + ln for ln in body)
    return f"attempt=0\nwhile :; do\n{inner}\ndone"


def wrapper_body(args, tracker_envs: Dict[str, str], cluster: str,
                 rank_snippet: str, stage_mode: str = "copy") -> str:
    """Wrapper shell body: export the env contract, run ``rank_snippet``
    (shell lines that must set ``DMLC_TASK_ID``), stage cached
    files/archives (``filecache.stage_snippet``; ``stage_mode='cwd'`` when
    the scheduler's own file cache already delivered them), derive
    ``DMLC_ROLE`` from the server split, then run the worker under
    :func:`retry_loop`.

    A missing, non-numeric, or out-of-range id fails fast with a clear
    message rather than joining the tracker with a bogus rank (in-place
    retry covers worker-process death; a scheduler that reschedules the
    whole task re-runs this wrapper and recovers through the same
    stable-id path)."""
    from .filecache import stage_snippet
    exports = render_exports(job_env(args, tracker_envs, cluster))
    cmd = " ".join(shlex.quote(c) for c in args.command)
    staging = stage_snippet(getattr(args, "cache_files", None) or [],
                            getattr(args, "cache_archives", None) or [],
                            mode=stage_mode)
    ns = args.num_servers
    nproc = args.num_workers + args.num_servers
    return f"""#!/bin/bash
{exports}
{rank_snippet}
{staging}
case "${{DMLC_TASK_ID}}" in
  (''|*[!0-9]*)
    echo "dmlc wrapper: task id '${{DMLC_TASK_ID}}' is not a number" >&2
    exit 1;;
esac
# supervisor-side node blacklist (yarn_am: REST submissions cannot carry
# an explicit node exclusion, so the wrapper enforces it — landing on a
# blacklisted node fails fast and the retry places elsewhere)
if [ -n "${{DMLC_BLACKLISTED_NODES:-}}" ]; then
  case ",${{DMLC_BLACKLISTED_NODES}}," in
    (*",$(hostname -s),"*|*",$(hostname -f 2>/dev/null || hostname),"*)
      echo "dmlc wrapper: node $(hostname) is blacklisted — exiting" >&2
      exit 1;;
  esac
fi
if [ "${{DMLC_TASK_ID}}" -ge "{nproc}" ]; then
  echo "dmlc wrapper: task id '${{DMLC_TASK_ID}}' outside cohort of {nproc}" >&2
  exit 1
fi
if [ "${{DMLC_TASK_ID}}" -lt "{ns}" ]; then
  export DMLC_ROLE=server
else
  export DMLC_ROLE=worker
fi
{retry_loop(cmd)}
"""


def write_wrapper_script(args, tracker_envs: Dict[str, str], cluster: str,
                         rank_snippet: str, stage_mode: str = "copy") -> str:
    """Write :func:`wrapper_body` to an executable temp file."""
    body = wrapper_body(args, tracker_envs, cluster, rank_snippet, stage_mode)
    fd, path = tempfile.mkstemp(prefix=f"dmlc_{cluster}_", suffix=".sh")
    with os.fdopen(fd, "w") as f:
        f.write(body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path
