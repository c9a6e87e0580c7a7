"""Local multi-process launcher — capability parity with reference
``tracker/dmlc_tracker/local.py``: N subprocesses on this host, each with the
DMLC_* env contract and a retry loop honoring ``DMLC_NUM_ATTEMPT``
(`local.py:12-44`).

Counterpart of ``dmlc_core_tpu/parallel/launcher/local.py``."""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

from ...utils.logging import log_info, log_warning

__all__ = ["submit"]


def _run_with_retry(cmd: List[str], env: Dict[str, str], max_attempts: int,
                    results: List[int], slot: int,
                    cwd: Optional[str] = None) -> None:
    attempt = 0
    while True:
        env_try = dict(env, DMLC_NUM_ATTEMPT=str(attempt))
        proc = subprocess.Popen(cmd, env=env_try, cwd=cwd)
        rc = proc.wait()
        if rc == 0:
            results[slot] = 0
            return
        attempt += 1
        log_warning("worker %s exited rc=%d (attempt %d/%d)",
                    env.get("DMLC_TASK_ID"), rc, attempt, max_attempts)
        if attempt >= max_attempts:
            results[slot] = rc
            return


def submit(args, tracker_envs: Dict[str, str]) -> int:
    """Spawn workers+servers locally; returns first nonzero exit code or 0."""
    nproc = args.num_workers + args.num_servers
    # ship --files/--archives + auto-cached command files into a job
    # staging dir and run the workers there (reference YARN file-cache
    # semantics, yarn.py:35-42, expressed as a local cwd)
    stage_dir = None
    if getattr(args, "cache_files", None) or getattr(args, "cache_archives",
                                                     None):
        from .filecache import stage_into
        stage_dir = tempfile.mkdtemp(prefix="dmlc_stage_")
        stage_into(stage_dir, args.cache_files, args.cache_archives)
        log_info("staged %d files + %d archives into %s",
                 len(args.cache_files), len(args.cache_archives), stage_dir)
    threads = []
    results = [0] * nproc
    for i in range(nproc):
        role = "server" if i < args.num_servers else "worker"
        env = dict(os.environ)
        env.update(tracker_envs)
        env.update(args.extra_env)
        env.update({
            "DMLC_ROLE": role,
            "DMLC_TASK_ID": str(i),
            "DMLC_NUM_WORKER": str(args.num_workers),
            "DMLC_NUM_SERVER": str(args.num_servers),
            "DMLC_JOB_CLUSTER": "local",
        })
        t = threading.Thread(
            target=_run_with_retry,
            args=(args.command, env, max(1, args.max_attempts), results, i,
                  stage_dir),
            daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    bad = [rc for rc in results if rc != 0]
    if bad:
        log_warning("local job finished with failures: %s", results)
        return bad[0]
    log_info("local job finished: all %d processes exited cleanly", nproc)
    return 0
