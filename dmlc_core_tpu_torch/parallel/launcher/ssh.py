"""SSH launcher — capability parity with reference
``tracker/dmlc_tracker/ssh.py``: host-file parsing (`ssh.py:36-70`), optional
workdir rsync (`ssh.py:13-21`), per-host ssh spawn with env forwarding —
PLUS the YARN ApplicationMaster's container-replacement failure domain
(`ApplicationMaster.java:73-74,508,535-563`): a task that keeps dying on a
host is rescheduled onto another host from the host file, the dying host is
blacklisted, and the restarted task re-enters the tracker's ``recover``
path (same task id, bumped ``DMLC_NUM_ATTEMPT``) so surviving peers re-link
to its new address.  An unreachable host (ssh rc 255) is blacklisted on
first contact; otherwise a host is dropped after ``DMLC_HOST_FAIL_LIMIT``
(default 2) failures.  The job aborts once a task burns ``--max-attempts``
or no replacement host remains — the AM's maxNumAttempt abort.

Host file format: one ``host[:port]`` per line (the PHub fork's
``ip:interface:port`` interface pinning collapses to plain addressing here —
on a GPU cluster NIC selection is the platform's concern, not the
launcher's).

Counterpart of ``dmlc_core_tpu/parallel/launcher/ssh.py``, copied as it
is.  Like the JAX backend it reserves no ``DMLC_ELASTIC_BASE_PORT`` (only
``--cluster gpu`` does): an elastic job over ssh passes its base port
with ``--env``."""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

from ...utils.logging import DMLCError, log_info, log_warning
from ...utils.parameter import env_int

__all__ = ["submit", "parse_host_file", "HostPool"]

_SSH_CONNECT_FAILED = 255  # ssh's own exit code for connection failure


class HostPool:
    """Host assignment with failure accounting and blacklisting (the node
    bookkeeping of the reference AM, `ApplicationMaster.java:535-563`)."""

    def __init__(self, hosts: List[Tuple[str, int]], fail_limit: int = 0):
        self._hosts = list(hosts)
        self._fail_limit = fail_limit or env_int(
            "DMLC_HOST_FAIL_LIMIT", 2, minimum=1)
        self._failures: Dict[Tuple[str, int], int] = {}
        self._black: set = set()
        self._next = 0
        self._lock = threading.Lock()

    def assign(self, exclude: Optional[Tuple[str, int]] = None
               ) -> Tuple[str, int]:
        """Next usable host round-robin; raises when none remain."""
        with self._lock:
            live = [h for h in self._hosts
                    if h not in self._black and h != exclude]
            if not live:
                raise DMLCError(
                    "no usable hosts remain (all blacklisted) — the AM "
                    "abort path, ApplicationMaster.java:508")
            h = live[self._next % len(live)]
            self._next += 1
            return h

    def record_failure(self, host: Tuple[str, int],
                       unreachable: bool = False) -> bool:
        """Count a task failure on ``host``; returns True when the host is
        now blacklisted."""
        with self._lock:
            n = self._failures[host] = self._failures.get(host, 0) + 1
            if unreachable or n >= self._fail_limit:
                if host not in self._black:
                    self._black.add(host)
                    log_warning("host %s:%d blacklisted after %d failure(s)%s",
                                host[0], host[1], n,
                                " (unreachable)" if unreachable else "")
                return True
            return False

    @property
    def blacklisted(self) -> set:
        with self._lock:
            return set(self._black)


def parse_host_file(path: str) -> List[Tuple[str, int]]:
    hosts: List[Tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" in line:
                h, p = line.rsplit(":", 1)
                hosts.append((h, int(p)))
            else:
                hosts.append((line, 22))
    if not hosts:
        raise DMLCError(f"host file {path!r} lists no hosts")
    return hosts


def _env_exports(env: Dict[str, str]) -> str:
    return " ".join(f"{k}={_shquote(v)}" for k, v in env.items())


def _shquote(s: str) -> str:
    return "'" + s.replace("'", "'\"'\"'") + "'"


def submit(args, tracker_envs: Dict[str, str]) -> int:
    if not args.host_file:
        raise DMLCError("ssh cluster requires --host-file")
    hosts = parse_host_file(args.host_file)
    nproc = args.num_workers + args.num_servers
    workdir = os.getcwd()

    if args.sync_dst_dir:
        for host, port in set(hosts):
            log_info("rsync %s -> %s:%s", workdir, host, args.sync_dst_dir)
            subprocess.run(
                ["rsync", "-az", "-e", f"ssh -p {port}", workdir + "/",
                 f"{host}:{args.sync_dst_dir}/"], check=True)
        workdir = args.sync_dst_dir

    # --files/--archives + auto-cached command files: rsync to a staging
    # dir on every host and run the job there (no shared-FS assumption;
    # reference ships via the YARN file cache, yarn.py:35-42 — ssh's
    # equivalent is explicit per-host transfer)
    pool = HostPool(hosts)
    cache = (getattr(args, "cache_files", None) or []) + \
            (getattr(args, "cache_archives", None) or [])
    if cache:
        from uuid import uuid4
        from .filecache import unpack_command
        # per-submit unique dir: concurrent jobs (or two users) sharing a
        # host must not overwrite each other's shipped files
        stage = args.sync_dst_dir or (
            f"/tmp/dmlc_{args.jobname or 'job'}_{uuid4().hex[:8]}")
        ssh_base = ["ssh", "-o", "StrictHostKeyChecking=no"]
        for host, port in set(hosts):
            steps = [ssh_base + ["-p", str(port), host,
                                 f"mkdir -p {_shquote(stage)}"],
                     ["rsync", "-az", "-e", f"ssh -p {port}"] + cache
                     + [f"{host}:{stage}/"]]
            steps += [ssh_base + ["-p", str(port), host,
                                  f"cd {_shquote(stage)} && "
                                  f"{unpack_command(os.path.basename(a))}"]
                      for a in (getattr(args, "cache_archives", None) or [])]
            log_info("ship %d cached files -> %s:%s", len(cache), host, stage)
            for cmd in steps:
                rc = subprocess.call(cmd)
                if rc == _SSH_CONNECT_FAILED:
                    # host unreachable: blacklist it, tasks go elsewhere
                    log_warning("staging to %s:%d unreachable — blacklisting",
                                host, port)
                    pool.record_failure((host, port), unreachable=True)
                    break
                if rc != 0:
                    # a LOCAL/protocol error (bad source, perms, rsync exit
                    # 23) would hit every host the same way: abort loudly
                    # instead of blacklisting the fleet one by one
                    raise DMLCError(
                        f"file-cache staging failed (rc={rc}): "
                        f"{' '.join(cmd)}")
        workdir = stage
    max_attempts = max(1, getattr(args, "max_attempts", 1))
    results = [0] * nproc
    threads = []

    def supervise(slot: int) -> None:
        """Run one task with in-place retry + host replacement: stable task
        id across attempts (the rabit recover key), DMLC_NUM_ATTEMPT
        incremented, new host drawn from the pool when the current one is
        blacklisted (AM container replacement)."""
        role = "server" if slot < args.num_servers else "worker"
        env = dict(tracker_envs)
        env.update(args.extra_env)
        env.update({
            "DMLC_ROLE": role,
            "DMLC_TASK_ID": str(slot),
            "DMLC_NUM_WORKER": str(args.num_workers),
            "DMLC_NUM_SERVER": str(args.num_servers),
            "DMLC_JOB_CLUSTER": "ssh",
        })
        try:
            host, port = pool.assign()
        except DMLCError:
            results[slot] = 1
            return
        attempt = 0
        while attempt < max_attempts:
            env["DMLC_NUM_ATTEMPT"] = str(attempt)
            remote_cmd = (f"cd {_shquote(workdir)} && "
                          f"{_env_exports(env)} " +
                          " ".join(_shquote(c) for c in args.command))
            rc = subprocess.call(
                ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port),
                 host, remote_cmd])
            if rc == 0:
                results[slot] = 0
                return
            results[slot] = rc
            unreachable = rc == _SSH_CONNECT_FAILED
            log_warning("ssh task %d on %s exited rc=%d (attempt %d/%d)",
                        slot, host, rc, attempt + 1, max_attempts)
            if not unreachable:
                # a connect failure never launched the task — it is a
                # placement failure, not a task attempt (the AM does not
                # count allocation failures against maxNumAttempt)
                attempt += 1
            if pool.record_failure((host, port), unreachable=unreachable):
                try:
                    host, port = pool.assign(exclude=(host, port))
                except DMLCError:
                    return  # no replacement host: abort with last rc
                if attempt < max_attempts:
                    log_info("ssh task %d rescheduled onto %s:%d",
                             slot, host, port)

    for i in range(nproc):
        t = threading.Thread(target=supervise, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    return next((rc for rc in results if rc), 0)
