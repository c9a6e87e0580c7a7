"""CLI options for the job launcher — capability parity with reference
``tracker/dmlc_tracker/opts.py`` (`opts.py:60-163`).

Counterpart of ``dmlc_core_tpu/parallel/launcher/opts.py``: the whole
parser, so that every JAX command line parses here to the same
namespace.  The clusters are the JAX package's plus ``gpu`` (this
host's cards, the counterpart of ``tpu``); :mod:`.submit` refuses
``tpu``."""

from __future__ import annotations

import argparse
import os
from typing import List, Optional
from ...utils.parameter import env_int, get_env, parse_lenient_bool

__all__ = ["build_parser", "get_opts"]

CLUSTERS = ["local", "ssh", "mpi", "sge", "slurm", "yarn", "mesos", "tpu",
            "gpu"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dmlc-submit-gpu",
        description="Submit a distributed job (the CUDA port's "
                    "dmlc-submit): "
                    "boots a rendezvous tracker and launches workers on the "
                    "chosen cluster backend.")
    p.add_argument("--cluster", default=get_env(
        "DMLC_SUBMIT_CLUSTER", "local"), choices=CLUSTERS,
        help="cluster backend (env DMLC_SUBMIT_CLUSTER overrides the default)")
    p.add_argument("--num-workers", "-n", type=int, required=True,
                   help="number of worker processes")
    p.add_argument("--num-servers", "-s", type=int, default=0,
                   help="number of server processes (parameter-server mode)")
    p.add_argument("--worker-cores", type=int, default=1)
    p.add_argument("--worker-memory-mb", type=int, default=1024)
    p.add_argument("--worker-memory", default=None, metavar="Ng|Nm",
                   help="worker memory as '4g'/'512m' (reference form; "
                        "overrides --worker-memory-mb)")
    p.add_argument("--server-cores", type=int, default=1,
                   help="cores per server process (PS mode)")
    p.add_argument("--server-memory-mb", type=int, default=1024)
    p.add_argument("--server-memory", default=None, metavar="Ng|Nm",
                   help="server memory as '4g'/'512m' (overrides "
                        "--server-memory-mb)")
    p.add_argument("--jobname", default=None)
    p.add_argument("--log-file", default=None,
                   help="also write launcher logs to this file "
                        "(stderr logging stays on)")
    p.add_argument("--hdfs-tempdir", default="/tmp",
                   help="HDFS temp dir, exported to workers as "
                        "DMLC_HDFS_TEMPDIR (reference opts.py:104; its "
                        "yarn client staged job files through it)")
    p.add_argument("--sge-log-dir", default=None,
                   help="sge: directory for qsub stdout/stderr logs")
    p.add_argument("--files", action="append", default=[], metavar="PATH",
                   help="ship this file into each worker's cwd "
                        "(repeatable)")
    p.add_argument("--archives", action="append", default=[], metavar="PATH",
                   help="ship and extract this zip/tar into each worker's "
                        "cwd (repeatable)")
    p.add_argument("--auto-file-cache", default=None,
                   type=lambda s: s.lower() not in ("0", "false", "no"),
                   help="auto-ship command-line tokens that name local "
                        "files under the cwd, rewriting them to ./<name>. "
                        "Default: on for yarn (the executable must ship, "
                        "as the reference does) and whenever "
                        "--files/--archives are given; off otherwise, so "
                        "in-place jobs keep their cwd-relative paths")
    p.add_argument("--host-file", default=None,
                   help="ssh/mpi: file listing one host per line")
    p.add_argument("--host-ip", default=None,
                   help="tracker bind address (default: auto-detect)")
    p.add_argument("--sync-dst-dir", default=None,
                   help="ssh: rsync the working dir to this path on each host")
    p.add_argument("--queue", default=None,
                   help="scheduler queue (reference opts.py:96); maps to "
                        "the backend-specific queue unless that is set "
                        "explicitly (--sge-queue/--yarn-queue/"
                        "--slurm-partition)")
    p.add_argument("--slurm-partition", default=None)
    p.add_argument("--slurm-worker-nodes", type=int, default=None,
                   help="slurm: node count for the worker srun "
                        "(reference opts.py --slurm-worker-nodes)")
    p.add_argument("--slurm-server-nodes", type=int, default=None,
                   help="slurm: node count for the server srun")
    p.add_argument("--sge-queue", default=None)
    p.add_argument("--yarn-queue", default=None,
                   help="yarn: capacity-scheduler queue")
    p.add_argument("--yarn-app-classpath", default=None,
                   help="yarn: extra classpath exported to containers as "
                        "DMLC_YARN_APP_CLASSPATH (reference opts.py:118)")
    p.add_argument("--yarn-app-dir", default=None,
                   help="yarn: staging dir for shipped job files "
                        "(reference yarn.py jar/app dir)")
    p.add_argument("--mesos-master", default=None,
                   help="mesos: master host:port (env MESOS_MASTER)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the scheduler submission without running it")
    p.add_argument("--max-attempts", type=int,
                   default=env_int("DMLC_MAX_ATTEMPT", 3, minimum=1),
                   help="per-worker restart attempts before giving up")
    p.add_argument("--elastic", action="store_true",
                   default=bool(parse_lenient_bool("DMLC_ELASTIC")),
                   help="gpu cluster: respawn crashed workers with a "
                        "bumped DMLC_NUM_ATTEMPT (pair worker code with "
                        "ElasticTorchMesh — a plain torch.distributed "
                        "group cannot admit a reborn process, so without "
                        "elastic worker code a respawn would hang, which "
                        "is why this is opt-in)")
    p.add_argument("--env", action="append", default=[],
                   metavar="K=V", help="extra env vars forwarded to workers")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="worker command line")
    return p


def memory_mb(mem: str) -> int:
    """'4g'/'512m' → MB (reference ``opts.py:get_memory_mb``)."""
    m = mem.lower()
    if m.endswith("g"):
        return int(float(m[:-1]) * 1024)
    if m.endswith("m"):
        return int(float(m[:-1]))
    raise ValueError(f"memory spec {mem!r} must end with 'g' or 'm'")


def get_opts(argv: Optional[List[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if not args.command:
        build_parser().error("no worker command given")
    # strip a leading '--' separator
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    args.extra_env = {}
    for kv in args.env:
        if "=" not in kv:
            build_parser().error(f"--env expects K=V, got {kv!r}")
        k, v = kv.split("=", 1)
        args.extra_env[k] = v
    # generic --queue (reference name) maps onto whichever backend queue
    # wasn't given explicitly
    if args.queue:
        args.sge_queue = args.sge_queue or args.queue
        args.yarn_queue = args.yarn_queue or args.queue
        args.slurm_partition = args.slurm_partition or args.queue
    if args.yarn_app_dir:
        args.extra_env.setdefault("DMLC_YARN_APP_DIR", args.yarn_app_dir)
    for which in ("worker", "server"):
        spec = getattr(args, f"{which}_memory")
        if spec is not None:
            try:
                setattr(args, f"{which}_memory_mb", memory_mb(spec))
            except ValueError as e:
                build_parser().error(str(e))
    # --files/--archives must exist NOW: a typo'd path should fail the
    # submit, not surface as FileNotFoundError inside a worker later
    for f in args.files + args.archives:
        if not os.path.exists(f):
            build_parser().error(f"--files/--archives path not found: {f!r}")
    # file cache: auto-ship command files + --files/--archives, rewrite the
    # command to staged names (reference get_cache_file_set, opts.py:6-36).
    # The rewrite moves the worker cwd to a staging dir, so it only engages
    # when shipping is actually in play — explicitly shipped files, yarn
    # (whose containers never share the submit cwd), or an explicit
    # --auto-file-cache true
    if args.auto_file_cache is None:
        args.auto_file_cache = bool(args.files or args.archives
                                    or args.cluster == "yarn")
    from .filecache import resolve
    args.command_raw = list(args.command)
    args.cache_files, args.cache_archives, args.command = resolve(
        args.command, args.files, args.archives, args.auto_file_cache)
    return args
