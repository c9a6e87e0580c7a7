"""Batch-scheduler launchers: Slurm, SGE, and MPI — capability parity with
reference ``slurm.py`` (`slurm.py:38-60`), ``sge.py`` (`sge.py:30-43`) and
``mpi.py`` (`mpi.py:12-36`).

Each backend materializes the DMLC_* env contract and delegates process
placement to the scheduler.  Worker rank comes from the scheduler's own task
id env (SLURM_PROCID / SGE_TASK_ID / OMPI_COMM_WORLD_RANK / PMI_RANK), which
the generated wrapper maps onto DMLC_TASK_ID.

Counterpart of ``dmlc_core_tpu/parallel/launcher/batch.py``, copied as it
is: no card is touched by the launcher, the ranks find theirs."""

from __future__ import annotations

import os
import subprocess
from typing import Dict

from ...utils.logging import log_info
from .wrapper import write_wrapper_script

__all__ = ["submit_slurm", "submit_sge", "submit_mpi"]


def _launch(args, cmd, label: str, script: str) -> int:
    log_info("%s%s: %s", label, " (dry run)" if args.dry_run else "",
             " ".join(cmd))
    try:
        if args.dry_run:
            # the wrapper IS the substance of the submission: show it,
            # since the temp file is removed below
            with open(script) as f:
                log_info("%s wrapper script:\n%s", label, f.read())
            return 0
        # srun / qsub -sync y / mpirun all block until the job ends, so the
        # wrapper can be removed once the call returns
        return subprocess.call(cmd)
    finally:
        try:
            os.unlink(script)
        except OSError:
            pass


def submit_slurm(args, tracker_envs: Dict[str, str]) -> int:
    nproc = args.num_workers + args.num_servers
    script = write_wrapper_script(
        args, tracker_envs, "slurm",
        'export DMLC_TASK_ID="${SLURM_PROCID}"')
    cmd = ["srun", "-n", str(nproc)]
    if args.slurm_partition:
        cmd += ["-p", args.slurm_partition]
    # reference opts.py --slurm-worker-nodes/--slurm-server-nodes: pin the
    # node count; one srun hosts both roles here, so the counts add
    nodes = ((args.slurm_worker_nodes or 0)
             + (args.slurm_server_nodes or 0))
    if nodes:
        cmd += ["-N", str(nodes)]
    cmd.append(script)
    return _launch(args, cmd, "slurm", script)


def submit_sge(args, tracker_envs: Dict[str, str]) -> int:
    nproc = args.num_workers + args.num_servers
    # SGE_TASK_ID is 1-based
    script = write_wrapper_script(
        args, tracker_envs, "sge",
        'export DMLC_TASK_ID="$((SGE_TASK_ID - 1))"')
    cmd = ["qsub", "-cwd", "-t", f"1-{nproc}", "-b", "y", "-sync", "y"]
    if args.sge_queue:
        cmd += ["-q", args.sge_queue]
    if getattr(args, "sge_log_dir", None):
        # reference opts.py:108 --sge-log-dir: qsub stdout/stderr land here
        cmd += ["-o", args.sge_log_dir, "-e", args.sge_log_dir]
    cmd.append(script)
    return _launch(args, cmd, "sge", script)


def submit_mpi(args, tracker_envs: Dict[str, str]) -> int:
    nproc = args.num_workers + args.num_servers
    # OpenMPI vs MPICH rank env detected in the wrapper at runtime
    script = write_wrapper_script(
        args, tracker_envs, "mpi",
        'export DMLC_TASK_ID="${OMPI_COMM_WORLD_RANK:-${PMI_RANK:-0}}"')
    cmd = ["mpirun", "-n", str(nproc)]
    if args.host_file:
        cmd += ["--hostfile", args.host_file]
    cmd.append(script)
    return _launch(args, cmd, "mpi", script)
