"""Inside-container bootstrap — capability parity with reference
``tracker/dmlc_tracker/launcher.py`` (the shim that runs *inside* a
YARN/SGE/Mesos container before the worker: hadoop classpath fixup,
``LD_LIBRARY_PATH``, archive unpacking, role derivation, `launcher.py:36-77`).

Counterpart of ``dmlc_core_tpu/parallel/launcher/bootstrap.py``.  The
fixups are the same, but the contract the worker reads is
``torch.distributed``'s where the JAX bootstrap fills JAX's
multi-process one:

* unzip shipped archives into the cwd (same as the reference :60-66);
* derive ``DMLC_TASK_ID``/``DMLC_ROLE`` from scheduler env if the wrapper
  didn't (SGE-style role derivation, reference :68-75); these
  ``DMLC_*`` keys are the JAX bootstrap's, byte for byte;
* map the DMLC contract onto the one
  :func:`~.gpu.initialize_torch_from_env` and
  :class:`~..elastic.ElasticTorchMesh` read: ``RANK`` ←
  ``DMLC_TASK_ID`` − ``DMLC_NUM_SERVER`` (workers only) and
  ``WORLD_SIZE`` ← ``DMLC_NUM_WORKER`` (the JAX bootstrap's
  ``JAX_PROCESS_ID`` and ``JAX_NUM_PROCESSES``), so worker code needs no
  per-cluster logic;
* then ``exec`` the worker command.

Usage (as the command a scheduler runs)::

    python -m dmlc_core_tpu_torch.parallel.launcher.bootstrap -- python train.py
"""

from __future__ import annotations

import os
import sys
import zipfile
from typing import Dict, List, Optional

from ...utils.logging import log_info

__all__ = ["fixup_env", "unpack_archives", "main"]


def unpack_archives(workdir: str = ".") -> List[str]:
    """Unzip any ``*.zip`` shipped into the container cwd (reference
    `launcher.py:60-66` unzips the YARN file cache)."""
    done = []
    for name in sorted(os.listdir(workdir)):
        if name.endswith(".zip"):
            dest = os.path.join(workdir, name[:-4])
            if not os.path.isdir(dest):
                with zipfile.ZipFile(os.path.join(workdir, name)) as z:
                    z.extractall(dest)
                done.append(dest)
    return done


def fixup_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Normalize the in-container env: fill DMLC_* from scheduler vars and
    mirror them onto ``torch.distributed``'s ``RANK`` / ``WORLD_SIZE``."""
    e = dict(os.environ if env is None else env)

    # scheduler-specific rank envs → DMLC_TASK_ID (reference SGE derivation;
    # SGE sets the literal 'undefined' for non-array jobs — skip non-digits)
    if "DMLC_TASK_ID" not in e:
        for var, off in (("SLURM_PROCID", 0), ("OMPI_COMM_WORLD_RANK", 0),
                         ("PMI_RANK", 0), ("SGE_TASK_ID", -1)):
            val = e.get(var, "")
            if val.isdigit():
                e["DMLC_TASK_ID"] = str(int(val) + off)
                break

    # role derivation from the server split
    ns = int(e.get("DMLC_NUM_SERVER", "0") or 0)
    if "DMLC_ROLE" not in e and "DMLC_TASK_ID" in e:
        e["DMLC_ROLE"] = ("server" if int(e["DMLC_TASK_ID"]) < ns
                          else "worker")

    # DMLC contract → torch.distributed's.  Only WORKERS join the process
    # group (servers are host-side PS processes), and the task id space
    # is global (servers 0..ns-1, workers ns..), so a worker's rank is
    # task_id - num_server
    if ("RANK" not in e and "DMLC_TASK_ID" in e
            and e.get("DMLC_ROLE", "worker") == "worker"):
        e["RANK"] = str(int(e["DMLC_TASK_ID"]) - ns)
    if "WORLD_SIZE" not in e and "DMLC_NUM_WORKER" in e:
        e["WORLD_SIZE"] = e["DMLC_NUM_WORKER"]
    return e


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "--":
        args = args[1:]
    if not args:
        print("usage: python -m dmlc_core_tpu_torch.parallel.launcher."
              "bootstrap -- <worker command...>", file=sys.stderr)
        return 2
    unpacked = unpack_archives()
    if unpacked:
        log_info("bootstrap: unpacked %s", unpacked)
    env = fixup_env()
    os.execvpe(args[0], args, env)  # never returns


if __name__ == "__main__":
    sys.exit(main())
