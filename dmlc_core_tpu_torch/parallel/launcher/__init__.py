"""Cluster launchers of the port (counterpart of
``dmlc_core_tpu/parallel/launcher``; reference ``tracker/dmlc_tracker``):
the ``local``, ``ssh``, ``slurm``, ``sge``, ``mpi``, ``yarn``, ``mesos``
and ``gpu`` backends behind one submit CLI, ``python -m
dmlc_core_tpu_torch.parallel.launcher.submit``, and the in-container
bootstrap, ``python -m dmlc_core_tpu_torch.parallel.launcher.bootstrap``."""

from .opts import build_parser, get_opts  # noqa: F401
from .submit import main, refuse_cluster, submit  # noqa: F401

__all__ = ["build_parser", "get_opts", "submit", "main", "refuse_cluster"]
