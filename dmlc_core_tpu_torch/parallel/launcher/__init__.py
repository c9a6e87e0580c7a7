"""Cluster launchers of the port (counterpart of
``dmlc_core_tpu/parallel/launcher``; reference ``tracker/dmlc_tracker``):
the ``local`` and ``gpu`` backends behind one submit CLI, ``python -m
dmlc_core_tpu_torch.parallel.launcher.submit``.  The backends without a
card (ssh, slurm, sge, mpi, yarn, mesos) wait for ROADMAP A.7.c2."""

from .opts import build_parser, get_opts  # noqa: F401
from .submit import main, refuse_cluster, submit  # noqa: F401

__all__ = ["build_parser", "get_opts", "submit", "main", "refuse_cluster"]
