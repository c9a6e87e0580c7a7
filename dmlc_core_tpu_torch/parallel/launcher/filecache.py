"""File/archive shipping for job submission — capability parity with the
reference's file cache (``tracker/dmlc_tracker/opts.py:6-36``
``get_cache_file_set`` + the YARN file-cache wiring ``yarn.py:35-42`` and
auto-cached executable).

Counterpart of ``dmlc_core_tpu/parallel/launcher/filecache.py``, copied
as it is (the shell staging serves the ssh, slurm, sge, mpi, yarn and
mesos backends).

Three pieces:

* :func:`resolve` — scan the command line for local files (auto-cache),
  merge ``--files``/``--archives``, and rewrite the command to use staged
  names (``../../kmeans ../kmeans.conf`` → ``./kmeans kmeans.conf``).
* :func:`stage_into` — python-side staging for same-host backends (local):
  copy files (exec bit preserved) and extract archives into the worker cwd.
* :func:`stage_snippet` — shell staging for script/inline backends
  (slurm/sge/mpi/yarn/mesos): each task makes a private scratch dir, copies
  the cached files from their absolute source paths (reachable via the
  cluster's shared filesystem, as the reference assumes outside YARN) and
  cds into it.  The ssh backend rsyncs instead (no shared-FS assumption).
"""

from __future__ import annotations

import os
import shlex
import shutil
import tarfile
import zipfile
from typing import List, Tuple

__all__ = ["resolve", "stage_into", "stage_snippet", "extract_archive"]


def resolve(command: List[str], files: List[str], archives: List[str],
            auto_file_cache: bool = True
            ) -> Tuple[List[str], List[str], List[str]]:
    """Return ``(cache_files, cache_archives, rewritten_command)``.

    With ``auto_file_cache`` every command token naming an existing local
    file is cached and rewritten to ``./<basename>`` (the executable ships
    with the job instead of being found by luck on the worker).
    """
    seen = set()

    def _add(lst: List[str], f: str) -> None:
        a = os.path.abspath(f)
        if a not in seen:
            seen.add(a)
            lst.append(a)

    cache: List[str] = []
    cmds: List[str] = []
    if auto_file_cache:
        cwd = os.getcwd()
        for tok in command:
            # only auto-ship files under the submit cwd: system paths like
            # the interpreter (/usr/bin/python) must run in place — copying
            # a venv python elsewhere breaks its prefix resolution (the
            # reference caches ANY existing path, opts.py:27; this is the
            # safe subset of that behavior)
            a = os.path.abspath(tok)
            if os.path.isfile(tok) and a.startswith(cwd.rstrip(os.sep)
                                                    + os.sep):
                _add(cache, tok)
                cmds.append("./" + os.path.basename(tok))
            else:
                cmds.append(tok)
    else:
        cmds = list(command)
    for f in files:
        if os.path.exists(f):
            _add(cache, f)
    arch: List[str] = []
    for f in archives:
        if os.path.exists(f):
            _add(arch, f)
    return cache, arch, cmds


def unpack_command(path: str, dest: str = ".") -> str:
    """The shell command extracting archive ``path`` into ``dest`` — the
    ONE home for the zip/tar dispatch used by every shell-staging backend."""
    q = shlex.quote(path)
    qd = dest if dest.startswith('"') else shlex.quote(dest)
    if path.endswith(".zip"):
        return f"unzip -oq {q} -d {qd}"
    return f"tar -xf {q} -C {qd}"


def extract_archive(path: str, dest: str) -> None:
    """Extract a zip/tar archive into ``dest`` (the YARN file-cache unzip
    behavior for ``--archives``; ships e.g. python libraries)."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            t.extractall(dest)
    else:
        # not an archive: behave like a plain cached file
        shutil.copy2(path, os.path.join(dest, os.path.basename(path)))


def stage_into(dest: str, cache_files: List[str],
               cache_archives: List[str]) -> None:
    """Copy cached files (+x preserved via copy2) and extract archives into
    ``dest`` — the python-side analog of the YARN local resource download."""
    os.makedirs(dest, exist_ok=True)
    for f in cache_files:
        shutil.copy2(f, os.path.join(dest, os.path.basename(f)))
    for a in cache_archives:
        extract_archive(a, dest)


def stage_snippet(cache_files: List[str], cache_archives: List[str],
                  mode: str = "copy") -> str:
    """Shell lines staging the cache for script/inline backends.

    ``mode='copy'`` (slurm/sge/mpi/mesos): make a task-private dir, copy
    the cached files from their absolute submit-host paths (reachable over
    the cluster's shared filesystem), extract archives, cd there.

    ``mode='cwd'`` (yarn): the scheduler's own file cache already placed
    the files in the container cwd (DistributedShell ``-shell_files``), so
    only archive extraction of ``./<basename>`` remains.
    """
    if not cache_files and not cache_archives:
        return ""
    lines: List[str] = []
    # any staging step failing must kill the attempt loudly, not leave the
    # task running the wrong (empty) cwd until retries exhaust
    guard = ' || { echo "dmlc: file-cache staging failed" >&2; exit 97; }'
    if mode == "copy":
        lines.append(
            'DMLC_STAGE_DIR="$(mktemp -d "${TMPDIR:-/tmp}/dmlc_stage_XXXXXX")"')
        for f in cache_files:
            lines.append(f'cp -f {shlex.quote(f)} "$DMLC_STAGE_DIR/"' + guard)
    for a in cache_archives:
        if mode == "copy":
            lines.append(unpack_command(a, '"$DMLC_STAGE_DIR"') + guard)
        else:
            lines.append(unpack_command("./" + os.path.basename(a)) + guard)
    if mode == "copy":
        lines.append('cd "$DMLC_STAGE_DIR"')
    return "\n".join(lines)
