"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``*.cu`` file beside this module is one kernel source with a plain
``extern "C"`` launcher; the device helpers they share (the id rules)
are in ``common.cuh``.  At first use each source is compiled for Hopper
(``sm_90a``) into its own shared library under ``_build/``, all sources
at once, one ``nvcc`` process each.  A library is rebuilt when the hash
of its source, the shared headers and the flags changes (the scheme of
``dmlc_core_tpu/native/build.py``).  A failed build raises: there is no
fallback.

Binding through ctypes keeps PyTorch's headers out of the build, so a
build takes seconds.  Launchers take raw ``data_ptr()`` values and the
caller's CUDA stream; the Python wrappers allocate every output.

Run ``python -m dmlc_core_tpu_torch.kernels.build`` on a machine with
``nvcc`` to build everything ahead of time and print the register and
shared-memory use of each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from ..utils.logging import DMLCError, log_info

__all__ = ["sources", "build_all", "load", "nvcc_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_ptxas_reports: Dict[str, str] = {}


def sources() -> List[str]:
    """Names (without ``.cu``) of every kernel source in the package."""
    return sorted(f[:-3] for f in os.listdir(_DIR) if f.endswith(".cu"))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise DMLCError("nvcc not found: the CUDA kernels need the CUDA "
                    "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    """Hash of the source, every shared header beside it and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(_DIR, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()


def _lib_path(name: str) -> str:
    return os.path.join(_BUILD, f"lib{name}.so")


def _fresh(name: str) -> bool:
    try:
        with open(_lib_path(name) + ".srchash") as f:
            return (f.read().strip() == _digest(name)
                    and os.path.isfile(_lib_path(name)))
    except OSError:
        return False


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every stale source, all in parallel; returns the seconds
    each build took (empty when everything was fresh).  Raises
    :class:`DMLCError` with nvcc's output if any build fails."""
    with _lock:
        return _build_locked(force)


def _build_locked(force: bool) -> Dict[str, float]:
    stale = [n for n in sources() if force or not _fresh(n)]
    if not stale:
        return {}
    nvcc = nvcc_path()
    os.makedirs(_BUILD, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in stale:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", tmp, os.path.join(_DIR, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    took: Dict[str, float] = {}
    failed = []
    for name, (tmp, p) in procs.items():
        out, _ = p.communicate()
        took[name] = time.monotonic() - t0
        if p.returncode != 0:
            failed.append(f"--- {name}.cu (exit {p.returncode}) ---\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        _ptxas_reports[name] = out
        os.replace(tmp, _lib_path(name))
        with open(_lib_path(name) + ".srchash", "w") as f:
            f.write(_digest(name))
        log_info("kernels: built %s in %.1fs", name, took[name])
    if failed:
        raise DMLCError("nvcc failed:\n" + "\n".join(failed))
    return took


def ptxas_report(name: str) -> Optional[str]:
    """What ``ptxas -v`` said when ``name`` was last built in this
    process (None if it was loaded from an earlier build)."""
    return _ptxas_reports.get(name)


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel source ``name``, built on first use
    (together with every other stale source)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in sources():
                raise DMLCError(f"no kernel source {name}.cu")
            _build_locked(False)
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
    return lib


if __name__ == "__main__":
    for n, s in build_all(force=True).items():
        print(f"{n}: {s:.1f}s\n{ptxas_report(n)}")
