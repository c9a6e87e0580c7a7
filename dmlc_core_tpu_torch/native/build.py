"""Build the port's native parse and pack library with g++.

Counterpart of ``dmlc_core_tpu/native/build.py``: one translation unit,
``dmlc_native.cpp`` beside this module, compiled at first use (never at
import) into ``_build/libdmlc_native.so`` with the JAX package's flags
(``-O3 -std=c++17 -shared -fPIC -march=native -fopenmp``), and once more
with the conservative flags (no ``-march=native``, no OpenMP) when the
first try fails.  The library is rebuilt when the hash of the source, the
flags and the machine's architecture changes.  The library is written to
a per-process temporary file and published with ``os.replace``, and
builds are serialised by a thread lock and a file lock, so that several
processes starting at once never load a half-written library.

Run ``python -m dmlc_core_tpu_torch.native.build`` to build it ahead of
time.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

__all__ = ["SRC", "OUT", "compiler", "is_fresh", "build_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "dmlc_native.cpp")
_BUILD = os.path.join(_HERE, "_build")
OUT = os.path.join(_BUILD, "libdmlc_native.so")
_HASH = OUT + ".srchash"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
         "-fopenmp"]
FLAGS_CONSERVATIVE = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()


def compiler() -> Optional[str]:
    """The path of ``g++``, or None when there is none."""
    return shutil.which("g++")


def _digest(flags: List[str]) -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(platform.machine().encode())
    return h.hexdigest()


def is_fresh() -> bool:
    """True when the built library matches the source (built with either
    set of flags)."""
    try:
        with open(_HASH) as f:
            got = f.read().strip()
    except OSError:
        return False
    return (os.path.isfile(OUT)
            and got in (_digest(FLAGS), _digest(FLAGS_CONSERVATIVE)))


def build_native(force: bool = False) -> Tuple[bool, str]:
    """Compile the library unless it is fresh.  Returns ``(ok, report)``:
    ``ok`` False with g++'s output when both flag sets failed."""
    with _lock:
        os.makedirs(_BUILD, exist_ok=True)
        with open(os.path.join(_BUILD, "lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)      # released at close
            if not force and is_fresh():
                return True, "fresh"
            return _compile()


def _compile() -> Tuple[bool, str]:
    gxx = compiler()
    if gxx is None:
        return False, "g++ not found"
    tmp = f"{OUT}.{os.getpid()}.tmp"
    reports = []
    for flags in (FLAGS, FLAGS_CONSERVATIVE):
        t0 = time.monotonic()
        try:
            proc = subprocess.run([gxx, *flags, SRC, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            reports.append(f"{' '.join(flags)}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, OUT)
            tmp_hash = f"{_HASH}.{os.getpid()}.tmp"
            with open(tmp_hash, "w") as f:
                f.write(_digest(flags))
            os.replace(tmp_hash, _HASH)
            return True, (f"built {OUT} with {' '.join(flags)} in "
                          f"{time.monotonic() - t0:.1f}s")
        reports.append(f"{' '.join(flags)} (exit {proc.returncode}):\n"
                       f"{proc.stderr}")
    if os.path.exists(tmp):
        os.remove(tmp)
    return False, "\n".join(reports)


if __name__ == "__main__":
    ok, report = build_native(force=True)
    print(report)
    sys.exit(0 if ok else 1)
