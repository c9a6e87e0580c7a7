"""Persisted transfer tuning and the autotuner's converged configs.

Counterpart of ``dmlc_core_tpu/pipeline/tuned.py``, copied so that the
port never imports the JAX package.  One JSON file holds, per backend,
the transfer knobs a probe found best (``put_threads``,
``wire_compact``), and under the reserved ``"autotune"`` section the
closed-loop autotuner's converged configs (:mod:`.autotune`), keyed by
:func:`.fingerprint.autotune_key`.

:class:`~.loader.DeviceLoader` resolves ``put_threads="auto"`` and
``wire_compact="auto"`` through :func:`resolve` for its device type.
The precedence: an explicit value, then ``DMLC_PUT_THREADS`` /
``DMLC_WIRE_COMPACT``, then the persisted file, then the built-in
default (cpu: 1 and False; any other backend: 1 and True).  The port's
backend key is the torch device type, ``"cuda"`` on the card: a key the
JAX package never writes (its backends are ``cpu``, ``gpu`` and
``tpu``), so a measurement of the JAX package never steers the port,
while both read and write the same file.

``DMLC_TUNED_CONFIG`` names the file, by default ``.dmlc_tuned.json`` at
the repository's root.  Writers serialize through a sidecar lockfile
(``<path>.lock``): ``fcntl.flock`` where available, an O_CREAT|O_EXCL
spin (a stale lock broken after a timeout) where not; every write is a
locked read-modify-write landed by an atomic replace, so concurrent
writers merge instead of dropping each other's entries.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import time
from typing import Iterator, Optional

from ..utils.logging import log_info, log_warning
from ..utils.parameter import env_int, get_env, parse_lenient_bool

__all__ = ["tuned_path", "save_tuned", "load_tuned", "resolve",
           "save_autotuned", "load_autotuned", "update_tuned"]

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: reserved top-level section holding autotuner entries (never a platform
#: name, so ``load_tuned`` can't confuse the two)
AUTOTUNE_SECTION = "autotune"


def tuned_path() -> str:
    return get_env("DMLC_TUNED_CONFIG",
                   os.path.join(_REPO_ROOT, ".dmlc_tuned.json"))


@contextlib.contextmanager
def _locked(path: str, timeout_s: float = 10.0) -> Iterator[None]:
    """Serialize read-modify-write of ``path`` across processes via
    ``<path>.lock``.  flock when the platform has it; otherwise an
    O_EXCL retry loop that breaks locks older than ``timeout_s`` (a
    crashed fallback-path holder must not wedge tuning forever)."""
    lock = path + ".lock"
    d = os.path.dirname(lock)
    if d:
        os.makedirs(d, exist_ok=True)
    try:
        import fcntl
    except ImportError:
        fcntl = None
    if fcntl is not None:
        fd = os.open(lock, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            # unlink before unlock would open an exclusion hole (a waiter
            # holding the old inode vs a fresh creator); just leave the
            # tiny sidecar — flock state lives on the inode, not the name
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)
        return
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            os.close(fd)
            break
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
            if time.monotonic() > deadline:
                try:                        # stale lock: holder is gone
                    os.unlink(lock)
                except OSError:
                    pass
                log_warning("tuned config %s: broke stale lock", path)
                deadline = time.monotonic() + timeout_s
            time.sleep(0.01)
    try:
        yield
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def _load_all(path: str) -> dict:
    try:
        with open(path) as f:
            all_cfg = json.load(f)
    except (OSError, ValueError):
        return {}
    return all_cfg if isinstance(all_cfg, dict) else {}


def update_tuned(mutate) -> None:
    """Locked read-modify-write of the whole tuned file:
    ``mutate(all_cfg)`` edits the dict in place, then it lands via
    tmp-file + atomic replace.  Every writer goes through here, so
    concurrent probes/autotuners merge instead of clobbering."""
    path = tuned_path()
    with _locked(path):
        all_cfg = _load_all(path)
        mutate(all_cfg)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(all_cfg, f, indent=1)
        os.replace(tmp, path)


def save_tuned(cfg: dict) -> None:
    """Atomically persist a probe winner.  ``cfg`` must carry
    ``platform``; the file keeps one entry per platform so a cpu run
    never clobbers the tpu tuning."""
    platform = str(cfg.get("platform", "unknown"))

    def mutate(all_cfg: dict) -> None:
        all_cfg[platform] = cfg

    update_tuned(mutate)


def load_tuned(platform: str) -> Optional[dict]:
    """The persisted winner for ``platform``, or None."""
    got = _load_all(tuned_path()).get(platform)
    return got if isinstance(got, dict) else None


def save_autotuned(key: str, cfg: dict) -> None:
    """Persist one converged autotuner config under the ``autotune``
    section, keyed by :func:`.fingerprint.autotune_key` output."""

    def mutate(all_cfg: dict) -> None:
        section = all_cfg.get(AUTOTUNE_SECTION)
        if not isinstance(section, dict):
            section = {}
            all_cfg[AUTOTUNE_SECTION] = section
        section[str(key)] = cfg

    update_tuned(mutate)


def load_autotuned(key: str) -> Optional[dict]:
    """The persisted autotuner config for ``key``, or None."""
    section = _load_all(tuned_path()).get(AUTOTUNE_SECTION)
    if not isinstance(section, dict):
        return None
    got = section.get(str(key))
    return got if isinstance(got, dict) else None


def resolve(backend: str, put_threads, wire_compact):
    """Resolve the DeviceLoader's "auto" knobs for ``backend`` (the torch
    device type).

    Returns ``(put_threads: int, wire_compact: bool)``.  Explicit values
    pass through untouched; "auto" falls to ``DMLC_PUT_THREADS`` /
    ``DMLC_WIRE_COMPACT`` env pins, then to the persisted tuning for this
    backend, then to the built-in defaults (cpu: 1/False — no link to
    pipeline or compress for; other: 1/True).  Malformed env values fall
    through with one WARNING (:func:`~..utils.parameter.env_int`) rather
    than raising in whatever thread first built a loader."""
    if put_threads == "auto":
        env_pt = env_int("DMLC_PUT_THREADS", 0, minimum=1)
        if env_pt:
            put_threads = env_pt
    if wire_compact == "auto":
        env_wc = parse_lenient_bool("DMLC_WIRE_COMPACT")
        if env_wc is not None:
            wire_compact = env_wc
    tuned = (load_tuned(backend)
             if "auto" in (put_threads, wire_compact) else None)
    applied = []
    if put_threads == "auto":
        if backend != "cpu" and tuned and "put_threads" in tuned:
            put_threads = tuned["put_threads"]
            applied.append(f"put_threads={put_threads}")
        else:
            put_threads = 1
    if wire_compact == "auto":
        if backend == "cpu":
            wire_compact = False
        elif tuned and "wire_compact" in tuned:
            wire_compact = bool(tuned["wire_compact"])
            applied.append(f"wire_compact={wire_compact}")
        else:
            wire_compact = True
    if applied:
        # say so: a repo-level tuning file silently changing loader
        # behavior would make cross-host perf differences undebuggable
        log_info("tuned config (%s) applied for %s: %s", tuned_path(),
                 backend, " ".join(applied))
    return max(1, int(put_threads)), bool(wire_compact)
