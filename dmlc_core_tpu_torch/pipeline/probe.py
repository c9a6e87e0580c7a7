"""The transfer probe: which ``put_threads`` and wire the loader should run.

Counterpart of the JAX repository's root ``bench.py`` ``measure_ours``
(its config probe and the persisted winner).  It times
:class:`~.loader.DeviceLoader`'s delivered batches/s over a text file
for ``put_threads`` {1, 2} × the v2 and v3 (compact) wires:

* a warm pass of each wire first (the native library, the decode
  kernel, the file in the page cache), not scored;
* then ``rounds`` rounds, each running every configuration once, the
  order reversed every other round, so that each configuration samples
  the same states of the host (``bench.py`` pairs its runs for the same
  reason);
* every batch folded into an accumulator on the device and one value
  read back at the end of a pass, so that a pass ends only once every
  batch has landed.

A configuration scores its median; the winner goes through
:func:`.tuned.save_tuned` under the device type (``"cuda"`` on the
card), where ``DeviceLoader(put_threads="auto", wire_compact="auto")``
finds it (:func:`.tuned.resolve`).  Nothing is persisted while
``DMLC_PUT_THREADS`` or ``DMLC_WIRE_COMPACT`` pins a knob, as
``bench.py`` never persists from an override run.

    python -m dmlc_core_tpu_torch.pipeline.probe train.libsvm [--rows 4096]
        [--nnz-cap 131072] [--rounds 3] [--device cuda] [--no-persist]

prints each configuration's batches/s and, as its last line, the
persisted record as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..data.parser import create_parser
from ..utils.device import resolve_device
from ..utils.logging import check, log_info
from .loader import DeviceLoader
from .tuned import save_tuned, tuned_path

__all__ = ["CONFIGS", "ProbeResult", "measure", "persist", "pins", "main"]

Config = Tuple[int, bool]                  # (put_threads, wire_compact)

#: put_threads {1, 2} × {v2, v3}
CONFIGS: Tuple[Config, ...] = ((1, False), (2, False), (1, True), (2, True))

#: the environment knobs that pin the loader's transfer configuration
PIN_KNOBS = ("DMLC_PUT_THREADS", "DMLC_WIRE_COMPACT")


def _label(cfg: Config) -> str:
    return f"pt={cfg[0]},{'v3' if cfg[1] else 'v2'}"


@dataclass
class ProbeResult:
    """Batches/s of each configuration, one a round."""

    platform: str
    batch_rows: int
    nnz_cap: int
    batches: int                            # a pass's batches
    runs: Dict[Config, List[float]] = field(default_factory=dict)

    def score(self, cfg: Config) -> float:
        return statistics.median(self.runs[cfg])

    @property
    def winner(self) -> Config:
        return max(self.runs, key=self.score)

    def record(self) -> dict:
        """The tuned file's entry: the winner's knobs and every
        configuration's batches/s."""
        pt, wc = self.winner
        return {"platform": self.platform, "put_threads": pt,
                "wire_compact": wc, "batch_rows": self.batch_rows,
                "nnz_cap": self.nnz_cap,
                "batches_per_s": round(self.score(self.winner), 1),
                "configs": {_label(c): [round(v, 1) for v in r]
                            for c, r in self.runs.items()}}


def _one_pass(uri: str, device: torch.device, cfg: Config, batch_rows: int,
              nnz_cap: int) -> Tuple[float, int]:
    """One epoch of the loader at ``cfg``: (batches/s, batches)."""
    pt, wc = cfg
    t0 = time.perf_counter()
    acc, n = None, 0
    with DeviceLoader(create_parser(uri, 0, 1, "auto"), batch_rows,
                      nnz_cap, device=device, put_threads=pt,
                      wire_compact=wc, cache=None) as loader:
        for batch in loader:
            v = batch["vals"][0]
            acc = v if acc is None else acc + v
            n += 1
        if acc is not None:
            float(acc)                      # every batch has landed
    return n / (time.perf_counter() - t0), n


def measure(uri: str, *, batch_rows: int = 4096, nnz_cap: int = 131072,
            rounds: int = 3,
            device: Optional[Union[str, torch.device]] = None,
            configs: Sequence[Config] = CONFIGS) -> ProbeResult:
    """Time every configuration in ``rounds`` alternating rounds after a
    warm pass of each wire (the card unless ``device="cpu"``)."""
    check(rounds >= 1, f"rounds must be >= 1, got {rounds}")
    dev = resolve_device(device)
    configs = list(configs)
    n = 0
    for wc in dict.fromkeys(c[1] for c in configs):
        n = _one_pass(uri, dev, (1, wc), batch_rows, nnz_cap)[1]
    result = ProbeResult(dev.type, batch_rows, nnz_cap, n,
                         {c: [] for c in configs})
    for r in range(rounds):
        for cfg in (configs if r % 2 == 0 else configs[::-1]):
            rate, got = _one_pass(uri, dev, cfg, batch_rows, nnz_cap)
            check(got == n, f"{_label(cfg)} gave {got} batches, the warm "
                  f"pass {n}")
            result.runs[cfg].append(rate)
    log_info("probe: %s → %s", " ".join(
        f"{_label(c)} {result.score(c):.1f}/s" for c in configs),
        _label(result.winner))
    return result


def pins() -> List[str]:
    """The knobs the environment pins."""
    return [k for k in PIN_KNOBS if os.environ.get(k)]


def persist(result: ProbeResult) -> bool:
    """Save the winner under the device type it was measured on;
    nothing, and False, while the environment pins a knob."""
    pinned = pins()
    if pinned:
        log_info("probe: %s pinned, nothing persisted", ", ".join(pinned))
        return False
    save_tuned(result.record())
    log_info("probe: winner persisted for %s in %s", result.platform,
             tuned_path())
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.pipeline.probe",
        description="time the loader over put_threads x wire and persist "
                    "the winner")
    ap.add_argument("uri")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--nnz-cap", type=int, default=131072)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--no-persist", action="store_true")
    args = ap.parse_args(argv)
    result = measure(args.uri, batch_rows=args.rows, nnz_cap=args.nnz_cap,
                     rounds=args.rounds, device=args.device)
    for cfg in result.runs:
        print(f"{_label(cfg)}: " + " ".join(
            f"{v:.1f}" for v in result.runs[cfg])
            + f" batches/s, median {result.score(cfg):.1f}")
    rec = result.record()
    rec["persisted"] = False if args.no_persist else persist(result)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
