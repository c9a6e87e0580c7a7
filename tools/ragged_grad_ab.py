#!/usr/bin/env python3
"""Time the ragged-gather backward of two checkouts of the port on one
card, in turns, on the same inputs.

    python3 tools/ragged_grad_ab.py BASE_ROOT [--order base,change,change,base]

``BASE_ROOT`` is another checkout of this repository (an unpacked
``git archive`` of an earlier commit); ``change`` is the checkout this
script lies in.  Each turn is a fresh interpreter that imports
``dmlc_core_tpu_torch`` from its checkout, builds its kernels there and
times the backward, without dvals as the training paths call it, at the
shapes ``chip_smoke.py`` gives it: embed and fm at D = 32 (F 2^20, the
flat training batch), embed at FFM's D = 160 (F 2^18) and at the CLI's
FFM defaults, D = 640 (F 2^20); each against its plain version, and split
by ``torch.profiler`` into the device time of each launch (memsets
included).  Inputs come from one seed, so every turn sees the same ones.
Prints one line per turn, then one JSON object: the card's name and power
limit and each turn's numbers.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (the batches, the
    Timer and the bound)."""
    spec = importlib.util.spec_from_file_location(
        "_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split(torch, fn, calls: int = 5) -> dict:
    """Device microseconds a call of each kernel (and memset) ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", 0)
              or getattr(ev, "cuda_time_total", 0))
        if us:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].strip()
            out[name] = round(us / calls, 2)
    return out


def one(root: str) -> dict:
    """One turn: time the backward of the port under ``root``."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ragged_grad_ab: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(root))
    import dmlc_core_tpu_torch
    from dmlc_core_tpu_torch.kernels import (ragged_gather_grad,
                                             ragged_gather_table_grad)
    pkg = os.path.dirname(os.path.abspath(dmlc_core_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {pkg}, not the package under {root}")
    sm = _smoke()
    timer = sm.Timer(torch)
    rng = np.random.default_rng(0)
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    rows = {}

    def case(name, run, plain, reps=30):
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=sm.RTOL, atol=sm.ATOL):
            raise SystemExit(f"{name}: max |err| {err:.3g} against the "
                             "plain version")
        del got, want
        rows[name] = dict(ms=timer.ms(run, reps=reps), max_abs_err=err,
                          split_us=_split(torch, run))

    F, D = sm.F_FEATURES, sm.DIM
    table = dev(rng.standard_normal((F, D), dtype=np.float32) * 0.05)
    fids, fvals, fsegs, _, _ = sm._flat_train_batch(torch, rng)
    g1, g2 = (dev(rng.standard_normal((sm.ROWS_TR + 1, D),
                                      dtype=np.float32)) for _ in range(2))
    with torch.no_grad():
        for fm in (False, True):
            call = lambda engine, fm=fm: ragged_gather_grad(  # noqa: E731
                fids, fvals, fsegs, None, table, g1, g2 if fm else None,
                sm.ROWS_TR, need_dvals=False, engine=engine)[1]
            case(f"{'fm' if fm else 'embed'} D={D}",
                 lambda: call("kernel"), lambda: call("torch"))
        del table, g1, g2
        S = sm.ROWS_TR * sm.NF_FFM
        for Fc, Dc in ((sm.F_FFM, sm.NF_FFM * sm.DIM_FFM),
                       (F, sm.NF_FFM * 16)):
            ids, vals, segs, _ = sm._ffm_batch(torch, rng, Fc)
            g = dev(rng.standard_normal((S + 1, Dc), dtype=np.float32))
            call = lambda engine: ragged_gather_table_grad(  # noqa: E731
                ids, vals, segs, None, g, S, Fc, engine=engine)
            case(f"embed D={Dc} F={Fc}", lambda: call("kernel"),
                 lambda: call("torch"), reps=10 if Dc > 160 else 30)
            del g
    return {"root": root, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="root of the other checkout")
    ap.add_argument("--order", default="base,change,change,base")
    ap.add_argument("--one", action="store_true",
                    help="time the checkout at BASE in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.base)), flush=True)
        return 0
    roots = {"base": os.path.abspath(args.base), "change": HERE}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    turns = []
    for label in args.order.split(","):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), roots[label],
             "--one"], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"ragged_grad_ab: turn {label} failed")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["turn"] = label
        turns.append(res)
        print(f"[ab] {label}: " + ", ".join(
            f"{k} {v['ms'] * 1e3:.1f} us" for k, v in res["rows"].items())
            + f" [{smi}]", flush=True)
        for k, v in res["rows"].items():
            print(f"[ab] {label} {k} device us a call: " + ", ".join(
                f"{n} {t}" for n, t in v["split_us"].items()), flush=True)
    print(smi)
    print(json.dumps({"device": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
