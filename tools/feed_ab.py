#!/usr/bin/env python3
"""Time the flat training paths' steady state of two checkouts of the
port on one card, in turns, on the same data.

    python3 tools/feed_ab.py BASE_ROOT [--order base,change,change,base]

``BASE_ROOT`` is another checkout of this repository (an unpacked
``git archive`` of an earlier commit); ``change`` is the checkout this
script lies in (``change-threaded-split``: the same, its parsers built
over a split with a prefetch thread of its own, as the JAX package
builds them).  Each turn is a fresh interpreter that imports
``dmlc_core_tpu_torch`` from its checkout and trains, as chip_smoke's
``[train]`` phase does, FM(2^20, dim 32), DeepFM(2^20, dim 32, 2 layers)
and FieldAwareFM(2^18, 40 fields, dim 4) on the flat layout, one step a
batch, fed by ``DeviceLoader(create_parser(file, engine="native"))`` from
chip_smoke's seeded training file (libsvm; libfm for FFM): an epoch to
warm up, then ``REPEATS`` runs of 4 epochs in steady state (steps/s, the
wait in ``next_batch``, the host's enqueue of a step).  Prints one line
per turn, then one JSON object: the card's name and power limit and each
turn's numbers.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 3
PATHS = ("fm", "deepfm", "ffm")


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (the data writer,
    the models, the steady-state loop and their constants)."""
    spec = importlib.util.spec_from_file_location(
        "_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _turn(root: str, data: str, threaded_split: bool) -> dict:
    """One turn, in this interpreter, with ``root``'s package first on
    the path; ``threaded_split`` builds the parsers over a split with a
    prefetch thread of its own."""
    sys.path.insert(0, root)
    import torch
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     make_train_step)
    if threaded_split:
        from dmlc_core_tpu_torch.data import parser as parser_mod
        split = parser_mod.create_input_split
        parser_mod.create_input_split = (
            lambda *a, **kw: split(*a, **{**kw, "threaded": True}))
    smoke = _smoke()
    out = {}
    for kind in PATHS:
        ffm = kind == "ffm"
        path = os.path.join(data, "train.libfm" if ffm else "train.libsvm")
        model = smoke._model(torch, kind, "kernel")
        step = make_train_step(model, adam(model, smoke.LR))
        ld = DeviceLoader(
            create_parser(path, parser_type="libfm" if ffm else "libsvm",
                          engine="native"), smoke.ROWS_TR, smoke.CAP_TR,
            device="cuda", engine="native", fields=ffm,
            id_mod=smoke.F_FFM if ffm else 0)
        try:
            for batch in ld:                    # warm-up epoch
                step(batch)
            torch.cuda.synchronize()
            runs = [smoke._steady_state(torch, step, ld,
                                        smoke.STEADY_EPOCHS)
                    for _ in range(REPEATS)]
        finally:
            ld.close()
        out[kind] = [{"steps_per_s": r["steps"] / r["wall_s"],
                      "wait_mean_ms": r["wait_mean_ms"],
                      "wait_median_ms": r["wait_median_ms"],
                      "enqueue_median_ms": r["enqueue_median_ms"]}
                     for r in runs]
        del model, step
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="root of the other checkout")
    ap.add_argument("--order", default="base,change,change,base",
                    help="turns: base, change, or change-threaded-split "
                         "(the change with a prefetch thread on the "
                         "parser's split)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--threaded-split", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(_turn(args.turn, args.data, args.threaded_split)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("feed_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smoke = _smoke()
    power = smoke.smi_line()
    roots = {"base": os.path.abspath(args.base), "change": HERE,
             "change-threaded-split": HERE}
    turns = []
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".feed_ab_") as data:
        smoke._write_libsvm(os.path.join(data, "train.libsvm"),
                            smoke.TRAIN_STEPS * smoke.ROWS_TR, smoke.SEED + 10)
        smoke._write_libsvm(os.path.join(data, "train.libfm"),
                            smoke.TRAIN_STEPS * smoke.ROWS_TR, smoke.SEED + 10,
                            libfm=True)
        for side in args.order.split(","):
            extra = (["--threaded-split"]
                     if side == "change-threaded-split" else [])
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.base,
                 "--turn", roots[side], "--data", data, *extra],
                capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stderr[-3000:], file=sys.stderr)
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            turns.append({"side": side, **res})
            print(f"{side}: " + "; ".join(
                f"{k} " + "/".join(f"{x['steps_per_s']:.1f}" for x in v)
                + " steps/s" for k, v in res.items()) + f" [{power}]",
                flush=True)
    print(json.dumps({"card": power, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
