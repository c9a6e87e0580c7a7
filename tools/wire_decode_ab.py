#!/usr/bin/env python3
"""Time the v3 wire-decode kernel of two checkouts of the port on one
card, in turns, on the same buffers.

    python3 tools/wire_decode_ab.py BASE_ROOT [--order base,change,change,base]

``BASE_ROOT`` is another checkout of this repository (an unpacked
``git archive`` of an earlier commit); ``change`` is the checkout this
script lies in.  Each turn is a fresh interpreter that imports
``dmlc_core_tpu_torch`` from its checkout, builds its kernels there and
times ``wire_decode`` (chip_smoke's ``Timer``: median CUDA-event time
after an L2 flush) on v3 buffers built here in numpy from one seed, so
every turn sees the same ones:

* ``train``: the flat training batch (B 98,304, 4096 rows of 5-39
  values, id width 20, dict bits 14); ``train_raw``: the same with raw
  values (dict bits 0);
* ``cap``: the nnz cap, B 131,072 (4096 rows of 16-47 values);
* ``skewed``: one row holding 90 % of the batch's entries;
* ``half_empty``: half of the 4096 rows empty;
* ``zipf``: Zipf row lengths (a = 1.5);
* ``rows13000``: 13,000 rows at B 98,304;
* ``floor``: B 8, one row, the launch with next to no work.

Every turn holds each output ``array_equal`` (values as bits) to the
plain decode (``wire_decode_reference``) before it times.  Prints one
line per turn, then the card's name and power limit, then one JSON
object with each turn's numbers.  Needs a card; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, B_TRAIN, B_CAP = 4096, 98_304, 131_072
CASES = ("train", "train_raw", "cap", "skewed", "half_empty", "zipf",
         "rows13000", "floor")


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (the Timer and the
    bound)."""
    spec = importlib.util.spec_from_file_location(
        "_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pack_bits(np, values, width, nwords):
    bits = ((values.astype(np.uint64)[:, None]
             >> np.arange(width, dtype=np.uint64)) & 1).astype(np.uint8)
    flat = np.zeros(nwords * 32, np.uint8)
    flat[:bits.size] = bits.reshape(-1)
    return np.packbits(flat, bitorder="little").view("<u4").view(np.int32)


def _counts(np, rng, case):
    """(row lengths, B) of a case: every row's values, then padding."""
    if case == "cap":
        return rng.integers(16, 48, ROWS), B_CAP
    if case == "rows13000":
        return rng.integers(1, 13, 13_000), B_TRAIN
    if case == "floor":
        return np.array([5]), 8
    counts = rng.integers(5, 40, ROWS)
    if case == "skewed":
        counts = np.ones(ROWS, np.int64)
        counts[ROWS // 3] = int(0.9 * B_TRAIN) - (ROWS - 1)
    elif case == "half_empty":
        counts = rng.integers(10, 34, ROWS) * 2
        counts[rng.permutation(ROWS)[:ROWS // 2]] = 0
    elif case == "zipf":
        counts = np.minimum(rng.zipf(1.5, ROWS), 4000)
        counts = np.minimum(counts, np.maximum(
            0, B_TRAIN - np.concatenate([[0], np.cumsum(counts)[:-1]])))
    return counts, B_TRAIN


def buffer(case: str, seed: int = 0):
    """``(int32 buffer, rows, B, w, dbits)`` of one case."""
    import numpy as np
    rng = np.random.default_rng([seed, CASES.index(case)])
    counts, B = _counts(np, rng, case)
    rows, n = len(counts), int(counts.sum())
    assert n <= B, (case, n, B)
    w, dbits = (8, 0) if case == "floor" else (
        20, 0 if case == "train_raw" else 14)
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ids = np.zeros(B, np.int64)
    ids[:n] = rng.integers(0, 1 << w, n)
    parts = [_pack_bits(np, ids, w, (B * w + 31) // 32)]
    if dbits:
        table = np.sort(rng.random(1 << dbits, dtype=np.float32))
        table[0] = 0.0
        codes = np.zeros(B, np.int64)
        codes[:n] = rng.integers(1, 10_001, n)
        parts += [_pack_bits(np, codes, dbits, (B * dbits + 31) // 32),
                  table.view(np.int32)]
    else:
        vals = np.zeros(B, np.float32)
        vals[:n] = rng.random(n, dtype=np.float32)
        parts.append(vals.view(np.int32))
    labels = rng.integers(0, 2, rows).astype(np.float32)
    parts += [rp, labels.view(np.int32),
              np.ones(rows, np.float32).view(np.int32)]
    return np.concatenate(parts).astype(np.int32), rows, B, w, dbits


def one(root: str) -> dict:
    """One turn: time the decode of the port under ``root``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wire_decode_ab: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(root))
    import dmlc_core_tpu_torch
    from dmlc_core_tpu_torch.kernels import (wire_decode,
                                             wire_decode_reference)
    pkg = os.path.dirname(os.path.abspath(dmlc_core_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {pkg}, not the package under {root}")
    sm = _smoke()
    timer = sm.Timer(torch)
    rows_out = {}
    for case in CASES:
        host, rows, B, w, dbits = buffer(case)
        buf = torch.from_numpy(host).cuda()
        got = wire_decode(buf, rows, B, w, dbits, engine="kernel")
        want = wire_decode_reference(buf, rows, B, w, dbits)
        torch.cuda.synchronize()
        for name, g, r in zip(("ids", "vals", "segments"), got, want):
            if g.dtype == torch.float32:
                g, r = g.view(torch.int32), r.view(torch.int32)
            if not torch.equal(g, r):
                raise SystemExit(f"{case}: the kernel's {name} differ from "
                                 "the plain decode's")
        ms = timer.ms(lambda: wire_decode(buf, rows, B, w, dbits,
                                          engine="kernel"), reps=50)
        b_ms, b_by = sm.bound(len(host) * 4 + 3 * B * 4, 0)
        rows_out[case] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, rows=rows,
                              B=B, w=w, dbits=dbits)
    return {"root": root, "rows": rows_out}


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
            raise SystemExit(f"wire_decode_ab: turn {label} failed")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["turn"] = label
        turns.append(res)
        print(f"[ab] {label}: " + ", ".join(
            f"{k} {v['ms'] * 1e3:.2f} us" for k, v in res["rows"].items())
            + f" [{smi}]", flush=True)
    print(smi)
    print(json.dumps({"device": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
