#!/usr/bin/env python3
"""What the port's spans cost on the card's serving and training paths:
the parent checkout against this one in turns, and within this
checkout's turns the spans on against the spans taken out, in
alternating blocks of one process.

    python3 tools/trace_ab.py PARENT_ROOT [--rounds 2]

``PARENT_ROOT`` is another checkout of this repository (an unpacked
``git archive`` of the parent commit).  Each turn is a fresh
interpreter that imports ``dmlc_core_tpu_torch`` from its checkout; the
turns run ``parent, change, change, parent`` ``--rounds`` times.  A turn
measures, with chip_smoke.py's models, data and load shapes:

* ``load1``: an in-process ``PredictionServer`` of FM 2^20 x 32 (padded
  ladder, seeded weights) under ``run_load``'s load 1 (8 connections,
  one request of 128 rows in flight each), ``BLOCKS`` blocks of
  ``BLOCK_REQUESTS`` requests after 200 to warm up: qps, p50 and p99 of
  each block;
* ``engine``: ``InferenceEngine.predict`` of one 128-row request called
  directly, no server, ``BLOCKS`` blocks of ``ENGINE_CALLS`` calls: the
  median host µs of a call in each block;
* ``fm``: FM flat trained one step a batch from ``DeviceLoader`` (the
  native packer's v3 wire, Adam) in steady state, ``BLOCKS`` blocks of
  ``FM_EPOCHS`` epochs: steps/s, the consumer's median wait and the
  median enqueue of each block.

In this checkout's turns the blocks alternate ``on, off, off, on, ...``:
``off`` swaps the tracing module of every call site on these paths
(client, server, batcher, engine, loader) for one whose spans are
no-ops, and the histograms' exemplar lookup for one that finds no
trace, so a block pair of one process tells what tracing costs without
the noise between processes, and ``off`` blocks against the parent's
tell what else differs.  The parent's blocks are all ``plain``.  Prints one line per
turn, then the card's name and power limit, then one JSON object with
every block of every turn and the medians.  Needs a card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = 12                # blocks of each measurement in a turn
BLOCK_REQUESTS = 250       # load-1 requests a block
ENGINE_CALLS = 400         # direct engine calls a block
FM_EPOCHS = 2              # FM flat epochs a block (8 steps an epoch)
ORDER = ("parent", "change", "change", "parent")


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (models, data,
    shapes and the build)."""
    spec = importlib.util.spec_from_file_location(
        "_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _labels(traced: bool):
    """Each block's label: on, off, off, on, ... (plain for the parent)."""
    if not traced:
        return ["plain"] * BLOCKS
    return ["on" if (i % 4) in (0, 3) else "off" for i in range(BLOCKS)]


def _untraced(real):
    """A stand-in for the tracing module whose spans are no-ops."""
    null = contextlib.nullcontext()
    return types.SimpleNamespace(
        TraceContext=real.TraceContext, Span=real.Span,
        current=lambda: None, wire_ids=lambda: (0, 0),
        span=lambda *a, **kw: null, activate=lambda ctx: null,
        record_span=lambda *a, **kw: None,
        start_span=lambda *a, **kw: types.SimpleNamespace(
            end=lambda **kw: None, context=None))


def _switch(traced: bool):
    """``switch(on)`` gives every module with a tracing call site on these
    paths (client, server, batcher, engine, loader) its real tracing
    module (on) or the stand-in (off), and the histograms their exemplar
    lookup or one that finds no trace; a no-op for the parent."""
    if not traced:
        return lambda on: None
    import importlib
    mods = [importlib.import_module(f"dmlc_core_tpu_torch.{m}") for m in (
        "serving.client", "serving.server", "serving.batcher",
        "serving.engine", "pipeline.loader")]
    metrics_mod = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")
    saved = {m: (m.teltrace, getattr(m, "trace_span", None)) for m in mods}
    real_hex = metrics_mod._active_trace_hex
    null = contextlib.nullcontext()

    def switch(on: bool) -> None:
        for m, (real, rng) in saved.items():
            m.teltrace = real if on else _untraced(real)
            if rng is not None:
                m.trace_span = rng if on else (lambda name: null)
        metrics_mod._active_trace_hex = real_hex if on else (lambda: None)
    return switch


def turn(root: str, train_file: str) -> dict:
    """One turn with the port under ``root``; returns its blocks."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    import dmlc_core_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {pkg.__file__}, not {root}'s")
    from dmlc_core_tpu_torch import (BucketLadder, DeviceLoader,
                                     FactorizationMachine, InferenceEngine,
                                     PredictionServer, adam, create_parser,
                                     make_train_step, run_load)
    from dmlc_core_tpu_torch.serving import engine as engine_mod
    cs = _smoke()
    traced = hasattr(engine_mod, "teltrace")
    labels = _labels(traced)
    switch = _switch(traced)
    out = {"root": root, "traced": traced, "load1": [], "engine": [],
           "fm": []}

    eng = InferenceEngine(FactorizationMachine(cs.F_FEATURES, cs.DIM,
                                               device="cuda"),
                          cs._np_params(cs.SEED + 1),
                          buckets=BucketLadder.default(),
                          postprocess="sigmoid", device="cuda")
    shape = dict(cs.LOADS)["load1"]
    srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0)
    srv.start()
    try:
        run_load(srv.host, srv.port, requests=200, features=cs.F_FEATURES,
                 seed=cs.SEED + 1, timeout=120.0, **shape)
        for i, label in enumerate(labels):
            switch(label != "off")
            rep = run_load(srv.host, srv.port, requests=BLOCK_REQUESTS,
                           features=cs.F_FEATURES, seed=cs.SEED + 100 + i,
                           timeout=120.0, **shape)
            if rep["rejected"] or rep["errors"] or \
                    rep["ok"] != BLOCK_REQUESTS:
                raise RuntimeError(f"load 1 block {i}: {rep}")
            out["load1"].append({"label": label, "qps": rep["qps"],
                                 "p50_ms": rep["latency_ms"]["p50"],
                                 "p99_ms": rep["latency_ms"]["p99"]})
    finally:
        srv.stop()
        switch(True)

    ids, vals, rp = cs._requests(np.random.default_rng(cs.SEED + 50), 1)[0]
    for _ in range(50):
        eng.predict(ids, vals, rp)
    for label in labels:
        switch(label != "off")
        ts = []
        for _ in range(ENGINE_CALLS):
            t = time.perf_counter()
            eng.predict(ids, vals, rp)
            ts.append((time.perf_counter() - t) * 1e6)
        out["engine"].append({"label": label,
                              "call_us": float(np.median(ts))})
    switch(True)

    model = cs._model(torch, "fm", "kernel")
    step = make_train_step(model, adam(model, cs.LR))
    loader = DeviceLoader(create_parser(train_file, engine="native"),
                          cs.ROWS_TR, cs.CAP_TR, layout="flat",
                          device="cuda", engine="native")
    try:
        float(step(loader.next_batch()))
        cs._steady_state(torch, step, loader, 1)
        for label in labels:
            switch(label != "off")
            r = cs._steady_state(torch, step, loader, FM_EPOCHS)
            out["fm"].append({"label": label,
                              "steps_s": r["steps"] / r["wall_s"],
                              "wait_ms": r["wait_median_ms"],
                              "enqueue_ms": r["enqueue_median_ms"]})
    finally:
        loader.close()
        switch(True)
    return out


def _summary(turns) -> dict:
    """Medians over every block of each label, and each change turn's
    on / off ratio of its block medians."""
    keys = {"load1": ("qps", "p50_ms", "p99_ms"), "engine": ("call_us",),
            "fm": ("steps_s", "wait_ms", "enqueue_ms")}
    out: dict = {}
    for part, fields in keys.items():
        for label in ("plain", "on", "off"):
            blocks = [b for t in turns for b in t[part]
                      if b["label"] == label]
            if blocks:
                out[f"{part}.{label}"] = {
                    f: float(np.median([b[f] for b in blocks]))
                    for f in fields}
        ratios = []
        for t in turns:
            on = [b[fields[0]] for b in t[part] if b["label"] == "on"]
            off = [b[fields[0]] for b in t[part] if b["label"] == "off"]
            if on and off:
                ratios.append(float(np.median(on) / np.median(off)))
        if ratios:
            out[f"{part}.on_over_off"] = ratios
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "TRAIN_FILE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(turn(*args.turn)))
        return 0
    sys.path.insert(0, HERE)
    cs = _smoke()
    power = cs.phase_device(torch)
    cs.phase_build()
    turns = []
    with cs._data_files() as (_, train_file, _eval):
        for arm in args.rounds * ORDER:
            root = os.path.abspath(args.parent) if arm == "parent" else HERE
            t0 = time.monotonic()
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                args.parent, "--turn", root, train_file],
                               cwd=HERE, capture_output=True, text=True,
                               timeout=900)
            if r.returncode != 0:
                raise RuntimeError(f"{arm} turn exited {r.returncode}: "
                                   f"{r.stderr[-3000:]}")
            res = json.loads(r.stdout.strip().splitlines()[-1])
            res["arm"] = arm
            turns.append(res)
            s = _summary([res])
            print(f"[trace-ab] {arm} turn in {time.monotonic() - t0:.1f} s: "
                  + "; ".join(f"{k} {v}" for k, v in s.items())
                  + f" [{power}]", flush=True)
    print(power)
    print(json.dumps({"power": power, "summary": _summary(turns),
                      "parent": _summary([t for t in turns
                                          if t["arm"] == "parent"]),
                      "change": _summary([t for t in turns
                                          if t["arm"] == "change"]),
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
