#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device  — the card's name and power limit (nvidia-smi) and its
   compute capability, which must be (9, 0);
2. build   — compiles every kernel under dmlc_core_tpu_torch/kernels/
   with nvcc, one process per source, all at once;
3. kernels — each kernel on the card at the serving path's shapes, held
   against its plain PyTorch version (rtol = atol = 1e-5; zero fill must
   give exact zeros), with CUDA-event times of kernel, plain version and,
   where one PyTorch call computes the same function, that call;
4. serving — FactorizationMachine(num_features=2^20, dim=32) from seeded
   weights, saved and restored through the port's CheckpointManager and
   served by InferenceEngine + MicroBatcher in padded and ragged mode
   with sigmoid scores: 72 requests per mode from 8 threads, every answer
   held against the plain path on the card and a few against a float64
   numpy FM; then a hot-reload to a second step, and one row-major
   forward.  The kernels' launch counts are read around this phase.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is one JSON object with each kernel's numbers.  Runs with no card, or
without the package beside it, exit non-zero.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F_FEATURES = 1 << 20
DIM = 32
CAP, ROWS = 8192, 128            # the ladders' largest bucket
B_RM, K_RM = 128, 64             # row-major batch: the ladder's nnz_per_row
RTOL = ATOL = 1e-5               # kernel vs plain version, same f32 inputs
ATOL_F64 = 1e-4                  # f32 scores vs a float64 FM (sums of up
                                 # to 8192 f32 terms)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- timing -----------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call on the device, each call after
    an L2 flush (serving requests find the gathered table rows cold).
    A spin kernel queued ahead of each call keeps the device busy while
    the host enqueues it, so the events time the device's work and not
    the host's launch overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 30, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 + 2 ------------------------------------------------------------

def phase_device(torch) -> str:
    line = smi_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} count {torch.cuda.device_count()}")
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"need an sm_90 card, got capability {cap}")
    return line


def phase_build() -> None:
    from dmlc_core_tpu_torch.kernels import build
    t0 = time.monotonic()
    took = build.build_all(force=True)
    log(f"[build] {len(took)} kernels in {time.monotonic() - t0:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in took.items()))
    for name in took:
        for ln in (build.ptxas_report(name) or "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")


# -- phase 3 ----------------------------------------------------------------

def _ragged_inputs(torch, rng, fill: int):
    """A capacity batch: ``fill`` live entries over ROWS sorted rows,
    then a garbage tail (NaN values, hostile segments, ids past the
    table) that no result may see."""
    ids = rng.integers(0, F_FEATURES, CAP).astype(np.int32)
    vals = rng.random(CAP, dtype=np.float32)
    segs = np.sort(rng.integers(0, ROWS, CAP)).astype(np.int32)
    vals[fill:] = np.nan
    segs[fill:] = rng.choice(np.array([-5, ROWS + 9], np.int32), CAP - fill)
    ids[fill:] = F_FEATURES + 3
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return (dev(ids), dev(vals), dev(segs),
            torch.tensor([fill], dtype=torch.int32, device="cuda"))


def _close(name, got, ref, exact_zero=False):
    torch = sys.modules["torch"]
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if exact_zero:
        if bool((got != 0).any()):
            raise RuntimeError(f"{name}: zero fill gave non-zero output")
    elif not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"{name}: max |err| {err:.3g} beyond rtol=atol="
                           f"{RTOL}")
    return err


def phase_kernels(torch, timer: Timer, power: str) -> dict:
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (fm_terms, fm_terms_reference,
                                             ragged_gather,
                                             ragged_gather_reference)
    rng = np.random.default_rng(SEED)
    results = {}
    with torch.inference_mode():
        for D, variants in ((DIM, (True, False)), (1, (False,))):
            table = torch.from_numpy(rng.standard_normal(
                (F_FEATURES, D), dtype=np.float32) * 0.05).cuda()
            for fill in (0, 3031, CAP):             # 0 %, ~37 %, 100 %
                ids, vals, segs, nnz = _ragged_inputs(torch, rng, fill)
                live_rows = int(torch.unique(ids[:fill]).numel())
                for fm in variants:
                    name = "ragged_gather_fm" if fm else "ragged_gather_embed"
                    run = lambda: ragged_gather(  # noqa: E731
                        ids, vals, segs, nnz, table, ROWS, fm=fm,
                        engine="kernel")
                    plain = lambda: ragged_gather_reference(  # noqa: E731
                        ids, vals, segs, nnz, table, ROWS, fm=fm)
                    got, want = run(), plain()
                    torch.cuda.synchronize()
                    err = 0.0
                    for g, w in zip(got, want):
                        if g is not None:
                            err = max(err, _close(f"{name} D={D} "
                                                  f"fill={fill}", g, w,
                                                  exact_zero=fill == 0))
                    ms, plain_ms = timer.ms(run), timer.ms(plain)
                    nout = 2 if fm else 1
                    nbytes = (live_rows * D * 4 + 12 * fill + 4
                              + nout * (ROWS + 1) * D * 4)
                    b_ms, b_by = bound(nbytes, (4 if fm else 2) * fill * D)
                    lib_ms = None
                    if not fm and fill == CAP:
                        # one PyTorch call computing the same embed sum
                        offsets = torch.searchsorted(
                            segs, torch.arange(ROWS, dtype=torch.int32,
                                               device="cuda"),
                            out_int32=True)
                        lib = lambda: Fn.embedding_bag(  # noqa: E731
                            ids, table, offsets, mode="sum",
                            per_sample_weights=vals)
                        _close(f"embedding_bag D={D}", lib(), want[0][:ROWS])
                        lib_ms = timer.ms(lib)
                    log(f"[kernels] {name} cap={CAP} rows={ROWS} D={D} "
                        f"fill={fill}: kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, embedding_bag "
                        f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                        f"bound {b_ms:.4f} ms ({b_by}), max|err| {err:.3g} "
                        f"[{power}]")
                    # the serving path runs the fm variant at D=32 and the
                    # embed variant (linear term) at D=1, at full fill
                    if fill == CAP and (fm or D == 1):
                        results[name] = dict(
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms,
                            max_abs_err=err)
            del table

        # row-major FM terms at the ladder's nnz_per_row
        table = torch.from_numpy(rng.standard_normal(
            (F_FEATURES, DIM), dtype=np.float32) * 0.05).cuda()
        ids_np = rng.integers(0, F_FEATURES, (B_RM, K_RM)).astype(np.int32)
        vals_np = rng.random((B_RM, K_RM), dtype=np.float32)
        ids, vals = (torch.from_numpy(ids_np).cuda(),
                     torch.from_numpy(vals_np).cuda())
        got = fm_terms(ids, vals, table, engine="kernel")
        want = fm_terms_reference(ids, vals, table)
        err = max(_close("fm_terms", g, w) for g, w in zip(got, want))
        # out-of-range ids clamp the same way on both
        bad = ids.clone()
        bad[:, :3] = torch.tensor([-1, F_FEATURES, F_FEATURES + 7],
                                  dtype=torch.int32, device="cuda")
        for g, w in zip(fm_terms(bad, vals, table, engine="kernel"),
                        fm_terms_reference(bad, vals, table)):
            _close("fm_terms out-of-range ids", g, w)
        run = lambda: fm_terms(ids, vals, table, engine="kernel")  # noqa
        plain = lambda: fm_terms_reference(ids, vals, table)  # noqa: E731
        ms, plain_ms = timer.ms(run), timer.ms(plain)
        offsets = torch.arange(0, B_RM * K_RM, K_RM, dtype=torch.int32,
                               device="cuda")
        lib_s1 = lambda: Fn.embedding_bag(  # noqa: E731
            ids.reshape(-1), table, offsets, mode="sum",
            per_sample_weights=vals.reshape(-1))
        _close("embedding_bag s1", lib_s1(), want[0])
        s1_lib_ms = timer.ms(lib_s1)
        uniq = int(torch.unique(ids).numel())
        nbytes = uniq * DIM * 4 + B_RM * K_RM * 8 + 2 * B_RM * DIM * 4
        b_ms, b_by = bound(nbytes, 4 * B_RM * K_RM * DIM)
        log(f"[kernels] fm_terms B={B_RM} K={K_RM} D={DIM}: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, embedding_bag (s1 only) "
            f"{s1_lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
            f"{err:.3g} [{power}]")
        results["fm_terms"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None,
                                   max_abs_err=err)
    return results


# -- phase 4 ----------------------------------------------------------------

def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w0": np.float32(0.1 * (seed + 1)).reshape(()),
            "w": rng.standard_normal(F_FEATURES, dtype=np.float32) * 0.05,
            "v": rng.standard_normal((F_FEATURES, DIM),
                                     dtype=np.float32) * 0.02}


def _fm_f64(p: dict, ids, vals, row_ptr) -> np.ndarray:
    w, v = p["w"].astype(np.float64), p["v"]
    out = []
    for r in range(len(row_ptr) - 1):
        i, x = ids[row_ptr[r]:row_ptr[r + 1]], vals[row_ptr[r]:row_ptr[r + 1]]
        x = x.astype(np.float64)
        vx = v[i].astype(np.float64) * x[:, None]
        pair = 0.5 * np.sum(vx.sum(0) ** 2 - (vx * vx).sum(0))
        out.append(float(p["w0"]) + float(w[i] @ x) + pair)
    return 1.0 / (1.0 + np.exp(-np.asarray(out)))


def _requests(rng, n: int):
    reqs = []
    for _ in range(n):
        rows = int(rng.integers(1, ROWS + 1))
        per = rng.integers(1, max(2, CAP // rows) + 1, rows)
        row_ptr = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
        nnz = int(row_ptr[-1])
        reqs.append((rng.integers(0, F_FEATURES, nnz).astype(np.int32),
                     rng.random(nnz, dtype=np.float32), row_ptr))
    return reqs


def _serve(batcher, reqs, threads: int = 8):
    """Closed-loop clients: each thread sends its share one at a time.
    Returns (answers, per-request latencies in ms, wall seconds)."""
    answers = [None] * len(reqs)
    lat = [0.0] * len(reqs)
    errors = []

    def client(k):
        try:
            for j in range(k, len(reqs), threads):
                t0 = time.perf_counter()
                answers[j] = batcher.submit(*reqs[j]).result(timeout=120)
                lat[j] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return answers, lat, wall


def breakdown(torch, timer: Timer, engines, reqs, power: str,
              reps: int = 20) -> None:
    """Where one ``predict`` of the largest request spends its time: each
    host stage run alone and synchronised (host clock, median of
    ``reps``), and the device time of the forward on a batch already on
    the card (CUDA events)."""
    from dmlc_core_tpu_torch.serving.engine import _batch_to_device
    for mode, eng in engines.items():
        ids, vals, rp = max(reqs[mode], key=lambda r: len(r[0]))
        bucket = eng.ladder.best_fit(len(rp) - 1, len(ids))
        stages = {"pad": [], "h2d": [], "forward": [], "predict": []}
        for _ in range(reps):
            t0 = time.perf_counter()
            batch = eng._pad(bucket, ids, vals, rp)
            t1 = time.perf_counter()
            dev_batch = _batch_to_device(batch, eng.device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            eng._forward_device(eng._params, dev_batch)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            eng.predict(ids, vals, rp)
            t4 = time.perf_counter()
            for k, a, b in (("pad", t0, t1), ("h2d", t1, t2),
                            ("forward", t2, t3), ("predict", t3, t4)):
                stages[k].append((b - a) * 1e3)
        dev_ms = timer.ms(lambda: eng._forward_device(eng._params,
                                                      dev_batch))
        log(f"[breakdown] {mode} bucket {tuple(bucket)} nnz={len(ids)}: "
            + ", ".join(f"{k} {np.median(v):.3f} ms"
                        for k, v in stages.items())
            + f", forward on the device {dev_ms:.4f} ms [{power}]")


def phase_serving(torch, timer: Timer, power: str) -> dict:
    from dmlc_core_tpu_torch import (BucketLadder, CheckpointManager,
                                     FactorizationMachine, InferenceEngine,
                                     MicroBatcher, params_from_jax)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts

    ckpt = os.path.join(ROOT, ".chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        p1, p2 = _np_params(SEED + 1), _np_params(SEED + 2)
        model = FactorizationMachine(F_FEATURES, DIM, device="cuda")
        model.load_state_dict(params_from_jax(p1, "cuda"))
        mgr = CheckpointManager(ckpt)
        mgr.save(1, {"params": p1}, meta={"model": "fm"})
        plain_model = copy.copy(model)        # shares the parameters
        plain_model.engine = "torch"
        rng = np.random.default_rng(SEED + 3)
        reqs = {m: _requests(rng, 72) for m in ("padded", "ragged")}
        reload_reqs = _requests(rng, 8)
        rm_ids = rng.integers(0, F_FEATURES, (B_RM, K_RM)).astype(np.int32)
        rm_vals = rng.random((B_RM, K_RM), dtype=np.float32)

        engines, answers, stats = {}, {}, {}
        reset_launch_counts()                 # the main path starts here
        for mode, ladder in (("padded", BucketLadder.default()),
                             ("ragged", BucketLadder.ragged_default())):
            eng = InferenceEngine(model, buckets=ladder,
                                  postprocess="sigmoid",
                                  ragged=mode == "ragged", device="cuda")
            if eng.reload_from_checkpoint(ckpt, step=1) != 1:
                raise RuntimeError("restored the wrong step")
            eng.warmup_all()
            calls = []
            predict = eng.predict

            def timed(*a, _predict=predict, _calls=calls):
                t0 = time.perf_counter()
                out = _predict(*a)
                _calls.append((time.perf_counter() - t0) * 1e3)
                return out
            eng.predict = timed
            with MicroBatcher(eng, default_deadline_s=60.0) as batcher:
                answers[mode], lat, wall = _serve(batcher, reqs[mode])
                nbatches = batcher.batches
            eng.predict = predict
            if eng.compile_count > len(eng.ladder):
                raise RuntimeError(f"{mode}: {eng.compile_count} buckets "
                                   f"prepared for a ladder of "
                                   f"{len(eng.ladder)}")
            rows = sum(len(r[2]) - 1 for r in reqs[mode])
            stats[mode] = dict(
                requests=len(reqs[mode]), batches=nbatches, rows=rows,
                request_p50_ms=float(np.percentile(lat, 50)),
                request_p99_ms=float(np.percentile(lat, 99)),
                predict_p50_ms=float(np.percentile(calls, 50)),
                predict_p99_ms=float(np.percentile(calls, 99)),
                rows_per_s=rows / wall, buckets_prepared=eng.compile_count,
                ladder=len(eng.ladder))
            engines[mode] = eng

        # hot-reload to a second step: scores must follow it
        mgr.save(2, {"params": p2}, meta={"model": "fm"})
        eng = engines["padded"]
        if eng.reload_from_checkpoint(ckpt) != 2:
            raise RuntimeError("hot-reload restored the wrong step")
        with MicroBatcher(eng, default_deadline_s=60.0) as batcher:
            reloaded, _, _ = _serve(batcher, reload_reqs)

        # the row-major branch of the same forward
        rm_batch = {"ids": torch.from_numpy(rm_ids).cuda(),
                    "vals": torch.from_numpy(rm_vals).cuda(),
                    "labels": torch.zeros(B_RM, device="cuda")}
        with torch.inference_mode():
            rm_got = model(rm_batch)
        torch.cuda.synchronize()
        launches = launch_counts()            # the main path ends here
        log(f"[serving] kernel launches on the main path: {launches}")

        # -- checks against the plain path and a float64 FM --------------
        for mode in ("padded", "ragged"):
            ref_eng = InferenceEngine(plain_model, postprocess="sigmoid",
                                      ragged=mode == "ragged", device="cuda")
            ref_eng.reload_from_checkpoint(ckpt, step=1)
            for j, (ids, vals, rp) in enumerate(reqs[mode]):
                got = answers[mode][j]
                want = ref_eng.predict(ids, vals, rp)
                if got.shape != (len(rp) - 1,) or not np.isfinite(got).all():
                    raise RuntimeError(f"{mode}: bad answer shape/values")
                if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                    raise RuntimeError(
                        f"{mode} request {j}: kernel path vs plain path "
                        f"max |err| {np.abs(got - want).max():.3g}")
                if j < 4 and not np.allclose(got, _fm_f64(p1, ids, vals, rp),
                                             rtol=0, atol=ATOL_F64):
                    raise RuntimeError(f"{mode} request {j}: far from the "
                                       f"float64 FM")
        for j, (ids, vals, rp) in enumerate(reload_reqs):
            want2 = _fm_f64(p2, ids, vals, rp)
            if not np.allclose(reloaded[j], want2, rtol=0, atol=ATOL_F64):
                raise RuntimeError("hot-reloaded scores do not follow step 2")
        if all(np.allclose(reloaded[j], _fm_f64(p1, *r), atol=ATOL_F64)
               for j, r in enumerate(reload_reqs)):
            raise RuntimeError("hot-reload changed no score")
        with torch.inference_mode():
            rm_want = plain_model(rm_batch)
        _close("row-major FM forward", rm_got, rm_want)

        breakdown(torch, timer, engines, reqs, power)
        for mode, s in stats.items():
            log(f"[serving] {mode}: {s['requests']} requests in "
                f"{s['batches']} batches, {s['rows']} rows, request p50 "
                f"{s['request_p50_ms']:.3f} ms p99 {s['request_p99_ms']:.3f}"
                f" ms, predict p50 {s['predict_p50_ms']:.3f} ms p99 "
                f"{s['predict_p99_ms']:.3f} ms, {s['rows_per_s']:.0f} rows/s,"
                f" buckets {s['buckets_prepared']}/{s['ladder']} [{power}]")
        log("[serving] hot-reload to step 2 followed; row-major forward "
            "matches its plain version")
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import dmlc_core_tpu_torch  # noqa: F401 — fails without the package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    power = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    kern = phase_kernels(torch, timer, power)
    launches = phase_serving(torch, timer, power)
    on_path = {"ragged_gather_fm", "ragged_gather_embed", "fm_terms"}
    missing = [k for k in sorted(on_path) if launches.get(k, 0) < 1]
    if missing:
        raise RuntimeError(f"main path never launched: {missing}")
    src = "dmlc_core_tpu_torch/kernels/"
    meta = {
        "ragged_gather_fm": ("ragged_gather.cu",
                             "dmlc_core_tpu/ops/ragged_csr.py:166"),
        "ragged_gather_embed": ("ragged_gather.cu",
                                "dmlc_core_tpu/ops/ragged_csr.py:166"),
        "fm_terms": ("fm_terms.cu", "dmlc_core_tpu/ops/pallas_embed.py:326"),
    }
    rows = []
    for name, (cu, replaces) in meta.items():
        k = kern[name]
        rows.append({"name": name, "route": "cuda", "source": src + cu,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    log(f"[done] {time.monotonic() - t_start:.1f}s")
    print(power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # noqa: BLE001 — any failed phase fails
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        rc = 1
    sys.exit(rc)
