#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device  — the card's name and power limit (nvidia-smi) and its
   compute capability, which must be (9, 0);
2. build   — compiles every kernel under dmlc_core_tpu_torch/kernels/
   with nvcc, one process per source, all at once, and beside them the
   native parse and pack library with g++;
3. kernels — each kernel on the card at the shapes of the path that runs
   it (serving: the ragged gather and fm terms; training: the embed bag
   and fm terms, forward and backward, at 4096 x 64 and the ragged
   gather forward and backward at 4096 rows in the native packer's nnz
   bucket of cap 131072 (as the flat training batches come), with
   out-of-range ids and padding; the ragged-gather forward also with
   the batch's entries shuffled and with all of them in one row), held
   against its plain PyTorch version (rtol = atol = 1e-5; zero fill must
   give exact zeros, the D = 1 backward also in a freed NaN-filled
   block; two fm-terms or embed-bag calls must be bit-equal, at B 4096
   and B 128), with CUDA-event times of kernel, plain version, the same
   call with next to no work (embed bag B 1 K 1, D = 1 backward with
   nnz_used = 0) and, where one PyTorch call computes the same function,
   that call;
4. serving — FactorizationMachine(num_features=2^20, dim=32) from seeded
   weights, saved and restored through the port's CheckpointManager and
   served by InferenceEngine + MicroBatcher in padded and ragged mode
   with sigmoid scores: 72 requests per mode from 8 threads, every answer
   held against the plain path on the card and a few against a float64
   numpy FM; then a hot-reload to a second step, and one row-major
   forward.  The kernels' launch counts are read around this phase;
   feed    — the host feed's stages apart over the training file: python
   and native parse, streampack, python and native pack (ms per
   4096-row batch), the H2D copy and device decode of each fused batch
   (CUDA events; the card's decode array_equal to the CPU's), and each
   loader on its own;
5. training — six paths: DCNv2(2^20, dim=32, layers=3) and
   DeepFM(2^20, dim=32, layers=2) on row-major and flat batches,
   FactorizationMachine(2^20, dim=32) on flat and row-major batches:
   seeded libsvm text, labelled by a planted linear model, through the
   port's native parser and DeviceLoader (engine="native"; the native
   packer on the flat layout, in nnz buckets), 8 Adam(1e-3) steps of
   4096 rows on the kernels, held against the same seeded model on the
   plain path on the same batches (one step's gradients at rtol = atol
   = 1e-5 and within 1e-4 of each parameter's largest gradient, the
   per-step losses at rtol = 1e-4 and within a tenth of their drift,
   the trained parameters within 1e-3 of how far they moved,
   evaluate_stream accuracy within one row and AUC within 1e-4) and
   against the planted model (the eval AUC of each row's change in
   score over the 8 steps at least LEARN_AUC_MIN), with steps/s over
   the 8 steps and in steady state over 4 epochs, the consumer's wait
   in next_batch per step, the device's per-step breakdown and its idle
   share.  Launch counts are read around each path;
6. cli — the port's dmlc-train (python -m dmlc_core_tpu_torch.models.cli)
   in subprocesses: DeepFM at the same width trained 8 steps on the card
   with a validation file and a checkpoint, then mode=predict on the
   eval file; the 8192 printed scores must match the restored
   checkpoint's scores on the plain path within 2e-6.  Each wall is
   split into the interpreter's start and imports and the CLI's own
   stages (set-up, build checks, first batch, steps, ...).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is one JSON object with each kernel's numbers.  Runs with no card, or
without the package beside it, exit non-zero.

    python3 chip_smoke.py --plant dtable|forward

plants a fault on the kernel path (a zeroed table gradient, or a zeroed
forward, of the D = 32 tables, in every kernel family) and runs phases
1, 2 and 5 only; it exits 0 only if phase 5's checks catch the fault on
every path.
"""

from __future__ import annotations

import contextlib
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
# training batches (benchmarks/bench_suite.py bench_dcn_train and the
# row-major integrity config): 4096 rows, k_cap 64 or nnz_cap 131072
ROWS_TR, K_TR, CAP_TR = 4096, 64, 131072
LAYERS = 3                       # DCNv2's cross layers
DEEPFM_LAYERS = 2                # bench_suite.py bench_deepfm_train
LR = 1e-3
TRAIN_STEPS = 8
EVAL_ROWS = 2 * ROWS_TR
BAD_IDS = [-1, -F_FEATURES - 3, F_FEATURES, F_FEATURES + 7]
SPIN_CYCLES = 100_000_000        # device spin that covers a step's enqueue
FEED_EPOCHS = 3                  # passes of the [feed] timings
STEADY_EPOCHS = 4                # passes of each path's steady-state run
HOT_IDS = 64                     # the planted model's ids
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
    from dmlc_core_tpu_torch.native import build as native_build
    t0 = time.monotonic()
    native = {}
    th = threading.Thread(target=lambda: native.update(
        out=native_build.build_native(force=True)))
    th.start()
    try:
        took = build.build_all(force=True)
    finally:
        th.join()
    ok, report = native["out"]
    if not ok:
        raise RuntimeError(f"the native library failed to build: {report}")
    log(f"[build] {len(took)} kernels in {time.monotonic() - t0:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in took.items()))
    log(f"[build] native: {report}")
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


def _bit_equal(name, first, second) -> None:
    """Two calls of a kernel whose every sum has a fixed order."""
    torch = sys.modules["torch"]
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{name}: two calls differ")


def phase_kernels(torch, timer: Timer, power: str) -> dict:
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (fm_terms, fm_terms_reference,
                                             ragged_gather,
                                             ragged_gather_reference)
    rng = np.random.default_rng(SEED)
    results = {}
    # what the Timer reads for one launch that does next to nothing: the
    # floor under every kernel time below (a wrapper that zeroes its
    # outputs first pays it twice)
    floor_ms = timer.ms(lambda: torch.zeros(1, device="cuda"))
    log(f"[kernels] timer floor: one torch.zeros(1) launch {floor_ms:.4f} "
        f"ms [{power}]")
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
        _bit_equal("fm_terms", got, fm_terms(ids, vals, table,
                                             engine="kernel"))
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
    results.update(_training_kernels(torch, timer, power, rng))
    return results


def _rowmajor_train_batch(torch, rng):
    """ids/vals [ROWS_TR, K_TR] with rows of 5-39 values, padding (id 0,
    value 0) after them, and the out-of-range ids in row 0."""
    counts = rng.integers(5, 40, ROWS_TR)
    ids = rng.integers(0, 1_000_000, (ROWS_TR, K_TR)).astype(np.int32)
    vals = rng.random((ROWS_TR, K_TR), dtype=np.float32)
    pad = np.arange(K_TR)[None, :] >= counts[:, None]
    ids[pad], vals[pad] = 0, 0.0
    ids[0, :4] = BAD_IDS
    return torch.from_numpy(ids).cuda(), torch.from_numpy(vals).cuda()


def _bucket(nnz: int) -> int:
    """The native packer's nnz bucket for a flat batch of ``nnz`` values
    under ``CAP_TR``: ``nnz`` rounded up to ``CAP_TR // 8``."""
    q = CAP_TR // 8
    return min(CAP_TR, max(q, -(-nnz // q) * q))


def _flat_train_batch(torch, rng):
    """A flat batch of ROWS_TR rows of 5-39 values, as the native packer
    lays it out for the training paths: in its nnz bucket of slots
    (padding: id 0, value 0, segment ROWS_TR), out-of-range ids first.
    Returns the device tensors, the live count and the row counts."""
    counts = rng.integers(5, 40, ROWS_TR)
    nnz = int(counts.sum())
    cap = _bucket(nnz)
    ids = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    segs = np.full(cap, ROWS_TR, np.int32)
    ids[:nnz] = rng.integers(0, 1_000_000, nnz)
    ids[:4] = BAD_IDS
    vals[:nnz] = rng.random(nnz, dtype=np.float32)
    segs[:nnz] = np.repeat(np.arange(ROWS_TR, dtype=np.int32), counts)
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return dev(ids), dev(vals), dev(segs), nnz, counts


def _library_grad(torch, ids, vals, offsets, table, g):
    """``() -> dtable``: the autograd backward of ``F.embedding_bag`` on
    in-range (clamped) ids, one PyTorch call's yardstick for the
    backward kernels (it sends out-of-range ids' gradient to the
    clamped row, so it is timed, not compared)."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    t = table.detach().clone().requires_grad_()
    with torch.enable_grad():
        out = Fn.embedding_bag(clamp_ids(ids, table.shape[0]).int(), t,
                               offsets, mode="sum", per_sample_weights=vals)
    return lambda: torch.autograd.grad(out, t, g, retain_graph=True)


def _gather_case(torch, timer: Timer, power: str, label: str, fids, fvals,
                 fsegs, tab, fm: bool, nnz: int, rows_read: int,
                 foffsets=None) -> dict:
    """One ragged-gather forward at the flat training batch's shapes
    (every entry live, padding on the scratch row) against its plain
    version, timed; with ``foffsets`` (sorted segments) also the one
    PyTorch call that computes the embed sum."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (ragged_gather,
                                             ragged_gather_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    Dg = tab.shape[1]
    name = "ragged_gather_fm" if fm else "ragged_gather_embed"
    run = lambda: ragged_gather(  # noqa: E731
        fids, fvals, fsegs, None, tab, ROWS_TR, fm=fm, engine="kernel")
    plain = lambda: ragged_gather_reference(  # noqa: E731
        fids, fvals, fsegs, None, tab, ROWS_TR, fm=fm)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(_close(f"{name} ({label}) D={Dg}", g, w)
              for g, w in zip(got, want) if g is not None)
    ms, plain_ms = timer.ms(run), timer.ms(plain)
    nout = 2 if fm else 1
    b_ms, b_by = bound(rows_read * Dg * 4 + 12 * fids.shape[0]
                       + nout * (ROWS_TR + 1) * Dg * 4,
                       (4 if fm else 2) * nnz * Dg)
    lib_ms = None
    if not fm and foffsets is not None:
        lib = lambda: Fn.embedding_bag(  # noqa: E731
            clamp_ids(fids[:nnz], tab.shape[0]).int(), tab, foffsets,
            mode="sum", per_sample_weights=fvals[:nnz])
        _close(f"embedding_bag (flat) D={Dg}", lib(), want[0][:ROWS_TR])
        lib_ms = timer.ms(lib)
    log(f"[kernels] {name} ({label}) cap={fids.shape[0]} nnz={nnz} rows="
        f"{ROWS_TR} D={Dg}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" embedding_bag {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}"
        f", bound {b_ms:.4f} ms ({b_by}), max|err| {err:.3g} [{power}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=err)


def _training_forward(torch, timer: Timer, power: str, table, fids, fvals,
                      fsegs, nnz, rows_read, foffsets) -> dict:
    """The ragged-gather forward at the flat training batch's shapes, as
    the training paths call it: fm at D=32 (FM), embed at D=1 (the
    linear terms) and at D=32 (DCNv2's x0).  Then fm and D=1 on the same
    batch with its live entries shuffled (unsorted segments), and on a
    batch whose live entries all fall in one row; that batch's values
    and table lie on a coarse dyadic grid, so every partial sum of its
    90,553-entry row is exact in float32 and any order of adds agrees
    with the plain version.  Returns ``{"<name>_train[_d32|_unsorted|
    _one_row]": numbers}``."""
    results = {}
    D = table.shape[1]
    col = lambda t: t[:, :1].contiguous()  # noqa: E731
    for fm, tab in ((True, table), (False, col(table)), (False, table)):
        name = "ragged_gather_fm" if fm else "ragged_gather_embed"
        key = f"{name}_train" + ("_d32" if not fm and tab.shape[1] == D
                                 else "")
        results[key] = _gather_case(torch, timer, power, "training", fids,
                                    fvals, fsegs, tab, fm, nnz, rows_read,
                                    foffsets)
    rng = np.random.default_rng(SEED + 7)
    perm = torch.from_numpy(np.concatenate([rng.permutation(nnz), np.arange(
        nnz, fids.shape[0])])).cuda()
    one_segs = torch.where(fsegs < ROWS_TR, 0, fsegs)
    exact_vals = torch.from_numpy(
        rng.integers(1, 5, fids.shape[0]) / 4).float().cuda() * (fvals != 0)
    exact_tab = torch.from_numpy(
        rng.integers(-4, 5, table.shape) / 64).float().cuda()
    cases = (("unsorted", fids[perm], fvals[perm], fsegs[perm], table),
             ("one_row", fids, exact_vals, one_segs, exact_tab))
    for label, ids_c, vals_c, segs_c, tab_c in cases:
        for fm, tab in ((True, tab_c), (False, col(tab_c))):
            name = "ragged_gather_fm" if fm else "ragged_gather_embed"
            results[f"{name}_train_{label}"] = _gather_case(
                torch, timer, power, label, ids_c, vals_c, segs_c, tab, fm,
                nnz, rows_read)
    del exact_tab
    return results


def _training_fm_terms(torch, timer: Timer, power: str, ids, vals, table,
                       g, rows_read: int, live: int) -> dict:
    """The fm-terms kernels at the row-major training batch's shapes
    (DeepFM and FM row-major: B 4096, K 64, D 32, F 2^20, out-of-range
    ids in row 0, padding), forward and backward, against their plain
    versions.  Returns ``fm_terms_train`` and ``fm_terms_grad``."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (fm_terms, fm_terms_grad,
                                             fm_terms_grad_reference,
                                             fm_terms_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    results = {}
    F, D = table.shape
    BK = ids.numel()
    run = lambda: fm_terms(ids, vals, table, engine="kernel")  # noqa: E731
    plain = lambda: fm_terms_reference(ids, vals, table)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(_close("fm_terms (training)", a, b) for a, b in zip(got, want))
    _bit_equal("fm_terms (training)", got, run())
    ms, plain_ms = timer.ms(run), timer.ms(plain)
    offsets = torch.arange(0, BK, K_TR, dtype=torch.int32, device="cuda")
    lib_s1 = lambda: Fn.embedding_bag(  # noqa: E731
        clamp_ids(ids, F).int().reshape(-1), table, offsets, mode="sum",
        per_sample_weights=vals.reshape(-1))
    _close("embedding_bag s1 (training)", lib_s1(), want[0])
    s1_lib_ms = timer.ms(lib_s1)
    b_ms, b_by = bound(rows_read * D * 4 + BK * 8 + 2 * ROWS_TR * D * 4,
                       4 * BK * D)
    results["fm_terms_train"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None,
                                     max_abs_err=err)
    log(f"[kernels] fm_terms (training) B={ROWS_TR} K={K_TR} D={D}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag (s1 only) "
        f"{s1_lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
        f"{err:.3g} [{power}]")

    g2 = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
        (ROWS_TR, D), dtype=np.float32)).cuda()
    lib_bwd = _library_grad(torch, ids.reshape(-1), vals.reshape(-1),
                            offsets, table, g)
    s1_lib_bwd_ms = timer.ms(lib_bwd)
    del lib_bwd
    for need_dvals in (False, True):
        run = lambda: fm_terms_grad(  # noqa: E731
            ids, vals, table, g, g2, need_dvals, engine="kernel")
        plain = lambda: fm_terms_grad_reference(  # noqa: E731
            ids, vals, table, g, g2, need_dvals)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max(_close(f"fm_terms_grad dvals={need_dvals}", a, b)
                  for a, b in zip(got, want) if a is not None)
        ms, plain_ms = timer.ms(run), timer.ms(plain)
        nbytes = (BK * 8 + 2 * ROWS_TR * D * 4 + rows_read * D * 4
                  + F * D * 4 + (BK * 4 if need_dvals else 0))
        b_ms, b_by = bound(nbytes, (4 + 2 * need_dvals) * live * D)
        if not need_dvals:              # the training paths ask no dvals
            results["fm_terms_grad"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err)
        log(f"[kernels] fm_terms_grad dvals={need_dvals} B={ROWS_TR} "
            f"K={K_TR} D={D}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"no library call computes both terms (embedding_bag backward, "
            f"s1 half only, {s1_lib_bwd_ms:.4f} ms), bound {b_ms:.4f} ms "
            f"({b_by}), max|err| {err:.3g} [{power}]")
    return results


def _zero_work_grad(torch, timer: Timer, power: str, fids, fvals, fsegs,
                    tab, g1) -> float:
    """The D = 1 ragged backward (the linear term's) at the training shape
    with ``nnz_used = 0``: after a freed NaN-filled ``[F, 1]`` block, so
    the caching allocator may hand it back, the gradient must be exact
    zeros (the kernel zeroes it, whatever the memory held).  Returns the
    call's time, the floor under the kernel's time at this shape."""
    from dmlc_core_tpu_torch.kernels import ragged_gather_grad
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    run = lambda: ragged_gather_grad(  # noqa: E731
        fids, fvals, fsegs, zero, tab, g1, None, ROWS_TR, need_dvals=False,
        engine="kernel")[1]
    poison = torch.full(tab.shape, float("nan"), device="cuda")
    torch.cuda.synchronize()
    ptr = poison.data_ptr()
    del poison
    got = run()
    torch.cuda.synchronize()
    if not bool((got == 0).all()):
        raise RuntimeError("ragged_gather_grad D=1 nnz_used=0: not all zeros "
                           "after a NaN-filled allocation")
    floor_ms = timer.ms(run)
    log(f"[kernels] ragged_gather_grad_embed cap={fids.shape[0]} D=1 "
        f"nnz_used=0: "
        f"{floor_ms:.4f} ms, exact zeros in "
        f"{'the freed NaN block' if got.data_ptr() == ptr else 'a new block'}"
        f" [{power}]")
    return floor_ms


def _training_kernels(torch, timer: Timer, power: str, rng) -> dict:
    """The embed-bag kernels (forward and backward) and the ragged-gather
    kernels (forward and backward) at the training paths' shapes,
    against their plain versions, with out-of-range ids and padding in
    the inputs."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (embed_bag_forward,
                                             embed_bag_grad,
                                             embed_bag_grad_reference,
                                             embed_bag_reference,
                                             ragged_gather_grad,
                                             ragged_gather_grad_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    results = {}
    F, D = F_FEATURES, DIM
    table = torch.from_numpy(rng.standard_normal(
        (F, D), dtype=np.float32) * 0.05).cuda()
    ids, vals = _rowmajor_train_batch(torch, rng)
    g = torch.from_numpy(rng.standard_normal(
        (ROWS_TR, D), dtype=np.float32)).cuda()
    BK = ROWS_TR * K_TR
    live = int((vals != 0).sum())
    rows_read = int(torch.unique(clamp_ids(ids, F)).numel())
    offsets = torch.arange(0, BK, K_TR, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        # the same call with next to no work (B 1, K 1): what a launch of
        # this kernel costs on the Timer
        one = (ids[:1, :1].contiguous(), vals[:1, :1].contiguous())
        _close("embed_bag B=1 K=1", embed_bag_forward(*one, table,
                                                      engine="kernel"),
               embed_bag_reference(*one, table))
        bag_floor_ms = timer.ms(lambda: embed_bag_forward(*one, table,
                                                          engine="kernel"))
        for square in (False, True):
            run = lambda: embed_bag_forward(  # noqa: E731
                ids, vals, table, square, engine="kernel")
            plain = lambda: embed_bag_reference(  # noqa: E731
                ids, vals, table, square)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = _close(f"embed_bag square={square}", got, want)
            _bit_equal(f"embed_bag square={square}", [got], [run()])
            # B 128 takes the launcher's k split
            few = (ids[:B_RM].contiguous(), vals[:B_RM].contiguous())
            got_few = embed_bag_forward(*few, table, square, engine="kernel")
            _close(f"embed_bag square={square} B={B_RM}", got_few,
                   embed_bag_reference(*few, table, square))
            _bit_equal(f"embed_bag square={square} B={B_RM}", [got_few],
                       [embed_bag_forward(*few, table, square,
                                          engine="kernel")])
            ms, plain_ms = timer.ms(run), timer.ms(plain)
            b_ms, b_by = bound(rows_read * D * 4 + BK * 8 + ROWS_TR * D * 4,
                               (3 if square else 2) * BK * D)
            lib_ms = None
            if not square:
                lib = lambda: Fn.embedding_bag(  # noqa: E731
                    clamp_ids(ids, F).int().reshape(-1), table, offsets,
                    mode="sum", per_sample_weights=vals.reshape(-1))
                _close("embedding_bag (row-major)", lib(), want)
                lib_ms = timer.ms(lib)
                # the training path runs square=False
                results["embed_bag"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, max_abs_err=err, floor_ms=bag_floor_ms)
            log(f"[kernels] embed_bag square={square} B={ROWS_TR} K={K_TR} "
                f"D={D}: kernel {ms:.4f} ms (B=1 K=1: {bag_floor_ms:.4f} "
                f"ms, above it {ms - bag_floor_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, embedding_bag "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g}; bit-equal "
                f"across two calls at B={ROWS_TR} and B={B_RM} [{power}]")

        lib_bwd = _library_grad(torch, ids.reshape(-1), vals.reshape(-1),
                                offsets, table, g)
        for square in (False, True):
            for need_dvals in (False, True):
                run = lambda: embed_bag_grad(  # noqa: E731
                    ids, vals, table, g, square, need_dvals,
                    engine="kernel")
                plain = lambda: embed_bag_grad_reference(  # noqa: E731
                    ids, vals, table, g, square, need_dvals)
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = max(_close(f"embed_bag_grad square={square} "
                                 f"dvals={need_dvals}", a, b)
                          for a, b in zip(got, want) if a is not None)
                ms, plain_ms = timer.ms(run), timer.ms(plain)
                need_x = square or need_dvals
                nbytes = (BK * 8 + ROWS_TR * D * 4 + F * D * 4
                          + (rows_read * D * 4 if need_x else 0)
                          + (BK * 4 if need_dvals else 0))
                b_ms, b_by = bound(nbytes, (2 + 2 * need_x) * live * D)
                lib_ms = None
                if not square and not need_dvals:
                    lib_ms = timer.ms(lib_bwd)
                    # the training path: square=False, no dvals
                    results["embed_bag_grad"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, max_abs_err=err)
                log(f"[kernels] embed_bag_grad square={square} dvals="
                    f"{need_dvals} B={ROWS_TR} K={K_TR} D={D}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag "
                    f"backward "
                    f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                    f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g} [{power}]")
        del lib_bwd
        results.update(_training_fm_terms(torch, timer, power, ids, vals,
                                          table, g, rows_read, live))

        fids, fvals, fsegs, nnz, counts = _flat_train_batch(torch, rng)
        rows_read = int(torch.unique(clamp_ids(fids[:nnz], F)).numel())
        foffsets = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(counts)[:-1]]).astype(np.int32)).cuda()
        results.update(_training_forward(torch, timer, power, table, fids,
                                         fvals, fsegs, nnz, rows_read,
                                         foffsets))
        for fm, Dg in ((True, D), (False, 1), (False, D)):
            tab = table if Dg == D else table[:, :1].contiguous()
            g1 = torch.from_numpy(rng.standard_normal(
                (ROWS_TR + 1, Dg), dtype=np.float32)).cuda()
            g2 = (torch.from_numpy(rng.standard_normal(
                (ROWS_TR + 1, Dg), dtype=np.float32)).cuda() if fm else None)
            name = "ragged_gather_grad_fm" if fm else "ragged_gather_grad_embed"
            floor_ms = (_zero_work_grad(torch, timer, power, fids, fvals,
                                        fsegs, tab, g1)
                        if Dg == 1 and not fm else None)
            for need_dvals in (False, True):
                run = lambda: ragged_gather_grad(  # noqa: E731
                    fids, fvals, fsegs, None, tab, g1, g2, ROWS_TR,
                    need_dvals=need_dvals, engine="kernel")
                plain = lambda: ragged_gather_grad_reference(  # noqa: E731
                    fids, fvals, fsegs, None, tab, g1, g2, ROWS_TR,
                    need_dvals=need_dvals)
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = max(_close(f"{name} D={Dg} dvals={need_dvals}", a, b)
                          for a, b in zip(got, want) if a is not None)
                ms, plain_ms = timer.ms(run), timer.ms(plain)
                need_x = fm or need_dvals
                nbytes = (12 * fids.shape[0]
                          + (1 + fm) * (ROWS_TR + 1) * Dg * 4 + F * Dg * 4
                          + (rows_read * Dg * 4 if need_x else 0)
                          + (fids.shape[0] * 4 if need_dvals else 0))
                b_ms, b_by = bound(nbytes, ((6 if fm else 1)
                                            + 2 * need_dvals) * nnz * Dg)
                lib_ms = None
                if not fm and not need_dvals:
                    lib_ms = timer.ms(_library_grad(
                        torch, fids[:nnz], fvals[:nnz], foffsets, tab,
                        g1[:ROWS_TR]))
                # the training path runs no dvals: fm at D=32, embed at
                # D=1 (the linear term; DCNv2 also runs it at D=32)
                if not need_dvals and (fm or Dg == 1):
                    results[name] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, max_abs_err=err)
                    if floor_ms is not None:
                        results[name]["floor_ms"] = floor_ms
                above = ("" if floor_ms is None else
                         f" (nnz_used=0: {floor_ms:.4f} ms, above it "
                         f"{ms - floor_ms:.4f} ms)")
                log(f"[kernels] {name} cap={fids.shape[0]} nnz={nnz} rows="
                    f"{ROWS_TR} D={Dg} dvals={need_dvals}: kernel {ms:.4f} "
                    f"ms{above}, plain {plain_ms:.4f} ms, embedding_bag "
                    f"backward "
                    f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                    f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g} [{power}]")
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


# -- phase 4b: the host feed -------------------------------------------------

def _median_ms(fn, items, reps: int) -> float:
    """Median host-clock ms of ``fn(item)`` over ``reps`` passes."""
    ts = []
    for _ in range(reps):
        for it in items:
            t = time.perf_counter()
            fn(it)
            ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def _loader_ms(torch, make, epochs: int) -> float:
    """Median ms a loader takes to hand over a batch when nothing
    consumes it (``epochs`` passes, ``before_first`` between them): what
    the feed can deliver on its own."""
    waits = []
    ld = make()
    try:
        for epoch in range(epochs):
            if epoch:
                ld.before_first()
            while True:
                t = time.perf_counter()
                if ld.next_batch() is None:
                    break
                waits.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
    finally:
        ld.close()
    return float(np.median(waits))


def phase_feed(torch, power: str, train_file: str) -> None:
    """[feed]: the host feed's stages apart, over the training file cut
    into its 8 batches of text (ms per 4096-row batch, host clock,
    median over FEED_EPOCHS passes; the python parser over one): python
    parse, native parse (its OpenMP team and one thread), streampack
    parse-and-pack, python pack (flat into the fused wire; row-major) and
    native pack; then the H2D copy of each fused batch from pinned memory
    and its device decode in CUDA events; then each loader on its own.
    The card's decode of every batch of one epoch must be array_equal to
    the CPU's decode of the same buffer."""
    from dmlc_core_tpu_torch import native
    from dmlc_core_tpu_torch.data import RowBlock, create_parser, parse_libsvm
    from dmlc_core_tpu_torch.data.parser import _default_nthreads
    from dmlc_core_tpu_torch.pipeline import (DeviceLoader, fused_words,
                                              make_decoder, pack_flat,
                                              pack_rowmajor)
    from dmlc_core_tpu_torch.pipeline.loader import (_decode_on_host,
                                                     _host_fused)
    t0 = time.monotonic()
    if not native.available():
        raise RuntimeError("the native library is unavailable")
    nt = _default_nthreads()
    log(f"[feed] native library ready in {time.monotonic() - t0:.2f} s; "
        f"parse threads {nt} (OpenMP default {native.num_threads()}), "
        f"torch intra-op threads {torch.get_num_threads()}, cores "
        f"{os.cpu_count()}")
    with open(train_file, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    texts = [b"".join(lines[i:i + ROWS_TR])
             for i in range(0, len(lines), ROWS_TR)]
    blocks = []
    for t in texts:
        d = native.parse_libsvm(t, nt)
        blocks.append(RowBlock(d["offsets"], d["labels"], d["indices"],
                               d["values"], d["weights"]))

    def streampack(text):
        sp = native.SpPacker(ROWS_TR, CAP_TR)
        list(sp.feed_text(text))
        sp.flush()
        sp.close()

    def native_pack(blk):
        pk = native.Packer(ROWS_TR, CAP_TR)
        list(pk.feed(blk))
        pk.flush()
        pk.close()

    def python_flat(blk):
        _host_fused(pack_flat(blk, ROWS_TR, CAP_TR, want_segments=False),
                    ROWS_TR, CAP_TR)

    st = {"python parse": _median_ms(parse_libsvm, texts, 1),
          f"native parse ({nt} threads)": _median_ms(
              lambda t: native.parse_libsvm(t, nt), texts, FEED_EPOCHS),
          "native parse (1 thread)": _median_ms(
              lambda t: native.parse_libsvm(t, 1), texts, FEED_EPOCHS),
          "streampack parse+pack": _median_ms(streampack, texts,
                                              FEED_EPOCHS),
          "python pack flat (fused wire)": _median_ms(python_flat, blocks,
                                                      FEED_EPOCHS),
          "python pack row-major": _median_ms(
              lambda b: pack_rowmajor(b, ROWS_TR, K_TR), blocks,
              FEED_EPOCHS),
          "native pack": _median_ms(native_pack, blocks, FEED_EPOCHS)}
    log("[feed] host stages, ms per 4096-row batch (median): " + ", ".join(
        f"{k} {v:.4f}" for k, v in st.items()) + f" [{power}]")

    # the fused buffers of one epoch, as the native loader emits them;
    # the card's decode of each against the CPU's
    ld = DeviceLoader(create_parser(train_file, engine="native"), ROWS_TR,
                      CAP_TR, device="cuda", engine="native", emit="host")
    items = []
    try:
        for _, buf, meta, _ in ld:
            items.append((buf.copy(), int(meta)))
            ld.recycle(buf)
    finally:
        ld.close()
    h2d, dec, nbytes = [], [], []
    for buf, meta in items:
        words = fused_words(ROWS_TR, meta)
        host = torch.empty(words, dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = buf[:words]
        dev = torch.empty(words, dtype=torch.int32, device="cuda")
        decode = make_decoder(ROWS_TR, meta)
        for _ in range(FEED_EPOCHS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda._sleep(1_000_000)
            ev[0].record()
            dev.copy_(host, non_blocking=True)
            ev[1].record()
            got = decode(dev)
            ev[2].record()
            torch.cuda.synchronize()
            h2d.append(ev[0].elapsed_time(ev[1]))
            dec.append(ev[1].elapsed_time(ev[2]))
        nbytes.append(words * 4)
        want = _decode_on_host(buf, ROWS_TR, meta)
        for k, w in want.items():
            if not torch.equal(got[k].cpu(), w):
                raise RuntimeError(f"[feed] the card's decode of {k} differs "
                                   f"from the CPU's")
    log(f"[feed] {len(items)} fused batches (nnz buckets "
        f"{sorted({m for _, m in items})}): H2D from pinned memory "
        f"{np.median(h2d):.4f} ms ({np.median(nbytes) / 1e6:.3f} MB, "
        f"{np.median(nbytes) / np.median(h2d) / 1e6:.2f} GB/s), device "
        f"decode {np.median(dec):.4f} ms (CUDA events, median); the card's "
        f"decode of every batch array_equal to the CPU's [{power}]")

    def loader(layout, cap, engine, **parser):
        return lambda: DeviceLoader(
            create_parser(train_file, engine="native", **parser), ROWS_TR,
            cap, layout=layout, device="cuda", engine=engine)
    alone = {"native flat": loader("flat", CAP_TR, "native"),
             "streampack flat": loader("flat", CAP_TR, "native",
                                       threaded=False, nthreads=1),
             "python flat": loader("flat", CAP_TR, "python"),
             "row-major (python pack)": loader("rowmajor", K_TR, "native")}
    log("[feed] each loader alone, ms per batch handed over (median, "
        f"{FEED_EPOCHS} epochs): " + ", ".join(
            f"{k} {_loader_ms(torch, make, FEED_EPOCHS):.4f}"
            for k, make in alone.items()) + f" [{power}]")


# -- phase 5 ----------------------------------------------------------------

TRAIN_PATHS = (            # (name, model, layout, nnz_cap or k_cap)
    ("dcn_rowmajor", "dcn", "rowmajor", K_TR),
    ("dcn_flat", "dcn", "flat", CAP_TR),
    ("fm_flat", "fm", "flat", CAP_TR),
    ("deepfm_rowmajor", "deepfm", "rowmajor", K_TR),
    ("deepfm_flat", "deepfm", "flat", CAP_TR),
    ("fm_rowmajor", "fm", "rowmajor", K_TR),
)


def _planted():
    """The planted linear model every data file's labels come from:
    HOT_IDS ids below 1,000,000 with N(0, 1) weights, from a seed of
    their own (the same for every file)."""
    rng = np.random.default_rng(SEED + 99)
    hot = rng.choice(1_000_000, size=HOT_IDS, replace=False)
    return hot, rng.standard_normal(HOT_IDS)


def _write_libsvm(path: str, rows: int, seed: int) -> None:
    """Seeded libsvm text in the shape of benchmarks/bench_suite.py's
    _gen_libsvm: 5-39 sorted distinct ids below 1,000,000 per row,
    values U[0,1).  Every row carries 2-4 of the planted model's hot ids
    among them; its label is 1 where the planted score (the sum of value
    times weight over its hot ids) lies above the file's median, so the
    classes are balanced and a model that learns ranks the eval rows."""
    rng = np.random.default_rng(seed)
    hot, w = _planted()
    lines, scores = [], np.empty(rows)
    for i in range(rows):
        n = int(rng.integers(5, 40))
        k = int(rng.integers(2, 5))
        which = rng.choice(HOT_IDS, size=k, replace=False)
        rest = rng.choice(1_000_000, size=n + k, replace=False)
        rest = rest[~np.isin(rest, hot)][:n - k]
        idx = np.concatenate([hot[which], rest])
        vals = rng.random(n)
        scores[i] = float(vals[:k] @ w[which])
        order = np.argsort(idx)
        lines.append(b" ".join(b"%d:%.4f" % (j, v) for j, v in
                               zip(idx[order].tolist(),
                                   vals[order].tolist())))
    labels = scores > np.median(scores)
    with open(path, "wb") as f:
        f.write(b"".join(b"%d %s\n" % (y, ln)
                         for y, ln in zip(labels.tolist(), lines)))


def _model(torch, kind: str, engine: str):
    from dmlc_core_tpu_torch import DCNv2, DeepFM, FactorizationMachine
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if kind == "dcn":
        return DCNv2(F_FEATURES, DIM, LAYERS, engine=engine, device="cuda",
                     generator=gen)
    if kind == "deepfm":
        return DeepFM(F_FEATURES, DIM, DEEPFM_LAYERS, engine=engine,
                      device="cuda", generator=gen)
    return FactorizationMachine(F_FEATURES, DIM, engine=engine,
                                device="cuda", generator=gen)


def _grads(model, batch) -> dict:
    model.zero_grad(set_to_none=True)
    model.loss(batch).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _step_breakdown(torch, model, opt, loader, steps: int = 4) -> dict:
    """Device time of the forward, the backward and the optimizer of a
    few more steps, in CUDA events, and the host's time to enqueue each
    while the feed's threads sit idle.  A spin kernel queued first keeps
    the device busy while the host enqueues the step, so the events time
    device work (the batch's wait is read in steady state instead)."""
    fwd, bwd, optm, busy, enq, spin_ok = [], [], [], [], [], True
    loader.before_first()
    batches = [loader.next_batch() for _ in range(steps)]
    # let the pack thread run to the end of the epoch first: a python
    # pack (row-major) holds the interpreter lock and would stretch the
    # host's enqueue past the spin
    time.sleep(1.0)
    for batch in batches:
        opt.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        t2 = time.perf_counter()
        loss = model.loss(batch)
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        t_enq = (time.perf_counter() - t2) * 1e3
        torch.cuda.synchronize()
        spin_ok &= ev[0].elapsed_time(ev[1]) > t_enq
        enq.append(t_enq)
        fwd.append(ev[1].elapsed_time(ev[2]))
        bwd.append(ev[2].elapsed_time(ev[3]))
        optm.append(ev[3].elapsed_time(ev[4]))
        busy.append(ev[1].elapsed_time(ev[4]))
    if not spin_ok:
        raise RuntimeError("the spin kernel ended before the host had "
                           "enqueued the step; raise SPIN_CYCLES")
    return {k: float(np.median(v)) for k, v in (
        ("forward_ms", fwd), ("backward_ms", bwd), ("optimizer_ms", optm),
        ("device_ms", busy), ("enqueue_idle_ms", enq))}


def _steady_state(torch, step, loader, epochs: int) -> dict:
    """``epochs`` passes over the training file (``before_first`` between
    them), one step a batch, as fast as the feed allows: steps/s on the
    host clock from the first batch request to the last loss read back,
    the consumer's wait in ``next_batch`` per step, and the host time to
    enqueue a step."""
    waits, enqueue, last = [], [], None
    loader.before_first()
    t0 = time.perf_counter()
    for epoch in range(epochs):
        if epoch:
            loader.before_first()
        while True:
            a = time.perf_counter()
            batch = loader.next_batch()
            b = time.perf_counter()
            if batch is None:
                break
            last = step(batch)
            enqueue.append((time.perf_counter() - b) * 1e3)
            waits.append((b - a) * 1e3)
    float(last)
    wall = time.perf_counter() - t0
    return {"steps": len(waits), "wall_s": wall,
            "wait_median_ms": float(np.median(waits)),
            "wait_mean_ms": float(np.mean(waits)),
            "wait_max_ms": float(np.max(waits)),
            "enqueue_median_ms": float(np.median(enqueue))}


def _eval_scores(torch, model, loader):
    """Each real eval row's score (float64) and label, in file order."""
    scores, labels = [], []
    with torch.no_grad():
        for batch in loader:
            keep = batch["weights"] > 0
            scores.append(model(batch)[keep])
            labels.append(batch["labels"][keep])
    return (torch.cat(scores).double().cpu().numpy(),
            torch.cat(labels).cpu().numpy())


def _auc(score: np.ndarray, label: np.ndarray) -> float:
    """ROC-AUC of ``score`` against ``label > 0`` by the rank sum."""
    ranks = np.empty(len(score))
    ranks[np.argsort(score, kind="stable")] = np.arange(1, len(score) + 1)
    pos = label > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / max(n_pos * n_neg, 1))


# phase 5's checks of the kernel path against the plain path; a reading
# beyond its limit fails the path (see _train_checks)
GRAD_SCALED_TOL = 1e-4     # max|err| over max|g_plain|, each parameter
LOSS_DRIFT_TOL = 0.1       # max|loss diff| over how far the losses moved
PARAM_TOL = 1e-3           # ||p_kernel - p_plain|| over ||p_plain - p_init||
# the kernel run's eval AUC of each row's change in score over the 8
# steps (trained minus initial) must reach this: it reads about 0.5
# (+-0.006, one standard deviation over 8192 rows) for a run that does
# not learn (a broken backward or optimizer), and read 0.867-0.871 on
# the six paths on an NVIDIA H100 80GB HBM3 at 700 W
LEARN_AUC_MIN = 0.75


def _train_checks(torch, g_kernel, g_plain, lk, lp, ev_kernel,
                  ev_plain, model, plain, p_init, learn_auc) -> list:
    """Every check of the kernel path, as ``(check, reading, limit, ok)``
    rows.  A check must be able to fail on a fault as small as the
    thing it compares: gradients are also held against each parameter's
    own scale, the losses against how far they moved, and the trained
    parameters against how far they moved.  The last row is the kernel
    run's learning: the eval AUC of the change in score."""
    rows = []
    # one step's gradients, elementwise (rtol = atol = 1e-5)
    worst = max(g_plain, key=lambda k: float(
        (g_kernel[k] - g_plain[k]).abs().max()))
    err = float((g_kernel[worst] - g_plain[worst]).abs().max())
    ok = all(torch.allclose(g_kernel[k], g_plain[k], rtol=RTOL, atol=ATOL)
             for k in g_plain)
    rows.append((f"gradients max|err| ({worst})", err, ATOL, ok))
    # ... and against each parameter's own scale
    ratios = {k: float((g_kernel[k] - g_plain[k]).abs().max())
              / max(float(g_plain[k].abs().max()), 1e-30) for k in g_plain}
    worst = max(ratios, key=ratios.get)
    rows.append((f"gradients max|err|/max|g| ({worst})", ratios[worst],
                 GRAD_SCALED_TOL, ratios[worst] <= GRAD_SCALED_TOL))
    # 8 losses, relative, and against the drift of the plain losses
    fin = bool(np.isfinite(lk).all())
    rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    rows.append(("losses max rel err", rel, 1e-4, fin and rel <= 1e-4))
    drift = float(np.max(np.abs(lp - lp[0])))
    share = float(np.max(np.abs(lk - lp))) / max(drift, 1e-30)
    rows.append((f"losses max|diff|/drift (drift {drift:.3g})", share,
                 LOSS_DRIFT_TOL, fin and share <= LOSS_DRIFT_TOL))
    # the trained parameters, each against how far it moved
    ratios = {}
    for k, p in plain.named_parameters():
        moved = float((p.detach() - p_init[k]).norm())
        diff = float((dict(model.named_parameters())[k].detach()
                      - p.detach()).norm())
        ratios[k] = diff / max(moved, 1e-30)
    worst = max(ratios, key=ratios.get)
    rows.append((f"parameters ||k-p||/||p-p0|| ({worst})", ratios[worst],
                 PARAM_TOL, ratios[worst] <= PARAM_TOL))
    # eval: accuracy within one row, AUC within 1e-4, every row evaluated
    acc_rows = abs(ev_kernel["accuracy"] - ev_plain["accuracy"]) * \
        ev_plain["weight"]
    rows.append(("eval accuracy |diff| in rows", acc_rows, 1.0,
                 acc_rows <= 1.0 + 1e-6
                 and ev_plain["weight"] == EVAL_ROWS
                 and ev_kernel["weight"] == EVAL_ROWS))
    auc = abs(ev_kernel["auc"] - ev_plain["auc"])
    rows.append(("eval auc |diff|", auc, 1e-4, auc <= 1e-4))
    rows.append(("learning: eval auc of the change in score, at least",
                 learn_auc, LEARN_AUC_MIN, learn_auc >= LEARN_AUC_MIN))
    return rows


class PathDeparts(RuntimeError):
    """A training path's kernel run disagrees with its plain run."""


def _train_path(torch, name, kind, layout, cap, train_file, eval_file,
                power) -> dict:
    """One training path on engine='kernel', held against the same
    seeded model on engine='torch', both fed by native loaders (the
    threaded native parser; the native packer on the flat layout).
    Returns the path's launch counts; raises, after logging every
    check's reading, if any check fails."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     evaluate_stream, make_train_step)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts

    def loader(path):
        return DeviceLoader(create_parser(path, engine="native"), ROWS_TR,
                            cap, layout=layout, device="cuda",
                            engine="native")

    model = _model(torch, kind, "kernel")
    train_ld, eval_ld = loader(train_file), loader(eval_file)
    try:
        opt = adam(model, LR)
        step = make_train_step(model, opt)

        reset_launch_counts()                      # the path starts here
        s_init, y_eval = _eval_scores(torch, model, eval_ld)
        g_kernel = _grads(model, train_ld.next_batch())
        train_ld.before_first()
        batches, losses = [], []
        t0 = time.perf_counter()
        for batch in train_ld:
            batches.append(batch)
            losses.append(step(batch))
        last = float(losses[-1])                   # the host clock stops
        wall = time.perf_counter() - t0
        eval_ld.before_first()
        ev_kernel = evaluate_stream(model, eval_ld)
        eval_ld.before_first()
        s_trained, _ = _eval_scores(torch, model, eval_ld)
        torch.cuda.synchronize()
        launches = launch_counts()                 # the path ends here
        if len(batches) != TRAIN_STEPS:
            raise RuntimeError(f"{name}: {len(batches)} batches, expected "
                               f"{TRAIN_STEPS}")
        shapes = sorted({tuple(b["ids"].shape) for b in batches})
        learn_auc = _auc(s_trained - s_init, y_eval)

        # the same seeded model on the plain path, on the same batches
        plain = _model(torch, kind, "torch")
        p_init = {k: p.detach().clone() for k, p in plain.named_parameters()}
        g_plain = _grads(plain, batches[0])
        p_step = make_train_step(plain, adam(plain, LR))
        p_losses = [p_step(b) for b in batches]
        lk = torch.stack(losses).cpu().numpy()
        lp = torch.stack(p_losses).cpu().numpy()
        eval_ld.before_first()
        ev_plain = evaluate_stream(plain, eval_ld)
        checks = _train_checks(torch, g_kernel, g_plain, lk, lp, ev_kernel,
                               ev_plain, model, plain, p_init, learn_auc)
        del plain, p_step, batches, p_init, g_kernel, g_plain
        log(f"[train] {name} checks: " + "; ".join(
            f"{c} {r:.3g} (limit {lim:g}{'' if ok else ', FAILED'})"
            for c, r, lim, ok in checks))
        failed = [c for c, _, _, ok in checks if not ok]
        if failed:
            raise PathDeparts(f"{name}: the kernel path fails {failed}")

        stages = _step_breakdown(torch, model, opt, train_ld)
        steady = _steady_state(torch, step, train_ld, STEADY_EPOCHS)
    finally:
        train_ld.close()
        eval_ld.close()
    idle = 1.0 - TRAIN_STEPS * stages["device_ms"] / (wall * 1e3)
    st_rate = steady["steps"] / steady["wall_s"]
    st_idle = 1.0 - steady["steps"] * stages["device_ms"] / (
        steady["wall_s"] * 1e3)
    log(f"[train] {name}: {TRAIN_STEPS} steps of {ROWS_TR} rows in "
        f"{wall:.4f} s: {TRAIN_STEPS / wall:.3f} steps/s, "
        f"{TRAIN_STEPS * ROWS_TR / wall:.1f} rows/s, device idle "
        f"{idle:.4f}; loss {lk[0]:.6f} -> {last:.6f} (plain {lp[-1]:.6f}); "
        f"eval accuracy {ev_kernel['accuracy']:.6f} (plain "
        f"{ev_plain['accuracy']:.6f}), auc {ev_kernel['auc']:.6f} (plain "
        f"{ev_plain['auc']:.6f}), auc of the change in score "
        f"{learn_auc:.6f}; batch ids shapes {shapes} [{power}]")
    log(f"[train] {name} steady state, {STEADY_EPOCHS} epochs "
        f"({steady['steps']} steps): {st_rate:.3f} steps/s, "
        f"{st_rate * ROWS_TR:.1f} rows/s; wait in next_batch median "
        f"{steady['wait_median_ms']:.4f} ms, mean "
        f"{steady['wait_mean_ms']:.4f} ms, max {steady['wait_max_ms']:.4f} "
        f"ms; host enqueue of a step median "
        f"{steady['enqueue_median_ms']:.4f} ms; device busy "
        f"{stages['device_ms']:.4f} ms/step; device idle share "
        f"{st_idle:.4f} [{power}]")
    log(f"[train] {name} per step (device, median of 4): forward "
        f"{stages['forward_ms']:.4f} ms, backward {stages['backward_ms']:.4f}"
        f" ms, optimizer {stages['optimizer_ms']:.4f} ms, busy "
        f"{stages['device_ms']:.4f} ms; host enqueue of the step with the "
        f"feed's threads idle {stages['enqueue_idle_ms']:.4f} ms [{power}]")
    log(f"[train] {name} kernel launches: {launches}")
    return launches


@contextlib.contextmanager
def _data_files():
    """``(directory, train file, eval file)``: seeded libsvm text for
    phases 5 and 6, removed afterwards."""
    data = os.path.join(ROOT, ".chip_smoke_data")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    try:
        train_file = os.path.join(data, "train.libsvm")
        eval_file = os.path.join(data, "eval.libsvm")
        _write_libsvm(train_file, TRAIN_STEPS * ROWS_TR, SEED + 10)
        _write_libsvm(eval_file, EVAL_ROWS, SEED + 11)
        yield data, train_file, eval_file
    finally:
        shutil.rmtree(data, ignore_errors=True)


def phase_training(torch, power: str, train_file: str, eval_file: str,
                   planted: bool = False) -> dict:
    """DCNv2 and DeepFM (row-major and flat each) and FM (flat and
    row-major) at full width: 8 Adam steps each through the port's
    parser, loader and train step on the kernels, against the plain
    path.  Returns the launch counts summed over the six paths; with
    ``planted`` (a fault planted on the kernel path), ``{path: True if
    its checks caught the fault}`` instead."""
    total: dict = {}
    caught: dict = {}
    for name, kind, layout, cap in TRAIN_PATHS:
        try:
            launches = _train_path(torch, name, kind, layout, cap,
                                   train_file, eval_file, power)
            caught[name] = False
        except PathDeparts as e:
            if not planted:
                raise
            log(f"[plant] {name}: caught: {e}")
            caught[name] = True
            continue
        finally:
            torch.cuda.empty_cache()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return caught if planted else total


# -- phase 6 ----------------------------------------------------------------

CLI_TOL = 2e-6             # printed scores ('%.6f') vs the in-process ones


def phase_cli(torch, power: str, data: str, train_file: str,
              eval_file: str) -> None:
    """The port's ``dmlc-train`` in subprocesses, as a user runs it:
    DeepFM(2^20, dim=32, layers=2) trained for one epoch (8 steps) on
    the card with a validation file and a checkpoint, then ``mode=
    predict`` on the eval file.  The scores must match what the restored
    checkpoint gives in-process on the plain path."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeepFM,
                                     DeviceLoader, create_parser,
                                     params_from_jax)
    ckpt = os.path.join(data, "cli_ckpt")
    out = os.path.join(data, "predictions.txt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    cli = [sys.executable, "-m", "dmlc_core_tpu_torch.models.cli",
           "model=deepfm", f"features={F_FEATURES}", f"dim={DIM}",
           f"layers={DEEPFM_LAYERS}"]

    def run(*args):
        t0 = time.monotonic()
        r = subprocess.run(cli + list(args), cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        secs = time.monotonic() - t0
        for ln in r.stdout.splitlines():
            log(f"[cli] {ln}")
        if r.returncode != 0:
            raise RuntimeError(f"dmlc-train {' '.join(args)} exited "
                               f"{r.returncode}: {r.stderr[-2000:]}")
        # the CLI's own split of its main(); what precedes main() is the
        # interpreter's start and the imports
        stages = [ln.split("INFO ", 1)[-1] for ln in r.stderr.splitlines()
                  if "dmlc-train stages" in ln]
        if not stages:
            raise RuntimeError("the CLI logged no stage times")
        main_s = float(stages[-1].split("main ", 1)[1].split("s", 1)[0])
        what = "predict" if "mode=predict" in args else "train"
        log(f"[cli] {what}: wall {secs:.3f} s = interpreter start and "
            f"imports {secs - main_s:.3f} s + {stages[-1]} [{power}]")
        return r.stdout, secs

    train_out, train_s = run(f"data={train_file}", f"valid={eval_file}",
                             f"ckpt_dir={ckpt}")
    want = f"trained deepfm: {TRAIN_STEPS} steps"
    if want not in train_out:
        raise RuntimeError(f"the CLI's log lacks {want!r}")
    _, pred_s = run("mode=predict", f"data={eval_file}", f"ckpt_dir={ckpt}",
                    f"output={out}")
    with open(out) as f:
        got = np.array([float(x) for x in f.read().split()])
    if got.shape != (EVAL_ROWS,):
        raise RuntimeError(f"{got.shape[0]} predictions, expected "
                           f"{EVAL_ROWS}")

    step, state = CheckpointManager(ckpt).restore()
    model = DeepFM(F_FEATURES, DIM, DEEPFM_LAYERS, engine="torch",
                   device="cuda")
    model.load_state_dict(params_from_jax(state["params"], "cuda"))
    loader = DeviceLoader(create_parser(eval_file, engine="native"), ROWS_TR,
                          CAP_TR, id_mod=F_FEATURES, device="cuda",
                          engine="native")
    with torch.no_grad():
        want_scores = torch.cat([torch.sigmoid(model(b)) for b in loader])
    loader.close()
    want_scores = want_scores[:EVAL_ROWS].double().cpu().numpy()
    err = float(np.abs(got - want_scores).max())
    count = int(np.asarray(state["opt_state"][0][0]))
    log(f"[cli] train {train_s:.1f} s, predict {pred_s:.1f} s (host clock, "
        f"process start included); checkpoint step {step}, Adam count "
        f"{count}; {got.shape[0]} predictions, max|err| against the "
        f"restored checkpoint on the plain path {err:.3g} (limit "
        f"{CLI_TOL:g}) [{power}]")
    if step != TRAIN_STEPS or count != TRAIN_STEPS:
        raise RuntimeError(f"checkpoint step {step}, Adam count {count}; "
                           f"expected {TRAIN_STEPS}")
    if not np.isfinite(got).all() or err > CLI_TOL:
        raise RuntimeError(f"CLI predictions depart from the checkpoint's "
                           f"scores: max|err| {err:.3g}")


# -- planted faults -----------------------------------------------------------

PLANTS = ("dtable", "forward")


def _plant(kind: str) -> None:
    """Break the kernel path on purpose, on the factor tables (D > 1)
    only, leaving the plain path alone: ``dtable`` zeroes the backward
    kernels' table gradient (ragged gather, embed bag, fm terms),
    ``forward`` the forward kernels' output.  Phase 5's checks must
    catch either on every path."""
    import importlib

    from dmlc_core_tpu_torch.kernels.common import use_kernel
    # the modules, not the functions the packages export under their names
    rg = importlib.import_module("dmlc_core_tpu_torch.kernels.ragged_gather")
    emb = importlib.import_module("dmlc_core_tpu_torch.ops.embed")

    if kind == "dtable":
        grad_kernel, bag_grad = rg._grad_kernel, emb.embed_bag_grad
        fm_grad = emb.fm_terms_grad

        def ragged(*a):
            dvals, dtable = grad_kernel(*a)
            if dtable is not None and dtable.shape[1] > 1:
                dtable.zero_()
            return dvals, dtable

        def bag(ids, vals, table, g, *a, engine="auto", **kw):
            dvals, dtable = bag_grad(ids, vals, table, g, *a, engine=engine,
                                     **kw)
            if (dtable is not None and table.shape[1] > 1
                    and use_kernel(engine, table.device)):
                dtable.zero_()
            return dvals, dtable
        def fm(ids, vals, table, g1, g2, *a, engine="auto", **kw):
            dvals, dtable = fm_grad(ids, vals, table, g1, g2, *a,
                                    engine=engine, **kw)
            if (dtable is not None and table.shape[1] > 1
                    and use_kernel(engine, table.device)):
                dtable.zero_()
            return dvals, dtable
        rg._grad_kernel, emb.embed_bag_grad = ragged, bag
        emb.fm_terms_grad = fm
    else:
        gather_kernel, bag_fwd = rg._ragged_gather_kernel, \
            emb.embed_bag_forward
        fm_fwd = emb.fm_terms

        def ragged(ids, vals, segments, nnz_used, table, num_rows, fm):
            out1, out2 = gather_kernel(ids, vals, segments, nnz_used, table,
                                       num_rows, fm)
            if table.shape[1] > 1:
                out1.zero_()
                if out2 is not None:
                    out2.zero_()
            return out1, out2

        def bag(ids, vals, table, square=False, engine="auto"):
            out = bag_fwd(ids, vals, table, square, engine)
            if table.shape[1] > 1 and use_kernel(engine, table.device):
                out.zero_()
            return out
        def fm(ids, vals, table, engine="auto"):
            s1, s2 = fm_fwd(ids, vals, table, engine)
            if table.shape[1] > 1 and use_kernel(engine, table.device):
                s1.zero_()
                s2.zero_()
            return s1, s2
        rg._ragged_gather_kernel, emb.embed_bag_forward = ragged, bag
        emb.fm_terms = fm


def main_planted(kind: str) -> int:
    """``--plant KIND``: the device and build phases, then phase 5 with a
    fault planted on the kernel path.  Exits 0 only if every path's
    checks caught it; the last line names what each path did."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power = phase_device(torch)
    phase_build()
    _plant(kind)
    with _data_files() as (_, train_file, eval_file):
        caught = phase_training(torch, power, train_file, eval_file,
                                planted=True)
    print(json.dumps({"plant": kind, "caught": caught}))
    return 0 if all(caught.values()) else 1


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
    serving = phase_serving(torch, timer, power)
    with _data_files() as (data, train_file, eval_file):
        phase_feed(torch, power, train_file)
        training = phase_training(torch, power, train_file, eval_file)
        phase_cli(torch, power, data, train_file, eval_file)
    src = "dmlc_core_tpu_torch/kernels/"
    # name: (source, TPU kernel, the path whose launches it reports)
    meta = {
        "ragged_gather_fm": ("ragged_gather.cu",
                             "dmlc_core_tpu/ops/ragged_csr.py:166", serving),
        "ragged_gather_embed": ("ragged_gather.cu",
                                "dmlc_core_tpu/ops/ragged_csr.py:166",
                                serving),
        "fm_terms": ("fm_terms.cu", "dmlc_core_tpu/ops/pallas_embed.py:326",
                     serving),
        "embed_bag": ("embed_bag.cu", "dmlc_core_tpu/ops/pallas_embed.py:290",
                      training),
        "embed_bag_grad": ("embed_bag.cu",
                           "dmlc_core_tpu/ops/pallas_embed.py:290", training),
        "ragged_gather_grad_fm": ("ragged_gather_grad.cu",
                                  "dmlc_core_tpu/ops/ragged_csr.py:166",
                                  training),
        "ragged_gather_grad_embed": ("ragged_gather_grad.cu",
                                     "dmlc_core_tpu/ops/ragged_csr.py:166",
                                     training),
        "fm_terms_grad": ("fm_terms.cu",
                          "dmlc_core_tpu/ops/pallas_embed.py:326", training),
    }
    missing = [k for k, (_, _, path) in meta.items() if path.get(k, 0) < 1]
    # the forward kernels run on the training paths too
    missing += [f"{k} (training)" for k in ("ragged_gather_fm",
                                            "ragged_gather_embed",
                                            "fm_terms")
                if training.get(k, 0) < 1]
    if missing:
        raise RuntimeError(f"main path never launched: {missing}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    rows = []
    for name, (cu, replaces, path) in meta.items():
        k = kern[name]
        row = {"name": name, "route": "cuda", "source": src + cu,
               "replaces": replaces, "launches": path.get(name, 0),
               **{key: k[key] for key in keys}}
        if "floor_ms" in k:
            # the same kernel with next to no work (see the log)
            row["floor_ms"] = k["floor_ms"]
        if name + "_train" in kern:
            # the serving row's numbers, then the same kernel at the
            # training batch's shapes, with the training launches
            row["training"] = {"launches": training.get(name, 0),
                               **{key: kern[name + "_train"][key]
                                  for key in keys}}
        for case in ("unsorted", "one_row"):
            # the same training batch, entries shuffled or in one row
            if f"{name}_train_{case}" in kern:
                row[f"training_{case}"] = {
                    key: kern[f"{name}_train_{case}"][key] for key in keys}
        rows.append(row)
    log(f"[done] {time.monotonic() - t_start:.1f}s")
    print(power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plant", choices=PLANTS, default=None,
                    help="plant a fault on the kernel path and show that "
                         "phase 5's checks catch it")
    args = ap.parse_args()
    try:
        rc = main() if args.plant is None else main_planted(args.plant)
    except Exception as e:  # noqa: BLE001 — any failed phase fails
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        rc = 1
    sys.exit(rc)
