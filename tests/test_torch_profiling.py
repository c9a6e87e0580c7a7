"""The port's sampling profiler and profile diffing
(``telemetry/profiling.py``), held against the JAX package's on the CPU.

* ``diff_collapsed`` gives the JAX bytes on the same seeded collapsed
  texts (stacks that grew, shrank, vanished and appeared; an empty
  baseline; junk lines), and ``incident_profile_diff`` the JAX text on
  the same recorded baseline (exact).
* ``SamplingProfiler.sample_once`` labels the frames of a known thread
  (a running profiler's) by the port's module names, root first.
* The env gates: ``DMLC_PROFILE_HZ`` (clamped as in the JAX package) and
  ``DMLC_FLIGHT_PROFILE_S`` (0 turns the incident profile off); an empty
  scrape never records a baseline; the window is clamped and never
  empty.
* ``max_stacks`` bounds the fold table; the rest folds into
  ``<overflow>``.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.telemetry import profiling as jprofiling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import profiling  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401

FRAMES = [f"mod{i}:fn{j}" for i in range(3) for j in range(3)]


def _collapsed(rng, n):
    """``n`` seeded ``stack count`` lines (some stacks repeated, which
    the parser sums), with a junk line and a blank one."""
    lines = []
    for _ in range(n):
        depth = int(rng.integers(1, 5))
        stack = ";".join(rng.choice(FRAMES, size=depth))
        lines.append(f"{stack} {int(rng.integers(1, 40))}")
    lines += ["not a collapsed line", ""]
    rng.shuffle(lines)
    return "\n".join(lines)


@pytest.mark.parametrize("seed", range(8))
def test_diff_collapsed_equals_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    base, inc = _collapsed(rng, 12), _collapsed(rng, 12)
    out = profiling.diff_collapsed(base, inc)
    assert out == jprofiling.diff_collapsed(base, inc)
    assert profiling.diff_collapsed("", inc) == \
        jprofiling.diff_collapsed("", inc)
    assert profiling.diff_collapsed(base, "") == \
        jprofiling.diff_collapsed(base, "")
    assert out.splitlines()      # both grown and displaced stacks show


def test_diff_collapsed_share_shift():
    """The JAX case: shares, not counts; a vanished stack still shows; no
    baseline annotates the incident profile."""
    out = profiling.diff_collapsed("main;a;db 50\nmain;a;cache 50\n",
                                   "main;a;db 90\nmain;a;cache 10\n")
    lines = out.splitlines()
    assert lines[0] == ("main;a;db 90 +40.0% (baseline 50.0% -> "
                        "incident 90.0%)")
    assert lines[1].startswith("main;a;cache 10 -40.0% ")
    out = profiling.diff_collapsed("gone 10\nmain 10\n", "main 20\n")
    assert any(ln.startswith("gone 0 -50.0%") for ln in out.splitlines())
    assert all(ln.endswith("(no baseline)") for ln in
               profiling.diff_collapsed("", "main 3\n").splitlines())


@pytest.mark.parametrize("seed", range(3))
def test_incident_profile_diff_equals_the_jax_one(seed):
    rng = np.random.default_rng(100 + seed)
    base, inc = _collapsed(rng, 10), _collapsed(rng, 10)
    for mod in (profiling, jprofiling):
        assert mod.baseline() is None
        assert mod.incident_profile_diff(inc) == ""
        mod.record_baseline("")              # an empty scrape never arms
        assert mod.baseline() is None
    # 100.25 s old: both headers round to the same age
    ts = time.time() - 100.25
    for mod in (profiling, jprofiling):
        mod.record_baseline(base, ts=ts)
    out = profiling.incident_profile_diff(inc)
    assert out == jprofiling.incident_profile_diff(inc)
    assert out.startswith(f"# profile diff: baseline @ {ts:.0f} (100s ago)")
    assert profiling.baseline() == (base, ts)
    assert profiling.incident_profile_diff("") == ""


def test_sample_once_labels_a_threads_frames_by_the_ports_modules():
    running = profiling.SamplingProfiler(hz=1.0).start()
    try:
        probe = profiling.SamplingProfiler()
        probe.sample_once(skip_tid=threading.get_ident())
        stacks = probe.collapsed().splitlines()
        # one sample a live thread; equal stacks fold into one line
        assert probe.samples == sum(int(ln.rsplit(" ", 1)[1])
                                    for ln in stacks) >= 1
        loops = [ln for ln in stacks
                 if "dmlc_core_tpu_torch.telemetry.profiling:_loop" in ln]
        assert loops
        for loop in loops:
            frames = loop.rsplit(" ", 1)[0].split(";")
            assert frames[0] == "threading:_bootstrap"    # root first
            assert "dmlc_core_tpu_torch.telemetry.profiling:_loop" in frames
            assert not any(f.startswith("dmlc_core_tpu.") for f in frames)
            assert all(":" in f for f in frames)
    finally:
        running.stop()
    assert running._thread is None


@pytest.mark.parametrize("hz,want", [(None, 67.0), ("250", 250.0),
                                     ("0.01", 1.0), ("5000", 1000.0)])
def test_profile_hz_gate_equals_the_jax_one(monkeypatch, hz, want):
    if hz is None:
        monkeypatch.delenv("DMLC_PROFILE_HZ", raising=False)
    else:
        monkeypatch.setenv("DMLC_PROFILE_HZ", hz)
    assert profiling.SamplingProfiler().hz == \
        jprofiling.SamplingProfiler().hz == want


def test_incident_profile_gate_and_window(monkeypatch):
    monkeypatch.setenv("DMLC_FLIGHT_PROFILE_S", "0")
    assert profiling.incident_profile() == \
        jprofiling.incident_profile() == ""
    monkeypatch.setenv("DMLC_FLIGHT_PROFILE_S", "0.05")
    assert profiling.incident_profile().strip()
    t0 = time.monotonic()
    text = profiling.profile_for(0.0)          # clamped up to 0.05 s
    assert time.monotonic() - t0 >= 0.05
    assert text.strip()                        # never empty
    assert all(ln.rsplit(" ", 1)[1].isdigit() for ln in text.splitlines())


def test_max_stacks_folds_the_rest_into_overflow():
    stop = threading.Event()

    def deep(n):
        if n:
            return deep(n - 1)
        stop.wait()

    threads = [threading.Thread(target=deep, args=(k,), daemon=True)
               for k in range(4)]
    for t in threads:
        t.start()
    try:
        prof = profiling.SamplingProfiler(max_stacks=2)
        for _ in range(3):
            prof.sample_once()
        counts = dict(ln.rsplit(" ", 1)
                      for ln in prof.collapsed().splitlines())
        assert len(counts) == 3 and "<overflow>" in counts
        assert sum(int(v) for v in counts.values()) == prof.samples
    finally:
        stop.set()
        for t in threads:
            t.join()
