"""The port's tail sampler (``telemetry/sampling.py``) held against the
JAX package's, on the CPU.

* ``_mix`` and ``hash_keep`` give the JAX bits on 10,000 seeded ids at
  every floor, debug bit or not (exact), so a JAX router and a port
  replica reach one verdict on one trace id.
* The JAX unit cases of ``tests/test_trace_sampling.py`` (hash floor,
  debug bit, token bucket, trace buffer, each verdict, sticky verdicts,
  ``was_kept``, ``flush``, ``maybe_install_from_env``, kept-only
  exemplars), run on each package: every case holds on both.
* The same seeded span sequences fed to both packages' ``TailSampler``
  through the hook surface, on one pinned clock, with a fixed
  ``keep_slow_ms``, floor and keep rate, give the same verdicts, the
  same kept records and the same counters (exact).
* Real spans, opened and ended through each package's trace API under
  seeded trace ids, get the same verdicts and the same kept sets: the
  port hands the sampler the finished span, the JAX package its record.

The ``history`` fixture (from ``tests/test_torch_exposition.py``) stops
both history samplers and puts back both packages' installed samplers,
flight recorders, exception hooks and signal handlers.
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.telemetry import exposition as jexposition  # noqa: E402
from dmlc_core_tpu.telemetry import sampling as jsampling  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu_torch.telemetry import exposition  # noqa: E402
from dmlc_core_tpu_torch.telemetry import sampling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

PACKAGES = {
    "port": SimpleNamespace(s=sampling, tr=teltrace, m=tmetrics.metrics,
                            exposition=exposition),
    "jax": SimpleNamespace(s=jsampling, tr=jtrace, m=jmetrics.metrics,
                           exposition=jexposition),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    p = PACKAGES[request.param]
    p.s.uninstall()
    p.tr.recorder.clear()
    yield p
    p.s.uninstall()
    p.tr.recorder.clear()


def _c(p, name):
    return p.m.counter(name).value


def _rec(p, name, tid, *, span_id="s1", parent_id=None, dur_us=1000,
         status="OK", error=None, kind="span"):
    attrs = {"status": status}
    if error is not None:
        attrs["error"] = error
    return {"kind": kind, "name": name,
            "trace_id": p.tr.format_id(tid), "span_id": span_id,
            "parent_id": parent_id, "dur_us": dur_us, "attrs": attrs,
            "events": []}


def _feed(p, sampler, tid, **kw):
    """One single-span trace through the sampler's hook surface."""
    sampler.on_start(tid)
    sampler.on_end(tid, _rec(p, kw.pop("name", "op"), tid, **kw))


def _sampler(p, **kw):
    """A sampler that is not installed, over a private recorder."""
    kw.setdefault("floor", 0.0)
    kw.setdefault("keep_per_s", 0.0)
    kw.setdefault("keep_slow_ms", 1e9)
    kw.setdefault("decide_timeout_s", 60.0)
    kw.setdefault("recorder", p.tr.SpanRecorder(capacity=4096))
    return p.s.TailSampler(**kw)


# ---------------------------------------------------------------------------
# the hash floor, bit for bit
# ---------------------------------------------------------------------------

def _seeded_ids(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    ids = [int(v) for v in rng.integers(1, 1 << 63, size=n, dtype=np.int64)]
    # a tenth with the debug bit, and the edges
    ids += [i | sampling.DEBUG_BIT for i in ids[: n // 10]]
    return ids + [1, (1 << 63) - 1, sampling.DEBUG_BIT, (1 << 64) - 1]


def test_mix_and_hash_keep_give_the_jax_bits():
    ids = _seeded_ids()
    assert [sampling._mix(i) for i in ids] == [jsampling._mix(i) for i in ids]
    for floor in (-1.0, 0.0, 1e-6, 0.01, 0.25, 0.5, 0.999, 1.0, 2.0):
        got = [sampling.hash_keep(i, floor) for i in ids]
        assert got == [jsampling.hash_keep(i, floor) for i in ids], floor
    assert sampling.DEBUG_BIT == jsampling.DEBUG_BIT
    assert [sampling.is_debug(i) for i in ids] == \
        [jsampling.is_debug(i) for i in ids]


# ---------------------------------------------------------------------------
# the JAX unit cases, on each package
# ---------------------------------------------------------------------------

def test_mix_and_hash_keep_deterministic(pkg):
    s = pkg.s
    ids = [pkg.tr.new_trace_id() for _ in range(4000)]
    assert all(s._mix(i) == s._mix(i) for i in ids[:32])
    assert all(s.hash_keep(i, 1.0) for i in ids[:32])
    assert not any(s.hash_keep(i, 0.0) for i in ids[:32])
    frac = sum(s.hash_keep(i, 0.25) for i in ids) / len(ids)
    assert 0.20 < frac < 0.30
    for i in ids[:64]:
        assert s.hash_keep(i, 0.25) == s.hash_keep(i | s.DEBUG_BIT, 0.25)


def test_debug_bit_marking(pkg):
    s, tr = pkg.s, pkg.tr
    assert all(tr.new_trace_id() < s.DEBUG_BIT for _ in range(256))
    ctx = tr.TraceContext(tr.new_trace_id(), tr.new_trace_id())
    marked = s.mark_debug(ctx)
    assert s.is_debug(marked.trace_id) and not s.is_debug(ctx.trace_id)
    assert marked.span_id == ctx.span_id
    assert (marked.trace_id & ~s.DEBUG_BIT) == ctx.trace_id
    assert s.is_debug(s.debug_trace_id())


def test_token_bucket_force_and_debt(pkg):
    b = pkg.s._TokenBucket(2.0)
    t = b._t
    assert b.take(now=t) and b.take(now=t)
    assert not b.take(now=t)
    assert b.take(force=True, now=t)
    assert b.take(now=t + 1.0)
    assert not b.take(now=t + 1.0)
    assert pkg.s._TokenBucket(0.0).take()


def test_buffer_decides_when_local_refcount_hits_zero(pkg):
    done = []
    b = pkg.s.TraceBuffer(lambda g, timed_out: done.append((g, timed_out)),
                          max_spans=64, decide_timeout_s=60.0)
    tid = pkg.tr.new_trace_id()
    b.on_start(tid)
    b.on_start(tid)
    b.on_end(tid, _rec(pkg, "child", tid, span_id="c"))
    assert not done
    assert b.attach(tid, _rec(pkg, "ev", tid, kind="event"))
    b.on_end(tid, _rec(pkg, "root", tid, span_id="r"))
    assert len(done) == 1
    g, timed_out = done[0]
    assert not timed_out
    assert [r["name"] for r in g.records] == ["child", "ev", "root"]
    assert len(b) == 0
    assert not b.attach(tid, _rec(pkg, "late", tid, kind="event"))


def test_buffer_unknown_span_is_its_own_group(pkg):
    done = []
    b = pkg.s.TraceBuffer(lambda g, timed_out: done.append(g))
    tid = pkg.tr.new_trace_id()
    b.on_end(tid, _rec(pkg, "orphan", tid))
    assert len(done) == 1 and len(done[0].records) == 1


def test_buffer_timeout_flush_counts(pkg):
    done = []
    b = pkg.s.TraceBuffer(lambda g, timed_out: done.append((g, timed_out)),
                          decide_timeout_s=0.05)
    tid = pkg.tr.new_trace_id()
    b.on_start(tid)
    b.on_start(tid)
    b.on_end(tid, _rec(pkg, "child", tid))
    t0 = _c(pkg, "telemetry.sampling.timeouts")
    assert b.flush_expired(now=time.monotonic() + 10.0) == 1
    assert done and done[0][1] is True
    assert _c(pkg, "telemetry.sampling.timeouts") - t0 == 1


def test_buffer_overflow_evicts_oldest_whole_trace(pkg):
    done = []
    b = pkg.s.TraceBuffer(lambda g, timed_out: done.append(g),
                          max_spans=4, decide_timeout_s=60.0)
    t1, t2 = pkg.tr.new_trace_id(), pkg.tr.new_trace_id()
    o0 = _c(pkg, "telemetry.sampling.overflow")
    for _ in range(4):
        b.on_start(t1)
    for i in range(3):
        b.on_end(t1, _rec(pkg, f"a{i}", t1, span_id=f"a{i}"))
    for _ in range(3):
        b.on_start(t2)
    b.on_end(t2, _rec(pkg, "b0", t2, span_id="b0"))
    assert not done
    b.on_end(t2, _rec(pkg, "b1", t2, span_id="b1"))
    assert _c(pkg, "telemetry.sampling.overflow") - o0 == 1
    assert len(done) == 1 and done[0].trace_id == t1
    assert len(done[0].records) == 3


def test_error_trace_kept_despite_zero_floor(pkg):
    s = _sampler(pkg)
    k0 = _c(pkg, "telemetry.sampling.kept")
    e0 = _c(pkg, "telemetry.sampling.keep_error")
    tid = pkg.tr.new_trace_id()
    _feed(pkg, s, tid, status="OVERLOADED")
    assert s.verdict(tid) is True
    assert [r["trace_id"] for r in s.recorder.snapshot()] == \
        [pkg.tr.format_id(tid)]
    assert _c(pkg, "telemetry.sampling.kept") - k0 == 1
    assert _c(pkg, "telemetry.sampling.keep_error") - e0 == 1
    tid2 = pkg.tr.new_trace_id()
    _feed(pkg, s, tid2, error="ValueError: boom")
    assert s.verdict(tid2) is True


def test_healthy_trace_dropped_and_counted(pkg):
    s = _sampler(pkg)
    d0 = _c(pkg, "telemetry.sampling.dropped")
    ds0 = _c(pkg, "telemetry.sampling.dropped_spans")
    tid = pkg.tr.new_trace_id()
    _feed(pkg, s, tid)
    assert s.verdict(tid) is False
    assert len(s.recorder) == 0
    assert _c(pkg, "telemetry.sampling.dropped") - d0 == 1
    assert _c(pkg, "telemetry.sampling.dropped_spans") - ds0 == 1


def test_slow_keep_explicit_threshold(pkg):
    s = _sampler(pkg, keep_slow_ms=50.0)
    sl0 = _c(pkg, "telemetry.sampling.keep_slow")
    fast, slow = pkg.tr.new_trace_id(), pkg.tr.new_trace_id()
    _feed(pkg, s, fast, dur_us=10_000)
    _feed(pkg, s, slow, dur_us=100_000)
    assert s.verdict(fast) is False
    assert s.verdict(slow) is True
    assert _c(pkg, "telemetry.sampling.keep_slow") - sl0 == 1


def test_adaptive_slow_threshold_from_live_p95(pkg):
    s = _sampler(pkg, keep_slow_ms=0.0)
    name = "adaptive.op.port_test"
    for _ in range(60):
        _feed(pkg, s, pkg.tr.new_trace_id(), dur_us=10_000, name=name)
    s._thr_cache.clear()
    sl0 = _c(pkg, "telemetry.sampling.keep_slow")
    outlier = pkg.tr.new_trace_id()
    _feed(pkg, s, outlier, dur_us=200_000, name=name)
    assert s.verdict(outlier) is True
    assert _c(pkg, "telemetry.sampling.keep_slow") - sl0 == 1


def test_floor_keep_matches_hash_and_caches_verdict(pkg):
    s = _sampler(pkg, floor=0.5)
    f0 = _c(pkg, "telemetry.sampling.keep_floor")
    ids = [pkg.tr.new_trace_id() for _ in range(64)]
    for tid in ids:
        _feed(pkg, s, tid)
    for tid in ids:
        assert s.verdict(tid) == pkg.s.hash_keep(tid, 0.5)
    kept = sum(1 for tid in ids if s.verdict(tid))
    assert _c(pkg, "telemetry.sampling.keep_floor") - f0 == kept
    assert 0 < kept < len(ids)


def test_debug_bit_forces_keep(pkg):
    s = _sampler(pkg)
    db0 = _c(pkg, "telemetry.sampling.keep_debug")
    tid = pkg.s.debug_trace_id()
    _feed(pkg, s, tid)
    assert s.verdict(tid) is True
    assert _c(pkg, "telemetry.sampling.keep_debug") - db0 == 1


def test_slo_breach_keeps_trace(pkg):
    g = pkg.m.gauge("slo.active_breaches")
    g.set(1)
    try:
        s = _sampler(pkg)
        s0 = _c(pkg, "telemetry.sampling.keep_slo")
        tid = pkg.tr.new_trace_id()
        _feed(pkg, s, tid)
        assert s.verdict(tid) is True
        assert _c(pkg, "telemetry.sampling.keep_slo") - s0 == 1
    finally:
        g.set(0)


def test_token_bucket_caps_floor_keeps_not_error_keeps(pkg):
    s = _sampler(pkg, floor=1.0, keep_per_s=2.0)
    k0 = _c(pkg, "telemetry.sampling.kept")
    t0 = _c(pkg, "telemetry.sampling.throttled")
    for _ in range(30):
        _feed(pkg, s, pkg.tr.new_trace_id())
    kept = _c(pkg, "telemetry.sampling.kept") - k0
    assert kept <= 4
    assert _c(pkg, "telemetry.sampling.throttled") - t0 >= 26
    for _ in range(5):
        _feed(pkg, s, pkg.tr.new_trace_id(), status="FAILED")
    assert _c(pkg, "telemetry.sampling.kept") - k0 == kept + 5


def test_sticky_verdicts_route_late_spans(pkg):
    s = _sampler(pkg)
    kept_tid, drop_tid = pkg.tr.new_trace_id(), pkg.tr.new_trace_id()
    _feed(pkg, s, kept_tid, status="FAILED")
    _feed(pkg, s, drop_tid)
    n = len(s.recorder)
    k0 = _c(pkg, "telemetry.sampling.kept")
    ds0 = _c(pkg, "telemetry.sampling.dropped_spans")
    s.on_start(kept_tid)
    s.on_end(kept_tid, _rec(pkg, "late", kept_tid, span_id="late"))
    assert len(s.recorder) == n + 1
    assert _c(pkg, "telemetry.sampling.kept") == k0
    s.on_start(drop_tid)
    s.on_end(drop_tid, _rec(pkg, "late2", drop_tid, span_id="late2"))
    assert len(s.recorder) == n + 1
    assert _c(pkg, "telemetry.sampling.dropped_spans") - ds0 == 1
    s.on_event(drop_tid, _rec(pkg, "ev", drop_tid, kind="event"))
    assert len(s.recorder) == n + 1
    s.on_event(None, _rec(pkg, "untraced", 1, kind="event"))
    assert len(s.recorder) == n + 2


def test_was_kept_lookup_and_module_level(pkg):
    assert pkg.s.was_kept("deadbeefdeadbeef") is None
    s = pkg.s.install(_sampler(pkg))
    tid = pkg.tr.new_trace_id()
    hexid = pkg.tr.format_id(tid)
    assert pkg.s.was_kept(hexid) is None
    _feed(pkg, s, tid, status="FAILED")
    assert pkg.s.was_kept(hexid) is True
    assert s.was_kept("not-hex") is None
    assert s.was_kept(None) is None


def test_flush_decides_pending_groups(pkg):
    s = _sampler(pkg)
    tid = pkg.tr.new_trace_id()
    s.on_start(tid)
    s.on_start(tid)
    s.on_end(tid, _rec(pkg, "child", tid, status="FAILED"))
    assert s.verdict(tid) is None
    s.flush()
    assert s.verdict(tid) is True


def test_maybe_install_from_env_gates_on_knob(pkg, monkeypatch):
    monkeypatch.delenv("DMLC_TRACE_SAMPLE", raising=False)
    assert pkg.s.maybe_install_from_env() is None
    assert pkg.s.get_sampler() is None
    monkeypatch.setenv("DMLC_TRACE_SAMPLE", "0.25")
    s = pkg.s.maybe_install_from_env()
    assert s is not None and s.floor == 0.25
    assert pkg.s.get_sampler() is s
    assert pkg.s.maybe_install_from_env() is s
    monkeypatch.setenv("DMLC_TRACE_SAMPLE", "not-a-rate")
    pkg.s.uninstall()
    with pytest.raises(ValueError):
        pkg.s.maybe_install_from_env()


def test_openmetrics_renders_only_kept_trace_exemplars(pkg):
    s = pkg.s.install(_sampler(pkg))
    h = pkg.m.histogram("test.exemplar.filter_port_ms")
    with pytest.raises(ValueError):
        with pkg.tr.span("ex-err-op") as sp_err:
            h.observe(5.0)
            raise ValueError("boom")
    kept_hex = pkg.tr.format_id(sp_err.trace_id)
    with pkg.tr.span("ex-ok-op") as sp_ok:
        h.observe(500.0)
    dropped_hex = pkg.tr.format_id(sp_ok.trace_id)
    assert s.verdict(sp_err.trace_id) is True
    assert s.verdict(sp_ok.trace_id) is False
    text = pkg.exposition.render_openmetrics(pkg.m.snapshot())
    assert text.endswith("# EOF\n")
    assert kept_hex in text
    assert dropped_hex not in text


# ---------------------------------------------------------------------------
# the same spans, both samplers: verdicts, kept records, counters
# ---------------------------------------------------------------------------

class _Clock:
    """A pinned ``time`` for a sampling module: ``monotonic`` advances
    only when told to."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    @staticmethod
    def time():
        return time.time()


def _traces(seed, n):
    """Seeded traces: each a list of ops, ``("start",)``, ``("end", rec)``
    and ``("event", rec)``, over span trees (some with several local
    roots) with statuses, errors, durations and events, and a gap
    (seconds) before the next trace."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tid = int(rng.integers(1, 1 << 63, dtype=np.int64))
        if rng.random() < 0.05:
            tid |= sampling.DEBUG_BIT
        hexid = f"{tid & ((1 << 64) - 1):016x}"
        width = int(rng.integers(1, 5))
        spans = []
        for k in range(width):
            status = rng.choice(["OK", "OK", "OK", "OK", "OVERLOADED",
                                 "DEADLINE_EXCEEDED", None])
            attrs = {"status": None if status is None else str(status)}
            if rng.random() < 0.03:
                attrs["error"] = "ValueError: boom"
            # a parent here, or one that ended elsewhere (another local
            # root: the longest root is the trace's)
            if k == 0:
                parent = None
            elif rng.random() < 0.3:
                parent = f"remote{k}"
            else:
                parent = f"s{int(rng.integers(0, k))}"
            spans.append({
                "kind": "span", "name": ["root", "child", "leaf",
                                         "leaf"][k],
                "trace_id": hexid, "span_id": f"s{k}",
                "parent_id": parent,
                "dur_us": int(rng.exponential(20_000)), "attrs": attrs,
                "events": []})
        ops = [("start",)] * width
        if rng.random() < 0.2:
            ops.append(("event", {"kind": "event", "name": "retry",
                                  "trace_id": hexid, "span_id": "s0",
                                  "attrs": {"attempt": 2}}))
        # children end first; sometimes the root never ends locally (a
        # remote-rooted trace, decided by the timeout)
        ends = spans[::-1] if rng.random() > 0.05 else spans[:0:-1]
        ops += [("end", r) for r in ends]
        out.append((tid, ops, float(rng.exponential(0.05))))
    return out


@pytest.mark.parametrize("keep_per_s", [0.0, 20.0])
@pytest.mark.parametrize("floor,keep_slow_ms", [(0.01, 50.0), (0.3, 0.0),
                                                (0.0, 1e9), (1.0, 30.0)])
def test_same_spans_give_the_jax_verdicts_and_counters(monkeypatch, floor,
                                                       keep_slow_ms,
                                                       keep_per_s):
    traces = _traces(int(floor * 1000 + keep_slow_ms + keep_per_s), 600)
    results = {}
    for name, p in PACKAGES.items():
        clock = _Clock()
        monkeypatch.setattr(p.s, "time", clock)
        # the adaptive threshold reads the live histogram, never a series
        # an earlier test's history sampler left in this process
        monkeypatch.setattr(p.s, "history",
                            SimpleNamespace(query=lambda *a, **k: []))
        p.m.reset()
        s = _sampler(p, floor=floor, keep_slow_ms=keep_slow_ms,
                     keep_per_s=keep_per_s, decide_timeout_s=2.0)
        for tid, ops, gap in traces:
            for op in ops:
                if op[0] == "start":
                    s.on_start(tid)
                elif op[0] == "end":
                    s.on_end(tid, dict(op[1]))
                else:
                    s.on_event(tid, dict(op[1]))
            clock.now += gap
        clock.now += 10.0
        s.flush()
        counters = {k: v for k, v in p.m.snapshot().items()
                    if k.startswith("telemetry.")}
        results[name] = ([s.verdict(t) for t, _, _ in traces],
                         s.recorder.snapshot(), counters)
    port, jax_ = results["port"], results["jax"]
    assert port[0] == jax_[0]
    assert port[1] == jax_[1]
    assert port[2] == jax_[2]
    # (a trace none of whose spans ended here has no records and no
    # verdict, in both)
    assert True in port[0] and (False in port[0] or floor >= 1.0)


@pytest.mark.parametrize("floor", [0.0, 0.2])
def test_real_spans_get_the_jax_verdicts(floor):
    """Span trees opened through each package's trace API under the same
    seeded trace ids (roots parented on a wire context with that id):
    the same verdicts, the same kept traces and span names, the same
    verdict counts.  The port's sampler is handed finished spans, and
    renders none it drops."""
    rng = np.random.default_rng(7)
    plan = []
    for _ in range(200):
        tid = int(rng.integers(1, 1 << 63, dtype=np.int64))
        plan.append((tid, int(rng.integers(0, 3)),
                     rng.choice(["OK", "OK", "OK", "OVERLOADED"]),
                     bool(rng.random() < 0.05)))
    results = {}
    for name, p in PACKAGES.items():
        p.m.reset()
        p.tr.recorder.clear()
        s = p.s.install(p.s.TailSampler(floor=floor, keep_per_s=0.0,
                                        keep_slow_ms=1e9,
                                        decide_timeout_s=60.0))
        for tid, children, status, raises in plan:
            root = p.tr.start_span("serving.server.request",
                                   parent=p.tr.TraceContext(tid, 0))
            with p.tr.activate(root.context):
                for k in range(children):
                    try:
                        with p.tr.span("serving.engine.forward", k=k):
                            if raises and k == children - 1:
                                raise RuntimeError("replay failed")
                    except RuntimeError:
                        pass
            root.end(status=str(status))
        p.s.uninstall()
        kept = sorted((r["trace_id"], r["name"], r["parent_id"] is None)
                      for r in p.tr.recorder.snapshot())
        results[name] = ([s.verdict(t) for t, *_ in plan], kept,
                         {k: v["value"] for k, v in p.m.snapshot().items()
                          if k.startswith("telemetry.sampling.")})
    assert results["port"] == results["jax"]
    assert any(results["port"][0]) and not all(results["port"][0])


def test_the_port_renders_no_span_it_drops(monkeypatch):
    """A dropped trace's spans are never rendered, a kept one's only when
    the ring is read."""
    rendered = []
    real = teltrace.Span.record

    def spy(self):
        rendered.append(self.name)
        return real(self)

    monkeypatch.setattr(teltrace.Span, "record", spy)
    teltrace.recorder.clear()
    s = sampling.install(sampling.TailSampler(floor=0.0, keep_per_s=0.0,
                                              keep_slow_ms=1e9))
    with teltrace.span("dropped.root"):
        with teltrace.span("dropped.child"):
            pass
    with pytest.raises(KeyError):
        with teltrace.span("kept.root"):
            raise KeyError("x")
    assert s.verdict(teltrace.recorder._buf[0].trace_id) is True
    assert rendered == []
    names = [r["name"] for r in teltrace.recorder.snapshot()]
    assert names == ["kept.root"] and rendered == ["kept.root"]
