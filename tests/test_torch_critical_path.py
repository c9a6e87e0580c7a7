"""The port's critical-path analytics (``telemetry/critical_path.py``),
held against the JAX package's on the CPU.

* The same seeded span records (random trees: nested and overlapping
  children, children past their parent's end, spans of other traces)
  through both packages' ``analyze`` give equal documents (``ts`` aside,
  exact) and through both ``render_text`` equal bytes.
* The complete-accounting invariant: along every path, the self times
  sum to the root's duration, and each percentage is its share.
* A span whose parent is not in the records (evicted from the ring)
  roots its own subtree, in both packages alike.
* ``incident_breakdown`` reads the process's span ring, keeps
  ``DMLC_FLIGHT_CRITICAL_TOP`` traces and is empty on an empty ring, as
  the JAX one.
* With the port's tail sampler installed (kept spans go to the ring as
  finished spans, rendered when it is read), ``analyze`` reads their
  records through ``recorder.snapshot()``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.telemetry import critical_path as jcp  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu_torch.telemetry import critical_path as cp  # noqa: E402
from dmlc_core_tpu_torch.telemetry import sampling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401


def _tree(rng, tid, t0, dur, depth, out, parent=None, name="root"):
    """One span and, below ``depth``, up to three children inside its
    window (overlapping each other; one in five runs past the parent's
    end, as a clock step would)."""
    sid = f"{tid}.{len(out)}"
    out.append({"kind": "span", "name": name, "trace_id": tid,
                "span_id": sid, "parent_id": parent, "ts_us": t0,
                "dur_us": dur, "attrs": {}, "events": []})
    if depth == 0 or dur < 4:
        return
    for k in range(int(rng.integers(0, 4))):
        c0 = t0 + int(rng.integers(0, dur // 2 + 1))
        cdur = int(rng.integers(1, max(2, t0 + dur - c0 + 1)))
        if rng.random() < 0.2:
            cdur += int(rng.integers(1, 50))
        _tree(rng, tid, c0, cdur, depth - 1, out, sid,
              f"stage{depth}.{int(rng.integers(0, 3))}")


def _records(seed, traces=12):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(traces):
        _tree(rng, f"{seed:04x}{t:012x}", 10 ** 12 + t * 10 ** 5,
              int(rng.integers(10, 20_000)), 3, out)
    out.append({"kind": "event", "name": "not.a.span", "trace_id": "x",
                "span_id": "y"})
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _no_ts(doc):
    return {k: v for k, v in doc.items() if k != "ts"}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("top", [1, 5, 50])
def test_analyze_and_text_equal_the_jax_ones(seed, top):
    recs = _records(seed)
    doc, jdoc = cp.analyze(top=top, records=recs), \
        jcp.analyze(top=top, records=recs)
    assert _no_ts(doc) == _no_ts(jdoc)
    assert doc["schema"] == jcp.ANALYZE_SCHEMA == cp.ANALYZE_SCHEMA
    assert cp.render_text(doc) == jcp.render_text(jdoc)
    assert cp.render_text(jdoc) == jcp.render_text(jdoc)


@pytest.mark.parametrize("seed", range(6))
def test_self_times_account_for_the_whole_root(seed):
    recs = _records(seed, traces=20)
    roots, jroots = cp.assemble(recs), jcp.assemble(recs)
    assert len(roots) == 20
    for tid, rs in roots.items():
        jby_id = {r.rec["span_id"]: r for r in jroots[tid]}
        for root in rs:
            path = cp.critical_path(root)
            assert all(us > 0 for _, us in path)
            assert sum(us for _, us in path) == root.end - root.start
            assert path == jcp.critical_path(jby_id[root.rec["span_id"]])
    doc = cp.analyze(top=50, records=recs)
    for tr in doc["top"]:
        assert sum(s["self_us"] for s in tr["path"]) == tr["dur_us"]
        for s in tr["path"]:
            assert s["pct"] == round(100.0 * s["self_us"]
                                     / max(1, tr["dur_us"]), 1)


def test_evicted_parent_roots_its_own_subtree():
    recs = [r for r in _records(7) if r.get("kind") == "span"]
    by_id = {r["span_id"]: r for r in recs}
    # drop every span with children of its own, as the ring's eviction of
    # the oldest would
    parents = {r["parent_id"] for r in recs if r["parent_id"]}
    kept = [r for r in recs if r["span_id"] not in parents
            or by_id[r["span_id"]]["parent_id"] is None]
    roots, jroots = cp.assemble(kept), jcp.assemble(kept)
    names = {t: sorted(n.rec["span_id"] for n in rs)
             for t, rs in roots.items()}
    assert names == {t: sorted(n.rec["span_id"] for n in rs)
                     for t, rs in jroots.items()}
    orphans = [r for r in kept if r["parent_id"]
               and r["parent_id"] not in {k["span_id"] for k in kept}]
    assert orphans
    rooted = {n.rec["span_id"] for rs in roots.values() for n in rs}
    assert {r["span_id"] for r in orphans} <= rooted
    assert _no_ts(cp.analyze(top=50, records=kept)) == \
        _no_ts(jcp.analyze(top=50, records=kept))


@pytest.mark.parametrize("top", [None, "1", "3"])
def test_incident_breakdown_reads_the_ring(monkeypatch, top):
    if top is None:
        monkeypatch.delenv("DMLC_FLIGHT_CRITICAL_TOP", raising=False)
    else:
        monkeypatch.setenv("DMLC_FLIGHT_CRITICAL_TOP", top)
    for rec in (teltrace.recorder, jtrace.recorder):
        rec.clear()
    assert cp.incident_breakdown() == jcp.incident_breakdown() == ""
    try:
        for r in _records(3):
            teltrace.recorder.record(dict(r))
            jtrace.recorder.record(dict(r))
        text = cp.incident_breakdown()
        assert text == jcp.incident_breakdown()
        assert text.startswith(f"critical path over top {top or 5} of 12 ")
    finally:
        for rec in (teltrace.recorder, jtrace.recorder):
            rec.clear()


def test_analyze_reads_sampled_spans_through_the_snapshot():
    """Kept spans sit in the ring as finished spans; ``analyze`` renders
    their records through ``recorder.snapshot()`` and walks them."""
    teltrace.recorder.clear()
    sampling.install(sampling.TailSampler(floor=1.0, keep_per_s=0.0,
                                          recorder=teltrace.recorder))
    try:
        with teltrace.span("cp.root"):
            with teltrace.span("cp.child"):
                pass
        assert any(not isinstance(r, dict)
                   for r in list(teltrace.recorder._buf))
        doc = cp.analyze(top=5)
        (tr,) = [t for t in doc["top"] if t["root"] == "cp.root"]
        assert {s["name"] for s in tr["path"]} <= {"cp.root", "cp.child"}
        assert sum(s["self_us"] for s in tr["path"]) == tr["dur_us"]
        assert _no_ts(doc) == _no_ts(jcp.analyze(
            top=5, records=teltrace.recorder.snapshot()))
    finally:
        sampling.uninstall()
        teltrace.recorder.clear()
