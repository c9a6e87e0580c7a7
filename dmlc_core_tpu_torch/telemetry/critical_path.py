"""Critical-path analytics over the span ring: where did the p99 go.

Counterpart of ``dmlc_core_tpu/telemetry/critical_path.py``, copied so
that the port never imports the JAX package: the same trees, walk,
document (:data:`ANALYZE_SCHEMA`) and text, byte for byte.  It reads
finished span records only, through ``recorder.snapshot()`` (where a
tail sampler keeps a finished span and renders its record when the ring
is read), never a live span.

The recorder (``telemetry.trace``) already holds the last few thousand
span records with parent links; Perfetto can *show* one trace, but
"which stage actually bounds the slow requests" needed a human staring
at timelines.  This module answers it mechanically:

* :func:`assemble` — span records → per-trace trees (a span whose
  parent scrolled off the ring roots its own subtree, so eviction
  degrades coverage, never correctness);
* :func:`critical_path` — the classic backward walk: from the end of a
  span, repeatedly step into the latest-finishing child that ends
  before the cursor; the gaps are the span's **self time**.  The sum of
  segment self-times equals the root's duration, so the breakdown is a
  complete accounting, not a sample;
* :func:`analyze` — the ``top=N`` slowest roots, each with its path
  breakdown, plus self-time aggregated by span name across those
  requests — the "client vs wire vs batcher vs engine vs h2d" answer
  as one dict.

Every ``TelemetryServer`` serves :func:`analyze` at ``/analyze?top=N``
(``format=text`` renders :func:`render_text`); flight bundles attach
the same breakdown as ``critical_path.txt``
(``DMLC_FLIGHT_CRITICAL_TOP`` roots, default 5).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.parameter import get_env
from . import trace as _trace

__all__ = ["assemble", "critical_path", "analyze", "render_text",
           "incident_breakdown", "ANALYZE_SCHEMA"]

ANALYZE_SCHEMA = "dmlc.telemetry.critical_path/1"


class _Node:
    __slots__ = ("rec", "children")

    def __init__(self, rec: Dict[str, Any]) -> None:
        self.rec = rec
        self.children: List["_Node"] = []

    @property
    def start(self) -> int:
        return int(self.rec.get("ts_us", 0))

    @property
    def end(self) -> int:
        return self.start + int(self.rec.get("dur_us", 0))

    @property
    def name(self) -> str:
        return str(self.rec.get("name", "?"))


def assemble(records: Optional[List[Dict[str, Any]]] = None
             ) -> Dict[str, List[_Node]]:
    """Span records → ``{trace_id: [root nodes]}``.  A span whose parent
    is absent (genuinely a root, or its parent was evicted from the
    ring) becomes a root of its own subtree."""
    if records is None:
        records = _trace.recorder.snapshot()
    by_trace: Dict[str, Dict[str, _Node]] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        tid, sid = rec.get("trace_id"), rec.get("span_id")
        if not tid or not sid:
            continue
        by_trace.setdefault(str(tid), {})[str(sid)] = _Node(rec)
    roots: Dict[str, List[_Node]] = {}
    for tid, nodes in by_trace.items():
        tr_roots: List[_Node] = []
        for node in nodes.values():
            parent = nodes.get(str(node.rec.get("parent_id") or ""))
            if parent is not None and parent is not node:
                parent.children.append(node)
            else:
                tr_roots.append(node)
        roots[tid] = tr_roots
    return roots


def critical_path(root: _Node) -> List[Tuple[str, int]]:
    """``[(span_name, self_us), ...]`` along the critical path.

    Backward walk from the root's end: step into the latest-finishing
    child that ends at or before the cursor, charge the gap to the
    current span, recurse; concurrent siblings off the path are by
    definition not what bounded the request.  Malformed timestamps
    (clock steps) clamp to zero rather than emitting negative time.
    """
    segments: List[Tuple[str, int]] = []

    def walk(node: _Node, lo: int, hi: int) -> None:
        cursor = hi
        for child in sorted(node.children, key=lambda n: n.end,
                            reverse=True):
            if child.end > cursor or child.end <= lo:
                continue        # overlaps a later child / outside window
            gap = cursor - child.end
            if gap > 0:
                segments.append((node.name, gap))
            walk(child, max(lo, child.start), child.end)
            cursor = max(lo, child.start)
        if cursor > lo:
            segments.append((node.name, cursor - lo))

    walk(root, root.start, root.end)
    segments.reverse()          # chronological: first gap first
    return segments


def analyze(top: int = 5,
            records: Optional[List[Dict[str, Any]]] = None
            ) -> Dict[str, Any]:
    """The ``/analyze`` document: top-N slowest traces with per-request
    critical paths, plus self-time totals by span name across them."""
    top = max(1, min(int(top), 50))
    roots = assemble(records)
    # one "request" per trace: its longest root
    requests: List[Tuple[str, _Node]] = []
    for tid, rs in roots.items():
        if rs:
            requests.append((tid, max(rs, key=lambda n: n.end - n.start)))
    requests.sort(key=lambda t: t[1].end - t[1].start, reverse=True)
    picked = requests[:top]
    self_time: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for tid, root in picked:
        path = critical_path(root)
        dur = max(1, root.end - root.start)
        for name, us in path:
            self_time[name] = self_time.get(name, 0) + us
        out.append({
            "trace_id": tid,
            "root": root.name,
            "dur_us": root.end - root.start,
            "path": [{"name": n, "self_us": us,
                      "pct": round(100.0 * us / dur, 1)}
                     for n, us in path],
        })
    return {"schema": ANALYZE_SCHEMA, "ts": time.time(),
            "traces_seen": len(roots), "top": out,
            "self_time_us": dict(sorted(self_time.items(),
                                        key=lambda kv: -kv[1]))}


def render_text(doc: Dict[str, Any]) -> str:
    """``/analyze?format=text`` / ``critical_path.txt``: the aggregate
    self-time table first (the headline), then each slow trace's path."""
    lines: List[str] = []
    agg = doc.get("self_time_us") or {}
    total = sum(agg.values()) or 1
    lines.append(f"critical path over top {len(doc.get('top', []))} of "
                 f"{doc.get('traces_seen', 0)} trace(s)")
    lines.append("self time by span:")
    for name, us in agg.items():
        lines.append(f"  {name:<40} {us / 1e3:>10.3f} ms "
                     f"{100.0 * us / total:>5.1f}%")
    for tr in doc.get("top", []):
        lines.append(f"trace {tr['trace_id']} root={tr['root']} "
                     f"{tr['dur_us'] / 1e3:.3f} ms")
        for seg in tr["path"]:
            lines.append(f"  {seg['name']:<40} {seg['self_us'] / 1e3:>10.3f}"
                         f" ms {seg['pct']:>5.1f}%")
    return "\n".join(lines) + "\n"


def incident_breakdown() -> str:
    """The flight-recorder hook: the top-N breakdown as text, empty when
    the ring holds no complete spans (the bundle then skips the file)."""
    top = int(get_env("DMLC_FLIGHT_CRITICAL_TOP", 5))
    doc = analyze(top=top)
    if not doc["top"]:
        return ""
    return render_text(doc)
