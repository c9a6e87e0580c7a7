#!/usr/bin/env python3
"""Host µs of the tracing primitives on this machine: the clock reads,
``os.getpid``, the thread lookup, an empty ``span``, ``record_span``
and an idle ``trace_span`` (the median of 5 repeats of N calls each).

    python3 tools/span_cost.py [N]

Prints one JSON object.  Needs no card.
"""

from __future__ import annotations

import json
import os
import sys
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CASES = {
    "time.time": "time.time()",
    "time.monotonic": "time.monotonic()",
    "os.getpid": "os.getpid()",
    "threading.current_thread": "threading.current_thread()",
    "span": "with tr.span('x', rows=128, bucket_rows=128, "
            "bucket_nnz=8192, ragged=False): pass",
    "record_span": "tr.record_span('x', time.time(), time.monotonic(), "
                   "rows=128, bucket_rows=128, bucket_nnz=8192, "
                   "ragged=False)",
    "trace_span": "with trace_span('x'): pass",
}


def main() -> int:
    import threading
    import time

    from dmlc_core_tpu_torch.telemetry import trace as tr
    from dmlc_core_tpu_torch.utils.metrics import trace_span
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    g = {"tr": tr, "trace_span": trace_span, "time": time, "os": os,
         "threading": threading}
    out = {}
    for name, stmt in CASES.items():
        runs = sorted(timeit.repeat(stmt, globals=g, number=n, repeat=5))
        out[name] = runs[2] / n * 1e6
    tr.recorder.clear()
    print(json.dumps({"calls": n, "us": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
