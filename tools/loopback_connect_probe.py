"""How often a TCP connect over loopback hangs on this machine.

    python3 tools/loopback_connect_probe.py [SECONDS] [--out DIR]

Uploads 8 MB bodies, one connection each, to two servers on 127.0.0.1 in
turns, 20 requests at a time, for SECONDS (180 by default): chip_smoke's
fake WebHDFS datanode (the body written to a file) and a server that
reads the body and drops it.  A request that takes over 5 s counts as a
stall; the script records in which step it stalled (connect, send or
response) and writes the stacks of every thread at that moment to
``DIR/loopback_stacks.txt``, or to standard error without ``--out``.  Prints,
for each server, the requests made, their mean and longest time and the
stalls.

A stall in connect means that the server saw nothing of the request, so
a client may retry it whatever the method: what
``dmlc_core_tpu_torch.io.remote_filesys._http_request`` does.
"""

import argparse
import faulthandler
import http.client
import importlib.util
import os
import shutil
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALL_S = 5.0
BODY = 8 << 20


class _Drop(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_PUT(self):
        left = int(self.headers.get("Content-Length", 0))
        while left:
            chunk = self.rfile.read(min(left, 1 << 20))
            if not chunk:
                raise OSError("request body cut short")
            left -= len(chunk)
        self.send_response(201)
        self.send_header("Content-Length", "0")
        self.end_headers()


def _fake_store(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._FakeStore(root)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=float, default=180.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.join(ROOT, ".chip_smoke_data", "loopback_probe")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.dirname(root), exist_ok=True)
    store = _fake_store(root)
    drop = ThreadingHTTPServer(("127.0.0.1", 0), _Drop)
    drop.daemon_threads = True
    threading.Thread(target=drop.serve_forever, daemon=True).start()
    targets = {"fake_webhdfs": (store.hdfs, "/data/x/f{}.bin"),
               "drop": (f"127.0.0.1:{drop.server_address[1]}", "/d{}")}
    body = os.urandom(BODY)
    stats = {k: {"n": 0, "stalls": [], "max": 0.0, "sum": 0.0}
             for k in targets}
    if args.out is None:
        stacks = sys.stderr
    else:
        os.makedirs(args.out, exist_ok=True)
        stacks = open(os.path.join(args.out, "loopback_stacks.txt"), "w")
    t_end = time.monotonic() + args.seconds
    i = 0
    try:
        while time.monotonic() < t_end:
            for name, (netloc, pattern) in targets.items():
                for _ in range(20):
                    i += 1
                    st = stats[name]
                    t0 = time.monotonic()
                    step = "connect"
                    conn = http.client.HTTPConnection(netloc,
                                                      timeout=STALL_S)
                    try:
                        conn.connect()
                        step = "send"
                        conn.request("PUT", pattern.format(i % 4), body=body)
                        step = "response"
                        conn.getresponse().read()
                    except OSError as e:
                        faulthandler.dump_traceback(file=stacks,
                                                    all_threads=True)
                        stacks.write(f"--- {name} request {i} stalled in "
                                     f"{step}: {e!r}\n")
                        stacks.flush()
                        st["stalls"].append(
                            (i, step, repr(e),
                             round(time.monotonic() - t0, 3)))
                    finally:
                        conn.close()
                    d = time.monotonic() - t0
                    st["n"] += 1
                    st["sum"] += d
                    st["max"] = max(st["max"], d)
    finally:
        store.close()
        drop.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        if stacks is not sys.stderr:
            stacks.close()
    for name, st in stats.items():
        print(f"{name}: {st['n']} requests of {BODY >> 20} MB, mean "
              f"{st['sum'] / max(1, st['n']) * 1e3:.2f} ms, longest "
              f"{st['max']:.3f} s, stalls over {STALL_S:.0f} s "
              f"{len(st['stalls'])}: {st['stalls']}", flush=True)


if __name__ == "__main__":
    main()
