"""The port's disaggregated ingest (``pipeline/ingest_service.py``) on the
CPU, loopback only.

The cases of ``tests/test_ingest_service.py`` on the port: the union of
two workers over two epochs, the compact wire over the network, a worker
that dies mid-frame raising loudly, a ``batch_rows`` mismatch, and an
early close freeing the worker.  Across packages: a JAX ``serve_ingest``
worker feeds the port's ``RemoteIngestLoader`` and a port worker feeds
the JAX loader, each with the frames and batches of the same package's
own pair (one part, both wires).  The ``ingest.send`` and
``ingest.recv`` fault points, the reader's restarts, and the worker's
command line in a process of its own.

Workers run in daemon threads started by :func:`start_port_worker`
(the JAX package's by ``conftest.start_ingest_worker``).
"""

import hashlib
import os
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from conftest import free_port  # noqa: E402
from conftest import start_ingest_worker as start_jax_worker  # noqa: E402
from dmlc_core_tpu.pipeline import \
    RemoteIngestLoader as JRemoteIngestLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import (RemoteIngestLoader,  # noqa: E402
                                          ingest_worker_main, serve_ingest)
from dmlc_core_tpu_torch.utils import faults  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402

KEYS = ("ids", "vals", "segments", "row_ptr", "labels", "weights")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_port_worker(uri: str, part: int, nparts: int,
                      fmt: str = "libsvm", *, port: int = 0,
                      batch_rows: int = 64, nnz_cap: int = 1024,
                      max_epochs: int = 1, device: str = "cpu",
                      **kw) -> int:
    """One port ``serve_ingest`` in a daemon thread; returns its port
    once it listens."""
    port = port or free_port()
    ev = threading.Event()
    threading.Thread(
        target=serve_ingest, args=(uri, part, nparts, fmt),
        kwargs=dict(batch_rows=batch_rows, nnz_cap=nnz_cap, port=port,
                    host="127.0.0.1", max_epochs=max_epochs,
                    ready_event=ev, device=device, **kw),
        daemon=True, name="test-port-ingest-worker").start()
    assert ev.wait(timeout=30), "ingest worker never became ready"
    return port


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    monkeypatch.delenv("DMLC_AUTOTUNE", raising=False)
    faults.clear_faults()
    yield
    faults.clear_faults()


@pytest.fixture()
def libsvm_file(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "svc.libsvm"
    with open(path, "w") as f:
        for r in range(600):            # label = row id: the union key
            k = int(rng.integers(1, 6))
            idx = np.sort(rng.choice(5000, size=k, replace=False))
            f.write(f"{r} " + " ".join(
                f"{j}:{rng.random():.4f}" for j in idx) + "\n")
    return str(path), 600


def _loader(ports, **kw):
    kw.setdefault("batch_rows", 64)
    return RemoteIngestLoader([("127.0.0.1", p) for p in ports],
                              device="cpu", **kw)


def _collect_rows(loader):
    seen, nb = [], 0
    for b in loader:
        w = b["weights"].numpy() > 0
        seen.extend(b["labels"].numpy()[w].astype(int).tolist())
        nb += 1
    return seen, nb


def test_two_workers_union_equals_file_two_epochs(libsvm_file):
    uri, nrows = libsvm_file
    ports = [start_port_worker(f"file://{uri}", p, 2, max_epochs=2)
             for p in range(2)]
    with _loader(ports) as loader:
        seen, nb = _collect_rows(loader)
        assert sorted(seen) == list(range(nrows)), len(seen)
        assert nb >= 2
        loader.before_first()
        seen2, _ = _collect_rows(loader)
        assert sorted(seen2) == list(range(nrows))


def _batches(loader):
    return [{k: b[k].numpy().copy() for k in KEYS} for b in loader]


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_compact_wire_over_the_network(libsvm_file):
    """One worker packs the v3 compact layout, one v2: the decoded
    batches are equal, array for array, and v3 crosses in fewer bytes."""
    uri, nrows = libsvm_file

    def run(compact):
        port = start_port_worker(f"file://{uri}", 0, 1,
                                 wire_compact=compact)
        with _loader([port], emit="host") as ld:
            frames = [(np.asarray(b).copy(), m) for _, b, m, _ in ld]
        port = start_port_worker(f"file://{uri}", 0, 1,
                                 wire_compact=compact)
        with _loader([port]) as ld:
            return frames, _batches(ld)

    (f2, plain), (f3, compact) = run(False), run(True)
    assert all((m >> 32) & 0xFF == 0 for _, m in f2)
    assert all((m >> 32) & 0xFF for _, m in f3)
    assert sum(b.size for b, _ in f3) < sum(b.size for b, _ in f2)
    _same(compact, plain)


def test_worker_device_picks_the_wire(libsvm_file):
    """``device`` resolves ``wire_compact="auto"`` as the trainer's
    loader would (v3 for cuda, v2 for cpu) and touches no card."""
    uri, _ = libsvm_file
    for device, v3 in (("cuda", True), ("cpu", False)):
        port = start_port_worker(f"file://{uri}", 0, 1, device=device)
        with _loader([port], emit="host") as ld:
            metas = [m for _, _, m, _ in ld]
        assert metas and all(bool((m >> 32) & 0xFF) == v3 for m in metas)


def test_worker_death_raises_loudly(libsvm_file, monkeypatch):
    """A worker that dies mid-frame surfaces an error; the epoch is never
    silently cut short."""
    monkeypatch.setenv("DMLC_INGEST_READER_RETRIES", "0")
    port = free_port()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)

    def half_worker():
        conn, _ = srv.accept()
        conn.sendall(struct.pack("<QII", 100, 100, 0xFFFFFFFF))
        conn.sendall(b"\x00" * 40)
        conn.close()

    threading.Thread(target=half_worker, daemon=True).start()
    loader = _loader([port], connect_timeout=10.0)
    try:
        with pytest.raises(Exception, match="mid-frame"):
            for _ in loader:
                pass
    finally:
        loader.close()
        srv.close()


def test_batch_rows_mismatch_raises(libsvm_file):
    uri, _ = libsvm_file
    port = start_port_worker(f"file://{uri}", 0, 1)
    with _loader([port], batch_rows=32) as loader:
        with pytest.raises(Exception, match="batch_rows"):
            for _ in loader:
                pass


def test_early_close_frees_worker_for_next_connection(libsvm_file):
    uri, nrows = libsvm_file
    port = start_port_worker(f"file://{uri}", 0, 1, max_epochs=2)
    loader = _loader([port])
    assert loader.next_batch() is not None
    loader.close()
    with _loader([port], connect_timeout=30.0) as loader2:
        seen, _ = _collect_rows(loader2)
        assert sorted(seen) == list(range(nrows))


def test_loader_needs_a_card_unless_told_cpu(monkeypatch):
    from dmlc_core_tpu_torch.utils.logging import DMLCError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        RemoteIngestLoader([("127.0.0.1", 1)], batch_rows=64)


# -- across packages -------------------------------------------------------------

def _frame_digests(loader):
    out = []
    for _, buf, meta, rows in loader:
        from dmlc_core_tpu.pipeline.device_loader import _fused_words_meta
        words = _fused_words_meta(64, int(meta))
        out.append((int(meta), hashlib.sha1(
            np.asarray(buf)[:words].tobytes()).hexdigest()))
        loader.recycle(buf)
    return out


@pytest.mark.parametrize("compact", [False, True])
def test_jax_worker_feeds_the_port_loader(libsvm_file, compact):
    uri, _ = libsvm_file
    jport = start_jax_worker(f"file://{uri}", 0, 1, max_epochs=2,
                             wire_compact=compact)
    tport = start_port_worker(f"file://{uri}", 0, 1, max_epochs=2,
                              wire_compact=compact)
    with _loader([jport], emit="host") as a, \
            _loader([tport], emit="host") as b:
        frames = _frame_digests(a)
        assert frames == _frame_digests(b)
    assert all(bool((m >> 32) & 0xFF) == compact for m, _ in frames)
    with _loader([jport]) as a, _loader([tport]) as b:
        _same(_batches(a), _batches(b))


@pytest.mark.parametrize("compact", [False, True])
def test_port_worker_feeds_the_jax_loader(libsvm_file, compact):
    uri, _ = libsvm_file
    jport = start_jax_worker(f"file://{uri}", 0, 1, max_epochs=1,
                             wire_compact=compact)
    tport = start_port_worker(f"file://{uri}", 0, 1, max_epochs=1,
                              wire_compact=compact)

    def jax_batches(port):
        ld = JRemoteIngestLoader([("127.0.0.1", port)], batch_rows=64)
        try:
            return [{k: np.asarray(b[k]) for k in KEYS} for b in ld]
        finally:
            ld.close()
    _same(jax_batches(tport), jax_batches(jport))


# -- fault points ----------------------------------------------------------------

def test_recv_fault_restarts_the_reader_and_covers_every_row(libsvm_file,
                                                             monkeypatch):
    """An injected receive error kills one stream; the reader reconnects,
    the worker serves its partition again, and the epoch still holds
    every row (frames before the fault may repeat)."""
    uri, nrows = libsvm_file
    monkeypatch.setenv("DMLC_INGEST_READER_BACKOFF", "0.01")
    port = start_port_worker(f"file://{uri}", 0, 1, max_epochs=2)
    r0 = metrics.counter("ingest.reader.restarts").value
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "ingest.recv:error=1:times=1:after=3")
    with _loader([port]) as loader:
        seen, _ = _collect_rows(loader)
    assert metrics.counter("ingest.reader.restarts").value >= r0 + 1
    assert set(seen) == set(range(nrows))
    assert metrics.counter("faults.ingest.recv.errors").value >= 1


def test_send_fault_ends_the_connection_and_the_reader_recovers(
        libsvm_file, monkeypatch):
    uri, nrows = libsvm_file
    monkeypatch.setenv("DMLC_INGEST_READER_BACKOFF", "0.01")
    port = start_port_worker(f"file://{uri}", 0, 1, max_epochs=2)
    r0 = metrics.counter("ingest.reader.restarts").value
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "ingest.send:error=1:times=1:after=2")
    with _loader([port]) as loader:
        seen, _ = _collect_rows(loader)
    assert metrics.counter("ingest.reader.restarts").value >= r0 + 1
    assert set(seen) == set(range(nrows))


def test_reader_gives_up_after_its_retries(libsvm_file, monkeypatch):
    monkeypatch.setenv("DMLC_INGEST_READER_RETRIES", "1")
    monkeypatch.setenv("DMLC_INGEST_READER_BACKOFF", "0.01")
    uri, _ = libsvm_file
    port = start_port_worker(f"file://{uri}", 0, 1, max_epochs=3)
    monkeypatch.setenv("DMLC_FAULT_SPEC", "ingest.recv:error=1")
    with _loader([port]) as loader:
        with pytest.raises(Exception, match="ingest reader failed"):
            for _ in loader:
                pass


# -- the worker's command line -----------------------------------------------------

def test_worker_cli_usage_and_bad_keys(capsys):
    assert ingest_worker_main([]) == 2
    assert "usage" in capsys.readouterr().err
    assert ingest_worker_main(["x", "0", "1", "libsvm", "0",
                               "device=tpu"]) == 2
    assert "device must be cuda or cpu" in capsys.readouterr().err
    assert ingest_worker_main(["x", "zero", "1", "libsvm", "0"]) == 2


def test_worker_cli_in_a_process_of_its_own(libsvm_file):
    uri, nrows = libsvm_file
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.pipeline.ingest_service",
         uri, "0", "1", "libsvm", "0", "batch_rows=64", "nnz_cap=1024",
         "max_epochs=1", "device=cuda"],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            if "ingest worker: part 0/1" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
                assert "(wire v3)" in line
                break
        assert port, "the worker never listened"
        with _loader([port]) as loader:
            seen, _ = _collect_rows(loader)
        assert sorted(seen) == list(range(nrows))
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
