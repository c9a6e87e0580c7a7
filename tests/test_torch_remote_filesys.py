"""The port's remote filesystems (``io/remote_filesys.py``) and the paths
they open (input splits, the loader, checkpoints, ``fscli``), held
against the JAX package on the CPU over one set of in-process fake
servers on loopback.

The fakes are the JAX package's own (``tests/test_remote_filesys.py``:
HTTP with Range, S3 with SigV4 and multipart, WebHDFS with a two-step
namenode and datanode, 429 with ``Retry-After``), loaded by path, so
both packages are held against the same servers; an Azure List Blobs
fake is added here.

* ``sign_v4`` equals the official AWS test vector and the JAX
  ``sign_v4`` on seeded inputs.
* Ranged reads: seek, tell, restart-on-seek; 404; 429 with
  ``Retry-After`` in both RFC forms; a deadline caps the wait.
* S3: small and multipart round trips, part and initiate retry on a
  dropped connection, a complete that fails surfaces, an abort leaves
  no object, a special-character key, the bucket root as a directory.
* WebHDFS: read, seek, list, streaming append, delegation token,
  rename; a connect that hangs is retried even for an APPEND's POST,
  which is never sent twice once connected.  Azure: listing; reading is refused, in both packages.
* Across packages: an object written by one reads byte-equal in the
  other; ``create_input_split`` over each URI form gives the same
  records; the loader's batches from ``s3://`` are ``array_equal`` to
  the JAX loader's; a ``CheckpointManager`` over ``s3://`` and WebHDFS
  written by either package restores in the other.
* The page cache keys a remote source by path and size (its mtime is
  None in both packages): an object rewritten at the same size is
  served stale from the page file.

Backoff is cut to milliseconds (``DMLC_IO_BACKOFF_BASE`` / ``_MAX``), so
no test sleeps for seconds.
"""

import datetime
import email.utils
import hashlib
import http.client
import importlib.util
import os
import shutil
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dmlc_core_tpu.io as jio  # noqa: E402
from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.io import remote_filesys as jrfs  # noqa: E402
from dmlc_core_tpu.pipeline import DeviceLoader as JDeviceLoader  # noqa: E402
from dmlc_core_tpu.utils import checkpoint as jckpt  # noqa: E402
from dmlc_core_tpu.utils.logging import DMLCError as JDMLCError  # noqa: E402
import dmlc_core_tpu_torch.io as pio  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.io import remote_filesys as rfs  # noqa: E402
from dmlc_core_tpu_torch.io.fscli import main as fscli_main  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from dmlc_core_tpu_torch.utils.faults import inject_faults  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402
from dmlc_core_tpu_torch.utils.retry import Deadline  # noqa: E402


def _load_jax_fakes():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_remote_filesys.py")
    spec = importlib.util.spec_from_file_location("_jax_remote_fakes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_fakes = _load_jax_fakes()
S3 = _fakes._FakeS3Handler
HDFS = _fakes._FakeWebHDFSHandler
# the JAX package's fixtures: servers on 127.0.0.1, state reset per test
http_server = _fakes.http_server
s3_server = _fakes.s3_server
hdfs_server = _fakes.hdfs_server
ratelimit_server = _fakes.ratelimit_server


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setenv("DMLC_IO_BACKOFF_BASE", "0.001")
    monkeypatch.setenv("DMLC_IO_BACKOFF_MAX", "0.01")


def _hostport(srv):
    return f"127.0.0.1:{srv.server_address[1]}"


# ---------------------------------------------------------------------------
# SigV4
# ---------------------------------------------------------------------------

def test_sign_v4_matches_the_aws_vector_and_the_jax_package():
    """AWS sigv4 test-suite vector ``get-vanilla-query-order-key-case``,
    then 40 seeded requests signed by both packages."""
    now = datetime.datetime(2015, 8, 30, 12, 36, 0,
                            tzinfo=datetime.timezone.utc)
    headers = rfs.sign_v4(
        "GET", "example.amazonaws.com", "/",
        {"Param2": "value2", "Param1": "value1"}, {},
        hashlib.sha256(b"").hexdigest(), "us-east-1", "service",
        "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", now=now,
        include_content_sha256=False)
    assert headers["Authorization"].endswith(
        "Signature=b97d918cfa904a5beff61c982a1b6f458b799221646efd99d3219ec"
        "94cdf2500")
    assert "SignedHeaders=host;x-amz-date" in headers["Authorization"]
    rng = np.random.default_rng(12)
    chars = "abcXYZ019 -_.~/+=&%é"
    for i in range(40):
        word = lambda n: "".join(rng.choice(list(chars), n))  # noqa: E731
        args = ("PUT" if i % 3 else "GET", f"h{i}.example:9000",
                "/" + word(12),
                {word(4): word(6) for _ in range(int(rng.integers(0, 4)))},
                {"x-amz-meta-" + str(i): word(5)},
                hashlib.sha256(word(30).encode()).hexdigest(),
                "eu-west-1", "s3", "AK" + word(4), "SK" + word(8))
        kw = dict(session_token="tok" if i % 2 else None,
                  now=now + datetime.timedelta(seconds=int(i) * 977),
                  include_content_sha256=bool(i % 4))
        assert rfs.sign_v4(*args, **kw) == jrfs.sign_v4(*args, **kw)


# ---------------------------------------------------------------------------
# ranged reads over HTTP
# ---------------------------------------------------------------------------

def test_ranged_stream_sequential_read(http_server):
    srv, h = http_server
    data = bytes(range(256)) * 100
    h.files["/blob"] = data
    s = rfs.RangedReadStream("http", _hostport(srv), "/blob",
                             buffer_size=1000)
    assert s.read(10) == data[:10]
    assert s.read() == data[10:]
    assert s.read(5) == b""


def test_ranged_stream_seek_tell_restart(http_server):
    srv, h = http_server
    data = np.random.default_rng(3).bytes(50000)
    h.files["/blob"] = data
    s = rfs.RangedReadStream("http", _hostport(srv), "/blob",
                             buffer_size=4096)
    s.read(100)
    n_before = len(h.requests)
    s.seek(2000)                     # inside the buffer: no new request
    assert s.read(96) == data[2000:2096]
    assert len(h.requests) == n_before
    s.seek(40000)                    # outside: one fresh ranged GET
    assert s.read(100) == data[40000:40100]
    assert len(h.requests) == n_before + 1
    assert h.requests[-1][2] == "bytes=40000-44095"
    assert s.tell() == 40100
    s.seek(-10, os.SEEK_END)
    assert s.read() == data[-10:]
    s.seek(5, os.SEEK_CUR)           # past the end: nothing to read
    assert s.read(3) == b""


def test_http_file_through_open_stream_and_404(http_server):
    srv, h = http_server
    h.files["/f.txt"] = b"hello remote world"
    url = f"http://{_hostport(srv)}/f.txt"
    with pio.open_seek_stream_for_read(url) as s:
        assert s.read() == b"hello remote world"
    info = pio.get_filesystem(pio.URI(url)).get_path_info(pio.URI(url))
    assert (info.size, info.type) == (18, "file")
    with pytest.raises(DMLCError, match="404"):
        pio.open_seek_stream_for_read(f"http://{_hostport(srv)}/no").read()
    with pytest.raises(DMLCError, match="read-only"):
        pio.open_stream(url, "w")


def test_parse_retry_after_both_rfc_forms_match_jax():
    future = datetime.datetime.now(datetime.timezone.utc) \
        + datetime.timedelta(seconds=60)
    for hdrs in ({}, {"retry-after": "7"}, {"retry-after": "-3"},
                 {"retry-after": "0.25"}, {"retry-after": "not a date"}):
        assert rfs._parse_retry_after(hdrs) == jrfs._parse_retry_after(hdrs)
    got = rfs._parse_retry_after(
        {"retry-after": email.utils.format_datetime(future)})
    assert got is not None and 50.0 <= got <= 61.0
    past = email.utils.format_datetime(
        future - datetime.timedelta(seconds=600))
    assert rfs._parse_retry_after({"retry-after": past}) == 0.0


@pytest.mark.parametrize("form", ["delta-seconds", "http-date"])
def test_http_429_retry_after_raises_the_backoff_floor(ratelimit_server,
                                                       form):
    srv, h = ratelimit_server
    h.files["/obj"] = b"rate limited payload"
    if form == "delta-seconds":
        h.limit_next, floor = ["0.3"], 0.25
    else:
        # an HTTP-date has whole seconds: 1 s ahead waits (0, 1] s
        at = datetime.datetime.now(datetime.timezone.utc) \
            + datetime.timedelta(seconds=1)
        h.limit_next, floor = [email.utils.format_datetime(at)], 0.0
    t0 = time.monotonic()
    status, _, data = rfs._http_request("http", _hostport(srv), "GET",
                                        "/obj", {})
    took = time.monotonic() - t0
    assert status == 200 and data == b"rate limited payload"
    assert h.limit_next == [] and took >= floor and took < 3.0


def test_http_429_retry_after_is_capped_by_the_deadline(ratelimit_server):
    srv, h = ratelimit_server
    h.files["/obj"] = b"x"
    h.limit_next = ["30"] * 10
    t0 = time.monotonic()
    status, _, _ = rfs._http_request("http", _hostport(srv), "GET", "/obj",
                                     {}, deadline=Deadline(0.3))
    assert status == 429
    assert time.monotonic() - t0 < 3.0


def test_ranged_read_recovers_from_429(ratelimit_server):
    srv, h = ratelimit_server
    data = np.random.default_rng(4).bytes(5000)
    h.files["/blob"] = data
    h.limit_next = ["0.01"]
    with pio.open_seek_stream_for_read(
            f"http://{_hostport(srv)}/blob") as s:
        assert s.read() == data


def test_injected_s3_request_faults_are_retried(http_server):
    from dmlc_core_tpu_torch.utils.metrics import metrics
    srv, h = http_server
    data = np.random.default_rng(5).bytes(20000)
    h.files["/blob"] = data
    before = metrics.counter("faults.s3.request.errors").value
    with inject_faults("s3.request:error=0.2:seed=7"):
        s = rfs.RangedReadStream("http", _hostport(srv), "/blob",
                                 buffer_size=1000)
        assert s.read() == data
    assert metrics.counter("faults.s3.request.errors").value > before


# ---------------------------------------------------------------------------
# S3
# ---------------------------------------------------------------------------

def test_s3_round_trip_small(s3_server):
    data = b"small object contents"
    with pio.open_stream("s3://bkt/dir/obj.bin", "w") as w:
        w.write(data)
    assert S3.objects["bkt/dir/obj.bin"] == data
    assert S3.uploads == {} and S3.next_upload == [0]    # one PUT
    with pio.open_seek_stream_for_read("s3://bkt/dir/obj.bin") as r:
        assert r.read() == data
    assert S3.auth_seen and all(a.startswith("AWS4-HMAC-SHA256")
                                for a in S3.auth_seen)


def test_s3_multipart_round_trip(s3_server):
    fs = rfs.S3FileSystem(part_size=1024)
    data = np.random.default_rng(6).bytes(10 * 1024 + 123)
    w = fs.open(pio.URI("s3://bkt/big.bin"), "w")
    for i in range(0, len(data), 700):               # odd write sizes
        w.write(data[i:i + 700])
    w.close()
    assert S3.objects["bkt/big.bin"] == data
    assert S3.uploads == {}
    assert S3.part_attempts == list(range(1, 12))    # 10 full + the tail
    s = fs.open(pio.URI("s3://bkt/big.bin"), "r")
    s.seek(5000)
    assert s.read(100) == data[5000:5100]


def test_s3_default_parts_are_at_least_5_mib(s3_server):
    assert rfs._MIN_PART_SIZE == 5 << 20
    data = np.random.default_rng(7).bytes((5 << 20) + 17)
    with pio.open_stream("s3://bkt/five.bin", "w") as w:
        w.write(data)
    assert S3.part_attempts == [1, 2]
    assert S3.objects["bkt/five.bin"] == data


def test_s3_part_retry_on_a_dropped_connection(s3_server):
    fs = rfs.S3FileSystem(part_size=1024)
    data = np.random.default_rng(8).bytes(5 * 1024 + 77)
    S3.fail_next = ["part"]
    with fs.open(pio.URI("s3://bkt/retry.bin"), "w") as w:
        w.write(data)
    assert S3.objects["bkt/retry.bin"] == data
    assert S3.uploads == {} and S3.fail_next == []
    assert S3.part_attempts[:2] == [1, 1]
    assert S3.part_attempts[2:] == sorted(set(S3.part_attempts[2:]))


def test_s3_initiate_retry_on_a_dropped_connection(s3_server):
    fs = rfs.S3FileSystem(part_size=1024)
    data = np.random.default_rng(9).bytes(3 * 1024)
    S3.fail_next = ["initiate"]
    with fs.open(pio.URI("s3://bkt/init.bin"), "w") as w:
        w.write(data)
    assert S3.objects["bkt/init.bin"] == data and S3.fail_next == []


def test_s3_failed_complete_surfaces(s3_server):
    fs = rfs.S3FileSystem(part_size=1024)
    S3.fail_next = ["complete"]
    w = fs.open(pio.URI("s3://bkt/cmpl.bin"), "w")
    w.write(np.random.default_rng(10).bytes(2048))
    with pytest.raises(DMLCError):
        w.close()
    assert "bkt/cmpl.bin" not in S3.objects


@pytest.mark.parametrize("how", ["abort", "part fault"])
def test_s3_abort_leaves_no_object(s3_server, how):
    fs = rfs.S3FileSystem(part_size=1024)
    w = fs.open(pio.URI("s3://bkt/gone.bin"), "w")
    if how == "abort":
        w.write(np.random.default_rng(11).bytes(4096))
        assert S3.uploads                          # parts are pending
    else:
        S3.fail_next = ["part"] * 5                # past every retry
        with pytest.raises(DMLCError):
            w.write(np.random.default_rng(11).bytes(8192))
    w.abort()
    assert S3.uploads == {}
    assert "bkt/gone.bin" not in S3.objects


def test_s3_special_character_key(s3_server):
    data = b"odd key bytes"
    with pio.open_stream("s3://bkt/dir/my file+x=é.txt", "w") as w:
        w.write(data)
    assert S3.objects["bkt/dir/my file+x=é.txt"] == data
    with pio.open_seek_stream_for_read("s3://bkt/dir/my file+x=é.txt") as r:
        assert r.read() == data


def test_s3_list_path_info_and_the_bucket_root(s3_server):
    S3.objects.update({"bkt/d/a.txt": b"aa", "bkt/d/b.txt": b"bbb",
                       "bkt/d/sub/c.txt": b"c", "bkt/x.txt": b"x"})
    fs = pio.get_filesystem(pio.URI("s3://bkt/d"))
    infos = sorted(fs.list_directory(pio.URI("s3://bkt/d")),
                   key=lambda i: i.path)
    assert [(i.path, i.size, i.type) for i in infos] == [
        ("s3://bkt/d/a.txt", 2, "file"), ("s3://bkt/d/b.txt", 3, "file"),
        ("s3://bkt/d/sub", 0, "dir")]
    assert fs.get_path_info(pio.URI("s3://bkt/d/a.txt")).size == 2
    assert fs.get_path_info(pio.URI("s3://bkt/d")).type == "dir"
    assert fs.get_path_info(pio.URI("s3://bkt/")).type == "dir"
    with pytest.raises(DMLCError, match="no such object"):
        fs.get_path_info(pio.URI("s3://bkt/none"))
    fs.delete(pio.URI("s3://bkt/x.txt"))
    assert "bkt/x.txt" not in S3.objects


def test_s3_endpoint_forms(monkeypatch):
    monkeypatch.setenv("DMLC_S3_ENDPOINT", "localhost:9000")
    assert rfs._S3Config().resolve("bkt") == ("http", "localhost:9000",
                                               "/bkt")
    monkeypatch.delenv("DMLC_S3_ENDPOINT")
    monkeypatch.setenv("S3_ENDPOINT", "https://minio.local:9443")
    assert rfs._S3Config().resolve("bkt") == ("https", "minio.local:9443",
                                               "/bkt")
    monkeypatch.delenv("S3_ENDPOINT")
    monkeypatch.setenv("AWS_DEFAULT_REGION", "ap-south-1")
    monkeypatch.delenv("AWS_REGION", raising=False)
    assert rfs._S3Config().resolve("bkt") == \
        jrfs._S3Config().resolve("bkt") == \
        ("https", "bkt.s3.ap-south-1.amazonaws.com", "")
    monkeypatch.setenv("DMLC_GCS_ENDPOINT", "http://127.0.0.1:1")
    assert rfs.GCSFileSystem().cfg.resolve("b")[1] == "127.0.0.1:1"


def test_gcs_goes_through_the_s3_api(s3_server, monkeypatch):
    srv, _ = s3_server
    monkeypatch.setenv("DMLC_GCS_ENDPOINT", f"http://{_hostport(srv)}")
    with pio.open_stream("gs://gbk/o.bin", "w") as w:
        w.write(b"gcs bytes")
    assert S3.objects["gbk/o.bin"] == b"gcs bytes"
    with pio.open_seek_stream_for_read("gs://gbk/o.bin") as r:
        assert r.read() == b"gcs bytes"


# ---------------------------------------------------------------------------
# WebHDFS and Azure
# ---------------------------------------------------------------------------

def test_webhdfs_read_seek_list(hdfs_server):
    srv, h = hdfs_server
    data = np.random.default_rng(12).bytes(30000)
    h.files["/user/x/part-0"] = data
    h.files["/user/x/part-1"] = b"small"
    uri = f"hdfs://{_hostport(srv)}/user/x/part-0"
    s = pio.open_seek_stream_for_read(uri)
    assert s.read(100) == data[:100]
    s.seek(20000)
    assert s.read(50) == data[20000:20050]
    fs = pio.get_filesystem(pio.URI(uri))
    infos = fs.list_directory(pio.URI(f"hdfs://{_hostport(srv)}/user/x"))
    assert sorted((i.path.rsplit("/", 1)[-1], i.size) for i in infos) == \
        [("part-0", 30000), ("part-1", 5)]
    assert fs.get_path_info(pio.URI(uri)).size == len(data)


def test_webhdfs_streaming_append_and_rename(hdfs_server, monkeypatch):
    srv, h = hdfs_server
    hp = _hostport(srv)
    monkeypatch.setenv("DMLC_WEBHDFS_PART_SIZE", "1024")
    payload = bytes(range(256)) * 10               # 2.5 parts
    with pio.open_stream(f"hdfs://{hp}/out/big.bin", "w") as w:
        for off in range(0, len(payload), 700):
            w.write(memoryview(payload)[off:off + 700])
    assert h.files["/out/big.bin"] == payload
    reqs = [r for r in h.data_requests if r[1] == "/out/big.bin"]
    assert [r[0] for r in reqs] == ["PUT", "POST", "POST"]
    fs = pio.get_filesystem(pio.URI(f"hdfs://{hp}/"))
    fs.rename(pio.URI(f"hdfs://{hp}/out/big.bin"),
              pio.URI(f"hdfs://{hp}/out/moved.bin"))
    assert "/out/big.bin" not in h.files
    assert h.files["/out/moved.bin"] == payload
    fs.delete(pio.URI(f"hdfs://{hp}/out/moved.bin"))
    assert h.files == {}


@pytest.fixture
def hanging_connects(monkeypatch):
    """``http.client`` connects counted from 1; those whose numbers are
    put in ``["fail"]`` time out before a byte is sent.  Records each
    connect's timeout and its socket's timeout once connected."""
    real = http.client.HTTPConnection.connect
    real_request = http.client.HTTPConnection.request
    seen = {"n": 0, "fail": set(), "connect": [], "after": []}

    def connect(self):
        seen["n"] += 1
        seen["connect"].append(self.timeout)
        if seen["n"] in seen["fail"]:
            raise socket.timeout("timed out")
        real(self)

    def request(self, *a, **k):
        seen["after"].append(self.sock.gettimeout())
        return real_request(self, *a, **k)

    monkeypatch.setattr(http.client.HTTPConnection, "connect", connect)
    monkeypatch.setattr(http.client.HTTPConnection, "request", request)
    return seen


def test_a_hanging_connect_is_retried_for_a_webhdfs_append(
        hdfs_server, monkeypatch, hanging_connects):
    """CREATE, then two APPENDs, each a namenode request and a datanode
    one: the connects of both datanode POSTs time out once.  Each is
    retried on a new connection, every part lands once, and the
    connect is bounded by ``DMLC_IO_CONNECT_TIMEOUT``, the request by
    its own timeout."""
    srv, h = hdfs_server
    hp = _hostport(srv)
    monkeypatch.setenv("DMLC_WEBHDFS_PART_SIZE", "1024")
    monkeypatch.setenv("DMLC_IO_CONNECT_TIMEOUT", "0.5")
    hanging_connects["fail"] = {4, 7}     # each APPEND's datanode POST
    retried = metrics.counter("retry.io.connect.retries")
    before = retried.value
    payload = bytes(range(256)) * 10               # 2.5 parts
    with pio.open_stream(f"hdfs://{hp}/out/hang.bin", "w") as w:
        w.write(payload)
    assert h.files["/out/hang.bin"] == payload
    reqs = [r for r in h.data_requests if r[1] == "/out/hang.bin"]
    assert [r[0] for r in reqs] == ["PUT", "POST", "POST"]
    assert retried.value - before == 2
    assert hanging_connects["n"] == 8
    assert set(hanging_connects["connect"]) == {0.5}
    assert set(hanging_connects["after"]) == {60.0}


def test_a_webhdfs_append_is_not_resent_once_connected(
        hdfs_server, monkeypatch):
    """A POST whose reply is lost after its connect fails the write:
    the datanode has seen it once, and a resend could apply it twice."""
    srv, h = hdfs_server
    hp = _hostport(srv)
    monkeypatch.setenv("DMLC_WEBHDFS_PART_SIZE", "1024")
    real = http.client.HTTPConnection.getresponse
    calls = {"n": 0}

    def getresponse(self):
        calls["n"] += 1
        resp = real(self)
        if calls["n"] == 4:                        # the first APPEND's data
            raise ConnectionResetError("reply lost")
        return resp

    monkeypatch.setattr(http.client.HTTPConnection, "getresponse",
                        getresponse)
    w = pio.open_stream(f"hdfs://{hp}/out/lost.bin", "w")
    with pytest.raises(DMLCError, match="reply lost"):
        w.write(bytes(range(256)) * 10)
    reqs = [r for r in h.data_requests if r[1] == "/out/lost.bin"]
    assert [r[0] for r in reqs] == ["PUT", "POST"]
    assert h.files["/out/lost.bin"] == (bytes(range(256)) * 10)[:2048]


def test_webhdfs_delegation_token_and_user(hdfs_server, monkeypatch):
    srv, h = hdfs_server
    hp = _hostport(srv)
    monkeypatch.setenv("HADOOP_USER_NAME", "alice")
    monkeypatch.setenv("DMLC_WEBHDFS_TOKEN", "HAAEdG9r")
    h.files["/secure/f.bin"] = b"secret bytes"
    assert pio.open_seek_stream_for_read(
        f"hdfs://{hp}/secure/f.bin").read() == b"secret bytes"
    with pio.open_stream(f"hdfs://{hp}/secure/out.bin", "w") as w:
        w.write(b"tokenized write")
    assert h.files["/secure/out.bin"] == b"tokenized write"
    assert h.namenode_queries
    assert all(q.get("delegation") == "HAAEdG9r" and "user.name" not in q
               for _, q in h.namenode_queries)
    monkeypatch.delenv("DMLC_WEBHDFS_TOKEN")
    h.namenode_queries.clear()
    pio.get_filesystem(pio.URI(f"hdfs://{hp}/")).get_path_info(
        pio.URI(f"hdfs://{hp}/secure/f.bin"))
    assert h.namenode_queries and all(
        q.get("user.name") == "alice" and "delegation" not in q
        for _, q in h.namenode_queries)


class _FakeAzureHandler(BaseHTTPRequestHandler):
    """List Blobs (``restype=container&comp=list``) over ``blobs``
    ({"container/name": size}), one blob a page to exercise NextMarker;
    records each query."""
    blobs = {}
    queries = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        import urllib.parse
        u = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
        type(self).queries.append(q)
        container = u.path.strip("/")
        prefix, marker = q.get("prefix", ""), q.get("marker", "")
        entries = []
        for full, size in sorted(self.blobs.items()):
            c, name = full.split("/", 1)
            if c != container or not name.startswith(prefix):
                continue
            rest = name[len(prefix):]
            if "/" in rest:
                entry = ("prefix", prefix + rest.split("/")[0] + "/", 0)
            else:
                entry = ("blob", name, size)
            if entry not in entries:
                entries.append(entry)
        start = int(marker) if marker else 0
        page = entries[start:start + 1]
        xml = ["<EnumerationResults><Blobs>"]
        for kind, name, size in page:
            if kind == "blob":
                xml.append(f"<Blob><Name>{name}</Name><Properties>"
                           f"<Content-Length>{size}</Content-Length>"
                           f"</Properties></Blob>")
            else:
                xml.append(f"<BlobPrefix><Name>{name}</Name></BlobPrefix>")
        xml.append("</Blobs>")
        nxt = start + 1 if start + 1 < len(entries) else ""
        xml.append(f"<NextMarker>{nxt}</NextMarker></EnumerationResults>")
        body = "".join(xml).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def azure_server(monkeypatch):
    _FakeAzureHandler.blobs = {}
    _FakeAzureHandler.queries = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeAzureHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    monkeypatch.setenv("AZURE_STORAGE_ENDPOINT", f"http://{_hostport(srv)}")
    monkeypatch.setenv("AZURE_STORAGE_SAS", "sv=2020&sig=abc")
    yield srv, _FakeAzureHandler
    srv.shutdown()


def test_azure_lists_as_the_jax_package_and_refuses_reads(azure_server):
    _, h = azure_server
    h.blobs.update({"cont/data/a.csv": 10, "cont/data/b.csv": 20,
                    "cont/data/sub/c.csv": 3, "cont/other.txt": 1})
    uri = "azure://acct/cont/data"
    got = pio.get_filesystem(pio.URI(uri)).list_directory(pio.URI(uri))
    want = jio.get_filesystem(jio.URI(uri)).list_directory(jio.URI(uri))
    assert [(i.path, i.size, i.type) for i in got] == \
        [(i.path, i.size, i.type) for i in want] == [
            ("azure://acct/cont/data/a.csv", 10, "file"),
            ("azure://acct/cont/data/b.csv", 20, "file"),
            ("azure://acct/cont/data/sub", 0, "dir")]
    assert all(q.get("sig") == "abc" and q.get("prefix") == "data/"
               for q in h.queries)
    with pytest.raises(DMLCError, match="listing-only"):
        pio.open_seek_stream_for_read(uri + "/a.csv")
    with pytest.raises(JDMLCError, match="listing-only"):
        jio.open_seek_stream_for_read(uri + "/a.csv")


@pytest.mark.parametrize("raw", [None, "", "  ", "12", "-3", "8x", "0x10"])
def test_lenient_knob_reads_match_jax(monkeypatch, raw):
    """``env_int`` (``DMLC_WEBHDFS_PART_SIZE``'s read) and the lenient
    bool read, copied from the JAX package: a malformed value reads as
    unset, never raises."""
    from dmlc_core_tpu.utils import parameter as jparam
    from dmlc_core_tpu_torch.utils import parameter as tparam
    key = "DMLC_TEST_LENIENT_KNOB"
    if raw is None:
        monkeypatch.delenv(key, raising=False)
    else:
        monkeypatch.setenv(key, raw)
    for kw in ({}, {"minimum": 1}):
        assert tparam.env_int(key, 7, **kw) == jparam.env_int(key, 7, **kw)
    assert tparam.parse_lenient_bool(key) == jparam.parse_lenient_bool(key)
    for b in ("true", "0", "yes", "F", "maybe"):
        monkeypatch.setenv(key, b)
        assert tparam.parse_lenient_bool(key) == \
            jparam.parse_lenient_bool(key)


def test_an_unknown_scheme_still_raises():
    with pytest.raises(DMLCError, match="unknown filesystem scheme 'ftp'"):
        pio.open_stream("ftp://host/x", "r")


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _remote_uri(kind, srv, name):
    return (f"s3://bkt/{name}" if kind == "s3"
            else f"hdfs://{_hostport(srv)}/{name}")


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_an_object_written_by_one_package_reads_in_the_other(
        s3_server, hdfs_server, monkeypatch, kind, writer):
    srv = s3_server[0] if kind == "s3" else hdfs_server[0]
    monkeypatch.setattr(rfs._s3_fs, "_part_size", 4096)
    monkeypatch.setattr(jrfs._s3_fs, "_part_size", 4096)
    monkeypatch.setenv("DMLC_WEBHDFS_PART_SIZE", "4096")
    data = np.random.default_rng(13).bytes(3 * 4096 + 55)
    uri = _remote_uri(kind, srv, "x/obj.bin")
    w, r = (pio, jio) if writer == "port" else (jio, pio)
    with w.open_stream(uri, "w") as f:
        f.write(data)
    with r.open_seek_stream_for_read(uri) as f:
        assert f.read() == data
        f.seek(4000)
        assert f.read(200) == data[4000:4200]
    if kind == "s3":
        assert S3.part_attempts == [1, 2, 3, 4]


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    return [(f"{i % 2} " + " ".join(
        f"{j}:{v:.3f}" for j, v in zip(
            np.sort(rng.choice(3000, int(rng.integers(1, 20)),
                               replace=False)),
            rng.random(20)))).encode() for i in range(n)]


@pytest.fixture
def s3_train(s3_server):
    """Three libsvm objects under ``s3://bkt/train/`` (and an empty one)
    with the same bytes under a local directory."""
    return _put_train_files(s3_server)


def _put_train_files(s3_server):
    blobs = {"p0.libsvm": _lines(300, 1), "p1.libsvm": _lines(250, 2),
             "p2.libsvm": _lines(170, 3)}
    for name, lines in blobs.items():
        S3.objects[f"bkt/train/{name}"] = b"\n".join(lines) + b"\n"
    S3.objects["bkt/train/zz.libsvm"] = b""
    return blobs


URI_FORMS = {
    "file": "s3://bkt/train/p1.libsvm",
    "prefix": "s3://bkt/train",
    "prefix/": "s3://bkt/train/",
    "; list": "s3://bkt/train/p2.libsvm;s3://bkt/train/p0.libsvm",
}


def _records(io_mod, uri, part, nparts):
    sp = io_mod.create_input_split(uri, part, nparts, "text", threaded=False)
    try:
        return [bytes(r) for r in iter(sp.next_record, None)]
    finally:
        sp.close()


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("form", sorted(URI_FORMS))
def test_create_input_split_records_match_jax(s3_train, form, nparts):
    uri = URI_FORMS[form]
    union = []
    for part in range(nparts):
        got = _records(pio, uri, part, nparts)
        assert got == _records(jio, uri, part, nparts)
        union += got
    want = {"file": s3_train["p1.libsvm"],
            "; list": s3_train["p2.libsvm"] + s3_train["p0.libsvm"]}.get(
        form, s3_train["p0.libsvm"] + s3_train["p1.libsvm"]
        + s3_train["p2.libsvm"])
    assert union == want
    sp = pio.create_input_split(uri, 0, nparts, "text", threaded=False)
    try:
        assert all(f.path.startswith("s3://") for f in sp.files)
        assert not sp._use_mmap
        chunk = sp.next_chunk()
        assert type(chunk) is bytes and chunk
    finally:
        sp.close()


def test_a_glob_over_s3_raises_in_both_packages(s3_train):
    with pytest.raises(DMLCError, match="no such object"):
        pio.create_input_split("s3://bkt/train/p*.libsvm")
    with pytest.raises(JDMLCError, match="no such object"):
        jio.create_input_split("s3://bkt/train/p*.libsvm")


@pytest.mark.parametrize("nparts", [1, 3])
def test_a_remote_file_larger_than_one_fill_reads_whole(s3_server, tmp_path,
                                                        nparts):
    """A remote stream's ``read`` stops where its 2 MiB buffer ends; the
    split reads on (``read_full``).  The JAX package's split reads once
    and raises a short read here (ROADMAP queue C), so the port is held
    against the same bytes on local disk."""
    lines = [b"%d %d:0.5 %d:1.25" % (i % 2, i % 977 + 1, i % 89 + 1000)
             for i in range(250000)]
    blob = b"\n".join(lines) + b"\n"
    assert len(blob) > 2 * rfs._DEFAULT_BUFFER
    S3.objects["bkt/big/a.libsvm"] = blob
    (tmp_path / "a.libsvm").write_bytes(blob)

    def chunks(uri, part):
        sp = pio.create_input_split(uri, part, nparts, "text",
                                    threaded=False)
        try:
            return b"".join(bytes(c) for c in iter(sp.next_chunk, None))
        finally:
            sp.close()

    union = b""
    for part in range(nparts):
        got = chunks("s3://bkt/big/a.libsvm", part)
        assert got == chunks(str(tmp_path / "a.libsvm"), part)
        union += got
    assert union == blob


def test_recordio_over_s3_larger_than_one_fill(s3_server):
    recs = [bytes([i % 251]) * (1000 + i % 3000) for i in range(2500)]
    with pio.open_stream("s3://bkt/r.rec", "w") as f:
        w = pio.RecordIOWriter(f)
        for r in recs:
            w.write_record(r)
    assert len(S3.objects["bkt/r.rec"]) > 2 * rfs._DEFAULT_BUFFER
    with pio.open_seek_stream_for_read("s3://bkt/r.rec") as f:
        r = pio.RecordIOReader(f)
        assert list(iter(r.next_record, None)) == recs


def test_threaded_and_cached_splits_over_s3(s3_train, tmp_path):
    """The prefetch thread and the raw-chunk ``#cachefile`` (a local
    file) over a remote source: the same records, the second epoch from
    the cache."""
    want = _records(jio, "s3://bkt/train", 0, 1)
    sp = pio.create_input_split("s3://bkt/train", threaded=True)
    try:
        assert [bytes(r) for r in iter(sp.next_record, None)] == want
    finally:
        sp.close()
    sp = pio.create_input_split(f"s3://bkt/train#{tmp_path}/c")
    try:
        assert [bytes(r) for r in iter(sp.next_record, None)] == want
        S3.objects.clear()                         # the store is gone
        sp.before_first()
        assert [bytes(r) for r in iter(sp.next_record, None)] == want
    finally:
        sp.close()


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()
    return native


ROWS, CAP = 64, 1024


def _epoch(loader):
    return [{k: np.asarray(v).copy() for k, v in b.items()} for b in loader]


def _assert_epochs_equal(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("path", ["native", "streampack", "python"])
def test_loader_batches_from_s3_equal_the_jax_loaders(lib, s3_train,
                                                      tmp_path, monkeypatch,
                                                      path):
    kw = {"native": {}, "streampack": {"threaded": False, "nthreads": 1},
          "python": {}}[path]
    engine = "python" if path == "python" else "native"
    if path == "python":
        # the JAX loader's python pack, to hold the port's python pack
        monkeypatch.setattr(jnative, "has_packer", lambda: False)
    jl = JDeviceLoader(jcreate_parser("s3://bkt/train"), ROWS, CAP,
                       id_mod=2048, put_threads=1, wire_compact=False,
                       prefetch=1)
    try:
        want = _epoch(jl)
    finally:
        jl.close()
    ld = DeviceLoader(create_parser("s3://bkt/train", engine=engine, **kw),
                      ROWS, CAP, id_mod=2048, device="cpu", engine=engine,
                      cache=None)
    try:
        _assert_epochs_equal(_epoch(ld), want)
    finally:
        ld.close()
    # and the same bytes from local files
    d = tmp_path / "train"
    d.mkdir()
    for key, blob in S3.objects.items():
        (d / key.rsplit("/", 1)[1]).write_bytes(blob)
    ld = DeviceLoader(create_parser(str(d), engine=engine, **kw), ROWS,
                      CAP, id_mod=2048, device="cpu", engine=engine,
                      cache=None)
    try:
        _assert_epochs_equal(_epoch(ld), want)
    finally:
        ld.close()


def test_loader_rides_over_injected_s3_request_faults(lib, s3_train):
    from dmlc_core_tpu_torch.utils.metrics import metrics

    def epoch():
        with DeviceLoader(create_parser("s3://bkt/train", engine="native"),
                          ROWS, CAP, id_mod=2048, device="cpu",
                          engine="native", cache=None) as ld:
            return _epoch(ld)

    want = epoch()
    before = metrics.counter("faults.s3.request.errors").value
    with inject_faults("s3.request:error=0.2:seed=7"):
        got = epoch()
    _assert_epochs_equal(got, want)
    assert metrics.counter("faults.s3.request.errors").value > before


def test_page_cache_keys_a_remote_source_by_path_and_size(lib, s3_train,
                                                          tmp_path):
    """A remote object has no mtime (None in both packages' fingerprint),
    so the page file keys it by path and size: an object rewritten at
    the same size is served stale from the page file (ROADMAP queue C).
    This pins the JAX package's behaviour, which the port keeps."""
    from dmlc_core_tpu.pipeline import fingerprint as jfp
    from dmlc_core_tpu_torch.pipeline import fingerprint as fp
    uri = f"s3://bkt/train#{tmp_path}/c"

    def epoch():
        # a writer queue of the epoch's 12 batches: never a dropped build
        with DeviceLoader(create_parser(uri, engine="native"), ROWS, CAP,
                          id_mod=2048, device="cpu", engine="native",
                          cache_queue_pages=12) as ld:
            return _epoch(ld), dict(ld.cache_stats), ld

    first, stats, ld = epoch()
    assert stats["misses"] == 1
    split = fp.find_file_split(ld.source)
    files = fp.split_files(split)
    assert files == jfp.split_files(split)
    assert [f[2] for f in files] == [None, None, None]
    assert [f[0] for f in files] == [f"s3://bkt/train/p{i}.libsvm"
                                     for i in range(3)]
    # rewrite one object at the same size: the page file is still served
    key = "bkt/train/p1.libsvm"
    old = S3.objects[key]
    S3.objects[key] = old.replace(b"1 ", b"0 ").replace(b"0 ", b"1 ", 5)
    assert len(S3.objects[key]) == len(old) and S3.objects[key] != old
    stale, stats, _ = epoch()
    assert stats["hits"] == 1 and stats["misses"] == 0
    _assert_epochs_equal(stale, first)
    # a size change shifts the fingerprint: rebuilt, never served
    S3.objects[key] = old + b"1 7:0.5\n"
    fresh, stats, _ = epoch()
    assert stats["hits"] == 0 and stats["misses"] == 1
    assert sum(len(b["labels"]) for b in fresh) >= sum(
        len(b["labels"]) for b in first)


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_written_by_either_package_restore_in_the_other(
        s3_server, hdfs_server, kind, writer):
    srv = s3_server[0] if kind == "s3" else hdfs_server[0]
    d = _remote_uri(kind, srv, "ck/run")
    rng = np.random.default_rng(14)
    states = [{"params": {"w": rng.normal(size=300).astype(np.float32),
                          "b": np.float32(0.5 * s)},
               "opt_state": ((np.int32(s), {"w": np.full(3, s, np.int64)}),
                             ())} for s in range(4)]
    mods = (ckpt, jckpt) if writer == "port" else (jckpt, ckpt)
    mgr = mods[0].CheckpointManager(d, max_to_keep=2)
    for s, st in enumerate(states):
        mgr.save(s, st, meta={"model": "fm", "steps": s})
    assert mgr.steps == [2, 3]
    other = mods[1].CheckpointManager(d, max_to_keep=2)
    assert other.steps == [2, 3] and other.meta(3)["steps"] == 3
    for s in (2, 3):
        step, got = other.restore(s)
        assert step == s
        a, b = ckpt.flatten_tree(got), ckpt.flatten_tree(states[s])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    leaves = other.restore_leaves(["params/w"])[1]
    np.testing.assert_array_equal(leaves["params/w"],
                                  states[3]["params"]["w"])
    # what is left on the store: two steps and the manifest, no temp names
    if kind == "s3":
        left = sorted(k for k in S3.objects if k.startswith("bkt/ck/run/"))
        assert left == ["bkt/ck/run/MANIFEST.json", "bkt/ck/run/ckpt-2.bin",
                        "bkt/ck/run/ckpt-3.bin"]
    else:
        assert set(HDFS.files) == {"/ck/run/ckpt-2.bin",
                                   "/ck/run/ckpt-3.bin",
                                   "/ck/run/MANIFEST.json"}


def test_load_for_inference_and_an_empty_remote_store(s3_server):
    mgr = ckpt.CheckpointManager("s3://bkt/empty")
    assert mgr.steps == [] and mgr.latest_step is None
    with pytest.raises(DMLCError, match="no checkpoints"):
        mgr.restore()
    ckpt.CheckpointManager("s3://bkt/inf").save(
        7, {"params": {"w": np.arange(5, dtype=np.float32)},
            "opt_state": np.zeros(5)}, meta={"model": "logreg"})
    step, params, meta = ckpt.load_for_inference("s3://bkt/inf")
    assert step == 7 and meta == {"model": "logreg"}
    np.testing.assert_array_equal(params["w"], np.arange(5))


def test_a_transient_store_error_is_not_an_empty_store(s3_server):
    """Only a definite 404 reads as "no manifest": a 5xx that outlasts
    the retries raises instead of rebuilding an empty history."""
    ckpt.CheckpointManager("s3://bkt/run").save(1, {"w": np.zeros(2)})
    with inject_faults("s3.request:error=1"):
        with pytest.raises(DMLCError):
            ckpt.CheckpointManager("s3://bkt/run").steps
    assert ckpt.CheckpointManager("s3://bkt/run").steps == [1]


# ---------------------------------------------------------------------------
# fscli
# ---------------------------------------------------------------------------

def test_fscli_ls_cat_cp_stat(tmp_path, capfd, s3_server):
    src = tmp_path / "in.txt"
    src.write_bytes(b"cli payload " * 100)
    assert fscli_main(["stat", f"file://{src}"]) == 0
    assert f"file {src.stat().st_size}" in capfd.readouterr().out
    assert fscli_main(["ls", f"file://{tmp_path}"]) == 0
    assert "in.txt" in capfd.readouterr().out
    assert fscli_main(["cp", f"file://{src}", "s3://bkt/out.txt"]) == 0
    assert S3.objects["bkt/out.txt"] == src.read_bytes()
    assert fscli_main(["ls", "s3://bkt/"]) == 0
    assert "s3://bkt/out.txt" in capfd.readouterr().out
    assert fscli_main(["cat", "s3://bkt/out.txt"]) == 0
    assert capfd.readouterr().out == src.read_text()
    assert fscli_main(["cp", "s3://bkt/out.txt",
                       f"file://{tmp_path}/back.txt"]) == 0
    assert (tmp_path / "back.txt").read_bytes() == src.read_bytes()
    assert fscli_main(["stat", "file:///definitely/not/there"]) == 1
    assert "dmlc-fs" in capfd.readouterr().err


def test_fscli_pack_unpack_round_trip_and_jax_reads_the_rec(tmp_path,
                                                             s3_server):
    import struct
    magic = struct.pack("<I", 0xced7230a)
    lines = [b"hello world", b"", b"x" * 5000, magic + b"embedded" + magic,
             "unicode-é".encode()]
    src = tmp_path / "in.txt"
    src.write_bytes(b"\n".join(lines) + b"\n")
    assert fscli_main(["pack", f"file://{src}", "s3://bkt/out.rec"]) == 0
    assert fscli_main(["unpack", "s3://bkt/out.rec",
                       f"file://{tmp_path}/back.txt"]) == 0
    assert (tmp_path / "back.txt").read_bytes() == src.read_bytes()
    from dmlc_core_tpu.io.fscli import main as jmain
    assert jmain(["unpack", "s3://bkt/out.rec",
                  f"file://{tmp_path}/jback.txt"]) == 0
    assert (tmp_path / "jback.txt").read_bytes() == src.read_bytes()
