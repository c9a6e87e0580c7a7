"""Remote object-store filesystems: HTTP, S3, GCS, WebHDFS, Azure.

Counterpart of ``dmlc_core_tpu/io/remote_filesys.py`` (the reference's
``src/io/s3_filesys.{h,cc}``, ``hdfs_filesys.cc`` and
``azure_filesys.cc``), copied so that the port imports nothing of the
JAX package.  The same environment variables and the same wire:

* :class:`RangedReadStream`: a seekable read stream over HTTP ranged
  GETs, buffered (2 MiB fills) with restart-on-seek: a seek outside the
  buffer drops it and the next read issues a Range request at the new
  offset.  A server that ignores Range leaves the whole object as the
  buffer.
* :class:`HttpFileSystem`: ``http://`` / ``https://``, read-only.
* :class:`S3FileSystem`: ``s3://bucket/key`` with AWS SigV4 signing
  (:func:`sign_v4`; ``AWS_ACCESS_KEY_ID``, ``AWS_SECRET_ACCESS_KEY``,
  ``AWS_SESSION_TOKEN``, ``AWS_REGION`` / ``AWS_DEFAULT_REGION``; a
  custom endpoint from ``DMLC_S3_ENDPOINT`` or ``S3_ENDPOINT``, path
  style), ``ListObjectsV2`` listing, a bucket root that reads as a
  directory, and multipart-upload writes: parts of at least 5 MiB,
  a single PUT for a smaller object, ``abort`` to publish nothing.
* :class:`GCSFileSystem`: ``gs://`` through the S3-compatible XML API
  (``GCS_*`` keys; ``DMLC_GCS_ENDPOINT``).
* :class:`WebHDFSFileSystem`: ``hdfs://namenode:port/path`` over the
  WebHDFS REST API: positional reads, listing, streaming writes
  (CREATE, then APPEND a part of ``DMLC_WEBHDFS_PART_SIZE`` bytes),
  ``rename`` and ``delete``; ``DMLC_WEBHDFS_SCHEME``,
  ``HADOOP_USER_NAME``, and a delegation token from
  ``DMLC_WEBHDFS_TOKEN`` (which drops ``user.name``).
* :class:`AzureFileSystem`: ``azure://account/container/path`` blob
  listing (``AZURE_STORAGE_ENDPOINT``, ``AZURE_STORAGE_SAS``); reading
  is refused, as in the reference and the JAX package.

Every round trip goes through :func:`_http_request`: plain
``http.client`` under :class:`..utils.retry.RetryPolicy` (exponential
backoff with full jitter; ``DMLC_IO_RETRIES``, ``DMLC_IO_BACKOFF_BASE``,
``DMLC_IO_BACKOFF_MAX``, ``DMLC_IO_DEADLINE``), which retries transport
errors, 5xx and 429 (``Retry-After`` in either RFC form raises the
backoff floor, capped by the deadline) and crosses the ``s3.request``
fault point (:mod:`..utils.faults`) on each attempt.  The connection is
opened apart, under ``DMLC_IO_CONNECT_TIMEOUT`` (10 s), and a connect
that fails is retried for every method: no byte of the request has left.
"""

from __future__ import annotations

import datetime as _dt
import email.utils
import hashlib
import hmac
import http.client
import io
import json
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import BinaryIO, Dict, List, Optional, Tuple

from ..utils.faults import fault_point
from ..utils.logging import DMLCError, check
from ..utils.parameter import env_int, get_env
from ..utils.retry import (Deadline, DeadlineExpired, RetriesExhausted,
                           RetryPolicy)
from .filesys import FS_REGISTRY, FileInfo, FileSystem
from .uri import URI

__all__ = [
    "RangedReadStream", "HttpFileSystem", "S3FileSystem", "GCSFileSystem",
    "WebHDFSFileSystem", "AzureFileSystem", "sign_v4",
]

_DEFAULT_BUFFER = 2 << 20      # fill granularity (ref kBufferSize 2MiB, input_split_base.h:40)
_MIN_PART_SIZE = 5 << 20       # S3 minimum multipart part (ref s3_filesys.cc:646)
_MAX_RETRY = 3


class _RetryableStatus(OSError):
    """A 5xx/429 response re-raised through the retry machinery.  Subclasses
    ``OSError`` so the default retryable predicate sees it; carries the full
    response so retry exhaustion can still RETURN it (the caller contract:
    non-transport failures come back as a status, not an exception), and the
    server's ``Retry-After`` as the ``retry_after_s`` backoff-floor hint that
    :meth:`RetryPolicy.call` honors (clamped at the remaining deadline)."""

    def __init__(self, status: int, hdrs: Dict[str, str], data: bytes,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(f"HTTP {status}")
        self.status = status
        self.hdrs = hdrs
        self.data = data
        self.retry_after_s = retry_after_s


def _parse_retry_after(hdrs: Dict[str, str]) -> Optional[float]:
    """``Retry-After`` → seconds; both RFC forms (delta-seconds, HTTP-date)."""
    ra = hdrs.get("retry-after")
    if ra is None:
        return None
    try:
        return max(0.0, float(ra))
    except ValueError:
        pass
    try:
        t = email.utils.parsedate_to_datetime(ra)
        now = _dt.datetime.now(_dt.timezone.utc)
        if t.tzinfo is None:
            t = t.replace(tzinfo=_dt.timezone.utc)
        return max(0.0, (t - now).total_seconds())
    except (TypeError, ValueError):
        return None


def _http_request(scheme: str, netloc: str, method: str, path_qs: str,
                  headers: Dict[str, str], body: bytes = b"",
                  timeout: float = 60.0,
                  retries: Optional[int] = None,
                  deadline: Optional[Deadline] = None
                  ) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP round trip under the shared retry machinery
    (:class:`..utils.retry.RetryPolicy`: exponential backoff,
    full jitter, ``DMLC_IO_*`` env knobs, ``retry.io.http.*`` counters).

    Transport errors, 5xx and 429 are retried; 429's ``Retry-After`` raises
    the backoff floor (capped at the remaining ``DMLC_IO_DEADLINE`` budget).
    By default only idempotent methods retry (a retried POST/PUT could
    double-apply or fail after server-side success — e.g. re-sending
    CompleteMultipartUpload for an already-completed id).  Callers that KNOW
    a write is idempotent (UploadPart: same partNumber+uploadId replaces the
    part; InitiateMultipartUpload: a lost-response orphan id is
    lifecycle-cleaned) pass ``retries`` explicitly — the write-side analog
    of restart-on-seek (`s3_filesys.cc:747-799`).

    Each attempt crosses the ``s3.request`` fault-injection probe, so drops/
    latency/5xx schedules from ``DMLC_FAULT_SPEC`` exercise this exact path.

    The connection is made first, within ``DMLC_IO_CONNECT_TIMEOUT``
    seconds, and a connect that fails or hangs is retried whatever the
    method (``retry.io.connect.*``): the server has seen nothing of the
    request yet, so even a POST cannot apply twice.  ``timeout`` then
    bounds each send and receive.
    """
    if retries is None:
        retries = (get_env("DMLC_IO_RETRIES", _MAX_RETRY)
                   if method in ("GET", "HEAD") else 1)
    if deadline is None:
        budget = get_env("DMLC_IO_DEADLINE", 0.0)
        deadline = Deadline(budget if budget > 0 else None)
    policy = RetryPolicy(
        max_attempts=retries,
        base_delay_s=get_env("DMLC_IO_BACKOFF_BASE", 0.1),
        max_delay_s=get_env("DMLC_IO_BACKOFF_MAX", 2.0),
        retryable=lambda e: isinstance(
            e, (OSError, http.client.HTTPException)),
        name="io.http")

    cls = (http.client.HTTPSConnection if scheme == "https"
           else http.client.HTTPConnection)
    connect_s = get_env("DMLC_IO_CONNECT_TIMEOUT", 10.0)
    connecting = RetryPolicy(
        max_attempts=get_env("DMLC_IO_RETRIES", _MAX_RETRY),
        base_delay_s=policy.base_delay_s, max_delay_s=policy.max_delay_s,
        retryable=lambda e: isinstance(e, OSError), name="io.connect")

    def _connect() -> http.client.HTTPConnection:
        conn = cls(netloc, timeout=deadline.clamp(min(timeout, connect_s)))
        try:
            conn.connect()
        except BaseException:
            conn.close()
            raise
        conn.sock.settimeout(deadline.clamp(timeout))
        return conn

    def _once() -> Tuple[int, Dict[str, str], bytes]:
        fault_point("s3.request")
        conn = None
        try:
            conn = connecting.call(_connect, deadline=deadline)
            conn.request(method, path_qs, body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            hdrs = {k.lower(): v for k, v in resp.getheaders()}
        finally:
            if conn is not None:
                conn.close()
        if resp.status >= 500 or resp.status == 429:
            raise _RetryableStatus(resp.status, hdrs, data,
                                   _parse_retry_after(hdrs))
        return resp.status, hdrs, data

    try:
        return policy.call(_once, deadline=deadline)
    except (RetriesExhausted, DeadlineExpired) as e:
        cause = e.__cause__
        if isinstance(cause, _RetryableStatus):
            # exhausted on a retryable STATUS: hand the caller the final
            # response, same contract as the old hand-rolled loop
            return cause.status, cause.hdrs, cause.data
        raise DMLCError(
            f"http {method} {netloc}{path_qs} failed: {cause or e}") from e


class RangedReadStream(io.RawIOBase):
    """Seekable read stream over HTTP Range GETs with restart-on-seek.

    The ``CURLReadStreamBase`` design (`s3_filesys.cc:219-361`): a buffer is
    filled by ranged GETs starting at ``curr_bytes_``; ``Seek`` outside the
    buffered window discards state and restarts the transfer at the new
    offset (`s3_filesys.cc:234-239`). Subclasses provide
    :meth:`_request_headers` to sign each range request.
    """

    def __init__(self, scheme: str, netloc: str, path_qs: str,
                 size: Optional[int] = None,
                 buffer_size: int = _DEFAULT_BUFFER) -> None:
        super().__init__()
        self._scheme = scheme
        self._netloc = netloc
        self._path_qs = path_qs
        self._buffer_size = buffer_size
        self._size = size          # lazily discovered from Content-Range
        self._pos = 0              # logical read position
        self._buf = b""
        self._buf_start = 0        # file offset of self._buf[0]

    # subclass hook: per-request auth headers (S3 signs every range request)
    def _request_headers(self, method: str,
                         headers: Dict[str, str]) -> Dict[str, str]:
        return headers

    def _fetch(self, start: int, end_excl: int) -> bytes:
        headers = {"Range": f"bytes={start}-{end_excl - 1}"}
        headers = self._request_headers("GET", headers)
        status, hdrs, data = _http_request(
            self._scheme, self._netloc, "GET", self._path_qs, headers)
        if status == 206:
            cr = hdrs.get("content-range", "")
            if "/" in cr and self._size is None:
                try:
                    self._size = int(cr.rsplit("/", 1)[1])
                except ValueError:
                    pass
            return data
        if status == 200:
            # server ignored Range: we now hold the whole object — keep it
            # all as the buffer so we never re-download it per refill
            if self._size is None:
                self._size = len(data)
            self._buf = data
            self._buf_start = 0
            return data[start:end_excl]
        if status in (404, 403):
            raise DMLCError(
                f"GET {self._netloc}{self._path_qs}: HTTP {status}")
        if status == 416:           # requested range beyond EOF
            return b""
        raise DMLCError(
            f"GET {self._netloc}{self._path_qs} range {start}-{end_excl}: "
            f"HTTP {status}")

    # -- io.RawIOBase interface --------------------------------------------
    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def _length(self) -> int:
        if self._size is None:
            headers = self._request_headers("HEAD", {})
            status, hdrs, _ = _http_request(
                self._scheme, self._netloc, "HEAD", self._path_qs, headers)
            if status != 200 or "content-length" not in hdrs:
                # fall back: probe with a 1-byte range GET
                self._fetch(0, 1)
                if self._size is None:
                    raise DMLCError(
                        f"cannot determine size of {self._netloc}{self._path_qs}")
            else:
                self._size = int(hdrs["content-length"])
        return self._size

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            new = offset
        elif whence == os.SEEK_CUR:
            new = self._pos + offset
        elif whence == os.SEEK_END:
            new = self._length() + offset
        else:
            raise ValueError(f"bad whence {whence}")
        check(new >= 0, "negative seek position")
        # restart-on-seek: outside the buffered window → drop buffer
        if not (self._buf_start <= new <= self._buf_start + len(self._buf)):
            self._buf = b""
            self._buf_start = new
        self._pos = new
        return self._pos

    def readinto(self, b) -> int:
        want = len(b)
        if want == 0:
            return 0
        off = self._pos - self._buf_start
        if not (0 <= off < len(self._buf)):
            # refill buffer at current position
            if self._size is not None and self._pos >= self._size:
                return 0
            fill = max(self._buffer_size, want)
            data = self._fetch(self._pos, self._pos + fill)
            if not data:
                return 0
            # a 200-fallback (server ignored Range) leaves the WHOLE object
            # in self._buf — recompute the window instead of clobbering it,
            # or each refill would re-download the full object
            off = self._pos - self._buf_start
            if not (0 <= off < len(self._buf)):
                self._buf = data
                self._buf_start = self._pos
                off = 0
        n = min(want, len(self._buf) - off)
        b[:n] = self._buf[off:off + n]
        self._pos += n
        return n

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while True:
                c = super().read(self._buffer_size)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)
        return super().read(n) or b""


# ---------------------------------------------------------------------------
# http:// / https:// — read-only remote files (ref HttpReadStream
# s3_filesys.cc:533-549: unsigned ranged reads over any URL)
# ---------------------------------------------------------------------------

class HttpFileSystem(FileSystem):
    """Read-only FS over plain HTTP(S) (reference `s3_filesys.cc:533-549`)."""

    def __init__(self, scheme: str = "http") -> None:
        self._scheme = scheme

    def get_path_info(self, uri: URI) -> FileInfo:
        status, hdrs, _ = _http_request(self._scheme, uri.host, "HEAD",
                                        uri.name or "/", {})
        if status != 200:
            raise DMLCError(f"HEAD {uri.raw}: HTTP {status}")
        if "content-length" in hdrs:
            size = int(hdrs["content-length"])
        else:
            # chunked/dynamic responses omit Content-Length; a zero size
            # would silently drop the file from input splits — probe instead
            s = RangedReadStream(self._scheme, uri.host, uri.name or "/")
            size = s._length()
        return FileInfo(path=uri.raw, size=size, type="file")

    def list_directory(self, uri: URI) -> List[FileInfo]:
        raise DMLCError("HttpFileSystem does not support listing")

    def open(self, uri: URI, mode: str) -> BinaryIO:
        check(mode == "r", "http(s):// is read-only")
        return RangedReadStream(self._scheme, uri.host, uri.name or "/")


# ---------------------------------------------------------------------------
# AWS Signature Version 4
# ---------------------------------------------------------------------------

def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac_sha256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(method: str, host: str, path: str,
            query: Dict[str, str], headers: Dict[str, str],
            payload_hash: str, region: str, service: str,
            access_key: str, secret_key: str,
            session_token: Optional[str] = None,
            now: Optional[_dt.datetime] = None,
            include_content_sha256: bool = True) -> Dict[str, str]:
    """AWS SigV4: returns ``headers`` + ``Authorization``/``x-amz-*``.

    The reference signs with v2 HMAC-SHA1 (`s3_filesys.cc:90-121`); modern
    S3/GCS-interop require v4. Canonicalization follows the official spec:
    sorted URL-encoded query, sorted lowercase signed headers, hex payload
    hash; signing key = HMAC chain over date/region/service.
    """
    now = now or _dt.datetime.now(_dt.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    headers = dict(headers)
    headers["host"] = host
    headers["x-amz-date"] = amz_date
    if include_content_sha256:      # S3 requires it; the generic AWS
        headers["x-amz-content-sha256"] = payload_hash  # test suite omits it
    if session_token:
        headers["x-amz-security-token"] = session_token

    canonical_uri = urllib.parse.quote(path, safe="/")
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query.items()))
    lower = {k.lower(): v.strip() for k, v in headers.items()}
    signed_headers = ";".join(sorted(lower))
    canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_hash])

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256_hex(canonical_request.encode())])

    k_date = _hmac_sha256(b"AWS4" + secret_key.encode(), datestamp)
    k_region = _hmac_sha256(k_date, region)
    k_service = _hmac_sha256(k_region, service)
    k_signing = _hmac_sha256(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()

    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return headers


# ---------------------------------------------------------------------------
# S3 (and S3-compatible endpoints: minio, GCS interop, fake test servers)
# ---------------------------------------------------------------------------

class _S3Config:
    """Credentials/endpoint from env (reference ctor `s3_filesys.cc:926`:
    AWS_ACCESS_KEY_ID/SECRET/SESSION_TOKEN/REGION + custom endpoint)."""

    def __init__(self, scheme_env_prefix: str = "AWS",
                 service: str = "s3") -> None:
        env = os.environ
        self.access_key = env.get(f"{scheme_env_prefix}_ACCESS_KEY_ID", "")
        self.secret_key = env.get(f"{scheme_env_prefix}_SECRET_ACCESS_KEY", "")
        self.session_token = env.get(f"{scheme_env_prefix}_SESSION_TOKEN") or None
        self.region = (env.get(f"{scheme_env_prefix}_REGION")
                       or env.get(f"{scheme_env_prefix}_DEFAULT_REGION")
                       or "us-east-1")
        self.endpoint = env.get("DMLC_S3_ENDPOINT") or env.get("S3_ENDPOINT") or ""
        self.service = service

    def resolve(self, bucket: str) -> Tuple[str, str, str]:
        """-> (scheme, netloc, path_prefix). Custom endpoints use path-style
        addressing (bucket in the path) so local fake servers/minio work."""
        if self.endpoint:
            ep = self.endpoint
            if "://" not in ep:        # "localhost:9000" minio-style form
                ep = "http://" + ep
            p = urllib.parse.urlparse(ep)
            return p.scheme or "http", p.netloc, f"/{bucket}"
        return "https", f"{bucket}.s3.{self.region}.amazonaws.com", ""


class _S3ReadStream(RangedReadStream):
    """Signed ranged-read stream (reference ``s3::ReadStream``
    `s3_filesys.cc:462-530`: every range fill re-signs the request)."""

    def __init__(self, cfg: _S3Config, bucket: str, key: str,
                 size: Optional[int] = None) -> None:
        scheme, netloc, prefix = cfg.resolve(bucket)
        path = f"{prefix}/{key}"
        # wire path must be the same percent-encoded bytes sign_v4 signs
        super().__init__(scheme, netloc, urllib.parse.quote(path, safe="/"),
                         size=size)
        self._cfg = cfg
        self._sign_path = path

    def _request_headers(self, method: str,
                         headers: Dict[str, str]) -> Dict[str, str]:
        if not self._cfg.access_key:
            return headers
        return sign_v4(method,
                       self._netloc, self._sign_path, {}, headers,
                       _sha256_hex(b""), self._cfg.region, self._cfg.service,
                       self._cfg.access_key, self._cfg.secret_key,
                       self._cfg.session_token)


class _S3WriteStream(io.RawIOBase):
    """Multipart-upload write stream (reference ``s3::WriteStream``
    `s3_filesys.cc:551-799`): buffer ≥5MB, InitiateMultipartUpload on first
    flush, UploadPart per buffer, CompleteMultipartUpload XML on close;
    small objects fall back to a single PUT."""

    def __init__(self, fs: "S3FileSystem", bucket: str, key: str,
                 part_size: int = _MIN_PART_SIZE) -> None:
        super().__init__()
        self._fs = fs
        self._bucket = bucket
        self._key = key
        self._part_size = max(part_size, 1)
        self._buf = bytearray()
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._buf.extend(b)
        while len(self._buf) >= self._part_size:
            self._flush_part(bytes(self._buf[:self._part_size]))
            del self._buf[:self._part_size]
        return len(b)

    def _flush_part(self, data: bytes) -> None:
        # Initiate and UploadPart retry on dropped connections / 5xx
        # (reference `s3_filesys.cc:747-799` loops its curl calls the same
        # way): re-PUTting partNumber+uploadId replaces the part — exactly
        # idempotent — and a lost Initiate response only orphans an id for
        # lifecycle cleanup.  CompleteMultipartUpload (close) stays
        # single-shot: a blind re-send after server-side success returns
        # NoSuchUpload and would turn a succeeded publish into an error.
        if self._upload_id is None:
            status, _, body = self._fs._request(
                "POST", self._bucket, self._key, {"uploads": ""}, b"",
                retries=_MAX_RETRY)
            check(status == 200, f"InitiateMultipartUpload: HTTP {status}")
            self._upload_id = ET.fromstring(body).findtext(".//{*}UploadId")
            check(bool(self._upload_id), "no UploadId in response")
        part_no = len(self._etags) + 1
        status, hdrs, _ = self._fs._request(
            "PUT", self._bucket, self._key,
            {"partNumber": str(part_no), "uploadId": self._upload_id}, data,
            retries=_MAX_RETRY)
        check(status == 200, f"UploadPart {part_no}: HTTP {status}")
        self._etags.append(hdrs.get("etag", f'"{part_no}"'))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._upload_id is None:
            # small object: single PUT (reference same fallback, :747)
            status, _, _ = self._fs._request(
                "PUT", self._bucket, self._key, {}, bytes(self._buf))
            check(status == 200, f"PUT object: HTTP {status}")
        else:
            if self._buf:
                self._flush_part(bytes(self._buf))
                self._buf.clear()
            parts = "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{etag}</ETag></Part>"
                for i, etag in enumerate(self._etags))
            xml_body = (f"<CompleteMultipartUpload>{parts}"
                        f"</CompleteMultipartUpload>").encode()
            status, _, _ = self._fs._request(
                "POST", self._bucket, self._key,
                {"uploadId": self._upload_id}, xml_body)
            check(status == 200, f"CompleteMultipartUpload: HTTP {status}")
        super().close()

    def abort(self) -> None:
        """Abandon the write WITHOUT publishing: callers that hit an error
        mid-write call this instead of close(), so a partial buffer never
        becomes the object (AbortMultipartUpload when one is open)."""
        if self._closed:
            return
        self._closed = True
        self._buf.clear()
        if self._upload_id is not None:
            try:
                self._fs._request("DELETE", self._bucket, self._key,
                                  {"uploadId": self._upload_id}, b"")
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
        super().close()


class S3FileSystem(FileSystem):
    """``s3://bucket/key`` object store (reference `s3_filesys.cc`)."""

    def __init__(self, env_prefix: str = "AWS", service: str = "s3",
                 part_size: int = _MIN_PART_SIZE) -> None:
        self._env_prefix = env_prefix
        self._service = service
        self._part_size = part_size

    @property
    def cfg(self) -> _S3Config:
        # re-read env per request (cheap: six dict lookups) so credentials
        # and endpoint can change after the scheme singletons are created
        return _S3Config(self._env_prefix, self._service)

    def _request(self, method: str, bucket: str, key: str,
                 query: Dict[str, str], body: bytes,
                 retries: Optional[int] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        cfg = self.cfg
        scheme, netloc, prefix = cfg.resolve(bucket)
        path = f"{prefix}/{key}" if key else (prefix or "/")
        headers: Dict[str, str] = {}
        if cfg.access_key:
            headers = sign_v4(method, netloc, path, query, headers,
                              _sha256_hex(body), cfg.region, cfg.service,
                              cfg.access_key, cfg.secret_key,
                              cfg.session_token)
        # encode path+query exactly as sign_v4 canonicalized them, or the
        # server-side signature check would see different bytes
        qs = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(query.items()))
        wire_path = urllib.parse.quote(path, safe="/")
        path_qs = f"{wire_path}?{qs}" if qs else wire_path
        return _http_request(scheme, netloc, method, path_qs, headers, body,
                             retries=retries)

    @staticmethod
    def _split(uri: URI) -> Tuple[str, str]:
        return uri.host, uri.name.lstrip("/")

    def get_path_info(self, uri: URI) -> FileInfo:
        bucket, key = self._split(uri)
        # empty key = bucket root: HEAD would be HeadBucket (200) and
        # misreport a zero-size file — go straight to the prefix probe
        if key:
            status, hdrs, _ = self._request("HEAD", bucket, key, {}, b"")
            if status == 200:
                return FileInfo(path=uri.raw,
                                size=int(hdrs.get("content-length", 0)),
                                type="file")
        else:
            status = 404
        # directory probe: any object under the prefix? (ref TryGetPathInfo)
        infos = self.list_directory(uri)
        if infos:
            return FileInfo(path=uri.raw, size=0, type="dir")
        raise DMLCError(f"s3: no such object {uri.raw} (HTTP {status})")

    def delete(self, uri: URI) -> None:
        bucket, key = self._split(uri)
        status, _, _ = self._request("DELETE", bucket, key, {}, b"")
        # S3 DeleteObject: 204 on success (idempotent — deleting a missing
        # key also returns 204)
        check(status in (200, 204), f"s3 DELETE {uri.raw}: HTTP {status}")

    def list_directory(self, uri: URI) -> List[FileInfo]:
        bucket, key = self._split(uri)
        prefix = key if not key or key.endswith("/") else key + "/"
        out: List[FileInfo] = []
        token: Optional[str] = None
        while True:
            q = {"list-type": "2", "prefix": prefix, "delimiter": "/"}
            if token:
                q["continuation-token"] = token
            status, _, body = self._request("GET", bucket, "", q, b"")
            check(status == 200, f"ListObjectsV2: HTTP {status}")
            root = ET.fromstring(body)

            def _find(el, tag):
                return el.findtext(f"{{*}}{tag}") or el.findtext(tag)

            for c in list(root.iter()):
                if c.tag.endswith("Contents"):
                    k = _find(c, "Key")
                    if k and k != prefix:
                        out.append(FileInfo(
                            path=f"{uri.protocol}{bucket}/{k}",
                            size=int(_find(c, "Size") or 0), type="file"))
                elif c.tag.endswith("CommonPrefixes"):
                    p = _find(c, "Prefix")
                    if p:
                        out.append(FileInfo(
                            path=f"{uri.protocol}{bucket}/{p.rstrip('/')}",
                            size=0, type="dir"))
            token = (root.findtext("{*}NextContinuationToken")
                     or root.findtext("NextContinuationToken"))
            if not token:
                return out

    def open(self, uri: URI, mode: str) -> BinaryIO:
        bucket, key = self._split(uri)
        if mode == "r":
            return _S3ReadStream(self.cfg, bucket, key)
        check(mode == "w", "s3 supports modes 'r' and 'w' only")
        return _S3WriteStream(self, bucket, key, self._part_size)


class GCSFileSystem(S3FileSystem):
    """``gs://`` via the GCS S3-compatible XML API with HMAC interop keys
    (env ``GCS_ACCESS_KEY_ID``/``GCS_SECRET_ACCESS_KEY``; endpoint
    ``https://storage.googleapis.com`` unless ``DMLC_GCS_ENDPOINT`` is
    set)."""

    def __init__(self) -> None:
        super().__init__(env_prefix="GCS", service="s3")

    @property
    def cfg(self) -> _S3Config:
        c = _S3Config("GCS", "s3")
        # a custom *S3* endpoint (minio etc.) must not reroute gs:// traffic;
        # only the GCS-specific override applies here
        c.endpoint = (get_env("DMLC_GCS_ENDPOINT", None)
                      or "https://storage.googleapis.com")
        return c


# ---------------------------------------------------------------------------
# WebHDFS
# ---------------------------------------------------------------------------

def _request_url(method: str, url: str,
                 body: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
    p = urllib.parse.urlparse(url)
    path_qs = p.path + (f"?{p.query}" if p.query else "")
    return _http_request(p.scheme or "http", p.netloc, method, path_qs,
                         {}, body)


def _webhdfs_location(status: int, hdrs: Dict[str, str],
                      data: bytes) -> Optional[str]:
    """Two-step WebHDFS data ops: the namenode answers OPEN/CREATE either
    with a 307 redirect or (with ``noredirect=true``) a JSON body holding
    the datanode ``Location``; data flows to/from that second URL."""
    if status == 307:
        return hdrs.get("location")
    if status == 200 and "json" in hdrs.get("content-type", ""):
        try:
            return json.loads(data).get("Location")
        except (ValueError, AttributeError):
            return None
    return None


class _WebHDFSReadStream(RangedReadStream):
    """Ranged reads via ``OPEN&offset=..&length=..`` (maps the reference's
    hdfsPread positional read, `hdfs_filesys.cc:31-55`, onto REST)."""

    def __init__(self, scheme: str, netloc: str, path: str, size: int,
                 auth: Dict[str, str]) -> None:
        super().__init__(scheme, netloc, path, size=size)
        self._auth = auth

    def _fetch(self, start: int, end_excl: int) -> bytes:
        q = {"op": "OPEN", "offset": str(start),
             "length": str(end_excl - start), "noredirect": "true"}
        q.update(self._auth)
        qs = urllib.parse.urlencode(q)
        status, hdrs, data = _http_request(
            self._scheme, self._netloc, "GET", f"{self._path_qs}?{qs}", {})
        loc = _webhdfs_location(status, hdrs, data)
        if loc is not None:
            # namenode handed us the datanode URL — fetch the bytes there
            status, _, data = _request_url("GET", loc)
        if status != 200:
            raise DMLCError(f"webhdfs OPEN {self._path_qs}: HTTP {status}")
        return data


class WebHDFSFileSystem(FileSystem):
    """``hdfs://host:port/path`` over WebHDFS REST (reference wraps libhdfs
    JNI, `hdfs_filesys.cc`; same surface, no JVM dependency).

    Env: ``DMLC_WEBHDFS_SCHEME`` (default http), ``HADOOP_USER_NAME``,
    ``DMLC_WEBHDFS_TOKEN`` — a Hadoop delegation token appended as
    ``delegation=`` to every request.  This is the standard way into a
    kerberized cluster without SPNEGO on the client: obtain the token
    out-of-band (``hdfs fetchdt`` after kinit, or from the YARN AM's
    credentials) and export it.  When the token is set, ``user.name`` is
    omitted — Hadoop rejects requests carrying both.
    The URI host is the namenode ``host:port`` (reference connect,
    `hdfs_filesys.cc:94`).
    """

    def _base(self, uri: URI) -> Tuple[str, str, str]:
        scheme = get_env("DMLC_WEBHDFS_SCHEME", "http")
        path = urllib.parse.quote(uri.name, safe="/")
        return scheme, uri.host, f"/webhdfs/v1{path}"

    @staticmethod
    def _auth_params() -> Dict[str, str]:
        """delegation token > user.name > nothing (simple-auth clusters)."""
        token = get_env("DMLC_WEBHDFS_TOKEN", None)
        if token:
            return {"delegation": token}
        user = os.environ.get("HADOOP_USER_NAME")
        return {"user.name": user} if user else {}

    def _op(self, uri: URI, method: str, op: str,
            extra: Optional[Dict[str, str]] = None,
            body: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        scheme, netloc, path = self._base(uri)
        q = {"op": op}
        q.update(self._auth_params())
        q.update(extra or {})
        qs = urllib.parse.urlencode(q)
        return _http_request(scheme, netloc, method, f"{path}?{qs}", {}, body)

    @staticmethod
    def _info_from_status(uri_prefix: str, name: str, st: dict) -> FileInfo:
        path = uri_prefix if not name else f"{uri_prefix.rstrip('/')}/{name}"
        return FileInfo(path=path, size=int(st.get("length", 0)),
                        type="dir" if st.get("type") == "DIRECTORY" else "file")

    def get_path_info(self, uri: URI) -> FileInfo:
        status, _, body = self._op(uri, "GET", "GETFILESTATUS")
        if status != 200:
            raise DMLCError(f"webhdfs GETFILESTATUS {uri.raw}: HTTP {status}")
        st = json.loads(body)["FileStatus"]
        return self._info_from_status(uri.raw, "", st)

    def list_directory(self, uri: URI) -> List[FileInfo]:
        status, _, body = self._op(uri, "GET", "LISTSTATUS")
        if status != 200:
            raise DMLCError(f"webhdfs LISTSTATUS {uri.raw}: HTTP {status}")
        sts = json.loads(body)["FileStatuses"]["FileStatus"]
        return [self._info_from_status(uri.raw, st.get("pathSuffix", ""), st)
                for st in sts]

    def rename(self, src: URI, dst: URI) -> None:
        """``op=RENAME`` — atomic within HDFS (`FileSystem.rename`); the
        publish step for write-to-temp checkpoint objects."""
        status, _, _ = self._op(
            src, "PUT", "RENAME",
            {"destination": "/" + dst.name.lstrip("/")})
        check(status == 200, f"webhdfs RENAME {src.raw}: HTTP {status}")

    def delete(self, uri: URI) -> None:
        status, _, _ = self._op(uri, "DELETE", "DELETE")
        check(status == 200, f"webhdfs DELETE {uri.raw}: HTTP {status}")

    def open(self, uri: URI, mode: str) -> BinaryIO:
        if mode == "r":
            info = self.get_path_info(uri)
            scheme, netloc, path = self._base(uri)
            return _WebHDFSReadStream(scheme, netloc, path, info.size,
                                      self._auth_params())
        check(mode == "w", "webhdfs supports modes 'r' and 'w' only")
        part = env_int("DMLC_WEBHDFS_PART_SIZE", 8 << 20, minimum=1)
        return _WebHDFSWriteStream(self, uri, max(1, part))


class _WebHDFSWriteStream(io.BufferedIOBase):
    """Streaming writer: CREATE carries the first part, each further part
    goes out as an APPEND — memory stays bounded at ``part_size`` no matter
    how large the object (the reference streams via hdfsWrite,
    `hdfs_filesys.cc:56-75`; buffering the whole object, as v1 did, OOMs on
    large checkpoint writes)."""

    def __init__(self, fs: "WebHDFSFileSystem", uri: URI,
                 part_size: int) -> None:
        self._fs = fs
        self._uri = uri
        self._part = part_size
        self._buf = bytearray()
        self._created = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        if self.closed:
            raise ValueError("I/O operation on closed file")
        self._buf += b
        while len(self._buf) >= self._part:
            self._send(bytes(self._buf[:self._part]))
            del self._buf[:self._part]
        return len(b)

    def _send(self, data: bytes) -> None:
        if not self._created:
            # step 1: namenode CREATE (no body) → datanode Location
            status, hdrs, resp = self._fs._op(
                self._uri, "PUT", "CREATE",
                {"overwrite": "true", "noredirect": "true"}, b"")
            loc = _webhdfs_location(status, hdrs, resp)
            if loc is not None:
                # step 2: stream the first part to the datanode
                status, _, _ = _request_url("PUT", loc, data)
            elif status in (200, 201):
                # gateway (e.g. HttpFS) accepted data directly
                status, _, _ = self._fs._op(
                    self._uri, "PUT", "CREATE",
                    {"overwrite": "true", "noredirect": "true"}, data)
            check(status in (200, 201), f"webhdfs CREATE: HTTP {status}")
            self._created = True
            return
        status, hdrs, resp = self._fs._op(self._uri, "POST", "APPEND",
                                          {"noredirect": "true"}, b"")
        loc = _webhdfs_location(status, hdrs, resp)
        if loc is not None:
            status, _, _ = _request_url("POST", loc, data)
        elif status in (200, 201, 204):
            status, _, _ = self._fs._op(self._uri, "POST", "APPEND", {}, data)
        check(status in (200, 201, 204), f"webhdfs APPEND: HTTP {status}")

    def abort(self) -> None:
        """Drop buffered bytes and close without flushing.  NOTE: parts
        already APPENDed are visible at the target path (WebHDFS has no
        upload session) — atomic publish over hdfs:// therefore needs
        write-to-temp + :meth:`WebHDFSFileSystem.rename`, which is what
        the checkpoint layer does."""
        if not self.closed:
            self._buf = bytearray()
            self._created = True    # suppress the empty-file CREATE
            super().close()

    def close(self) -> None:
        if not self.closed:
            # final short part; an empty file still needs its CREATE
            if self._buf or not self._created:
                self._send(bytes(self._buf))
                self._buf = bytearray()
            super().close()


# ---------------------------------------------------------------------------
# Azure (listing-only, like the reference azure_filesys.cc:42-80)
# ---------------------------------------------------------------------------

class AzureFileSystem(FileSystem):
    """``azure://account/container/path`` blob listing via the public List
    Blobs REST API (reference backend is also listing-only; its Open is
    unimplemented, `azure_filesys.cc`). Env: ``AZURE_STORAGE_ENDPOINT`` to
    override the host (for tests), ``AZURE_STORAGE_SAS`` appended as auth."""

    def _endpoint(self, account: str) -> Tuple[str, str]:
        ep = os.environ.get("AZURE_STORAGE_ENDPOINT", "")
        if ep:
            p = urllib.parse.urlparse(ep)
            return p.scheme or "http", p.netloc
        return "https", f"{account}.blob.core.windows.net"

    def list_directory(self, uri: URI) -> List[FileInfo]:
        account = uri.host
        parts = uri.name.lstrip("/").split("/", 1)
        container = parts[0]
        prefix = parts[1] if len(parts) > 1 else ""
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        scheme, netloc = self._endpoint(account)
        sas = os.environ.get("AZURE_STORAGE_SAS", "")
        out: List[FileInfo] = []
        marker = ""
        while True:     # follow NextMarker pagination (5000 blobs per page)
            q = {"restype": "container", "comp": "list", "prefix": prefix,
                 "delimiter": "/"}
            if marker:
                q["marker"] = marker
            qs = urllib.parse.urlencode(q) + (
                f"&{sas.lstrip('?&')}" if sas else "")
            status, _, body = _http_request(scheme, netloc, "GET",
                                            f"/{container}?{qs}", {})
            check(status == 200, f"azure List Blobs: HTTP {status}")
            root = ET.fromstring(body)
            for b in root.iter():
                if b.tag.endswith("Blob"):
                    name = b.findtext("Name") or b.findtext("{*}Name") or ""
                    size = b.findtext(".//Content-Length") or "0"
                    out.append(FileInfo(
                        path=f"azure://{account}/{container}/{name}",
                        size=int(size), type="file"))
                elif b.tag.endswith("BlobPrefix"):
                    name = b.findtext("Name") or ""
                    out.append(FileInfo(
                        path=f"azure://{account}/{container}/{name.rstrip('/')}",
                        size=0, type="dir"))
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return out

    def get_path_info(self, uri: URI) -> FileInfo:
        raise DMLCError("AzureFileSystem is listing-only (as the reference)")

    def open(self, uri: URI, mode: str) -> BinaryIO:
        raise DMLCError("AzureFileSystem is listing-only (as the reference)")


# -- scheme registration (reference io.cc:31-60) -----------------------------
_http_fs = HttpFileSystem("http")
_https_fs = HttpFileSystem("https")
_s3_fs = S3FileSystem()
_gcs_fs = GCSFileSystem()
_hdfs_fs = WebHDFSFileSystem()
_azure_fs = AzureFileSystem()

FS_REGISTRY.register("http", description="HTTP read-only")(lambda: _http_fs)
FS_REGISTRY.register("https", description="HTTPS read-only")(lambda: _https_fs)
FS_REGISTRY.register("s3", description="S3 object store")(lambda: _s3_fs)
FS_REGISTRY.register("gs", description="GCS (S3-compat XML API)")(lambda: _gcs_fs)
FS_REGISTRY.register("hdfs", description="WebHDFS")(lambda: _hdfs_fs)
FS_REGISTRY.register("azure", description="Azure blob (listing)")(lambda: _azure_fs)
