"""The frame wire and the sanctioned raw send.

Counterpart of ``dmlc_core_tpu/transport/frames.py``, reduced to what the
serving server and client, the ingest service and rabit use:
:func:`send_all`, the one blocking send they write through, the ingest
stream's frames, and :func:`pack_obj` / :func:`unpack_obj`, the pickles
of rabit's broadcast payloads (a cohort of both packages' workers reads
either's).  A frame is a 16-byte little-endian header :data:`FRAME`
``<QII`` (meta u64, words u32, rows u32) and ``words * 4`` bytes of
fused int32 payload; ``words == 0`` ends a stream, and ``rows ==``
:data:`NO_ROWS` means the row count is not tracked.  :class:`FrameWriter`
hands a frame's header and payload, with any queued control frames, to
one vectored ``sendmsg``.  The bytes are the JAX package's with no codec
negotiated, so either package's worker feeds the other's loader.

The codecs, the control frames of the negotiation (``CTRL_TRANSPORT``)
and of fd passing (``CTRL_FDPASS``) are ROADMAP queue A.11.b.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import List

from ..utils.metrics import metrics

__all__ = ["FRAME", "NO_ROWS", "FrameWriter", "send_all", "pack_obj",
           "unpack_obj"]

#: (meta u64, words u32, rows u32): the frame header.
FRAME = struct.Struct("<QII")
#: ``rows`` sentinel: the frame does not track a row count.
NO_ROWS = 0xFFFFFFFF


def send_all(sock: socket.socket, data) -> None:
    """Send every byte of ``data``: the one choke point for sends."""
    sock.sendall(data)


def pack_obj(obj) -> bytes:
    """Serialize a control-plane object for the wire (rabit broadcast
    payloads): one choke point instead of scattered ``pickle.dumps``."""
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def unpack_obj(data: bytes):
    """Inverse of :func:`pack_obj` (trusted peers of one cohort only)."""
    return pickle.loads(data)


class FrameWriter:
    """Vectored frame sender for one connection.

    ``send_frame`` hands header and payload (and any queued control
    frames) to one ``sendmsg`` instead of two or more ``sendall`` round
    trips, so the serve path pays one system call a frame.  ``control``
    queues a small frame to ride the next send; ``flush`` sends the
    queue now (the end of a stream).  Queue order is kept, so the byte
    stream is that of sequential sends."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._vectored = hasattr(sock, "sendmsg")
        self._pending: List[bytes] = []
        self._pending_frames = 0
        self._m_coalesced = metrics.counter("transport.frames_coalesced")

    def control(self, meta: int, words: int, rows: int) -> None:
        """Queue a control frame (a header alone, such as the end of a
        stream); it rides the next ``send_frame`` or ``flush``."""
        self._pending.append(FRAME.pack(meta, words, rows))
        self._pending_frames += 1

    def send_frame(self, meta: int, words: int, rows: int, payload) -> int:
        """Send one data frame (``payload``: ``words * 4`` bytes), with
        any queued control frames in the same call.  Returns the bytes
        sent."""
        parts = self._pending + [FRAME.pack(meta, words, rows), payload]
        nframes = 1 + self._pending_frames
        self._pending = []
        self._pending_frames = 0
        return self._send_parts(parts, nframes)

    def flush(self) -> int:
        """Send any queued control frames now (one system call)."""
        if not self._pending:
            return 0
        parts, nframes = self._pending, self._pending_frames
        self._pending = []
        self._pending_frames = 0
        return self._send_parts(parts, nframes)

    def _send_parts(self, parts: List, nframes: int) -> int:
        total = sum(len(p) for p in parts)
        if self._vectored:
            sent = self.sock.sendmsg(parts)
            if sent < total:
                # a partial sendmsg: flatten the tail and finish it
                send_all(self.sock, b"".join(bytes(p) for p in parts)[sent:])
            self._m_coalesced.add(nframes)
        else:
            send_all(self.sock, b"".join(bytes(p) for p in parts))
        return total
