"""The sanctioned raw send.

Counterpart of ``dmlc_core_tpu/transport/frames.py``, reduced to
:func:`send_all`, the one blocking send the serving server and client
write through.  The frame header, codecs, ``FrameWriter`` and the
control frames are not ported (ROADMAP queue A.11).
"""

from __future__ import annotations

import socket

__all__ = ["send_all"]


def send_all(sock: socket.socket, data) -> None:
    """Send every byte of ``data``: the one choke point for sends."""
    sock.sendall(data)
