"""Socket plumbing of the port (counterpart of ``dmlc_core_tpu/transport``),
reduced to what the serving server and client, the fleet's registry, the
ingest service and rabit use: :func:`frames.send_all`, the frame header
and ``FrameWriter``, the control-plane pickles (``pack_obj``,
``unpack_obj``), :func:`lane.recv_exact_into`, the :mod:`listener`
skeleton and the :mod:`endpoints` lists (``EndpointSet``, sticky
failover with ``control_epoch`` fencing).  The codecs, their
negotiation, fd passing and the reactor come with the fleet's router
(ROADMAP queue A.11.b)."""

from .endpoints import EndpointSet, parse_endpoints  # noqa: F401
from .frames import (FRAME, NO_ROWS, FrameWriter, pack_obj,  # noqa: F401
                     send_all, unpack_obj)
from .lane import recv_exact_into  # noqa: F401
from .listener import (FD_EXHAUSTION_ERRNOS, Listener,  # noqa: F401
                       accept_loop, accept_once, backoff_s, is_fd_exhaustion,
                       serve_connection)

__all__ = ["EndpointSet", "parse_endpoints",
           "send_all", "FRAME", "NO_ROWS", "FrameWriter", "pack_obj",
           "unpack_obj", "recv_exact_into",
           "FD_EXHAUSTION_ERRNOS", "is_fd_exhaustion",
           "backoff_s", "accept_loop", "accept_once", "serve_connection",
           "Listener"]
