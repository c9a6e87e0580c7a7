"""Socket plumbing of the port (counterpart of ``dmlc_core_tpu/transport``),
reduced to what the serving server and client use: :func:`frames.send_all`
and the :mod:`listener` skeleton.  The codecs, ``FrameWriter``, fd passing
and the reactor come with the serving fleet (ROADMAP queue A.11)."""

from .frames import send_all  # noqa: F401
from .listener import (FD_EXHAUSTION_ERRNOS, Listener,  # noqa: F401
                       accept_loop, accept_once, backoff_s, is_fd_exhaustion,
                       serve_connection)

__all__ = ["send_all", "FD_EXHAUSTION_ERRNOS", "is_fd_exhaustion",
           "backoff_s", "accept_loop", "accept_once", "serve_connection",
           "Listener"]
