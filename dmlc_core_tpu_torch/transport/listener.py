"""TCP listener skeleton: bind, accept loop, shutdown wake-up.

Counterpart of ``dmlc_core_tpu/transport/listener.py`` without the
``SO_REUSEPORT`` group (the reactor's, ROADMAP queue A.11.b).

The accept helpers tell the two ``OSError`` kinds of ``accept()`` apart:
**fd exhaustion** (``EMFILE``/``ENFILE``/``ENOBUFS``/``ENOMEM``) sleeps
with jitter and retries (counted on ``transport.accept_backoffs``);
anything else is the listener going away and ends the loop.
:func:`serve_connection` is the per-connection thread spawn (counted on
``transport.conn_threads``).  :meth:`Listener.close` shuts the socket
down before it closes it: a thread blocked in ``accept()`` holds a
kernel reference to the listening socket, so a bare ``close()`` would
leave the port accepting.
"""

from __future__ import annotations

import errno
import random
import socket
import threading
import time
from typing import Callable, Optional, Tuple

from ..utils.metrics import metrics

__all__ = ["FD_EXHAUSTION_ERRNOS", "is_fd_exhaustion", "backoff_s",
           "accept_loop", "accept_once", "serve_connection", "Listener"]

#: accept() errnos that mean "out of fds or buffers", not "listener
#: closed": back off and retry instead of ending the accept loop
FD_EXHAUSTION_ERRNOS = frozenset({
    errno.EMFILE, errno.ENFILE, errno.ENOBUFS, errno.ENOMEM})

#: base accept backoff on fd exhaustion, jittered ±50 % a sleep
_BACKOFF_BASE_S = 0.05


def is_fd_exhaustion(exc: BaseException) -> bool:
    return (isinstance(exc, OSError)
            and exc.errno in FD_EXHAUSTION_ERRNOS)


def backoff_s() -> float:
    """One jittered accept-backoff interval."""
    return _BACKOFF_BASE_S * (0.5 + random.random())


def accept_once(srv: socket.socket, *,
                stopping: Optional[Callable[[], bool]] = None,
                tcp_nodelay: bool = True
                ) -> Optional[Tuple[socket.socket, object]]:
    """One blocking accept with the fd-exhaustion backoff: ``(conn,
    addr)``, or None once the listener is closed or ``stopping()`` is
    true (the caller's signal to end its loop)."""
    while True:
        if stopping is not None and stopping():
            return None
        try:
            conn, addr = srv.accept()
        except OSError as e:
            if is_fd_exhaustion(e) and not (stopping and stopping()):
                metrics.counter("transport.accept_backoffs").add(1)
                time.sleep(backoff_s())
                continue
            return None                 # listener closed: shutdown
        if stopping is not None and stopping():
            try:
                conn.close()
            except OSError:
                pass
            return None
        if tcp_nodelay and conn.family != getattr(socket, "AF_UNIX", -1):
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        return conn, addr


def accept_loop(srv: socket.socket,
                on_conn: Callable[[socket.socket, object], None], *,
                stopping: Optional[Callable[[], bool]] = None,
                tcp_nodelay: bool = True) -> None:
    """Loop :func:`accept_once`, hand every connection to ``on_conn``,
    return when the listener closes."""
    while True:
        got = accept_once(srv, stopping=stopping, tcp_nodelay=tcp_nodelay)
        if got is None:
            return
        on_conn(*got)


def serve_connection(target: Callable[..., None], *args,
                     name: str) -> threading.Thread:
    """Start ``target(*args)`` on a named daemon thread: one thread a
    connection."""
    metrics.counter("transport.conn_threads").add(1)
    t = threading.Thread(target=target, args=args, name=name, daemon=True)
    t.start()
    return t


class Listener:
    """One bound listening socket and its stop idiom::

        lst = Listener("127.0.0.1", 0)
        t = lst.spawn(on_conn, name="my-accept")
        ...
        lst.close()     # wakes the accept thread; its loop returns
    """

    def __init__(self, host: str, port: int, *, backlog: int = 64) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(backlog)
        self.backlog = backlog
        self.host, self.port = self.sock.getsockname()[:2]
        self._closed = False

    def accept_loop(self, on_conn, *, stopping=None,
                    tcp_nodelay: bool = True) -> None:
        accept_loop(self.sock, on_conn, stopping=stopping,
                    tcp_nodelay=tcp_nodelay)

    def spawn(self, on_conn, *, name: str, stopping=None,
              tcp_nodelay: bool = True) -> threading.Thread:
        """Start the accept loop on a named daemon thread."""
        t = threading.Thread(
            target=self.accept_loop, args=(on_conn,),
            kwargs={"stopping": stopping, "tcp_nodelay": tcp_nodelay},
            name=name, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        """``shutdown()`` before ``close()``, so that the port stops
        accepting and a reconnecting client gets a refused dial."""
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
