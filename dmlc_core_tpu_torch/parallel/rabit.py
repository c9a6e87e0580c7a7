"""Rabit worker client: tracker rendezvous and host-side tree
collectives between processes.

Counterpart of ``dmlc_core_tpu/parallel/rabit.py``, with the same wire:
the tracker's JSON-line commands, the peer handshake (``<q`` rank and
``<q`` link generation; ``-2`` for a tracker control message, one JSON
line), and each collective's blob framed as ``<qQ`` (sequence number,
length) + payload, so a cohort may mix both packages' workers::

    with RabitContext.from_env() as rc:       # DMLC_TRACKER_URI/PORT env
        total = rc.allreduce(np.array([local_sum]))   # tree allreduce
        cfg = rc.broadcast(cfg_bytes, root=0)          # tree broadcast
        rc.tracker_print(f"rank {rc.rank} done")

The tracker assigns the rank and the topology (a binary tree and a
recovery ring) with the neighbours' addresses.  A reduction runs leaf to
root over persistent peer sockets, then root to leaf; broadcast climbs
and descends the same way with a first-non-empty combiner, and
allgather is an allreduce of a one-hot stack.  Collectives take and
return numpy arrays (a card tensor crosses as a host copy).

Recovery: a restarted worker re-registers with ``recover`` and keeps its
rank; the tracker bumps the link generation and pushes ``reset_links``
to the survivors, who drop every peer socket, and the collective in
flight aborts and is retried on the new links.  Each blob carries the
collective's sequence number, so a cohort that diverged fails loudly
(``checkpoint`` / ``load_checkpoint`` / ``resume_seq`` put a reborn
worker back in step).  A heartbeat thread (``DMLC_HEARTBEAT_INTERVAL``)
feeds the tracker's liveness board, and a telemetry thread
(``DMLC_TELEMETRY_INTERVAL``) pushes this process's registry, the
allocator's memory gauges refreshed first; a failed beat or push counts
on ``rabit.heartbeat.failures`` / ``rabit.telemetry.failures`` and
nothing more.

One difference by design: every connect to the tracker is bounded by
``DMLC_IO_CONNECT_TIMEOUT`` (10 s) a try, and a try that timed out is
made again (``retry.rabit.connect.*``, four tries): about one loopback
connect in 1,300 never completes on some hosts.  A refused connect
raises at once.  A second: a link dropped by the reset push (or replaced
by a newer dial) is shut down at once but closed only by the
collective's own thread, before its next collective: closed under a
recv blocked in it, its file descriptor could go to the next accepted
peer, and the recv would wait on that peer's link (a rejoin that hung in
one of the port's CPU cohorts; the JAX client closes at once).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry.graph_introspect import sample_memory
from ..transport.frames import pack_obj, send_all, unpack_obj
from ..utils.logging import (DMLCError, log_info, log_warning,
                             set_log_context)
from ..utils.metrics import metrics
from ..utils.parameter import get_env
from ..utils.retry import RetriesExhausted, RetryPolicy
from .tracker import jittered, recv_json, send_json

__all__ = ["RabitContext"]

#: tries of a tracker connect whose every try timed out
_CONNECT_TRIES = 4


def _connect(addr: Tuple[str, int], timeout: float) -> socket.socket:
    """``socket.create_connection(addr)``, each try bounded by
    ``DMLC_IO_CONNECT_TIMEOUT`` and by ``timeout``; a try that timed out
    is made again, up to :data:`_CONNECT_TRIES`; any other error raises
    at once."""
    attempt_s = min(float(timeout),
                    float(get_env("DMLC_IO_CONNECT_TIMEOUT", 10.0)))
    policy = RetryPolicy(max_attempts=_CONNECT_TRIES, base_delay_s=0.05,
                         max_delay_s=0.5,
                         retryable=lambda e: isinstance(e, TimeoutError),
                         name="rabit.connect")
    try:
        return policy.call(socket.create_connection, addr,
                           timeout=attempt_s)
    except RetriesExhausted as e:
        raise e.__cause__ from None


_OPS: Dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    "sum": np.add,
    "max": np.maximum,
    "min": np.minimum,
    "prod": np.multiply,
}

_CTRL_RANK = -2  # listener handshake sentinel: tracker control message


def _send_blob(sock: socket.socket, payload: bytes, seq: int) -> None:
    send_all(sock, struct.pack("<qQ", seq, len(payload)) + payload)


def _recv_blob(sock: socket.socket, seq: int) -> bytes:
    head = _recv_exact(sock, 16)
    got_seq, n = struct.unpack("<qQ", head)
    payload = _recv_exact(sock, n)
    if got_seq != seq:
        raise DMLCError(
            f"rabit: collective out of sync (expected op #{seq}, peer sent "
            f"#{got_seq}) — the cohort diverged across a mid-collective "
            f"restart; resume from a checkpoint instead")
    return payload


def _enable_keepalive(sock: socket.socket) -> None:
    """Bound dead-HOST detection on blocking peer links: a silent network
    partition (no RST/FIN — NIC death, cable pull) would otherwise hang a
    blocking recv forever, because the tracker-reset interrupter only
    fires when a launcher respawns a worker that exited.  Kernel
    keepalives (~60s idle + 6×10s probes where tunable) surface such a
    partition as an OSError, which re-enters the normal recovery path."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 10),
                     ("TCP_KEEPCNT", 6)):
        if hasattr(socket, opt):
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                getattr(socket, opt), val)
            except OSError:
                pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        try:
            chunk = sock.recv(n - len(out))
        except OSError as e:
            raise DMLCError(f"rabit: peer link lost ({e})") from e
        if not chunk:
            raise DMLCError("rabit: peer closed connection")
        out += chunk
    return bytes(out)


class RabitContext:
    """Worker-side rendezvous + collectives."""

    def __init__(self, tracker_uri: str, tracker_port: int,
                 jobid: Optional[str] = None, recover: bool = False,
                 connect_timeout: float = 60.0, connect_links: bool = True,
                 recover_timeout: float = 120.0,
                 heartbeat_interval: Optional[float] = None,
                 telemetry_interval: Optional[float] = None):
        self.tracker_addr = (tracker_uri, tracker_port)
        self.jobid = jobid or f"job-{os.getpid()}-{socket.gethostname()}"
        self.connect_timeout = connect_timeout
        self.recover_timeout = recover_timeout
        # long backstop recv timeout on PEER links: normally a dead peer is
        # detected via the tracker reset's shutdown(SHUT_RDWR), but if the
        # tracker itself is gone a fully-unbounded recv hangs the collective
        # forever.  Sized well past recover_timeout so a slow-but-alive peer
        # (an elastic-reborn rank redoes its epoch) is never misdiagnosed;
        # DMLC_PEER_RECV_TIMEOUT tunes it, <= 0 restores unbounded recv.
        # A malformed value falls back to the default — worker boot must
        # not crash over an env typo.
        try:
            t = float(get_env("DMLC_PEER_RECV_TIMEOUT",
                              2.0 * recover_timeout))
        except (TypeError, ValueError):
            log_warning("rabit: bad DMLC_PEER_RECV_TIMEOUT=%r; using "
                        "default %.0fs",
                        get_env("DMLC_PEER_RECV_TIMEOUT", None),
                        2.0 * recover_timeout)
            t = 2.0 * recover_timeout
        self.peer_recv_timeout: Optional[float] = None if t <= 0 else t
        # listener for peer links
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(16)
        self._listen_port = self._listener.getsockname()[1]
        self._peer_socks: Dict[int, socket.socket] = {}
        # links shut down by another thread, closed by the collective's
        # own thread (_ensure_links): closing one under a blocked recv
        # would free its fd for the next accept, and the recv would then
        # wait on the new peer's socket
        self._stale: List[socket.socket] = []
        self._sock_gen: Dict[int, int] = {}
        # populated by _register's reply; must EXIST before the accept
        # thread starts — a tracker reset_links push can race ahead of
        # the registration reply and must not kill the accept loop
        self._addresses: Dict[int, Tuple[str, int]] = {}
        self._peer_lock = threading.Lock()
        self._reset_event = threading.Event()
        self._target_gen = 0
        self._seq = 0  # collective sequence number (frame guard)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accepting = True
        self._accept_thread.start()
        self._register(recover)
        # liveness beats to the tracker (cmd=heartbeat) feed its
        # dead-worker monitor; a failed beat is the tracker's problem to
        # notice, never this worker's reason to die.  0 disables.
        if heartbeat_interval is None:
            heartbeat_interval = get_env("DMLC_HEARTBEAT_INTERVAL", 5.0)
        self.heartbeat_interval = float(heartbeat_interval)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if self.heartbeat_interval > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="rabit-heartbeat",
                daemon=True)
            self._hb_thread.start()
        # fleet telemetry: push this process's registry state to the
        # tracker (cmd=telemetry) on a cadence; the tracker merges the
        # per-rank states into its /metrics.  0 (the default) disables.
        if telemetry_interval is None:
            telemetry_interval = get_env("DMLC_TELEMETRY_INTERVAL", 0.0)
        self.telemetry_interval = float(telemetry_interval)
        self._tel_stop = threading.Event()
        self._tel_thread: Optional[threading.Thread] = None
        if self.telemetry_interval > 0:
            self._tel_thread = threading.Thread(
                target=self._telemetry_loop, name="rabit-telemetry",
                daemon=True)
            self._tel_thread.start()
        if connect_links:
            self._connect_links()

    @classmethod
    def from_env(cls, **kw) -> "RabitContext":
        """Bootstrap from the DMLC_* env contract (reference `local.py:21-27`).
        ``DMLC_CONNECT_TIMEOUT``/``DMLC_RECOVER_TIMEOUT`` (seconds) tune the
        link/recovery deadlines without code changes."""
        uri = get_env("DMLC_TRACKER_URI", "127.0.0.1")
        port = get_env("DMLC_TRACKER_PORT", 9091)
        jobid = get_env("DMLC_TASK_ID", None)
        attempt = get_env("DMLC_NUM_ATTEMPT", 0)
        kw.setdefault("connect_timeout",
                      get_env("DMLC_CONNECT_TIMEOUT", 60.0))
        kw.setdefault("recover_timeout",
                      get_env("DMLC_RECOVER_TIMEOUT", 120.0))
        return cls(uri, port, jobid=jobid, recover=attempt > 0, **kw)

    # -- rendezvous --
    def _register(self, recover: bool) -> None:
        sock = _connect(self.tracker_addr, self.connect_timeout)
        send_json(sock, {"cmd": "recover" if recover else "start",
                         "jobid": self.jobid, "port": self._listen_port})
        f = sock.makefile("r")
        sock.settimeout(self.connect_timeout)
        reply = recv_json(f)
        sock.close()
        if reply is not None and "error" in reply:
            raise DMLCError(f"rabit: tracker rejected registration: "
                            f"{reply['error']}")
        if reply is None or "rank" not in reply:
            raise DMLCError(f"rabit: bad tracker reply {reply!r}")
        self.rank: int = reply["rank"]
        self.world_size: int = reply["world"]
        self.parent: int = reply["parent"]
        self.children: List[int] = reply["children"]
        self.ring_prev: int = reply["ring_prev"]
        self.ring_next: int = reply["ring_next"]
        self.generation: int = reply.get("generation", 0)
        self._apply_topology(self.generation,
                             {int(k): tuple(v)
                              for k, v in reply["addresses"].items()})
        # every log record from this process now carries its rank
        set_log_context(rank=self.rank)

    def _apply_topology(self, gen: int,
                        addresses: Dict[int, Tuple[str, int]]) -> None:
        """Apply a rendezvous reply's topology under the peer lock.

        The accept thread is live before registration finishes, so a
        tracker ``reset_links`` push can interleave with the reply;
        ``_handle_ctrl`` mutates ``_target_gen``/``_addresses`` under
        ``_peer_lock`` and this must too — and must never roll a newer
        pushed topology back to the reply's older one."""
        with self._peer_lock:
            if gen >= self._target_gen:
                self._target_gen = gen
                self._addresses = dict(addresses)
            else:
                # a reset_links push raced ahead of this reply: keep the
                # newer pushed addresses, only fill ranks it left unset
                for r, a in addresses.items():
                    self._addresses.setdefault(r, a)

    # -- link management --
    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                head = _recv_exact(conn, 8)
                (peer_rank,) = struct.unpack("<q", head)
                if peer_rank == _CTRL_RANK:
                    self._handle_ctrl(conn)
                    continue
                (gen,) = struct.unpack("<q", _recv_exact(conn, 8))
                _enable_keepalive(conn)
                conn.settimeout(self.peer_recv_timeout)  # same backstop
                # as dial-direction links (see _dial)
                with self._peer_lock:
                    old = self._peer_socks.get(peer_rank)
                    if old is not None:
                        if self._sock_gen.get(peer_rank, -1) > gen:
                            # a stale dial arriving after a newer link was
                            # already established: reject it
                            conn.close()
                            continue
                        self._retire(old)
                    self._peer_socks[peer_rank] = conn
                    self._sock_gen[peer_rank] = gen
            except (DMLCError, OSError, struct.error):
                # a bad handshake (reset, scanner, garbage) must never kill
                # the accept thread — later peers still need to register
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle_ctrl(self, conn: socket.socket) -> None:
        """Tracker control message after the -2 handshake: one JSON line."""
        try:
            msg = recv_json(conn.makefile("r"))
        finally:
            try:
                conn.close()
            except OSError:
                pass
        if not msg or msg.get("cmd") != "reset_links":
            return
        gen = int(msg["generation"])
        addrs = {int(k): tuple(v) for k, v in msg.get("addresses", {}).items()}
        with self._peer_lock:
            if gen <= self._target_gen:
                return
            self._target_gen = gen
            # refresh neighbor addresses (restarted peers moved ports)
            for r in list(self._addresses):
                if r in addrs:
                    self._addresses[r] = addrs[r]
            # drop every pre-reset socket — shutdown(SHUT_RDWR), which
            # (unlike close) interrupts a recv blocked in another thread
            # with EOF; guarantees no stale half-blob survives into the
            # repaired topology
            for r, s in list(self._peer_socks.items()):
                if self._sock_gen.get(r, -1) < gen:
                    self._retire(s)
                    del self._peer_socks[r]
                    self._sock_gen.pop(r, None)
        log_warning("rabit rank %d: link reset to generation %d", self.rank, gen)
        self._reset_event.set()

    def _retire(self, sock: socket.socket) -> None:
        """Shut a link down now and close it later (caller holds the peer
        lock): the collective's thread may be blocked in it."""
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._stale.append(sock)

    def _close_stale(self) -> None:
        with self._peer_lock:
            stale, self._stale = self._stale, []
        for sock in stale:
            try:
                sock.close()
            except OSError:
                pass

    def _connect_links(self) -> None:
        """Dial peers with rank < ours; accept from ranks > ours (a
        deterministic direction avoids double links)."""
        deadline = time.monotonic() + self.connect_timeout
        gen = self.generation
        needed = set(self._addresses)
        for peer in sorted(needed):
            if peer < self.rank:
                with self._peer_lock:
                    have = (peer in self._peer_socks
                            and self._sock_gen.get(peer, -1) >= gen)
                if not have:
                    sock = self._dial(peer, deadline, gen)
                    with self._peer_lock:
                        self._peer_socks[peer] = sock
                        self._sock_gen[peer] = gen
        # wait for inbound from higher ranks
        higher = {p for p in needed if p > self.rank}
        while True:
            with self._peer_lock:
                missing = {p for p in higher
                           if p not in self._peer_socks
                           or self._sock_gen.get(p, -1) < gen}
            if not missing:
                break
            if time.monotonic() > deadline:
                raise DMLCError(f"rabit rank {self.rank}: peers {missing} "
                                f"never connected")
            time.sleep(0.01)

    def _dial(self, peer: int, deadline: float, gen: int) -> socket.socket:
        host, port = self._addresses[peer]
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                # the 5s budget is for CONNECTING only — left on the
                # socket it becomes a 5s recv timeout that misdiagnoses a
                # slow peer as dead (an elastic-reborn rank redoes a whole
                # epoch before its first collective while survivors block
                # in theirs).  Peer DEATH is detected by the tracker
                # reset's shutdown(SHUT_RDWR), which interrupts a blocked
                # recv (see _handle_ctrl); peer_recv_timeout is the long
                # env-tunable backstop for when the tracker is gone too —
                # a timeout flows the same OSError → "peer link lost" →
                # recovery path as a closed link.  Accepted sockets get
                # the identical setting in _accept_loop, so both link
                # directions behave the same
                sock.settimeout(self.peer_recv_timeout)
                _enable_keepalive(sock)
                send_all(sock, struct.pack("<qq", self.rank, gen))
                return sock
            except OSError as e:
                last_err = e
                time.sleep(0.05)
        raise DMLCError(f"rabit rank {self.rank}: cannot reach peer {peer} "
                        f"at {host}:{port}: {last_err}")

    def _sock_to(self, peer: int) -> socket.socket:
        with self._peer_lock:
            sock = self._peer_socks.get(peer)
        if sock is None:
            raise DMLCError(f"rabit rank {self.rank}: no link to {peer}")
        return sock

    def _ensure_links(self) -> None:
        """Repair links when a tracker reset moved the target generation.
        Loops: a newer reset arriving during a repair triggers another
        round (the event is cleared BEFORE the target is read, so a
        concurrent notification is never lost).  Links retired since the
        last collective are closed here, on the thread that used them."""
        self._close_stale()
        while True:
            self._reset_event.clear()
            with self._peer_lock:
                target = self._target_gen
            if target <= self.generation:
                return
            self.generation = target
            self._connect_links()
            log_info("rabit rank %d: links repaired at generation %d",
                     self.rank, target)

    def _with_recovery(self, fn):
        """Run a collective; on link failure wait for the tracker's reset,
        repair links, and retry from local inputs.  Safe because a reset
        closes *every* worker's sockets: an aborted attempt leaves no bytes
        behind, and no worker can have completed the op (the crashed rank's
        contribution is required globally), so all workers re-enter the same
        op — guarded by the frame sequence number."""
        deadline = time.monotonic() + self.recover_timeout
        while True:
            try:
                self._ensure_links()
                return fn()
            except (DMLCError, OSError) as e:
                if "out of sync" in str(e):
                    raise
                if time.monotonic() > deadline:
                    raise
                log_warning("rabit rank %d: collective aborted (%s); awaiting "
                            "link repair", self.rank, e)
                # wait for the tracker's reset notification (the restarted
                # worker must come back up and re-register first); poll the
                # target generation too in case the event was consumed by a
                # concurrent repair round
                while time.monotonic() < deadline:
                    if self._reset_event.wait(timeout=1.0):
                        break
                    with self._peer_lock:
                        if self._target_gen > self.generation:
                            break

    # -- collectives (binary tree: reduce up, broadcast down) --
    def allreduce(self, x: np.ndarray, op: str = "sum") -> np.ndarray:
        fn = _OPS.get(op)
        if fn is None:
            raise DMLCError(f"unknown op {op!r}; have {list(_OPS)}")
        seq = self._seq

        def attempt() -> np.ndarray:
            acc = np.array(x, copy=True)
            for child in self.children:
                contrib = np.frombuffer(_recv_blob(self._sock_to(child), seq),
                                        dtype=acc.dtype).reshape(acc.shape)
                acc = fn(acc, contrib)
            if self.parent >= 0:
                _send_blob(self._sock_to(self.parent), acc.tobytes(), seq)
                acc = np.frombuffer(_recv_blob(self._sock_to(self.parent), seq),
                                    dtype=acc.dtype).reshape(acc.shape)
            for child in self.children:
                _send_blob(self._sock_to(child), acc.tobytes(), seq)
            if not acc.flags.writeable:
                # frombuffer views are read-only; callers mutate results in
                # place (the reference rabit Allreduce is in-place by contract)
                acc = acc.copy()
            return acc

        out = self._with_recovery(attempt)
        self._seq = seq + 1
        return out

    def broadcast(self, obj: Any, root: int = 0) -> Any:
        """Tree broadcast of an arbitrary picklable object from ``root``.

        Same two-phase traffic pattern as allreduce (climb then descend) with
        a 'first non-empty wins' combiner, so arbitrary roots need no special
        routing and every queued blob is always consumed."""
        if self.world_size == 1:
            return obj
        seq = self._seq

        def attempt() -> bytes:
            payload = pack_obj(obj) if self.rank == root else b""
            for child in self.children:
                contrib = _recv_blob(self._sock_to(child), seq)
                if contrib and not payload:
                    payload = contrib
            if self.parent >= 0:
                _send_blob(self._sock_to(self.parent), payload, seq)
                payload = _recv_blob(self._sock_to(self.parent), seq)
            for child in self.children:
                _send_blob(self._sock_to(child), payload, seq)
            return payload

        payload = self._with_recovery(attempt)
        self._seq = seq + 1
        if not payload:
            raise DMLCError(f"broadcast: no payload reached rank {self.rank}")
        return unpack_obj(payload)

    def allgather(self, x: np.ndarray) -> np.ndarray:
        """Gather per-rank arrays to all (via allreduce of a one-hot stack)."""
        x = np.asarray(x)
        stack = np.zeros((self.world_size,) + x.shape, x.dtype)
        stack[self.rank] = x
        return self.allreduce(stack, "sum")

    # -- checkpoint API (rabit CheckPoint/LoadCheckPoint/VersionNumber) --
    def _ckpt_path(self) -> str:
        d = get_env("DMLC_CHECKPOINT_DIR", tempfile.gettempdir())
        # key by tracker address as well as jobid: tracker ports are
        # ephemeral per job, so a later job with the same task ids cannot
        # resurrect a stale checkpoint from a previous run
        tag = f"{self.tracker_addr[0]}_{self.tracker_addr[1]}".replace(
            os.sep, "_")
        return os.path.join(d, f"rabit_ckpt_{tag}_{self.jobid}.pkl")

    def checkpoint(self, state: Any) -> None:
        """Persist app state + the collective sequence number, so a restarted
        worker resumes in lock-step with survivors (rabit's ``CheckPoint``;
        state recovery itself is local-disk here — the reference's
        peer-to-peer ring recovery is downstream rabit, SURVEY §5)."""
        payload = pack_obj({"seq": self._seq, "state": state,
                                "version": getattr(self, "_version", 0) + 1})
        self._version = getattr(self, "_version", 0) + 1
        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self._ckpt_path())

    def load_checkpoint(self) -> Optional[Any]:
        """Restore state saved by :meth:`checkpoint`; fast-forwards the
        collective sequence counter (rabit's ``LoadCheckPoint``).  Returns
        None when no checkpoint exists (fresh start)."""
        try:
            with open(self._ckpt_path(), "rb") as f:
                saved = unpack_obj(f.read())
        except (OSError, pickle.UnpicklingError):
            return None
        self._seq = saved["seq"]
        self._version = saved.get("version", 0)
        return saved["state"]

    @property
    def version_number(self) -> int:
        return getattr(self, "_version", 0)

    @property
    def seq(self) -> int:
        """Collective sequence counter — persist it with externally-stored
        state (CheckpointManager over s3://…) so a worker reborn on a
        DIFFERENT host (node replacement: local disk gone, so
        :meth:`load_checkpoint` has nothing) can :meth:`resume_seq` into
        lock-step with survivors."""
        return self._seq

    def resume_seq(self, seq: int) -> None:
        """Fast-forward the sequence counter after restoring app state from
        a durable checkpoint — the external-store analog of
        :meth:`load_checkpoint`'s seq restore.  Only valid before the first
        post-restart collective; without it a reborn worker's first frame
        trips the survivors' out-of-sync guard and the whole cohort falls
        back to checkpoint-restart (safe, but a full-job bounce)."""
        if self._seq != 0:
            raise DMLCError(
                f"resume_seq after {self._seq} collectives — call it "
                f"immediately after restore, before any allreduce")
        self._seq = int(seq)

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(jittered(self.heartbeat_interval)):
            try:
                self._tracker_cmd({"cmd": "heartbeat", "jobid": self.jobid})
            except OSError:
                # tracker briefly unreachable — beats are best-effort
                metrics.counter("rabit.heartbeat.failures").add(1)

    # -- fleet telemetry --
    def push_telemetry(self) -> None:
        """Push this process's full registry state (mergeable form — see
        ``MetricsRegistry.state``) to the tracker, tagged with our rank.
        Device-memory/live-buffer gauges are refreshed first so the fleet
        view carries the card's memory state (from the caching
        allocator's counters; nothing while CUDA is not initialised)."""
        try:
            sample_memory()
        except Exception:   # sampling must never break the push
            pass
        self._tracker_cmd({"cmd": "telemetry", "jobid": self.jobid,
                           "rank": self.rank, "state": metrics.state()})

    def _telemetry_loop(self) -> None:
        while not self._tel_stop.wait(jittered(self.telemetry_interval)):
            try:
                self.push_telemetry()
            except OSError:
                metrics.counter("rabit.telemetry.failures").add(1)

    # -- misc rabit API --
    def tracker_print(self, msg: str) -> None:
        self._tracker_cmd({"cmd": "print", "msg": msg})

    def shutdown(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        self._tel_stop.set()
        if self._tel_thread is not None:
            self._tel_thread.join(timeout=2.0)
            try:  # final push so the fleet view reflects the full run
                self.push_telemetry()
            except OSError:
                pass
        self._tracker_cmd({"cmd": "shutdown", "jobid": self.jobid})
        try:  # clean exit: the recovery checkpoint is no longer needed
            os.unlink(self._ckpt_path())
        except OSError:
            pass
        self._accepting = False
        try:
            self._listener.close()
        except OSError:
            pass
        with self._peer_lock:
            for sock in self._peer_socks.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._peer_socks.clear()
            self._sock_gen.clear()
        self._close_stale()

    def _tracker_cmd(self, obj: dict) -> None:
        sock = _connect(self.tracker_addr, 10.0)
        sock.settimeout(10.0)
        send_json(sock, obj)
        sock.close()

    def __enter__(self) -> "RabitContext":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
