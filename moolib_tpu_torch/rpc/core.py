"""The RPC engine: peers, transports, futures, function registry.

The JAX package's ``rpc/core.py`` carried over to the port (wire-compatible
with it), itself a re-design of the reference's RPC core (``src/rpc.{h,cc}``,
``src/transports/``, ``src/moolib.cc`` bindings).  Same capabilities and
Python API:

- ``Rpc``: set_name/listen/connect/define/define_deferred/define_queue/
  undefine/async_/async_callback/sync/set_timeout/set_transports/debug_info
- ``Future`` with ``result/wait/done/cancel/exception`` and asyncio
  ``__await__`` integration
- transports: TCP (``tcp://`` or bare ``host:port``) and Unix-domain sockets
  (``ipc://path``); peers may hold several transports at once and the engine
  picks the lowest-latency one per message (EMA-scored, the analogue of the
  reference's bandit ``src/rpc.cc:640-716``)
- peer discovery by name: greeting exchange on connect plus gossip lookup
  through already-connected peers (reference ``findPeersImpl``
  ``src/rpc.cc:2332-2433``)
- reliability: explicit connections auto-reconnect with backoff, outstanding
  requests are resent on reconnect, receivers deduplicate by (peer-uid, rid)
  for at-most-once execution (reference poke/ack/nack/resend + ``recentIncoming``
  machinery, ``src/rpc.cc:2526-2703``), calls error out after a configurable
  timeout (default 120 s) with ``Call (peer::fn) timed out``.

Architecturally this is *not* a translation: instead of a hand-rolled epoll
poll-thread + lock-free scheduler, each ``Rpc`` runs one asyncio event loop on
a dedicated thread (the IO plane) and dispatches user handlers onto a shared
thread pool (the compute plane).  torch tensors ride the serialization
layer's out-of-band buffer path (host staging), so handlers can freely pass
nests of tensors and numpy arrays.
"""

from __future__ import annotations

import asyncio
import atexit
import collections
import concurrent.futures
import contextlib
import itertools
import math
import os
import random
import struct
import tempfile
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import telemetry, utils
from ..telemetry import tracing as _tracing
from ..utils import nest
from . import serialization

# Process-wide wire metrics (docs/TELEMETRY.md).  Per-Rpc views stay on the
# connection objects (transport_stats/debug_info); the registry carries the
# same counters labeled by transport for exporters and cohort aggregation.
_REG = telemetry.get_registry()
_M_TX_BYTES = _REG.counter(
    "rpc_tx_bytes_total", "bytes sent on the wire (frame payloads)", ("transport",)
)
_M_RX_BYTES = _REG.counter(
    "rpc_rx_bytes_total", "bytes received on the wire", ("transport",)
)
_M_TX_FRAMES = _REG.counter("rpc_tx_frames_total", "frames sent", ("transport",))
_M_RX_FRAMES = _REG.counter("rpc_rx_frames_total", "frames received", ("transport",))
_M_RTT = _REG.histogram(
    "rpc_rtt_seconds", "request->response round trips (clean samples only)",
    ("transport",),
)
_M_PEER_LATENCY = _REG.gauge(
    "rpc_peer_latency_seconds",
    "per-peer-connection latency EMA (the bandit's input)",
    ("peer", "transport"),
)
_M_CALL_ERRORS = _REG.counter(
    "rpc_call_errors_total", "calls completed with an error", ("kind",)
)
_M_NACKS = _REG.counter(
    "rpc_nacks_recovered_total", "requests resent after a receiver NACK"
)
_M_CONNECTS = _REG.counter(
    "rpc_connections_total", "connections registered", ("transport", "direction")
)
_M_QUEUE_DEPTH = _REG.gauge(
    "rpc_queue_depth", "calls waiting in a define_queue", ("queue",)
)
_M_QUEUE_ITEMS = _REG.counter(
    "rpc_queue_items_total", "calls serviced through a define_queue", ("queue",)
)
_M_QUEUE_TAKES = _REG.counter(
    "rpc_queue_takes_total", "service takes (batches) from a define_queue", ("queue",)
)
_M_QUEUE_WAIT = _REG.histogram(
    "rpc_queue_wait_seconds", "enqueue to service start", ("queue",)
)

# Protocol signature; a peer greeting with a different signature is rejected
# (reference kSignature, src/rpc.cc:810). Bumped when wire behavior changes
# incompatibly (0002: keepalive ping/pong + activity-based teardown; 0003:
# max-(initiator_uid, dial_seq) duplicate-connection tie-break — mixed
# versions would deterministically keep DIFFERENT duplicates and flap;
# 0004: poke/ack/nack fast recovery frames; 0005: request header grew a
# 2-byte trace-context length + optional 24-byte trace block after the fn
# name — an 0004 peer would parse trace bytes as payload).
SIGNATURE = 0x6D6F6F5450550005

KIND_GREETING = 1
KIND_REQUEST = 2
KIND_RESPONSE = 3
KIND_ERROR = 4
KIND_KEEPALIVE = 5
# Fast recovery (reference poke/ack/nack, src/rpc.cc:2526-2703): after a
# short silence the sender POKEs ("do you have rid X?"); the receiver
# re-sends the cached response, ACKs ("executing"), or NACKs ("never saw
# it") — a NACK triggers an immediate resend, so a dropped frame recovers at
# RTT scale instead of blind-resend scale.
KIND_POKE = 6
KIND_ACK = 7
KIND_NACK = 8

_DEFAULT_TIMEOUT = 120.0
# Keepalive cadence (reference: keepalives after idle, teardown of
# unresponsive connections, src/rpc.cc:1625-1665). A connection that has
# received nothing for _CONN_DEAD seconds while we kept pinging it is torn
# down; explicit connections then auto-reconnect.
_KEEPALIVE_IDLE = 4.0
_KEEPALIVE_INTERVAL = 2.0
_CONN_DEAD = 16.0
# Fast-recovery cadence: poke a silent rid after _POKE_AFTER; blind-resend
# the full request only if nothing (ack/nack/response) came back for
# _RESEND_BLIND — the fallback for lost control frames.
_POKE_AFTER = 0.75
_RESEND_BLIND = 9.0
# A connection whose peer has not greeted it this long after it opened is
# half-open: the greeting was lost (each side sends its own once, on open).
# The side without the greeting has no peer entry for it, while the other
# side holds it as that peer's live connection and keeps it over every later
# dial by the duplicate tie-break.  It is closed, so the other side drops it
# too and the next dial wins.  The JAX package keeps such links open.
_GREET_DEADLINE = 4.0
# Frames at least this large ride the memfd zero-copy path on ipc://
# connections between fd-passing-capable native peers.
_MEMFD_MIN = 1024 * 1024


class RpcError(RuntimeError):
    """Custom exception for Rpc errors (matches reference ``RpcError``)."""


class FrameTooLargeError(RpcError):
    """Payload exceeds the 4 GiB wire-frame limit (u32 length prefix).

    Permanent for a given payload: callers must NOT treat it as a dead
    connection (closing + resending would flap the link forever)."""


class Future:
    """Thread-safe future with asyncio interop, mirroring the reference's
    ``FutureWrapper`` (``src/moolib.cc:316-392``)."""

    __slots__ = ("_event", "_result", "_exc", "_callbacks", "_lock", "_cancelled")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable] = []
        self._lock = threading.Lock()
        self._cancelled = False

    # -- producer side ----------------------------------------------------
    def set_result(self, value) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = value
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exc = exc
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    # -- consumer side ----------------------------------------------------
    def result(self, timeout: Optional[float] = None):
        self.wait(timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError("Future timed out")

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        self._cancelled = True
        self.set_exception(RpcError("Future cancelled"))

    def exception(self) -> Optional[BaseException]:
        if self._event.is_set():
            return self._exc
        return None

    def add_done_callback(self, cb: Callable) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def __await__(self):
        loop = asyncio.get_event_loop()
        af = loop.create_future()

        def _done(self_, loop=loop, af=af):
            def _transfer():
                if af.cancelled():
                    return
                if self_._exc is not None:
                    af.set_exception(self_._exc)
                else:
                    af.set_result(self_._result)

            loop.call_soon_threadsafe(_transfer)

        self.add_done_callback(_done)
        return af.__await__()

    __iter__ = __await__


class RpcDeferredReturn:
    """Callable handed to deferred handlers; calling it sends the response."""

    __slots__ = ("_send", "_sent")

    def __init__(self, send: Callable[[Any, Optional[str]], None]):
        self._send = send
        self._sent = False

    def __call__(self, value=None) -> None:
        if self._sent:
            raise RpcError("RpcDeferredReturn called twice")
        self._sent = True
        self._send(value, None)

    def error(self, message: str) -> None:
        if self._sent:
            raise RpcError("RpcDeferredReturn called twice")
        self._sent = True
        self._send(None, message)


def _chunk_len(c) -> int:
    return c.nbytes if isinstance(c, memoryview) else len(c)


def _request_chunks(
    rid: int, fn_name: str, body: List[bytes], timeout_s: float, trace: bytes = b""
) -> List[bytes]:
    """Single source of truth for the request frame layout. The sender's
    call timeout travels with the request so the receiver can size its
    at-most-once dedup window to outlive every possible resend.  ``trace``
    is the encoded trace context (24 bytes when a trace is active, empty
    otherwise — untraced calls pay zero extra wire bytes beyond the length
    field)."""
    fnb = fn_name.encode()
    hdr = struct.pack(
        "<BQIHH",
        KIND_REQUEST,
        rid,
        min(int(timeout_s), 0xFFFFFFFF),
        len(fnb),
        len(trace),
    )
    return [hdr + fnb + trace] + body


def _trace_for_request():
    """Trace-context capture for one outgoing request.  Returns
    ``(wire_bytes, call_ctx, parent_ctx)``: a fresh child context whose
    span id becomes the ``rpc.call`` span (and the remote handler's
    parent), or ``(b"", None, None)`` when the calling thread has no
    active trace."""
    parent = _tracing.current_context()
    if parent is None:
        return b"", None, None
    call = parent.child()
    return _tracing.encode_context(call), call, parent


def _record_call_span(out: "_Outgoing", peers: Optional[int] = None) -> None:
    """Record the client-side ``rpc.call`` span when the response future
    resolves.  The span id matches what rode the wire, so the remote
    ``rpc.recv`` span's parent edge lands on it in a merged trace."""
    trace_id, span_id, parent_id = out.trace_parent
    args = {"peer": out.peer_name, "rid": out.rid}
    if peers is not None:
        args["peers"] = peers
    _tracing.get_tracer().record(
        f"rpc.call {out.fn_name}",
        out.t0_ns,
        time.perf_counter_ns() - out.t0_ns,
        trace_id=trace_id,
        span_id=span_id,
        parent_id=parent_id,
        args=args,
    )


# Shared no-op context manager: untraced requests skip span creation
# entirely (nullcontext is reusable and reentrant).
_NULL_CM = contextlib.nullcontext()


def _recv_span(fn_name: str, tctx, rid=None):
    """Child span for handler execution under a remote caller's context;
    a no-op when the request carried none."""
    if tctx is None:
        return _NULL_CM
    args = {} if rid is None else {"rid": rid}
    return _tracing.child_span(f"rpc.recv {fn_name}", tctx, **args)


def _record_resend_span(out: "_Outgoing", why: str) -> None:
    """Record a retry as a SIBLING of the rpc.call span (fresh span id,
    same parent) — resends stay visible in the trace without duplicating
    the call span's id.  Instant event (no meaningful duration)."""
    if out.trace_parent is None:
        return
    trace_id, _span_id, parent_id = out.trace_parent
    _tracing.get_tracer().record(
        f"rpc.resend {out.fn_name}",
        time.perf_counter_ns(),
        0,
        trace_id=trace_id,
        span_id=_tracing.new_span_id(),
        parent_id=parent_id,
        args={"peer": out.peer_name, "rid": out.rid, "why": why},
    )


def _local_addresses() -> List[str]:
    """Addresses to advertise for a wildcard listen: real interfaces first,
    loopback last (reference: deviceAddresses gathering for the greeting)."""
    import socket as _socket

    addrs: List[str] = []
    try:
        host = _socket.gethostname()
        for ip in _socket.gethostbyname_ex(host)[2]:
            if not ip.startswith("127.") and ip not in addrs:
                addrs.append(ip)
    except OSError:
        pass
    try:
        # UDP-connect trick: finds the IP of the default route interface.
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        if not ip.startswith("127.") and ip not in addrs:
            addrs.insert(0, ip)
    except OSError:
        pass
    addrs.append("127.0.0.1")
    return addrs


_BOOT_ID: Optional[str] = None


def _boot_id() -> str:
    """Machine identity for same-host detection (the reference's network key
    is the boot id too, ``src/transports/ipc.cc:280-315`` getNetworkKey).
    When the boot id is unreadable, fall back to a per-process random value:
    Rpcs in this process still match each other (genuinely same host), while
    cross-process peers never match — the upgrade quietly disables rather
    than treating two arbitrary machines as same-host."""
    global _BOOT_ID
    if _BOOT_ID is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _BOOT_ID = f.read().strip()
        except OSError:
            _BOOT_ID = f"noboot-{utils.create_uid()}"
    return _BOOT_ID


def parse_address(addr: str) -> Tuple[str, Any]:
    """Parse "tcp://host:port", "ipc://path", "host:port", ":port"."""
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://") :]
    elif addr.startswith("ipc://"):
        return ("ipc", addr[len("ipc://") :])
    elif addr.startswith("shm://"):
        # The reference advertises a shared-memory transport; we map it onto a
        # unix socket in the abstract namespace-ish tmp path.
        return ("ipc", f"/tmp/moolib_tpu_shm_{addr[len('shm://'):]}")
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise RpcError(f"cannot parse address {addr!r}")
    return ("tcp", (host or "0.0.0.0", int(port)))


class _Connection:
    """One live stream (tcp or ipc) to a remote peer."""

    __slots__ = (
        "transport",
        "reader",
        "writer",
        "rpc",
        "peer_name",
        "peer_uid",
        "send_count",
        "recv_count",
        "bytes_out",
        "bytes_in",
        "latency",
        "bandit",
        "bandit_t",
        "created",
        "last_recv",
        "last_keepalive",
        "closed",
        "inbound",
        "initiator_uid",
        "conn_seq",
        "_explicit_addr",
        "_m_tx_bytes",
        "_m_rx_bytes",
        "_m_tx_frames",
        "_m_rx_frames",
        "_m_rtt",
        "_m_peer_lat",
    )

    def __init__(self, transport: str, reader, writer, inbound: bool = False):
        self.transport = transport
        self.reader = reader
        self.writer = writer
        self.inbound = inbound
        # Bind the registry children once (per-frame cost is one locked add).
        self._m_tx_bytes = _M_TX_BYTES.labels(transport=transport)
        self._m_rx_bytes = _M_RX_BYTES.labels(transport=transport)
        self._m_tx_frames = _M_TX_FRAMES.labels(transport=transport)
        self._m_rx_frames = _M_RX_FRAMES.labels(transport=transport)
        self._m_rtt = _M_RTT.labels(transport=transport)
        self._m_peer_lat = None  # bound on first RTT (peer name from greeting)
        _M_CONNECTS.inc(
            transport=transport, direction="inbound" if inbound else "outbound"
        )
        # Owning Rpc (set at dial/accept).  Gives the ``send_frame`` fault
        # seam the SENDER's identity, so a simulated network partition
        # (testing.faults.Partition) can drop frames by (sender, receiver)
        # pair even with many Rpcs in one process.
        self.rpc = None
        self.peer_name: Optional[str] = None
        self.peer_uid: Optional[str] = None
        self.send_count = 0
        self.recv_count = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.latency: Optional[float] = None  # EMA seconds
        # Bandit value in [-1, 1] (reference banditValue, src/rpc.cc:640-716):
        # nudged up when this transport currently has the peer's best latency,
        # down otherwise, with time decay; transport choice is a softmax over
        # exp(bandit * 4), so the loser still gets occasional probe traffic
        # and can win back after a regime change.
        self.bandit = 0.0
        self.bandit_t = 0.0
        self.created = time.monotonic()
        self.last_recv = time.monotonic()
        self.last_keepalive = 0.0
        # Duplicate-connection tie-break identity: who dialed, and that
        # side's dial sequence number (set at dial for outbound, from the
        # greeting for inbound). Both ends keep the max — deterministic.
        self.initiator_uid: Optional[str] = None
        self.conn_seq = 0
        self.closed = False
        self._explicit_addr: Optional[str] = None

    def send_frame(self, chunks: List[bytes]) -> None:
        # Coalesce the frame into ONE buffer and issue a single write().
        # Feeding many chunks into the transport triggers CPython 3.12's
        # sendmsg multi-buffer accounting bug (gh: "pop from an empty deque"
        # in _adjust_leftover_buffer), which corrupts the stream under load.
        # One memcpy per frame also beats the sendmsg path on throughput.
        total = sum(_chunk_len(c) for c in chunks)
        if total > 0x7FFFFFFF:
            # Bit 31 of the length prefix is the memfd-frame flag (native
            # transport); both backends cap regular frames at 2 GiB - 1.
            raise FrameTooLargeError(f"frame of {total} bytes exceeds the 2 GiB limit")
        buf = bytearray(4 + total)
        struct.pack_into("<I", buf, 0, total)
        off = 4
        for c in chunks:
            if isinstance(c, memoryview) and c.ndim != 1:
                c = c.cast("B")
            n = _chunk_len(c)
            buf[off : off + n] = c
            off += n
        self.writer.write(buf)
        self.send_count += 1
        self.bytes_out += total
        self._m_tx_frames.inc()
        self._m_tx_bytes.inc(total)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.writer.close()
            except Exception:
                pass


class _NativeConnection(_Connection):
    """A stream owned by the native epoll engine (``native/transport.cc``).

    Same duck type as ``_Connection``; frames go out through the C engine
    (which adds the 4-byte length prefix and batches writes with writev),
    and arrive via engine callbacks instead of an asyncio read loop.
    """

    __slots__ = ("net", "conn_id", "rx_seen", "tx_seen")

    def __init__(self, net, conn_id: int, transport: str, rpc, inbound: bool = False):
        super().__init__(transport, None, None, inbound=inbound)
        self.net = net
        self.conn_id = conn_id
        self.rpc = rpc
        self.rx_seen = -1  # engine byte counters at last liveness check
        self.tx_seen = -1

    def send_frame(self, chunks: List[bytes]) -> None:
        total = sum(_chunk_len(c) for c in chunks)
        if total > 0x7FFFFFFF:
            raise FrameTooLargeError("frame exceeds the 2 GiB limit")
        # Same-host zero-copy: large frames to an fd-passing-capable peer on
        # a unix socket ride an anonymous memfd + SCM_RIGHTS — the payload
        # never crosses the socket buffers (VERDICT round-1 ask #8;
        # reference groundwork src/memory/memfd.cc + sendFd).
        if total >= _MEMFD_MIN and self.transport == "ipc":
            peer = self.rpc._peers.get(self.peer_name) if self.peer_name else None
            if peer is not None and peer.fdp_ok:
                if self.net.send_memfd(self.conn_id, chunks):
                    self.send_count += 1
                    self.bytes_out += total
                    self._m_tx_frames.inc()
                    self._m_tx_bytes.inc(total)
                    return
        if not self.net.send_iov(self.conn_id, chunks):
            raise RpcError("native send failed (engine destroyed or conn gone)")
        self.send_count += 1
        self.bytes_out += total
        self._m_tx_frames.inc()
        self._m_tx_bytes.inc(total)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.net.close_conn(self.conn_id)
            # Explicit closes get no engine callback; detach ourselves.
            self.rpc._native_forget(self.conn_id)


class _Peer:
    __slots__ = (
        "name",
        "uid",
        "connections",
        "addresses",
        "pending",
        "recent",
        "executing",
        "find_inflight",
        "native_ok",
        "fdp_ok",
        "upgrade_attempts",
    )

    def __init__(self, name: str):
        self.name = name
        self.uid: Optional[str] = None
        # ipc addresses we dialed for same-host transport upgrade -> when.
        self.upgrade_attempts: Dict[str, float] = {}
        # Whether the peer can decode the native codec (negotiated in the
        # greeting; until/unless true we send pickle-codec payloads).
        self.native_ok = False
        # Whether the peer's transport engine can receive SCM_RIGHTS memfd
        # frames (native engine only; negotiated in the greeting).
        self.fdp_ok = False
        self.connections: Dict[str, _Connection] = {}
        self.addresses: List[str] = []
        self.pending: List["_Outgoing"] = []  # waiting for a connection
        self.recent: Dict[int, Tuple[float, List[bytes]]] = {}  # rid -> (ts, resp chunks)
        self.executing: set = set()
        self.find_inflight = False

    def best_connection(self, order: List[str], big: bool = False) -> Optional[_Connection]:
        """Pick the transport for one message: softmax over per-connection
        bandit values (reference banditSend, ``src/rpc.cc:640-716``) —
        mostly-exploit with a sliver of exploration so a transport that went
        bad (or got one unlucky sample) keeps producing fresh latency data.

        ``big`` payloads (at/above the memfd zero-copy threshold) pick a live
        ipc connection outright: the latency bandit can't see throughput, and
        a same-host unix stream with SCM_RIGHTS memfd frames always beats
        loopback TCP on bytes/sec — size-aware selection is the upgrade over
        the reference's latency-only bandit.
        """
        if big:
            c = self.connections.get("ipc")
            if c is not None and not c.closed:
                return c
        conns = [c for c in self.connections.values() if not c.closed]
        if not conns:
            return None
        if len(conns) == 1:
            return conns[0]
        # Unmeasured connections start at the configured preference order
        # (ipc beats tcp locally) via a small bandit prior.
        def weight(c: _Connection):
            prior = 0.0
            if c.latency is None and c.transport in order:
                prior = 0.25 * (len(order) - order.index(c.transport)) / len(order)
            return math.exp((c.bandit + prior) * 4.0)

        ws = [weight(c) for c in conns]
        t = random.random() * sum(ws)
        for c, w in zip(conns, ws):
            t -= w
            if t <= 0:
                return c
        return conns[-1]

    def note_latency(self, conn: _Connection, rtt: float) -> None:
        """Fold one RTT sample into the connection's EMA and re-score the
        bandit values of every live connection to this peer (the analogue of
        the reference's addLatency, ``src/rpc.cc:2448-2486``)."""
        conn.latency = rtt if conn.latency is None else conn.latency * 0.9 + rtt * 0.1
        conn._m_rtt.observe(rtt)
        if conn.peer_name:
            # The EMA the bandit scores on, readable through the registry;
            # debug_info stays a view.  Bound lazily: the peer name only
            # exists after the greeting.
            if conn._m_peer_lat is None:
                conn._m_peer_lat = _M_PEER_LATENCY.labels(
                    peer=conn.peer_name, transport=conn.transport
                )
            conn._m_peer_lat.set(conn.latency)
        measured = [
            c
            for c in self.connections.values()
            if not c.closed and c.latency is not None
        ]
        if len(measured) < 2:
            return
        best = min(measured, key=lambda c: c.latency)
        now = time.monotonic()
        for c in measured:
            dt = now - (c.bandit_t or now)
            c.bandit *= 0.9375 ** min(dt, 60.0)
            c.bandit += 0.125 if c is best else -0.125
            c.bandit = max(-1.0, min(1.0, c.bandit))
            c.bandit_t = now


class _Outgoing:
    __slots__ = (
        "rid",
        "peer_name",
        "fn_name",
        "chunks",
        "chunks_portable",
        "payload_obj",
        "future",
        "deadline",
        "sent_at",
        "timeout_s",
        "resent",
        "parked",
        "last_probe",
        "acked_at",
        "peers_pending",
        "trace",
        "trace_parent",
        "t0_ns",
    )

    def __init__(self, rid, peer_name, fn_name, chunks, payload_obj, future, deadline):
        self.rid = rid
        self.peer_name = peer_name
        self.fn_name = fn_name
        self.chunks = chunks  # native-or-python encoding (sender's default)
        self.chunks_portable = None  # lazily built pickle-codec encoding
        self.payload_obj = payload_obj  # retained for portable re-encode
        self.future = future
        self.deadline = deadline
        self.sent_at = time.monotonic()
        self.timeout_s = _DEFAULT_TIMEOUT
        self.resent = False  # RTT samples from resent requests are ambiguous
        self.parked = False  # already waiting in peer.pending
        self.last_probe = 0.0  # last POKE sent for this rid
        self.acked_at = 0.0  # receiver confirmed it is executing
        # Broadcast requests (async_broadcast): the peers that have not
        # responded yet.  One rid + one serialized frame fan out to all of
        # them (receiver dedup is per (peer, rid), so the shared rid is
        # unambiguous); None for ordinary single-peer requests.
        self.peers_pending: Optional[set] = None
        # Distributed-tracing state: the encoded context bytes riding the
        # wire (threaded through portable re-encodes), the (trace_id,
        # span_id, parent_id) of the rpc.call span to record at completion,
        # and the send-time perf_counter_ns.  All None/b"" when untraced.
        self.trace = b""
        self.trace_parent = None
        self.t0_ns = 0


class _FnDef:
    __slots__ = ("name", "fn", "kind", "batch_size", "dynamic", "batch_state", "inline")

    def __init__(self, name, fn, kind, batch_size=None, dynamic=False, inline=False):
        self.name = name
        self.fn = fn
        self.kind = kind  # "plain" | "deferred" | "queue" | "batched"
        self.batch_size = batch_size
        self.dynamic = dynamic
        self.batch_state: List = []  # collected calls for kind=="batched"
        # Inline handlers run synchronously on the receiving IO thread with
        # BORROWED argument arrays (zero-copy views over the receive buffer,
        # valid only for the duration of the call) — the hot path of the
        # bucketed gradient combine.  See Rpc.define.
        self.inline = inline


_ADOPT = threading.local()
_ADOPT.ctx = None

# True while testing.faults.FrameFaults wraps the send_frame seam: the
# memfd-multicast broadcast fast path (which bypasses per-connection
# send_frame) steps aside so every frame stays visible to fault injection.
frame_seam_hooked = False


def adopt_current_frame():
    """Take ownership of the memfd mapping behind the frame currently being
    delivered on THIS thread (valid only inside an inline RPC handler on the
    native transport).  Returns a uint8 numpy array over the mapping — alive
    for the array's own lifetime, munmap'd by a GC finalizer — or None when
    the current frame is not an adoptable mapping (small copied frames, TCP,
    asyncio transport).  This is the zero-copy receive terminus of the
    flat-bucket data plane: the allreduce share result stays in the shared
    memfd pages instead of being copied out."""
    ctx = getattr(_ADOPT, "ctx", None)
    if ctx is None:
        return None
    net, frame = ctx
    if net is None:
        return None
    arr = net.adopt_frame(frame)
    if arr is not None:
        # One adoption per frame: further calls (other arrays in the same
        # payload) must go through the first adopter.
        _ADOPT.ctx = (None, None)
    return arr


_live_rpcs: "weakref.WeakSet[Rpc]" = weakref.WeakSet()


def _close_live_rpcs():
    """atexit: close every Rpc the user leaked (reference leak tracking +
    atexit cleanup, src/moolib.cc:127-183). Engines must stop BEFORE the
    interpreter finalizes — a C++ epoll thread calling back into a
    finalizing interpreter aborts."""
    for rpc in list(_live_rpcs):
        try:
            rpc.close()
        except Exception:  # noqa: BLE001 - best effort at shutdown
            pass


atexit.register(_close_live_rpcs)


class Queue:
    """Incoming-call queue created by ``Rpc.define_queue``.

    Awaiting (or iterating) yields ``(return_callback, args, kwargs)``; with
    ``batch_size`` set, args/kwargs arrive stacked along dim 0 across callers
    and the return callback unstacks the response back to each caller
    (reference ``QueueWrapper`` ``src/moolib.cc:426-576,1122-1178``).
    """

    def __init__(
        self,
        batch_size: Optional[int] = None,
        dynamic_batching: bool = False,
        name: str = "anon",
    ):
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._waiters: collections.deque = collections.deque()  # (loop, asyncio.Future)
        self._batch_size = batch_size
        self._dynamic = dynamic_batching
        # Cumulative service-quality counters (serve_bench reads these to
        # make the batching crossover visible: how full batches run and how
        # long calls sat queued before service).  The same numbers feed the
        # process registry labeled by queue name — stats() stays the
        # per-instance view, the registry the exported one.
        self._stats = {
            "items": 0, "takes": 0, "wait_s_sum": 0.0, "wait_s_max": 0.0,
            "depth_max": 0,
        }
        self._m_depth = _M_QUEUE_DEPTH.labels(queue=name)
        self._m_items = _M_QUEUE_ITEMS.labels(queue=name)
        self._m_takes = _M_QUEUE_TAKES.labels(queue=name)
        self._m_wait = _M_QUEUE_WAIT.labels(queue=name)

    # producer (rpc engine or user's enqueue) ------------------------------
    def enqueue(self, return_callback, args=None, kwargs=None) -> None:
        with self._lock:
            self._items.append((return_callback, args or (), kwargs or {}, time.monotonic()))
            self._stats["depth_max"] = max(self._stats["depth_max"], len(self._items))
            # inc/dec (not set): instances sharing a queue name — two peers
            # in one process defining the same fn — then SUM to a meaningful
            # process-wide depth instead of last-writer-wins clobbering.
            self._m_depth.inc()
            self._maybe_wake_locked()

    def _maybe_wake_locked(self) -> None:
        need = 1 if (self._batch_size is None or self._dynamic) else self._batch_size
        while self._waiters and len(self._items) >= need:
            loop, af = self._waiters.popleft()
            batch = self._take_locked()
            loop.call_soon_threadsafe(_set_async_result, af, batch)

    def _account_locked(self, calls) -> list:
        now = time.monotonic()
        s = self._stats
        s["takes"] += 1
        s["items"] += len(calls)
        self._m_takes.inc()
        self._m_items.inc(len(calls))
        self._m_depth.dec(len(calls))
        for c in calls:
            wait = now - c[3]
            s["wait_s_sum"] += wait
            s["wait_s_max"] = max(s["wait_s_max"], wait)
            self._m_wait.observe(wait)
        return [c[:3] for c in calls]

    def _take_locked(self):
        if self._batch_size is None:
            return self._account_locked([self._items.popleft()])[0]
        n = len(self._items) if self._dynamic else self._batch_size
        n = min(n, self._batch_size, len(self._items))
        calls = self._account_locked([self._items.popleft() for _ in range(n)])
        return _batch_calls(calls)

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> Dict[str, float]:
        """Cumulative queue service counters: ``items`` serviced, service
        ``takes`` (batches — average batch fill is items/takes), queue
        ``wait_s_sum``/``wait_s_max`` (enqueue to service start), and
        high-water ``depth_max``.  Thin per-instance view; the same numbers
        export through the registry as ``rpc_queue_*{queue=<name>}``
        (docs/TELEMETRY.md)."""
        with self._lock:
            return dict(self._stats)

    def __await__(self):
        loop = asyncio.get_event_loop()
        af = loop.create_future()
        with self._lock:
            need = 1 if (self._batch_size is None or self._dynamic) else self._batch_size
            if len(self._items) >= need:
                batch = self._take_locked()
                af.set_result(batch)
            else:
                self._waiters.append((loop, af))
        return af.__await__()

    __iter__ = __await__


def _set_async_result(af, value):
    if not af.cancelled():
        af.set_result(value)


def _batch_calls(calls):
    """Stack N collected calls into one batched call + unstacking return cb."""
    rets = [c[0] for c in calls]
    argss = [c[1] for c in calls]
    kwargss = [c[2] for c in calls]
    n = len(calls)
    if n == 1:
        return calls[0]
    batched_args = tuple(nest.stack([a for a in argss], dim=0)) if argss[0] else ()
    batched_kwargs = nest.stack([k for k in kwargss], dim=0) if kwargss[0] else {}

    def return_callback(value):
        parts = nest.unstack(value, dim=0)
        for ret, part in zip(rets, parts):
            ret(part)

    def error(message: str) -> None:
        # Fail every caller stacked into this batch (mirrors
        # RpcDeferredReturn.error so queue consumers can error uniformly).
        for ret in rets:
            ret.error(message)

    return_callback.error = error
    # Per-caller returns, row-aligned with the stacked batch: consumers that
    # need sub-batch blast-radius control (serving's unbatched retry of a
    # poisoned batch) answer callers individually instead of failing all.
    return_callback.rets = rets
    return (return_callback, batched_args, batched_kwargs)


class Rpc:
    """An RPC peer. See module docstring for the design.

    Concurrency model (mirrors the reference's poll-thread + fine-grained
    locking rather than pure loop confinement): ``_state`` guards all engine
    state (peers, outgoing, connections). With the native transport, frames
    are processed directly on the C++ epoll thread under ``_state`` — no
    cross-thread hop on the hot path. Futures complete *outside* ``_state``
    (their done-callbacks take caller locks). The asyncio fallback keeps all
    socket writes on the loop thread (asyncio transports are not
    thread-safe), so there sends marshal onto the loop as before.
    """

    def __init__(self):
        self._name = utils.create_uid()
        self._uid = utils.create_uid()
        self._timeout = _DEFAULT_TIMEOUT
        # Which remote failures are reported back to the caller (reference
        # ExceptionMode None/DeserializationOnly/All, src/rpc.h:201-205).
        # Default "all": handler exceptions return as RpcError with the full
        # remote traceback — richer than the reference's default.
        self._exception_mode = "all"
        self._state = threading.RLock()
        self._transport_order = ["ipc", "tcp"]
        self._functions: Dict[str, _FnDef] = {}
        self._peers: Dict[str, _Peer] = {}
        self._conns: List[_Connection] = []
        self._servers: List = []
        self._listen_addrs: List[str] = []
        self._explicit: List[str] = []
        self._rid = itertools.count(1)
        self._dial_seq = itertools.count(1)
        self._outgoing: Dict[int, _Outgoing] = {}
        self._nacks_recovered = 0  # requests resent on receiver NACK
        self._closed = False
        self._functions["__moolib_find_peer"] = _FnDef(
            "__moolib_find_peer", self._find_peer_handler, "plain"
        )
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=utils.get_max_threads() or min(32, (os.cpu_count() or 4))
        )
        # Warm the native codec here (user thread): first use compiles with
        # g++; doing it lazily would block the IO event loop mid-greeting.
        serialization.native_available()
        # Native epoll IO engine (C++), with asyncio fallback. The engine owns
        # the sockets; protocol state stays on the asyncio loop thread.
        self._net = None
        self._native_conns: Dict[int, _NativeConnection] = {}
        self._connect_reqs: Dict[int, Any] = {}
        self._connect_req_counter = itertools.count(1)
        if os.environ.get("MOOLIB_TPU_NATIVE_TRANSPORT", "1") != "0":
            try:
                from ..native.transport import NativeNet

                self._net = NativeNet(
                    self._net_on_accept,
                    self._net_on_frame,
                    self._net_on_close,
                    self._net_on_connect,
                )
            except Exception:  # noqa: BLE001 - fall back to asyncio sockets
                self._net = None
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop_main, name="moolib-rpc", daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()
        _live_rpcs.add(self)

    # ------------------------------------------------------------------ loop
    def _loop_main(self):
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        self._loop.create_task(self._timeout_task())
        try:
            self._loop.run_forever()
        finally:
            try:
                pending = asyncio.all_tasks(self._loop)
                for t in pending:
                    t.cancel()
                self._loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
            except Exception:
                pass
            self._loop.close()

    def _call_in_loop(self, fn, *args):
        if threading.current_thread() is self._thread:
            fn(*args)
        else:
            try:
                self._loop.call_soon_threadsafe(fn, *args)
            except RuntimeError:
                pass  # loop shut down

    def _spawn(self, coro_factory):
        """Schedule a coroutine on the engine loop from any thread."""
        if threading.current_thread() is self._thread:
            self._loop.create_task(coro_factory())
        else:
            try:
                self._loop.call_soon_threadsafe(
                    lambda: self._loop.create_task(coro_factory())
                )
            except RuntimeError:
                pass

    # ------------------------------------------------------------------ api
    def set_name(self, name: str) -> None:
        self._name = str(name)

    def get_name(self) -> str:
        return self._name

    def set_timeout(self, seconds: float) -> None:
        self._timeout = float(seconds)

    def set_transports(self, transports: List[str]) -> None:
        self._transport_order = list(transports)

    def set_exception_mode(self, mode: str) -> None:
        """Choose which remote failures travel back to callers (reference
        ``Rpc::setExceptionMode``, ``src/rpc.h:201-205``):

        - ``"none"``: nothing is reported; a failing call times out on the
          caller while the host logs the error.
        - ``"deserialization"``: only argument-deserialization errors are
          reported (the reference's default); handler exceptions are logged
          host-side and the call times out.
        - ``"all"`` (default): handler exceptions are reported with the full
          remote traceback text.

        Unknown-function errors are protocol-level and always reported.
        Swallowed failures leave the request uncached, so a sender resend
        may re-execute the handler — these modes are debugging tools, not a
        consistency mechanism.
        """
        if mode not in ("none", "deserialization", "all"):
            raise ValueError(f"exception mode must be none|deserialization|all, got {mode!r}")
        self._exception_mode = mode

    def listen(self, address: str) -> None:
        # A bare ":port" listens on every default transport (reference
        # Rpc::listen, src/rpc.cc:3102-3136): all TCP interfaces plus an
        # auto-pathed unix listener, so same-host peers can transport-upgrade
        # to ipc/memfd no matter which address they dialed.
        if address.startswith(":") and not any(
            a.startswith("ipc://") for a in self._listen_addrs
        ):
            sock = os.path.join(tempfile.gettempdir(), f"moolib_tpu_{self._uid}.sock")
            self.listen(f"ipc://{sock}")
        kind, target = parse_address(address)
        if self._net is not None:
            if kind == "tcp":
                host, port = target
                native_host = host
                if host not in ("", "0.0.0.0"):
                    # The native engine binds numeric IPv4 only; resolve
                    # hostnames here (user thread, listen is rare).
                    import socket as _socket

                    try:
                        _socket.inet_pton(_socket.AF_INET, host)
                    except OSError:
                        native_host = _socket.gethostbyname(host)
                actual_port = self._net.listen_tcp(native_host, port)
                self._advertise_tcp(native_host, actual_port)
            else:
                self._net.listen_unix(target)
                with self._state:
                    self._listen_addrs.append(f"ipc://{target}")
            return
        fut = concurrent.futures.Future()

        async def _do():
            try:
                if kind == "tcp":
                    host, port = target
                    server = await asyncio.start_server(
                        lambda r, w: self._on_accept("tcp", r, w), host, port
                    )
                    sock = server.sockets[0]
                    actual_port = sock.getsockname()[1]
                    self._advertise_tcp(host, actual_port)
                else:
                    path = target
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    server = await asyncio.start_unix_server(
                        lambda r, w: self._on_accept("ipc", r, w), path
                    )
                    self._listen_addrs.append(f"ipc://{path}")
                self._servers.append(server)
                fut.set_result(None)
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        asyncio.run_coroutine_threadsafe(_do(), self._loop)
        fut.result(10)

    def _advertise_tcp(self, host: str, actual_port: int) -> None:
        with self._state:
            if host in ("0.0.0.0", ""):
                # Advertise every reachable interface address so cross-host
                # gossip discovery works (not just loopback).
                for adv in _local_addresses():
                    self._listen_addrs.append(f"tcp://{adv}:{actual_port}")
            else:
                self._listen_addrs.append(f"tcp://{host}:{actual_port}")

    def connect(self, address: str) -> None:
        """Connect to an address; the connection is kept alive (reconnects)."""
        self._explicit.append(address)
        self._call_in_loop(lambda: self._loop.create_task(self._reconnect_task(address)))

    def peer_name_at(self, address: str) -> Optional[str]:
        """Name of the connected peer that advertises ``address`` among its
        greeting listen addresses, or None if no greeting from there has
        completed yet.  Calls route by peer NAME; this is how a client
        holding a LIST of broker *addresses* (broker-HA failover) resolves
        each one to the name it must actually call."""
        try:
            kind, target = parse_address(address)
        except Exception:
            return None
        if kind == "ipc":
            want = {f"ipc://{target}"}
        else:
            host, port = target
            hosts = {host}
            if host in ("0.0.0.0", "", "localhost"):
                hosts.add("127.0.0.1")
            else:
                try:
                    import socket as _socket

                    hosts.add(_socket.gethostbyname(host))
                except OSError:
                    pass
            want = {f"tcp://{h}:{port}" for h in hosts}
        with self._state:
            for p in self._peers.values():
                if any(a in want for a in p.addresses):
                    return p.name
        return None

    def define(self, name: str, fn: Callable, batch_size: Optional[int] = None,
               inline: bool = False) -> None:
        """Register ``fn`` as a callable RPC endpoint.

        ``inline=True`` is a hot-path opt-in for engine-internal handlers
        (the Group's allreduce combine): the handler runs synchronously on
        the receiving IO thread and its numpy array arguments are ZERO-COPY
        read-only views over the receive buffer, valid only for the duration
        of the call.  The handler must be fast, must not block, and must
        copy anything it retains past the return.  Regular (non-inline)
        handlers keep the copying deserialization and run on the thread
        pool — the safe default for user code.
        """
        if name in self._functions:
            raise RpcError(f"function {name!r} already defined")
        if inline and batch_size:
            raise RpcError("inline handlers cannot be batched")
        kind = "batched" if batch_size else "plain"
        self._functions[name] = _FnDef(name, fn, kind, batch_size, inline=inline)

    def define_deferred(self, name: str, fn: Callable) -> None:
        if name in self._functions:
            raise RpcError(f"function {name!r} already defined")
        self._functions[name] = _FnDef(name, fn, "deferred")

    def define_queue(
        self, name: str, batch_size: Optional[int] = None, dynamic_batching: bool = False
    ) -> Queue:
        if name in self._functions:
            raise RpcError(f"function {name!r} already defined")
        q = Queue(batch_size, dynamic_batching, name=name)
        fd = _FnDef(name, q, "queue", batch_size, dynamic_batching)
        self._functions[name] = fd
        return q

    def undefine(self, name: str) -> None:
        self._functions.pop(name, None)

    def async_(self, peer_name: str, fn_name: str, *args, **kwargs) -> Future:
        future = Future()
        self._send_request(peer_name, fn_name, args, kwargs, future)
        return future

    def async_callback(self, peer_name: str, fn_name: str, callback: Callable, *args, **kwargs):
        future = Future()

        def _done(f: Future):
            exc = f.exception()
            if exc is not None:
                callback(None, exc)
            else:
                callback(f._result, None)

        future.add_done_callback(_done)
        self._send_request(peer_name, fn_name, args, kwargs, future)

    def sync(self, peer_name: str, fn_name: str, *args, **kwargs):
        return self.async_(peer_name, fn_name, *args, **kwargs).result()

    def async_broadcast(self, peer_names: List[str], fn_name: str, *args, **kwargs) -> Future:
        """Send ONE request to several peers: the payload serializes once,
        and when every target is a same-host fd-passing peer the frame is
        written into a single memfd multicast to all of them (the payload
        bytes leave this process exactly once — the allreduce share-down's
        fast path).  All targets share one rid (receiver dedup is per peer,
        so this is unambiguous) and the returned future resolves to None
        once every peer has responded; per-peer results are discarded.
        Reliability is the standard poke/resend machinery, applied per
        pending peer."""
        future = Future()
        if not peer_names:
            future.set_result(None)
            return future
        try:
            sp = serialization.serialize((args, kwargs))
            body = serialization.pack(sp)
        except Exception as e:  # noqa: BLE001
            future.set_exception(RpcError(f"serialization error: {e}"))
            return future
        rid = next(self._rid)
        tb, call_ctx, parent_ctx = _trace_for_request()
        chunks = _request_chunks(rid, fn_name, body, self._timeout, tb)
        deadline = time.monotonic() + self._timeout
        out = _Outgoing(rid, peer_names[0], fn_name, chunks, (args, kwargs), future, deadline)
        out.timeout_s = self._timeout
        out.peers_pending = set(peer_names)
        if call_ctx is not None:
            out.trace = tb
            out.trace_parent = (call_ctx.trace_id, call_ctx.span_id, parent_ctx.span_id)
            out.t0_ns = time.perf_counter_ns()

        def _done(fut: Future):
            with self._state:
                self._outgoing.pop(rid, None)
            if out.trace_parent is not None:
                _record_call_span(out, peers=len(peer_names))

        future.add_done_callback(_done)
        with self._state:
            if not future.done():
                self._outgoing[rid] = out
                self._try_send(out)
        return future

    def _try_send_broadcast(self, out: _Outgoing):
        """Send (or resend) a broadcast request to every pending peer.
        Caller holds self._state.  The memfd-multicast fast path covers the
        peers reachable over same-host fd-passing ipc connections; everyone
        else gets an ordinary per-connection send of the same chunks."""
        fast: List[Tuple[_Peer, _NativeConnection]] = []
        slow: List[Tuple[_Peer, _Connection]] = []
        big = sum(_chunk_len(c) for c in out.chunks) >= _MEMFD_MIN
        for name in list(out.peers_pending or ()):
            peer = self._peers.get(name)
            conn = peer.best_connection(self._transport_order, big=big) if peer else None
            if conn is None:
                if peer is None:
                    peer = self._peers.setdefault(name, _Peer(name))
                self._spawn(lambda peer=peer: self._find_peer(peer))
                continue
            if (
                big
                and not frame_seam_hooked
                and self._net is not None
                and isinstance(conn, _NativeConnection)
                and conn.transport == "ipc"
                and peer.native_ok
                and peer.fdp_ok
            ):
                fast.append((peer, conn))
            else:
                slow.append((peer, conn))
        if fast:
            ids = [c.conn_id for _, c in fast]
            sent = self._net.send_memfd_multi(ids, out.chunks)
            total = sum(_chunk_len(c) for c in out.chunks)
            if sent == len(ids):
                for _, c in fast:
                    c.send_count += 1
                    c.bytes_out += total
                    c._m_tx_frames.inc()
                    c._m_tx_bytes.inc(total)
            else:
                # Unknown subset failed: resend individually; receivers
                # dedup duplicate rids.
                slow.extend(fast)
        for peer, conn in slow:
            try:
                conn.send_frame(self._chunks_for(peer, out))
            except Exception:
                conn.close()
        out.sent_at = time.monotonic()

    def debug_info(self) -> str:
        with self._state:
            return self._debug_info_locked()

    def _debug_info_locked(self) -> str:
        lines = [f"Rpc {self._name} (uid {self._uid}) listen={self._listen_addrs}"]
        for p in self._peers.values():
            lines.append(f"  peer {p.name} uid={p.uid} addrs={p.addresses}")
            for t, c in p.connections.items():
                lat = f"{c.latency*1e6:.0f}us" if c.latency is not None else "?"
                lines.append(
                    f"    {t}: sent={c.send_count} recv={c.recv_count}"
                    f" tx={c.bytes_out} rx={c.bytes_in} latency={lat}"
                    f" bandit={c.bandit:+.2f}"
                    f" age={time.monotonic()-c.created:.1f}s closed={c.closed}"
                )
        lines.append(
            f"  outstanding={len(self._outgoing)} nacks_recovered={self._nacks_recovered}"
            f" functions={list(self._functions)}"
        )
        return "\n".join(lines)

    def multicast_ready(self, peer_names: List[str]) -> bool:
        """True when every named peer is reachable over a live same-host
        fd-passing ipc connection — i.e. ``async_broadcast`` of a large
        frame will take the write-once memfd multicast path.  The allreduce
        share-down uses this to pick root-star (payload written once for the
        whole cohort) over tree forwarding."""
        if self._net is None:
            return False
        ready = True
        hunt: List[_Peer] = []
        with self._state:
            for name in peer_names:
                p = self._peers.get(name)
                if p is None or not any(
                    not c.closed for c in p.connections.values()
                ):
                    # Not even connected yet (tree traffic never needed it):
                    # start discovery so later rounds can upgrade to the
                    # multicast star; this round stays on the tree.
                    p = self._peers.setdefault(name, _Peer(name))
                    hunt.append(p)
                    ready = False
                    continue
                if not (p.native_ok and p.fdp_ok):
                    ready = False
                    continue
                c = p.connections.get("ipc")
                if c is None or c.closed or not isinstance(c, _NativeConnection):
                    ready = False
        for p in hunt:
            self._spawn(lambda p=p: self._find_peer(p))
        return ready

    def transport_stats(self) -> Dict[str, int]:
        """Aggregate wire counters across every live/dead-but-tracked
        connection: {"tx_bytes", "rx_bytes", "tx_frames", "rx_frames"}.
        The allreduce benchmark uses the per-peer spread of these to show
        the chunked ring's even load (vs the tree root's 2x hotspot).
        Thin per-Rpc view; the process-wide equivalents export through the
        registry as ``rpc_{tx,rx}_{bytes,frames}_total{transport=...}``."""
        with self._state:
            tx = rx = txf = rxf = 0
            for c in self._conns:
                tx += c.bytes_out
                rx += c.bytes_in
                txf += c.send_count
                rxf += c.recv_count
            return {"tx_bytes": tx, "rx_bytes": rx, "tx_frames": txf, "rx_frames": rxf}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True

        def _shutdown():
            for c in list(self._conns):
                c.close()
            for s in self._servers:
                s.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_shutdown)
            self._thread.join(timeout=5)
        except Exception:
            pass
        if self._net is not None:
            # After the loop stops nothing sends; joining the epoll thread
            # here guarantees no callback fires into a dead Rpc. (ctypes
            # releases the GIL during the call, so an in-flight callback can
            # finish.)
            try:
                self._net.destroy()
            except Exception:
                pass
        self._executor.shutdown(wait=False)

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    # --------------------------------------------------------- send path
    def _send_request(self, peer_name, fn_name, args, kwargs, future: Future):
        try:
            sp = serialization.serialize((args, kwargs))
            body = serialization.pack(sp)
        except Exception as e:  # noqa: BLE001
            future.set_exception(RpcError(f"serialization error: {e}"))
            return
        rid = next(self._rid)
        tb, call_ctx, parent_ctx = _trace_for_request()
        chunks = _request_chunks(rid, fn_name, body, self._timeout, tb)
        deadline = time.monotonic() + self._timeout
        out = _Outgoing(rid, peer_name, fn_name, chunks, (args, kwargs), future, deadline)
        out.timeout_s = self._timeout
        if call_ctx is not None:
            out.trace = tb
            out.trace_parent = (call_ctx.trace_id, call_ctx.span_id, parent_ctx.span_id)
            out.t0_ns = time.perf_counter_ns()

        def _done(fut: Future):
            # Completed (incl. user cancel): drop the resend buffer promptly.
            with self._state:
                self._outgoing.pop(rid, None)
            if out.trace_parent is not None:
                _record_call_span(out)

        future.add_done_callback(_done)

        if self._net is not None:
            # Native engine: sends are thread-safe; register + send inline.
            with self._state:
                if not future.done():
                    self._outgoing[rid] = out
                    self._try_send(out)
            return

        def _do():
            with self._state:
                if not future.done():
                    self._outgoing[rid] = out
                    self._try_send(out)

        self._call_in_loop(_do)

    def _send_poke(self, out: _Outgoing):
        # Caller holds self._state. Pokes are best-effort: if there is no
        # live connection, the greeting-time resend path owns recovery.
        names = out.peers_pending if out.peers_pending is not None else (out.peer_name,)
        for name in list(names):
            peer = self._peers.get(name)
            conn = peer.best_connection(self._transport_order) if peer else None
            if conn is None:
                continue
            try:
                conn.send_frame([struct.pack("<BQ", KIND_POKE, out.rid)])
            except Exception:
                conn.close()

    def _try_send(self, out: _Outgoing):
        # Caller holds self._state.
        if out.peers_pending is not None:
            self._try_send_broadcast(out)
            return
        peer = self._peers.get(out.peer_name)
        big = sum(_chunk_len(c) for c in out.chunks) >= _MEMFD_MIN
        conn = peer.best_connection(self._transport_order, big=big) if peer else None
        if conn is not None:
            try:
                conn.send_frame(self._chunks_for(peer, out))
                out.sent_at = time.monotonic()
                return
            except FrameTooLargeError as e:
                # Permanent for this payload — fail the call; closing the
                # (healthy) connection and resending would flap forever.
                # Complete off-thread: we hold _state here.
                with self._state:
                    self._outgoing.pop(out.rid, None)
                self._executor.submit(out.future.set_exception, RpcError(str(e)))
                return
            except Exception:
                conn.close()
        # No usable connection: park on the peer (once) and go find it.
        if peer is None:
            peer = self._peers.setdefault(out.peer_name, _Peer(out.peer_name))
        if not out.parked:
            out.parked = True
            peer.pending.append(out)
        self._spawn(lambda peer=peer: self._find_peer(peer))

    def _chunks_for(self, peer: _Peer, out: _Outgoing) -> List[bytes]:
        """Codec negotiation: if the peer can't decode native payloads,
        re-encode this request with the portable pickle codec."""
        if peer.native_ok or not serialization.native_available():
            return out.chunks
        if out.chunks_portable is None:
            sp = serialization._py_serialize(out.payload_obj)
            out.chunks_portable = _request_chunks(
                out.rid, out.fn_name, serialization.pack(sp), out.timeout_s, out.trace
            )
        return out.chunks_portable

    async def _find_peer(self, peer: _Peer):
        if peer.find_inflight:
            return
        peer.find_inflight = True
        try:
            # Try known addresses first, then gossip through connected peers
            # (reference reqLookingForPeer, src/rpc.cc:2332-2433).
            with self._state:
                addrs = list(peer.addresses)
            for addr in addrs:
                if any(not c.closed for c in peer.connections.values()):
                    return  # a dial (ours or another task's) just won
                if await self._connect_once(addr):
                    return
            with self._state:
                others = [p for p in self._peers.values() if p is not peer and p.connections]
            if others:
                sample = random.sample(others, min(len(others), max(2, int(len(others) ** 0.5))))
                for other in sample:
                    f = self.async_(other.name, "__moolib_find_peer", peer.name)

                    def _found(fut, peer=peer):
                        try:
                            addrs = fut.result(0)
                        except Exception:
                            return
                        if addrs:
                            with self._state:
                                for a in addrs:
                                    if a not in peer.addresses:
                                        peer.addresses.append(a)
                            self._spawn(lambda peer=peer: self._retry_connect(peer))

                    f.add_done_callback(_found)
        finally:
            peer.find_inflight = False

    async def _retry_connect(self, peer: _Peer):
        for addr in list(peer.addresses):
            if any(not c.closed for c in peer.connections.values()):
                return
            await self._connect_once(addr)

    async def _connect_once(self, address: str, explicit_addr: Optional[str] = None) -> bool:
        if self._net is not None:
            return await self._native_connect(address, explicit_addr)
        try:
            kind, target = parse_address(address)
            if kind == "tcp":
                host, port = target
                reader, writer = await asyncio.open_connection(host, port)
            else:
                reader, writer = await asyncio.open_unix_connection(target)
        except Exception:
            return False
        conn = _Connection(kind, reader, writer)
        conn.rpc = self
        conn.initiator_uid = self._uid
        conn.conn_seq = next(self._dial_seq)
        if explicit_addr is not None:
            # Tag so the reconnect task can see whether its address is live.
            conn._explicit_addr = explicit_addr
        self._conns.append(conn)
        self._send_greeting(conn)
        self._loop.create_task(self._read_loop(conn))
        return True

    async def _reconnect_task(self, address: str):
        backoff = 0.25
        while not self._closed:
            have = any(
                not c.closed
                for c in self._conns
                if getattr(c, "_explicit_addr", None) == address
            )
            if not have:
                ok = await self._connect_once(address, explicit_addr=address)
                backoff = 0.5 if ok else min(backoff * 2, 4.0)
            await asyncio.sleep(backoff)

    # ------------------------------------------------- native engine plumbing
    async def _native_connect(self, address: str, explicit_addr: Optional[str]) -> bool:
        try:
            kind, target = parse_address(address)
        except Exception:
            return False
        if kind == "tcp":
            host, port = target
            host = await self._resolve_host(host)
            if host is None:
                return False
        req_id = next(self._connect_req_counter)
        af = self._loop.create_future()
        with self._state:
            self._connect_reqs[req_id] = (af, kind, explicit_addr)
        if kind == "tcp":
            self._net.connect_tcp(req_id, host, port)
        else:
            self._net.connect_unix(req_id, target)
        return await af

    async def _resolve_host(self, host: str) -> Optional[str]:
        """Resolve a hostname to a numeric address off the IO threads (the
        native engine only dials numeric addresses — blocking getaddrinfo on
        its epoll thread would stall every connection)."""
        import socket as _socket

        try:
            _socket.inet_pton(_socket.AF_INET, host)
            return host  # already numeric
        except OSError:
            pass
        try:
            infos = await self._loop.getaddrinfo(host, None, type=_socket.SOCK_STREAM)
        except OSError:
            return None
        for family, _, _, _, sockaddr in infos:
            if family == _socket.AF_INET:
                return sockaddr[0]
        return infos[0][4][0] if infos else None

    # The _net_on_* callbacks run on the C++ epoll thread and process frames
    # right there under _state — no cross-thread hop on the hot path (the
    # reference handles messages on its poll thread the same way). The frame
    # is a ZERO-COPY view into the engine's receive buffer, valid only until
    # the callback returns: every deserialize path copies array/bytes leaves
    # during materialization, and nothing may retain `frame` (or slices of
    # it) past the callback.
    def _net_on_accept(self, conn_id: int, transport: str):
        with self._state:
            conn = _NativeConnection(self._net, conn_id, transport, self, inbound=True)
            self._native_conns[conn_id] = conn
            self._conns.append(conn)
            self._send_greeting(conn)

    def _net_on_frame(self, conn_id: int, frame: bytes):
        with self._state:
            conn = self._native_conns.get(conn_id)
            if conn is None or conn.closed:
                return
            conn.recv_count += 1
            conn.bytes_in += len(frame)
            conn.last_recv = time.monotonic()
            conn._m_rx_frames.inc()
            conn._m_rx_bytes.inc(len(frame))
        # Publish the frame for adopt_current_frame(): an inline handler may
        # take ownership of a memfd frame's mapping (zero-copy receive into
        # a long-lived buffer) while the callback is on this stack.
        prev = getattr(_ADOPT, "ctx", None)
        _ADOPT.ctx = (self._net, frame)
        try:
            self._on_frame(conn, frame)
        finally:
            _ADOPT.ctx = prev

    def _net_on_close(self, conn_id: int):
        with self._state:
            conn = self._native_conns.pop(conn_id, None)
            if conn is None:
                return
            conn.closed = True
            self._detach_conn(conn)

    def _native_forget(self, conn_id: int):
        with self._state:
            conn = self._native_conns.pop(conn_id, None)
            if conn is not None:
                self._detach_conn(conn)

    def _net_on_connect(self, req_id: int, conn_id: int):
        # Register the connection synchronously: the peer's greeting can race
        # through the epoll thread the moment the connect resolves, and it
        # must find the connection registered.
        with self._state:
            entry = self._connect_reqs.pop(req_id, None)
            if entry is None:
                if conn_id >= 0:
                    self._net.close_conn(conn_id)
                return
            af, kind, explicit_addr = entry
            ok = conn_id >= 0
            if ok:
                conn = _NativeConnection(self._net, conn_id, kind, self)
                conn.initiator_uid = self._uid
                conn.conn_seq = next(self._dial_seq)
                if explicit_addr is not None:
                    conn._explicit_addr = explicit_addr
                self._native_conns[conn_id] = conn
                self._conns.append(conn)
                self._send_greeting(conn)
        # The awaiting coroutine lives on the loop: complete its future there.
        self._call_in_loop(_set_async_result, af, ok)

    def _send_greeting(self, conn: _Connection):
        # Greetings always use the portable pickle codec: they must parse
        # before codec support has been negotiated.
        greeting = serialization.dumps_portable(
            {
                "sig": SIGNATURE,
                "name": self._name,
                "uid": self._uid,
                "addrs": list(self._listen_addrs),
                "host": _boot_id(),
                "native": serialization.native_available(),
                # fd-passing capability: our engine can receive SCM_RIGHTS
                # memfd frames (native transport only).
                "fdp": self._net is not None,
                # Dial sequence of this connection if WE initiated it (the
                # acceptor learns it for the duplicate tie-break).
                "seq": conn.conn_seq if not conn.inbound else 0,
            }
        )
        conn.send_frame([struct.pack("<B", KIND_GREETING), greeting])

    # --------------------------------------------------------- receive path
    def _on_accept(self, transport: str, reader, writer):
        conn = _Connection(transport, reader, writer, inbound=True)
        conn.rpc = self
        self._conns.append(conn)
        self._send_greeting(conn)
        self._loop.create_task(self._read_loop(conn))

    async def _read_loop(self, conn: _Connection):
        try:
            while not self._closed:
                hdr = await conn.reader.readexactly(4)
                (length,) = struct.unpack("<I", hdr)
                if length <= 1 << 20:
                    frame = await conn.reader.readexactly(length)
                else:
                    # Chunked read of large frames so last_recv reflects
                    # byte-level progress (keepalive teardown must not kill
                    # a link mid-way through a big transfer).
                    buf = bytearray(length)
                    got = 0
                    while got < length:
                        piece = await conn.reader.readexactly(min(1 << 20, length - got))
                        buf[got : got + len(piece)] = piece
                        got += len(piece)
                        conn.last_recv = time.monotonic()
                    frame = bytes(buf)
                conn.recv_count += 1
                conn.bytes_in += length
                conn.last_recv = time.monotonic()
                conn._m_rx_frames.inc()
                conn._m_rx_bytes.inc(length)
                self._on_frame(conn, frame)
        except (asyncio.IncompleteReadError, ConnectionError, OSError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001
            utils.log_error("rpc read loop error: %s", traceback.format_exc())
        finally:
            conn.close()
            self._detach_conn(conn)

    def _detach_conn(self, conn: _Connection):
        with self._state:
            if conn in self._conns:
                self._conns.remove(conn)
            if conn.peer_name is not None:
                peer = self._peers.get(conn.peer_name)
                if peer is not None and peer.connections.get(conn.transport) is conn:
                    del peer.connections[conn.transport]

    def _on_frame(self, conn: _Connection, frame: bytes):
        kind = frame[0]
        if kind == KIND_GREETING:
            self._on_greeting(conn, frame)
        elif kind == KIND_REQUEST:
            self._on_request(conn, frame)
        elif kind in (KIND_RESPONSE, KIND_ERROR):
            self._on_response(conn, frame, kind == KIND_ERROR)
        elif kind == KIND_KEEPALIVE:
            # Ping (flag 0) wants a pong (flag 1) so the *sender's* last_recv
            # refreshes too; pongs are not echoed (no ping-pong storm).
            if len(frame) < 2 or frame[1] == 0:
                try:
                    conn.send_frame([struct.pack("<BB", KIND_KEEPALIVE, 1)])
                except Exception:
                    conn.close()
        elif kind == KIND_POKE:
            self._on_poke(conn, frame)
        elif kind == KIND_ACK:
            self._on_ack(frame)
        elif kind == KIND_NACK:
            self._on_nack(frame)
        else:
            utils.log_error("rpc: unknown frame kind %d", kind)

    def _on_poke(self, conn: _Connection, frame: bytes):
        """Receiver side of fast recovery: the sender suspects loss on rid.
        Cached response → resend it; executing → ACK; unknown → NACK (the
        request frame died — sender resends immediately)."""
        (rid,) = struct.unpack_from("<Q", frame, 1)
        reply = None
        with self._state:
            peer = self._peers.get(conn.peer_name) if conn.peer_name else None
            if peer is not None:
                cached = peer.recent.get(rid)
                if cached is not None:
                    reply = cached[1]
                elif rid in peer.executing:
                    reply = [struct.pack("<BQ", KIND_ACK, rid)]
                else:
                    reply = [struct.pack("<BQ", KIND_NACK, rid)]
        if reply is not None:
            try:
                conn.send_frame(reply)
            except Exception:
                conn.close()

    def _on_ack(self, frame: bytes):
        (rid,) = struct.unpack_from("<Q", frame, 1)
        with self._state:
            out = self._outgoing.get(rid)
            if out is not None:
                out.acked_at = time.monotonic()

    def _on_nack(self, frame: bytes):
        (rid,) = struct.unpack_from("<Q", frame, 1)
        with self._state:
            out = self._outgoing.get(rid)
            if out is not None:
                self._nacks_recovered += 1
                _M_NACKS.inc()
                out.resent = True
                _record_resend_span(out, "nack")
                self._try_send(out)

    def _on_greeting(self, conn: _Connection, frame: bytes):
        info = serialization.loads(memoryview(frame)[1:])
        if info.get("sig") != SIGNATURE:
            utils.log_error("rpc: protocol signature mismatch, closing connection")
            conn.close()
            return
        name, uid = info["name"], info["uid"]
        if uid == self._uid:
            conn.close()  # self-connection (reference src/rpc.cc:2209-2224)
            return
        with self._state:
            self._on_greeting_locked(conn, info, name, uid)

    def _on_greeting_locked(self, conn: _Connection, info, name: str, uid: str):
        conn.peer_name = name
        conn.peer_uid = uid
        peer = self._peers.setdefault(name, _Peer(name))
        if peer.uid is not None and peer.uid != uid:
            # Same name, new incarnation (peer restarted): its rid space
            # restarts too, so the previous incarnation's dedup cache must go.
            peer.recent.clear()
            peer.executing.clear()
        peer.uid = uid
        peer.native_ok = bool(info.get("native", False))
        peer.fdp_ok = bool(info.get("fdp", False))
        for a in info.get("addrs", []):
            if a not in peer.addresses:
                peer.addresses.append(a)
        if conn.inbound:
            conn.initiator_uid = uid
            conn.conn_seq = int(info.get("seq", 0))
        old = peer.connections.get(conn.transport)
        if old is not None and old is not conn and not old.closed:
            # Duplicate-connection tie-break. Duplicates happen two ways:
            # simultaneous connect (each side dialed the other) and redundant
            # dials from one side (reconnect task racing discovery before the
            # first greeting lands). Keep the max (initiator_uid, dial_seq) —
            # both ends compute the same winner regardless of the order the
            # greetings arrived in, so they never keep different connections
            # (which would look like the peer closing our healthy link).
            new_key = (conn.initiator_uid or "", conn.conn_seq)
            old_key = (old.initiator_uid or "", old.conn_seq)
            if old_key >= new_key:
                conn.close()
                return
            old.close()
        peer.connections[conn.transport] = conn
        # Flush anything parked while the peer was unknown, and resend every
        # outstanding request addressed to this peer — receiver-side dedup
        # makes the resend idempotent (at-most-once execution).
        pending, peer.pending = peer.pending, []
        seen = set()
        for out in pending:
            out.parked = False
            if out.rid in self._outgoing and out.rid not in seen:
                seen.add(out.rid)
                self._try_send(out)
        for out in list(self._outgoing.values()):
            if out.rid in seen:
                continue
            if out.peers_pending is not None:
                # Broadcast: resend when THIS peer is still pending (the
                # single peer_name field only names the first target).
                if name in out.peers_pending:
                    self._try_send(out)
            elif out.peer_name == name:
                self._try_send(out)
        self._maybe_upgrade_transport(peer, info)

    def _maybe_upgrade_transport(self, peer: _Peer, info: dict) -> None:
        """Same-host transport upgrade (the reference's automatic transport
        selection, ``README.md:17-19`` / ``src/rpc.cc:640-716``): when a peer
        reached over TCP advertises an ipc:// listener on this machine
        (boot-id match), dial it too.  The bandit then has both transports
        and big frames take the unix/memfd zero-copy path outright.  Caller
        holds ``self._state``.  Only the uid-smaller side dials, so the pair
        doesn't create rival duplicate connections to tie-break."""
        if info.get("host") != _boot_id():
            return
        if peer.uid is not None and self._uid >= peer.uid:
            return
        ipc = peer.connections.get("ipc")
        if ipc is not None and not ipc.closed:
            return
        now = time.monotonic()
        for a in info.get("addrs", []):
            if not a.startswith("ipc://"):
                continue
            if now - peer.upgrade_attempts.get(a, -1e9) < 10.0:
                return  # a recent dial is in flight / just failed
            peer.upgrade_attempts[a] = now
            self._spawn(lambda a=a: self._connect_once(a))
            return

    def _on_request(self, conn: _Connection, frame: bytes):
        rid, sender_timeout, fnlen, tclen = struct.unpack_from("<QIHH", frame, 1)
        off = 1 + 8 + 4 + 2 + 2
        fn_name = bytes(frame[off : off + fnlen]).decode()
        off += fnlen
        # Remote trace context (0005): present only when the caller had an
        # active trace.  The handler runs under a child span of the caller's
        # rpc.call span — the cross-process edge trace_merge stitches on.
        tctx = _tracing.decode_context(bytes(frame[off : off + tclen])) if tclen else None
        off += tclen
        # At-most-once window must outlive every possible resend by this
        # sender: size it from the *sender's* call timeout, not ours.
        dedup_ttl = max(2.0 * sender_timeout, 120.0)
        with self._state:
            peer = self._peers.get(conn.peer_name) if conn.peer_name else None
            if peer is not None:
                cached = peer.recent.get(rid)
                if cached is not None:
                    try:
                        conn.send_frame(cached[1])
                    except Exception:
                        conn.close()
                    return
                if rid in peer.executing:
                    return  # duplicate while executing; response will go out
                peer.executing.add(rid)

        def respond(value, error: Optional[str], stage: str = "handler"):
            # Serialize outside the state lock (can be large); then publish
            # the dedup entry and send under it.
            if error is not None and not self._report_error(stage):
                # Swallowed by the exception mode: log host-side, free the
                # in-flight dedup slot (no response will ever go out), and
                # let the caller time out — reference None/DeserializationOnly
                # behavior (src/rpc.h:271-293).
                utils.log_error(
                    "rpc %s: %s error swallowed (exception_mode=%s): %s",
                    self._name, stage, self._exception_mode, error,
                )
                with self._state:
                    if peer is not None:
                        peer.executing.discard(rid)
                return
            ser_fn = (
                serialization.serialize
                if (peer is None or peer.native_ok)
                else serialization._py_serialize
            )
            try:
                if error is not None:
                    body = serialization.pack(ser_fn(error))
                    chunks = [struct.pack("<BQ", KIND_ERROR, rid)] + body
                else:
                    body = serialization.pack(ser_fn(value))
                    chunks = [struct.pack("<BQ", KIND_RESPONSE, rid)] + body
            except Exception as e:  # noqa: BLE001
                # A response that cannot serialize is a handler-stage failure:
                # it obeys the same exception-mode gate as a raising handler.
                if not self._report_error("handler"):
                    utils.log_error(
                        "rpc %s: response serialization error swallowed "
                        "(exception_mode=%s): %s",
                        self._name, self._exception_mode, e,
                    )
                    with self._state:
                        if peer is not None:
                            peer.executing.discard(rid)
                    return
                body = serialization.pack(
                    serialization._py_serialize(f"response serialization error: {e}")
                )
                chunks = [struct.pack("<BQ", KIND_ERROR, rid)] + body

            def _send():
                with self._state:
                    if peer is not None:
                        peer.executing.discard(rid)
                        peer.recent[rid] = (time.monotonic(), chunks, dedup_ttl)
                    # Respond over the best currently-alive connection to the
                    # peer; fall back to the one the request came in on.
                    big = sum(_chunk_len(c) for c in chunks) >= _MEMFD_MIN
                    target = (
                        peer.best_connection(self._transport_order, big=big)
                        if peer else None
                    )
                    if target is None or target.closed:
                        target = conn
                    try:
                        target.send_frame(chunks)
                    except FrameTooLargeError:
                        # Drop the response (caller times out); the link is
                        # healthy and must not be closed.
                        utils.log_error(
                            "rpc: response for rid %s exceeds the frame limit", rid
                        )
                    except Exception:
                        target.close()

            if self._net is not None:
                _send()  # native sends are thread-safe
            else:
                self._call_in_loop(_send)

        fdef = self._functions.get(fn_name)
        if fdef is None:
            respond(
                None,
                f"function {fn_name!r} is not defined on peer {self._name!r}",
                stage="protocol",
            )
            return
        if fdef.inline and fdef.kind == "plain":
            # Inline hot path: borrowed (zero-copy) argument arrays, handler
            # run right here on the receiving thread — while the frame's
            # receive buffer is still valid (native transport frames die
            # when this callback returns).  The handler contract (fast,
            # non-blocking, copy-on-retention) lives in Rpc.define.
            try:
                sp = serialization.unpack(frame, off)
                args, kwargs = serialization.deserialize(sp, borrow=True)
            except Exception as e:  # noqa: BLE001
                respond(None, f"argument deserialization error: {e}", stage="deserialization")
                return
            try:
                with _recv_span(fn_name, tctx, rid):
                    respond(fdef.fn(*args, **kwargs), None)
            except Exception:  # noqa: BLE001
                respond(None, f"exception in {fdef.name!r}: {traceback.format_exc()}")
            return
        try:
            sp = serialization.unpack(frame, off)
            args, kwargs = serialization.deserialize(sp)
        except Exception as e:  # noqa: BLE001
            respond(None, f"argument deserialization error: {e}", stage="deserialization")
            return
        self._dispatch(fdef, args, kwargs, respond, tctx=tctx, rid=rid)

    def _report_error(self, stage: str) -> bool:
        """Is this error stage reported to the caller under the current mode?"""
        if stage == "protocol":
            return True
        if stage == "deserialization":
            return self._exception_mode in ("deserialization", "all")
        return self._exception_mode == "all"

    def _dispatch(self, fdef: _FnDef, args, kwargs, respond, tctx=None, rid=None):
        # tctx: the caller's trace context decoded off the frame.  Each
        # execution path runs the handler under an rpc.recv child span, so
        # handler-internal span()/async_ calls chain beneath it — including
        # onward RPCs, which re-encode the context for the next hop.
        if fdef.kind == "queue":
            # The span covers the enqueue (service time is the queue's own
            # business); the Queue can capture current_context() here to
            # reattach at take time.
            with _recv_span(fdef.name, tctx, rid):
                fdef.fn.enqueue(RpcDeferredReturn(respond), args, kwargs)
            return
        if fdef.kind == "deferred":
            ret = RpcDeferredReturn(respond)

            def run_deferred():
                try:
                    with _recv_span(fdef.name, tctx, rid):
                        fdef.fn(ret, *args, **kwargs)
                except Exception:  # noqa: BLE001
                    if not ret._sent:
                        ret.error(f"exception in {fdef.name!r}: {traceback.format_exc()}")

            self._executor.submit(run_deferred)
            return
        if fdef.kind == "batched":
            fdef.batch_state.append((respond, args, kwargs))
            if len(fdef.batch_state) >= fdef.batch_size:
                calls, fdef.batch_state = fdef.batch_state, []
                success_calls = [
                    ((lambda v, r=r: r(v, None)), a, k) for (r, a, k) in calls
                ]
                ret_cb, bargs, bkwargs = _batch_calls(success_calls)

                def run_batched():
                    try:
                        # The batch executes once for many callers; it runs
                        # under the flush-triggering caller's context.
                        with _recv_span(fdef.name, tctx, rid):
                            ret_cb(fdef.fn(*bargs, **bkwargs))
                    except Exception:  # noqa: BLE001
                        msg = f"exception in {fdef.name!r}: {traceback.format_exc()}"
                        for r, _, _ in calls:
                            r(None, msg)

                self._executor.submit(run_batched)
            return

        # plain
        if asyncio.iscoroutinefunction(fdef.fn):
            async def run_async():
                try:
                    with _recv_span(fdef.name, tctx, rid):
                        value = await fdef.fn(*args, **kwargs)
                    respond(value, None)
                except Exception:  # noqa: BLE001
                    respond(None, f"exception in {fdef.name!r}: {traceback.format_exc()}")

            # May be reached from the epoll thread (native transport):
            # _spawn marshals task creation onto the loop thread.
            self._spawn(run_async)
            return

        def run_plain():
            try:
                with _recv_span(fdef.name, tctx, rid):
                    value = fdef.fn(*args, **kwargs)
                respond(value, None)
            except Exception:  # noqa: BLE001
                respond(None, f"exception in {fdef.name!r}: {traceback.format_exc()}")

        self._executor.submit(run_plain)

    def _on_response(self, conn: _Connection, frame: bytes, is_error: bool):
        (rid,) = struct.unpack_from("<Q", frame, 1)
        with self._state:
            out = self._outgoing.get(rid)
            if out is None:
                return  # late/duplicate response
            if out.peers_pending is not None:
                # Broadcast: track per-peer completion; per-peer results are
                # discarded (fire-and-forget semantics with reliability).
                if conn.peer_name is not None:
                    out.peers_pending.discard(conn.peer_name)
                if out.peers_pending:
                    return
                self._outgoing.pop(rid, None)
                done_broadcast = out
            else:
                done_broadcast = None
                self._outgoing.pop(rid, None)
        if done_broadcast is not None:
            done_broadcast.future.set_result(None)
            return
        with self._state:
            if not out.resent:
                # Resent requests give ambiguous RTTs (which send answered?)
                rtt = time.monotonic() - out.sent_at
                peer = self._peers.get(conn.peer_name) if conn.peer_name else None
                if peer is not None:
                    peer.note_latency(conn, rtt)
                else:
                    conn.latency = (
                        rtt if conn.latency is None else conn.latency * 0.9 + rtt * 0.1
                    )
        # Deserialize + complete outside the lock: payloads can be large and
        # future done-callbacks take caller locks.
        try:
            value = serialization.deserialize(serialization.unpack(frame, 9))
        except Exception as e:  # noqa: BLE001
            _M_CALL_ERRORS.inc(kind="deserialization")
            out.future.set_exception(RpcError(f"response deserialization error: {e}"))
            return
        if is_error:
            _M_CALL_ERRORS.inc(kind="remote")
            out.future.set_exception(RpcError(str(value)))
        else:
            out.future.set_result(value)

    # --------------------------------------------------------- housekeeping
    async def _timeout_task(self):
        while not self._closed:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            with self._state:
                expired = [o for o in self._outgoing.values() if now >= o.deadline]
                for out in expired:
                    self._outgoing.pop(out.rid, None)
            # Complete outside the lock (done-callbacks take caller locks).
            for out in expired:
                _M_CALL_ERRORS.inc(kind="timeout")
                out.future.set_exception(
                    RpcError(f"Call ({out.peer_name}::{out.fn_name}) timed out")
                )
            hunts = []
            with self._state:
                # Fast recovery (reference poke/ack/nack, src/rpc.cc:2526-2703):
                # after _POKE_AFTER of silence on a rid, send a tiny POKE; a
                # NACK resends immediately (RTT-scale recovery), an ACK means
                # the handler is still running, a cached response is re-sent
                # by the receiver. The blind full resend remains as a fallback
                # for the case where the poke/nack frames themselves died.
                for out in list(self._outgoing.values()):
                    if now - out.sent_at > _RESEND_BLIND:
                        out.resent = True  # RTT no longer a clean sample
                        _record_resend_span(out, "blind")
                        self._try_send(out)
                        out.sent_at = now
                        continue
                    last = max(out.sent_at, out.last_probe, out.acked_at)
                    if now - last > _POKE_AFTER:
                        out.last_probe = now
                        self._send_poke(out)
                # Prune dead entries from pending queues (their futures
                # already timed out); park flags reset so nothing leaks
                # against a peer that never comes back.
                for peer in self._peers.values():
                    if peer.pending:
                        peer.pending = [
                            o for o in peer.pending if o.rid in self._outgoing
                        ]
                # Dedup entries carry their own TTL (derived from each
                # sender's call timeout at request time).
                now2 = time.monotonic()
                for peer in self._peers.values():
                    peer.recent = {
                        rid: v for rid, v in peer.recent.items() if now2 - v[0] < v[2]
                    }
                    # Keep hunting for peers with parked requests (a closed
                    # conn pending detach does not count as connected).
                    if peer.pending and not any(
                        not c.closed for c in peer.connections.values()
                    ):
                        hunts.append(peer)
                # Keepalives + unresponsive-connection teardown (reference
                # timeoutConnections, src/rpc.cc:1625-1665): ping idle
                # connections; a link that stays silent while pinged is dead
                # (no RST on a silently dropped path) — close it so explicit
                # connections reconnect and requests fail over.
                for conn in list(self._conns):
                    if conn.closed:
                        continue
                    if isinstance(conn, _NativeConnection):
                        # Byte-level liveness: a link mid-way through a huge
                        # frame (no frame completion, but bytes moving) is
                        # alive — don't tear it down. Inbound bytes are
                        # definitive; outbound "progress" counts only when
                        # substantial (a dead socket still absorbs small
                        # writes — like our pings — into the kernel buffer).
                        rx = conn.net.conn_rx(conn.conn_id)
                        tx = conn.net.conn_tx(conn.conn_id)
                        if rx != conn.rx_seen or (
                            conn.tx_seen >= 0 and tx - conn.tx_seen >= 262144
                        ):
                            conn.last_recv = now2
                        conn.rx_seen = rx
                        conn.tx_seen = tx
                    if conn.peer_name is None and now2 - conn.created > _GREET_DEADLINE:
                        utils.log_verbose(
                            "rpc: closing %s connection the peer never greeted", conn.transport)
                        conn.close()
                        self._detach_conn(conn)
                        continue
                    idle = now2 - conn.last_recv
                    if idle > _CONN_DEAD:
                        utils.log_verbose(
                            "rpc: closing unresponsive %s connection to %s",
                            conn.transport,
                            conn.peer_name,
                        )
                        conn.close()
                        self._detach_conn(conn)
                    elif idle > _KEEPALIVE_IDLE and now2 - conn.last_keepalive > _KEEPALIVE_INTERVAL:
                        conn.last_keepalive = now2
                        try:
                            conn.send_frame([struct.pack("<BB", KIND_KEEPALIVE, 0)])
                        except Exception:
                            conn.close()
                            self._detach_conn(conn)
            for peer in hunts:
                self._loop.create_task(self._find_peer(peer))

    def _find_peer_handler(self, target: str):
        peer = self._peers.get(target)
        if peer is None:
            return []
        return list(peer.addresses)
