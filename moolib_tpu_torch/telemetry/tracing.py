"""Lightweight host-side span tracer with Chrome trace-event export.

``torch.profiler`` owns the *device* timeline (CUDA kernels, memory); this
tracer owns the *host* side: nested spans around the train loop's act/learn/
reduce phases, RPC rounds, env waits.  Spans export as Chrome trace-event
JSON (``chrome://tracing`` / Perfetto "Complete" events), so a host trace
can sit next to a ``torch.profiler`` capture — and when annotations are
enabled, each span also enters a ``torch.profiler.record_function`` so the
same names appear inside the profiler's timeline.

Recording is bounded (a ring of the newest ``capacity`` spans) and cheap:
one ``perf_counter_ns`` pair plus a deque append per span; nesting depth is
tracked per-thread with no locks on the hot path.  Stdlib only unless
annotations are switched on.

Distributed tracing
-------------------
Spans optionally carry W3C-style identity — a 128-bit ``trace_id`` shared
by every span of one logical operation and a 64-bit ``span_id`` unique per
span, with ``parent_id`` naming the span that caused it.  A per-thread
context stack links them up:

* :func:`root_span` starts a fresh trace (new ``trace_id``) and pushes it.
* Plain :func:`span` joins the active trace when one is on this thread's
  stack (its parent is the enclosing span) and stays id-free otherwise, so
  untraced code pays nothing and emits unchanged events.
* :func:`child_span` continues a trace whose context arrived from another
  process — the RPC layer decodes 24 bytes off the call frame
  (:func:`decode_context`) and opens the handler under it, which is what
  makes one serve request or one gradient round a single causal tree
  across hosts.  ``scripts/trace_merge.py`` stitches the per-process
  exports back together using each file's ``metadata.clock_sync`` anchor.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "Span",
    "TraceContext",
    "Tracer",
    "get_tracer",
    "span",
    "root_span",
    "child_span",
    "attach_context",
    "current_context",
    "encode_context",
    "decode_context",
    "new_trace_id",
    "new_span_id",
    "CONTEXT_WIRE_LEN",
]

# Wire form of a TraceContext: 16-byte trace_id + 8-byte span_id, little
# endian.  The RPC request header carries this blob (or nothing at all when
# no trace is active — untraced calls stay byte-identical in cost).
CONTEXT_WIRE_LEN = 24
_CTX_STRUCT = struct.Struct("<16s8s")


def new_trace_id() -> int:
    """Random non-zero 128-bit trace id."""
    while True:
        v = int.from_bytes(os.urandom(16), "little")
        if v:
            return v


def new_span_id() -> int:
    """Random non-zero 64-bit span id."""
    while True:
        v = int.from_bytes(os.urandom(8), "little")
        if v:
            return v


class TraceContext:
    """Identity of the *current* span: which trace, which span.  Immutable;
    what rides the wire and the per-thread stack."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self) -> "TraceContext":
        """A fresh context in the same trace (new span id)."""
        return TraceContext(self.trace_id, new_span_id())

    def __eq__(self, other):
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
        )

    def __hash__(self):
        return hash((self.trace_id, self.span_id))

    def __repr__(self):
        return f"TraceContext(trace_id={self.trace_id:032x}, span_id={self.span_id:016x})"


def encode_context(ctx: Optional[TraceContext]) -> bytes:
    """24-byte wire form (empty bytes for ``None`` — zero frame overhead)."""
    if ctx is None:
        return b""
    return _CTX_STRUCT.pack(
        ctx.trace_id.to_bytes(16, "little"), ctx.span_id.to_bytes(8, "little")
    )


def decode_context(data: bytes) -> Optional[TraceContext]:
    """Inverse of :func:`encode_context`; ``None`` on empty/odd-sized/zero
    input rather than raising (a peer speaking a future layout must not
    break request handling)."""
    if len(data) != CONTEXT_WIRE_LEN:
        return None
    tb, sb = _CTX_STRUCT.unpack(data)
    trace_id = int.from_bytes(tb, "little")
    span_id = int.from_bytes(sb, "little")
    if not trace_id or not span_id:
        return None
    return TraceContext(trace_id, span_id)


_tls = threading.local()


def _ctx_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = []
        _tls.stack = stack
    return stack


def current_context() -> Optional[TraceContext]:
    """The innermost active trace context on this thread, or ``None``."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return None


@contextlib.contextmanager
def attach_context(ctx: Optional[TraceContext]):
    """Make ``ctx`` the ambient context for the body WITHOUT opening a new
    span — for resuming a logical operation's identity on another thread
    (the serve client's retry timers fire attempts long after ``submit``
    returned) so calls made inside parent under a span that is recorded
    manually at completion.  ``None`` is a no-op."""
    if ctx is None:
        yield
        return
    stack = _ctx_stack()
    stack.append(ctx)
    try:
        yield
    finally:
        if stack and stack[-1] is ctx:
            stack.pop()
        else:  # mismatched nesting — drop ours wherever it landed
            try:
                stack.remove(ctx)
            except ValueError:
                pass


class Span:
    """One closed span: name, start (ns since epoch-ish origin), duration.

    ``trace_id``/``span_id``/``parent_id`` are ``None`` for spans recorded
    outside any trace; ``dur_ns`` is ``None`` for instant events."""

    __slots__ = (
        "name",
        "start_ns",
        "dur_ns",
        "tid",
        "thread_name",
        "args",
        "trace_id",
        "span_id",
        "parent_id",
    )

    def __init__(
        self,
        name,
        start_ns,
        dur_ns,
        tid,
        thread_name,
        args,
        trace_id=None,
        span_id=None,
        parent_id=None,
    ):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.thread_name = thread_name
        self.args = args
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id


# _ActiveSpan trace modes: join the ambient context if any (plain span()),
# force a fresh trace (root_span), or continue an explicit remote parent
# (child_span).
_AUTO, _ROOT, _CHILD = 0, 1, 2


class _ActiveSpan:
    __slots__ = (
        "_tracer",
        "_name",
        "_args",
        "_t0",
        "_annotation",
        "_mode",
        "_parent_ctx",
        "_ctx",
        "_parent_id",
        "_pushed",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        args: Optional[dict],
        mode: int = _AUTO,
        parent_ctx: Optional[TraceContext] = None,
    ):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._annotation = None
        self._mode = mode
        self._parent_ctx = parent_ctx
        self._ctx = None
        self._parent_id = None
        self._pushed = False

    @property
    def context(self) -> Optional[TraceContext]:
        """This span's TraceContext while open (``None`` when untraced)."""
        return self._ctx

    def __enter__(self):
        if self._mode == _ROOT:
            self._ctx = TraceContext(new_trace_id(), new_span_id())
        elif self._mode == _CHILD:
            parent = self._parent_ctx
            if parent is not None:
                self._parent_id = parent.span_id
                self._ctx = parent.child()
        else:
            parent = current_context()
            if parent is not None:
                self._parent_id = parent.span_id
                self._ctx = parent.child()
        if self._ctx is not None:
            _ctx_stack().append(self._ctx)
            self._pushed = True
        if self._tracer._annotate:
            ann = _torch_annotation(self._name)
            if ann is not None:
                ann.__enter__()
                self._annotation = ann
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if self._pushed:
            stack = _ctx_stack()
            if stack and stack[-1] is self._ctx:
                stack.pop()
            else:  # mismatched enter/exit ordering — drop ours wherever it is
                try:
                    stack.remove(self._ctx)
                except ValueError:
                    pass
            self._pushed = False
        ctx = self._ctx
        t = threading.current_thread()
        self._tracer._spans.append(
            Span(
                self._name,
                self._t0,
                dur,
                t.ident or 0,
                t.name,
                self._args,
                ctx.trace_id if ctx is not None else None,
                ctx.span_id if ctx is not None else None,
                self._parent_id,
            )
        )
        return False


def _torch_annotation(name: str):
    """A torch ``record_function`` range when torch is already imported;
    never imports it (the tracer must stay usable in workers that never
    touch torch)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — annotation is best-effort decoration
        return None


class Tracer:
    """Bounded span recorder.  ``get_tracer()`` returns the process default."""

    def __init__(self, capacity: int = 65536):
        self._spans: deque = deque(maxlen=capacity)
        self._annotate = False
        # Anchor pairing the monotonic span clock to wall time, captured
        # once: lets trace_merge rebase every process onto one unix-time
        # axis (perf_counter origins are arbitrary per process).
        self._clock_anchor = (time.time_ns(), time.perf_counter_ns())

    def span(self, name: str, **args) -> _ActiveSpan:
        """Context manager recording one span; nest freely (the Chrome view
        reconstructs nesting from same-thread containment).  Joins the
        thread's active trace when one exists, else records id-free."""
        return _ActiveSpan(self, name, args or None)

    def root_span(self, name: str, **args) -> _ActiveSpan:
        """Open a span that STARTS a new trace — the entry point of a
        logical operation (a serve request, one ``reduce_gradients`` round).
        Everything recorded beneath it, on any host the RPC layer carries
        the context to, shares its ``trace_id``."""
        return _ActiveSpan(self, name, args or None, mode=_ROOT)

    def child_span(
        self, name: str, parent: Optional[TraceContext], **args
    ) -> _ActiveSpan:
        """Open a span under an explicit parent context (typically decoded
        off an RPC frame).  ``parent=None`` degrades to a plain span."""
        mode = _CHILD if parent is not None else _AUTO
        return _ActiveSpan(self, name, args or None, mode=mode, parent_ctx=parent)

    def record(
        self,
        name: str,
        start_ns: int,
        dur_ns: int,
        trace_id: Optional[int] = None,
        span_id: Optional[int] = None,
        parent_id: Optional[int] = None,
        args: Optional[dict] = None,
    ) -> None:
        """Append an already-timed span — for code that cannot hold a
        context manager open (the RPC client records its ``rpc.call`` span
        when the response future resolves, possibly on another thread)."""
        t = threading.current_thread()
        self._spans.append(
            Span(
                name,
                start_ns,
                dur_ns,
                t.ident or 0,
                t.name,
                args or None,
                trace_id,
                span_id,
                parent_id,
            )
        )

    def event(self, name: str, **args) -> None:
        """Record an instant event (zero-duration marker) at now, tagged
        with the active trace context if any."""
        ctx = current_context()
        t = threading.current_thread()
        self._spans.append(
            Span(
                name,
                time.perf_counter_ns(),
                None,
                t.ident or 0,
                t.name,
                args or None,
                ctx.trace_id if ctx is not None else None,
                ctx.span_id if ctx is not None else None,
                None,
            )
        )

    def enable_torch_annotations(self, enabled: bool = True) -> None:
        """Mirror every span into ``torch.profiler.record_function`` so host
        phases appear inside profiler traces.  Off by default: creating an
        annotation per span costs even when no device trace is running."""
        self._annotate = bool(enabled)

    def clear(self) -> None:
        self._spans.clear()

    def spans(self) -> List[Span]:
        return list(self._spans)

    # ------------------------------------------------------------- exporting
    def chrome_trace(self) -> Dict[str, object]:
        """Chrome trace-event JSON object: ``{"traceEvents": [...]}`` of
        "X" (complete) events, timestamps in microseconds.  Loadable by
        chrome://tracing and Perfetto, mergeable next to a torch.profiler trace.
        Top-level ``metadata.clock_sync`` anchors this process's monotonic
        span clock to unix time for ``scripts/trace_merge.py``.
        """
        pid = os.getpid()
        events: List[dict] = []
        seen_tids = {}
        for s in self.spans():
            if s.tid not in seen_tids:
                seen_tids[s.tid] = s.thread_name
                events.append(
                    {
                        "ph": "M",
                        "pid": pid,
                        "tid": s.tid,
                        "name": "thread_name",
                        "args": {"name": s.thread_name},
                    }
                )
            ev = {
                "ph": "X" if s.dur_ns is not None else "i",
                "pid": pid,
                "tid": s.tid,
                "name": s.name,
                "ts": s.start_ns / 1000.0,
            }
            if s.dur_ns is not None:
                ev["dur"] = s.dur_ns / 1000.0
            else:
                ev["s"] = "t"
            if s.args:
                ev["args"] = dict(s.args)
            if s.span_id is not None:
                ids = ev.setdefault("args", {})
                ids["trace_id"] = f"{s.trace_id:032x}"
                ids["span_id"] = f"{s.span_id:016x}"
                if s.parent_id is not None:
                    ids["parent_id"] = f"{s.parent_id:016x}"
            events.append(ev)
        unix_ns, perf_ns = self._clock_anchor
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "clock_sync": {
                    "pid": pid,
                    "unix_time_ns": unix_ns,
                    "perf_counter_ns": perf_ns,
                }
            },
        }

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path`` (atomic rename)."""
        data = self.chrome_trace()
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
        return path


_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer


def span(name: str, **args) -> _ActiveSpan:
    """``with telemetry.span("act"): ...`` against the default tracer."""
    return get_tracer().span(name, **args)


def root_span(name: str, **args) -> _ActiveSpan:
    """Start a new trace on the default tracer (see :meth:`Tracer.root_span`)."""
    return get_tracer().root_span(name, **args)


def child_span(name: str, parent: Optional[TraceContext], **args) -> _ActiveSpan:
    """Continue a remote trace on the default tracer (see
    :meth:`Tracer.child_span`)."""
    return get_tracer().child_span(name, parent, **args)
