"""Cross-stage request tracing (Dapper-style spans over the pipeline hops).

One decode step fans a request across independent stage servers
(client → stage0 → stage1 → … → stageN → sample). The trace context rides the
wire header (``StageRequest.trace`` / ``StageResponse.span`` in
runtime/messages.py; the net.py frame adds a ``"trace"`` key) so the hop chain
reconstructs end-to-end even when every hop is a different process:

    trace = {"trace_id": "<16 hex>", "parent": "<span_id>", "hop": <int>}

The CLIENT opens a root span per pipeline step plus one child span per hop
(kind="client", wall-clock enter/exit around the transport call). The SERVER
side opens its own span per received request (kind="server") keyed to the same
trace_id, reporting its timestamps back in the response's ``span`` dict so the
client can attribute wire time vs compute time per hop. Clocks are the peers'
own ``time.time()`` — cross-host skew is the reader's problem, exactly as in
Dapper; within one host (the in-process LocalTransport rig and the tests) the
timeline is exact.

Disabled (the default) the tracer hands out a single shared no-op span and
allocates nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from collections import deque
from time import time as _wall
from typing import Dict, Optional, Tuple


def new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class Span:
    """One timed unit of work attributed to a trace."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    kind: str                       # "client" | "server" | "internal"
    start_s: float                  # wall clock (time.time) at open
    end_s: Optional[float] = None
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    _tracer: Optional["Tracer"] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_s is None:
            return None
        return self.end_s - self.start_s

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> "Span":
        if attrs:
            self.attrs.update(attrs)
        if self.end_s is None:
            self.end_s = _wall()
            if self._tracer is not None:
                self._tracer._record(self)
        return self

    # wire encoding ---------------------------------------------------------

    def wire_context(self, hop: int = 0) -> Dict[str, object]:
        """The dict a request carries downstream: children of THIS span."""
        return {"trace_id": self.trace_id, "parent": self.span_id, "hop": hop}

    def to_wire(self) -> Dict[str, object]:
        """The dict a SERVER reports back in its response (span summary)."""
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "start_s": self.start_s,
        }
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        if self.end_s is not None:
            out["end_s"] = self.end_s
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", repr(exc))
        self.end()


class _NoopSpan:
    """Shared inert span: every method is a cheap no-op, so disabled tracing
    adds one boolean check and zero allocation per would-be span."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    end_s = None
    duration_s = None
    attrs: Dict[str, object] = {}

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return self

    def wire_context(self, hop: int = 0):
        return None

    def to_wire(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def __bool__(self) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Bounded in-memory span store. Finished spans land in a ring buffer
    (oldest evicted) — enough to reconstruct recent steps without growing
    without bound on a long-lived server."""

    def __init__(self, enabled: bool = True, max_spans: int = 4096):
        self._enabled = bool(enabled)
        self._spans: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def start_span(self, name: str, *, trace_id: Optional[str] = None,
                   parent_id: Optional[str] = None, kind: str = "internal",
                   **attrs):
        """Open a span. With tracing disabled returns the shared no-op span;
        span.end() files it into the buffer."""
        if not self._enabled:
            return NOOP_SPAN
        return Span(
            trace_id=trace_id or new_id(),
            span_id=new_id(),
            parent_id=parent_id,
            name=name,
            kind=kind,
            start_s=_wall(),
            attrs=dict(attrs),
            _tracer=self,
        )

    def span_from_wire(self, trace: Optional[Dict[str, object]], name: str,
                       *, kind: str = "server", **attrs):
        """Server side: open a child span of an incoming wire context. A
        request without a trace (legacy client, tracing off) yields the no-op
        span, so server instrumentation is unconditional."""
        if not self._enabled or not trace:
            return NOOP_SPAN
        return self.start_span(
            name,
            trace_id=str(trace.get("trace_id") or new_id()),
            parent_id=trace.get("parent"),
            kind=kind,
            **attrs,
        )

    # -- reading ------------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None) -> Tuple[Span, ...]:
        with self._lock:
            if trace_id is None:
                return tuple(self._spans)
            return tuple(s for s in self._spans if s.trace_id == trace_id)

    def trace_ids(self) -> Tuple[str, ...]:
        seen, out = set(), []
        with self._lock:
            snap = tuple(self._spans)
        for s in snap:
            if s.trace_id not in seen:
                seen.add(s.trace_id)
                out.append(s.trace_id)
        return tuple(out)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


def reconstruct(spans: Tuple[Span, ...]) -> Dict[str, list]:
    """Group spans by trace_id, each sorted by start time — the flat form a
    trace viewer (or a test) wants."""
    out: Dict[str, list] = {}
    for s in spans:
        out.setdefault(s.trace_id, []).append(s)
    for tid in out:
        out[tid].sort(key=lambda s: (s.start_s, s.span_id))
    return out


# -- process-global tracer (default OFF, like the metrics registry) ----------

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL
