"""Transport abstraction between the pipeline client and stage servers.

Port of the JAX package's ``runtime/transport.py``: the `Transport` seam and
`LocalTransport`, every stage executor in one process, with deterministic
fault injection for tests (`kill`, `revive`, `fail_next`, and the `on_call`
tap that sees every request first). Transports raise `PeerUnavailable` (a
ConnectionError) for a dead peer, which the client's recovery wrapper fails
over. `LocalTransport` is the serving boundary of its peers, so it records
their ``transport_*`` and ``server_*`` metrics, the ``server_forward`` span
and the phase profiler's ``server`` phase. Its timings are host time: an
intermediate stage's step returns once its kernels are enqueued, and only
the last stage's includes the token read it already does. Stalls (and with
them ``transport_timeout``), deadlines, push chains and the training verb
are not ported yet.
"""

from __future__ import annotations

import abc
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from ..telemetry import get_tracer
from ..telemetry.profiling import get_profiler as _get_profiler
from .errors import register as _catalog
from .executor import StageExecutor
from .messages import StageRequest, StageResponse


@_catalog
class PeerUnavailable(ConnectionError):
    """The peer is dead/unreachable (the client must fail over)."""


class Transport(abc.ABC):
    """Client-side view: submit a request to a named peer."""

    @abc.abstractmethod
    def call(self, peer_id: str, request: StageRequest,
             timeout: Optional[float] = None) -> StageResponse:
        ...

    def end_session(self, peer_id: str, session_id: str) -> None:
        """Best-effort: release the session's KV lease on a peer."""


class LocalTransport(Transport):
    """In-process transport over a dict of stage executors.

    Fault injection: `kill(peer)` makes later calls raise PeerUnavailable
    until `revive(peer)`; `fail_next(peer, n)` fails the next n calls, then
    recovers (a transient partition)."""

    def __init__(self):
        self._peers: Dict[str, StageExecutor] = {}
        self._dead: Dict[str, bool] = {}
        self._fail_next: Dict[str, int] = {}
        self._lock = threading.Lock()
        # Optional per-call tap for tests: (peer_id, request) -> None. It runs
        # after this call read the peer's state, so a kill from the tap takes
        # effect from the next call on.
        self.on_call: Optional[Callable[[str, StageRequest], None]] = None
        # Telemetry (process-global registry and tracer; a no-op unless
        # enabled). Bytes are tensor nbytes, read from metadata.
        self._m_calls = _tm.get("transport_calls_total")
        self._m_sent = _tm.get("transport_bytes_sent_total")
        self._m_recv = _tm.get("transport_bytes_received_total")
        self._m_step = _tm.get("server_step_latency_seconds")
        self._m_tokens = _tm.get("server_tokens_total")
        self._m_requests = _tm.get("server_requests_total")

    def add_peer(self, peer_id: str, executor: StageExecutor) -> None:
        with self._lock:
            self._peers[peer_id] = executor
            self._dead[peer_id] = False

    def executor(self, peer_id: str) -> StageExecutor:
        with self._lock:
            return self._peers[peer_id]

    def peers(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._peers)

    def kill(self, peer_id: str) -> None:
        with self._lock:
            self._dead[peer_id] = True

    def revive(self, peer_id: str) -> None:
        with self._lock:
            self._dead[peer_id] = False

    def fail_next(self, peer_id: str, n: int = 1) -> None:
        with self._lock:
            self._fail_next[peer_id] = n

    def end_session(self, peer_id: str, session_id: str) -> None:
        with self._lock:
            executor = self._peers.get(peer_id)
            dead = self._dead.get(peer_id, True)
        if executor is not None and not dead:
            executor.drop_session(session_id)

    def call(self, peer_id: str, request: StageRequest,
             timeout: Optional[float] = None) -> StageResponse:
        t_in = time.monotonic()
        with self._lock:
            executor = self._peers.get(peer_id)
            dead = self._dead.get(peer_id, True)
            flake = self._fail_next.get(peer_id, 0)
            if flake > 0:
                self._fail_next[peer_id] = flake - 1
        if self.on_call is not None:
            self.on_call(peer_id, request)
        trace_id = (request.trace.get("trace_id")
                    if isinstance(request.trace, dict) else None)
        if executor is None or dead:
            _ev.emit("transport_error", session_id=request.session_id,
                     trace_id=trace_id, peer=peer_id, verb="forward",
                     error="peer not reachable")
            raise PeerUnavailable(f"peer {peer_id} is not reachable")
        if flake > 0:
            _ev.emit("transport_error", session_id=request.session_id,
                     trace_id=trace_id, peer=peer_id, verb="forward",
                     error="transient failure (injected)")
            raise PeerUnavailable(f"peer {peer_id} transient failure (injected)")
        phase = "prefill" if request.is_prefill else "decode"
        self._m_calls.labels(verb="forward").inc()
        if request.hidden is not None:
            self._m_sent.inc(request.hidden.nbytes)
        span = get_tracer().span_from_wire(
            request.trace, "server_forward", kind="server", peer=peer_id,
            phase=phase)
        t0 = time.monotonic()
        try:
            resp = executor.forward(request)
        except BaseException as exc:
            self._m_requests.labels(outcome="error").inc()
            span.end(error=repr(exc))
            raise
        dur = time.monotonic() - t0
        self._m_step.labels(phase=phase).observe(dur)
        self._m_tokens.labels(phase=phase).inc(request.seq_len)
        self._m_requests.labels(outcome="ok").inc()
        _get_profiler().observe("server", time.monotonic() - t_in)
        # queue_s: the wait at this boundary before compute; the doctor's
        # critical path splits the hop into queue and compute with it.
        span.set(cache_len=resp.cache_len, queue_s=max(0.0, t0 - t_in)).end()
        if resp.hidden is not None:
            self._m_recv.inc(resp.hidden.nbytes)
        if request.trace is not None:
            resp.span = span.to_wire()
        return resp
