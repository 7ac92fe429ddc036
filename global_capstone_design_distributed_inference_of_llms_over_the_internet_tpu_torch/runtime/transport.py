"""Transport abstraction between the pipeline client and stage servers.

Port of the JAX package's ``runtime/transport.py``: the `Transport` seam and
`LocalTransport`, every stage executor in one process, with deterministic
fault injection for tests (`kill`, `revive`, `fail_next`, and the `on_call`
tap that sees every request first). Transports raise `PeerUnavailable` (a
ConnectionError) for a dead peer, which the client's recovery wrapper fails
over. Telemetry, stalls, deadlines, push chains and the training verb are
not ported yet.
"""

from __future__ import annotations

import abc
import threading
from typing import Callable, Dict, Optional, Tuple

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
        with self._lock:
            executor = self._peers.get(peer_id)
            dead = self._dead.get(peer_id, True)
            flake = self._fail_next.get(peer_id, 0)
            if flake > 0:
                self._fail_next[peer_id] = flake - 1
        if self.on_call is not None:
            self.on_call(peer_id, request)
        if executor is None or dead:
            raise PeerUnavailable(f"peer {peer_id} is not reachable")
        if flake > 0:
            raise PeerUnavailable(f"peer {peer_id} transient failure (injected)")
        return executor.forward(request)
