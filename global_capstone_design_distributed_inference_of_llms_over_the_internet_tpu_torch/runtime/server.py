"""Stage server lifecycle, fixed-split mode.

Port of the fixed-split part of the JAX package's ``runtime/server.py``: a
server for a statically assigned span registers on the placement registry
and refreshes its heartbeat every TTL/3, re-registering when the registry
forgot it; between beats it pings the servers of its likely next hops and
publishes the RTTs with its record. In an in-process swarm the server
joins a `LocalTransport`; ``--mode serve`` (``main.run_serve``) passes
none, serves the executor through a `TcpStageServer` and advertises its
address in the record. The elastic (load-balancing) server is not ported
(ROADMAP Queue 1 #4).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

from ..models.config import ModelConfig
from ..models.partition import StageSpec
from ..scheduling.registry import PlacementRegistry, ServerRecord, ServerState
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .executor import StageExecutor
from .transport import LocalTransport, Transport

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

# How many likely next-hop peers a server pings per heartbeat.
MAX_PINGED_NEXT_SERVERS = 5


def measure_next_server_rtts(
    registry: PlacementRegistry,
    ping: Callable[[ServerRecord], Optional[float]],
    peer_id: str,
    end_block: int,
    budget_s: Optional[float] = None,
    model: Optional[str] = None,
) -> Dict[str, float]:
    """Ping the live servers able to serve ``end_block`` (this server's
    likely next hops), newest first, and return {peer_id: rtt_seconds}.
    Unreachable peers are left out (absence, not infinity). ``budget_s``
    caps the whole sweep, checked between pings, so a pile-up of timeouts
    cannot stretch a heartbeat past the registry's TTL."""
    cands = [
        r for r in registry.live_servers(model=model)
        if r.peer_id != peer_id
        and r.start_block <= end_block < r.end_block
    ]
    cands.sort(key=lambda r: r.timestamp, reverse=True)
    deadline = None if budget_s is None else time.monotonic() + budget_s
    rtts: Dict[str, float] = {}
    for rec in cands[:MAX_PINGED_NEXT_SERVERS]:
        if deadline is not None and time.monotonic() >= deadline:
            break
        rtt = ping(rec)
        if rtt is not None:
            rtts[rec.peer_id] = rtt
    return rtts


def _pinger_from_transport(
    transport,
) -> Optional[Callable[[ServerRecord], Optional[float]]]:
    """A pinger on the transport's `ping`, or None when the transport does
    not override the base method (no RTT table is published then)."""
    tping = getattr(type(transport), "ping", None)
    if tping is None or tping is Transport.ping:
        return None
    return lambda rec: transport.ping(rec.peer_id)


class FixedStageServer:
    """Fixed-split server: a statically assigned span and its heartbeat.
    With `transport`, `start_serving` adds the executor to it; without,
    another front end serves `executor` at `address`. Given `executor`
    (a batched engine's adapter, say) it serves that one instead of
    building a `StageExecutor`; its record carries the executor's
    ``engine`` tag."""

    def __init__(
        self,
        peer_id: str,
        cfg: ModelConfig,
        spec: StageSpec,
        params: Params,
        registry: PlacementRegistry,
        transport: Optional[LocalTransport] = None,
        *,
        executor_kwargs: Optional[dict] = None,
        pinger: Optional[Callable[[ServerRecord], Optional[float]]] = None,
        model: Optional[str] = None,
        address: Optional[str] = None,
        executor=None,
    ):
        self.peer_id = peer_id
        self.address = address
        self.model = model
        self.spec = spec
        self.registry = registry
        self.transport = transport
        self._pinger = (pinger if pinger is not None
                        else _pinger_from_transport(transport))
        self.next_server_rtts: Dict[str, float] = {}
        self.executor = executor or StageExecutor(
            cfg, spec, params, peer_id=peer_id, **(executor_kwargs or {}))

    def _record(self) -> ServerRecord:
        return ServerRecord(
            peer_id=self.peer_id, start_block=self.spec.start,
            end_block=self.spec.end,
            state=ServerState.ONLINE, final_stage=self.spec.is_last,
            stage_index=self.spec.index,
            next_server_rtts=self._published_rtts(),
            model=self.model, address=self.address,
            engine=getattr(self.executor, "engine", "session"),
        )

    def start_serving(self) -> None:
        if self.transport is not None:
            self.transport.add_peer(self.peer_id, self.executor)
        self.registry.register(self._record())
        _ev.emit("server_join", peer=self.peer_id,
                 start_block=self.spec.start, end_block=self.spec.end)

    def _published_rtts(self) -> Optional[Dict[str, float]]:
        # None = nothing to say (last span, or no pinger); {} retracts
        # stale measurements.
        if self._pinger is None or self.spec.is_last:
            return None
        return dict(self.next_server_rtts)

    def ping_next_servers(self) -> Dict[str, float]:
        if self.spec.is_last or self._pinger is None:
            self.next_server_rtts = {}
        else:
            self.next_server_rtts = measure_next_server_rtts(
                self.registry, self._pinger, self.peer_id, self.spec.end,
                budget_s=self.registry.ttl / 6.0, model=self.model)
        return self.next_server_rtts

    def heartbeat_once(self) -> None:
        # Refresh first, measure after: a slow ping sweep must not delay
        # the refresh past the TTL.
        if not self.registry.heartbeat(
            self.peer_id,
            cache_tokens_left=self.executor.arena.tokens_left(),
            next_server_rtts=self._published_rtts(),
        ):
            self.registry.register(self._record())  # self-heal after expiry
            _ev.emit("server_rejoin", peer=self.peer_id)
        _tm.get("server_heartbeats_total").inc()
        self.ping_next_servers()

    def shutdown(self) -> None:
        if self.transport is not None:
            self.transport.remove_peer(self.peer_id)
        self.registry.unregister(self.peer_id)
        _ev.emit("server_leave", peer=self.peer_id)
