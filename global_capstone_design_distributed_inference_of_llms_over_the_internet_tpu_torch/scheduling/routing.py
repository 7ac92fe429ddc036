"""Latency-aware route planning over swarm block coverage.

The reference's client routes greedily: cover the next uncovered block with
the candidate whose span reaches furthest, tie-break throughput
(``src/rpc_transport.py:440-449``). Upstream Petals goes further: the
announcer pings its likely next-hop servers and publishes the RTTs
(``petals/server/server.py:760-767``), and the client picks the sequence
minimizing estimated end-to-end step time. This module is that planner,
TPU-framework edition — a pure function over registry records so it is
directly property-testable (SURVEY.md §4 "implication").

Cost model for a route  client → s1 → s2 → … → sk (final):

    cost = Σ_hops [ rtt(prev, s) + span_tokens(s) / throughput(s) ]

* ``rtt(prev, s)`` — seconds, from the *predecessor's* published
  ``next_server_rtts`` (servers ping the peers that start where they end);
  for the first hop, from the client's own ping table. Missing measurements
  fall back to ``default_rtt`` so unmeasured peers are neither free nor
  excluded.
* ``span_tokens(s)/throughput`` — the server's own advertised rate (requests/s
  → we charge 1/throughput per block served, matching how the LB algorithms
  treat a span's cost; ``src/load_balancing.py:151-172``).

The planner runs Dijkstra over states ``(covered_block, peer)`` — the cost to
have blocks [start, covered) done with the activation sitting on ``peer``.
Edges enter server ``r`` at any block inside its span (sub-span serving is
supported by the executor), so a hop may start mid-span exactly like the
greedy router's coverage walk.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .registry import ServerRecord, ServerState

DEFAULT_RTT = 0.05  # seconds; unmeasured link penalty (WAN-scale, not free)

# Entry state: the client itself holds the activation after stage0.
CLIENT = "__client__"


class RouteHop:
    """One planned hop: ``record`` serves ``[entry, end)``."""

    __slots__ = ("record", "entry", "end")

    def __init__(self, record: ServerRecord, entry: int, end: int):
        self.record = record
        self.entry = entry
        self.end = end

    def __repr__(self):  # pragma: no cover - debug aid
        return f"RouteHop({self.record.peer_id}, [{self.entry},{self.end}))"


def hop_rtt(prev_peer: str, record: ServerRecord,
            records_by_id: Mapping[str, ServerRecord],
            client_rtts: Mapping[str, float],
            default_rtt: float) -> float:
    """RTT estimate for prev_peer → record, preferring measured values."""
    if prev_peer == CLIENT:
        rtt = client_rtts.get(record.peer_id)
    else:
        prev = records_by_id.get(prev_peer)
        rtts = getattr(prev, "next_server_rtts", None) if prev else None
        rtt = rtts.get(record.peer_id) if rtts else None
    base = default_rtt if rtt is None else rtt
    # A relayed peer is reached via its volunteer — traffic pays the sender→
    # relay leg (the base above: measured or default) PLUS the relay→peer
    # forwarding leg, which nobody measures. Charge the extra leg at
    # default_rtt so relayed peers lose ties against direct-reachable
    # equivalents (the reference's relay deprioritization, on top of the
    # RELAY_PENALTY already folded into the advertised throughput).
    if getattr(record, "relay_via", None):
        base += default_rtt
    return base


def plan_min_latency_route(
    records: Sequence[ServerRecord],
    start_block: int,
    total_blocks: int,
    *,
    client_rtts: Optional[Mapping[str, float]] = None,
    default_rtt: float = DEFAULT_RTT,
    exclude: Sequence[str] = (),
) -> Optional[List[RouteHop]]:
    """Minimum-estimated-latency route covering [start_block, total_blocks).

    Returns None when no live coverage exists (caller falls back to greedy
    routing or raises its NoRouteError).
    """
    client_rtts = client_rtts or {}
    excluded = set(exclude)
    live = [
        r for r in records
        if r.state == ServerState.ONLINE and r.peer_id not in excluded
        and r.end_block > start_block and r.throughput > 0
    ]
    if not live:
        return None
    by_id = {r.peer_id: r for r in live}

    # Dijkstra state: (cost, covered_block, peer_id); parent pointers rebuild
    # the hop list. States are (block, peer) pairs — the RTT of the next edge
    # depends on who currently holds the activation.
    start_state = (start_block, CLIENT)
    best: Dict[Tuple[int, str], float] = {start_state: 0.0}
    parent: Dict[Tuple[int, str], Tuple[Tuple[int, str], ServerRecord]] = {}
    heap: List[Tuple[float, int, str]] = [(0.0, start_block, CLIENT)]

    goal: Optional[Tuple[int, str]] = None
    while heap:
        cost, block, peer = heapq.heappop(heap)
        state = (block, peer)
        if cost > best.get(state, float("inf")):
            continue
        if block >= total_blocks:
            rec = by_id.get(peer)
            if rec is not None and rec.final_stage:
                goal = state
                break
            continue  # covered all blocks but last hop can't finish — dead end
        for r in live:
            if not (r.start_block <= block < r.end_block):
                continue
            end = min(r.end_block, total_blocks)
            step = (hop_rtt(peer, r, by_id, client_rtts, default_rtt)
                    + (end - block) / r.throughput)
            nxt = (end, r.peer_id)
            ncost = cost + step
            if ncost < best.get(nxt, float("inf")):
                best[nxt] = ncost
                parent[nxt] = (state, r)
                heapq.heappush(heap, (ncost, end, r.peer_id))

    if goal is None:
        return None
    hops: List[RouteHop] = []
    state = goal
    while state in parent:
        prev_state, rec = parent[state]
        hops.append(RouteHop(rec, prev_state[0], state[0]))
        state = prev_state
    hops.reverse()
    _tm.get("scheduler_route_plans_total").labels(planner="latency").inc()
    _tm.get("scheduler_route_hops").observe(len(hops))
    _ev.emit("route_planned", planner="latency", hops=len(hops),
             peers=",".join(h.record.peer_id for h in hops))
    return hops


def route_cost(hops: Sequence[RouteHop], *,
               client_rtts: Optional[Mapping[str, float]] = None,
               default_rtt: float = DEFAULT_RTT) -> float:
    """Estimated per-step latency of a planned route (for tests/metrics)."""
    client_rtts = client_rtts or {}
    by_id = {h.record.peer_id: h.record for h in hops}
    total, prev = 0.0, CLIENT
    for h in hops:
        total += hop_rtt(prev, h.record, by_id, client_rtts, default_rtt)
        total += (h.end - h.entry) / h.record.throughput
        prev = h.record.peer_id
    return total
