"""Placement registry: the service-discovery layer (DHT-schema mirror).

The PyTorch port keeps this module as a copy of the JAX package's
``scheduling/registry.py``, telemetry hooks included; only this note
differs, and ``tests/test_torch_isolation.py`` holds the rest of the file
to the original.

The reference's control plane is a Kademlia DHT (``src/dht_utils.py``) storing
three kinds of records:

  * ``mini_petals:stage{N}``  -> {subkey=peer_id: (value, expiration)} — one
    record per pipeline stage, many servers per stage (``src/main.py:517-527``);
  * ``petals:module:<model>:block_i`` -> same, one record per transformer
    block, used by load balancing + module routing (``src/dht_utils.py:82-133``);
  * ``petals:server:<model>:<peer_id>`` -> server info blob
    (``src/dht_utils.py:34-79``).

On a TPU pod the ICI topology is static, so the hot path needs no discovery at
all (SURVEY.md §2.3); this registry exists for the *elastic multi-host* story:
servers register/heartbeat with a TTL, dead servers expire, clients discover
and load balancing reads coverage. Single-process implementation with the same
record schema; a multi-host deployment points every process at one registry
service (see runtime.dcn) — the schema is the contract, the backend is
swappable.

TTL/liveness semantics preserved: records expire TTL seconds after their last
refresh (reference default 45s, refreshed every TTL/3 — ``src/main.py:520-537``);
discovery prefers the newest records and picks randomly among the 5 freshest
(``src/rpc_transport.py:337-344``).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..telemetry import events as _ev

DEFAULT_TTL = 45.0          # src/main.py:524
DISCOVERY_POOL = 5          # random among 5 newest, src/rpc_transport.py:337-344


class ServerState:
    """Lifecycle states (``src/load_balancing.py:17-21``)."""

    JOINING = "joining"
    ONLINE = "online"
    OFFLINE = "offline"


@dataclasses.dataclass
class ServerRecord:
    """One server's registration (the DHT value at ``src/dht_utils.py:57-67``)."""

    peer_id: str
    start_block: int
    end_block: int
    throughput: float = 1.0
    state: str = ServerState.ONLINE
    final_stage: bool = False
    # Which model this server's span belongs to. Every reference DHT key
    # embeds the model name (``src/dht_utils.py:20-31``,
    # ``petals/server/server.py:738-744``) so multiple models can share one
    # control plane; records with different models never cross-route. None =
    # single-model swarm (matches any query — the pre-multi-model schema).
    model: Optional[str] = None
    # Serving engine capability: "session" (per-session executor — the full
    # protocol incl. beam/speculative/replay) or "batched" (continuous
    # slot-batched decode — plain prefill/decode only, but one compiled step
    # serves every concurrent session). Clients prefer batched peers for
    # plain sessions and per-session peers for the exotic verbs; the
    # reference's serving runtime is batch-first throughout
    # (petals/server/server.py:557-671).
    engine: str = "session"
    # engine="sp": the advertised long-context admission limit (prompt +
    # generated tokens) — prefix KV shards across the server's mesh, so this
    # scales with its device count. None for other engines.
    max_context: Optional[int] = None
    stage_index: Optional[int] = None      # fixed-split mode stage number
    cache_tokens_left: Optional[int] = None  # petals/server/server.py:721
    address: Optional[str] = None          # "host:port" for the TCP data plane
    # Measured RTTs (seconds) to likely next-hop peers, published with each
    # heartbeat — the _ping_next_servers signal (petals/server/server.py:760-767)
    # consumed by scheduling.routing's latency-aware planner.
    next_server_rtts: Optional[Dict[str, float]] = None
    # NAT relay data plane (petals/server/reachability.py): a server that
    # fails the dial-back vote attaches to a reachable volunteer and sets
    # relay_via to that volunteer's peer_id. Its `address` stays its OWN
    # advertised (unreachable) address; clients resolve relay_via -> the
    # volunteer's record and dial the volunteer instead, stamping frames
    # with relay_to so the volunteer forwards verbatim.
    relay_via: Optional[str] = None
    # Volunteer capability: how many relayed peers this server is willing to
    # forward for (0/None = does not volunteer). Attach requests beyond this
    # are shed with an error frame so load spreads across volunteers.
    relay_capacity: Optional[int] = None
    timestamp: float = dataclasses.field(default_factory=time.monotonic)
    expires_at: float = 0.0

    def expired(self, now: Optional[float] = None) -> bool:
        return (now or time.monotonic()) >= self.expires_at


# Wire schema for ServerRecord: the field set shipped by the registry
# service's register/list verbs AND by gossip deltas. Owned here (beside the
# dataclass) so every control-plane surface — runtime.net's RegistryServer,
# the gossip mirrors, the peers-cache file — serializes identically.
# `timestamp`/`expires_at` are deliberately absent: they are time.monotonic()
# values, meaningless across hosts; freshness crosses the wire as RELATIVE
# age/TTL-remaining and is re-anchored on receipt.
REC_FIELDS = ("peer_id", "start_block", "end_block", "throughput", "state",
              "final_stage", "stage_index", "cache_tokens_left", "address",
              "next_server_rtts", "model", "engine", "max_context",
              "relay_via", "relay_capacity")


def rec_to_dict(rec: "ServerRecord") -> dict:
    return {f: getattr(rec, f) for f in REC_FIELDS}


def dict_to_rec(d: dict) -> "ServerRecord":
    vals = {f: d.get(f) for f in REC_FIELDS}
    if vals.get("engine") is None:      # record from a pre-engine peer
        vals["engine"] = "session"
    return ServerRecord(**vals)


def _model_ok(rec: ServerRecord, model: Optional[str]) -> bool:
    """Model filter for discovery/coverage queries: a query for model M sees
    M's records plus legacy untagged ones; a query with no model sees all
    (single-model swarm). Mirrors the reference's model-prefixed DHT keys
    (``src/dht_utils.py:20-31``) — two models on one registry must never
    cross-route."""
    return model is None or rec.model is None or rec.model == model


class PlacementRegistry:
    """In-process registry with TTL liveness. Thread-safe."""

    def __init__(self, ttl: float = DEFAULT_TTL, rng: Optional[random.Random] = None):
        self.ttl = ttl
        self._lock = threading.Lock()
        self._servers: Dict[str, ServerRecord] = {}
        # Seeded default: choose_server tie-breaks must replay identically.
        self._rng = rng or random.Random(0)

    # -- registration / heartbeat ------------------------------------------

    def register(self, record: ServerRecord, ttl: Optional[float] = None) -> None:
        """Register or refresh a server (covers both ``register_server_on_dht``
        and ``register_blocks_on_dht`` — block coverage is derived from the
        span, there is no separate per-block write to keep consistent)."""
        now = time.monotonic()
        record.timestamp = now
        record.expires_at = now + (ttl if ttl is not None else self.ttl)
        with self._lock:
            self._servers[record.peer_id] = record

    def heartbeat(self, peer_id: str, throughput: Optional[float] = None,
                  cache_tokens_left: Optional[int] = None,
                  next_server_rtts: Optional[Dict[str, float]] = None) -> bool:
        """Refresh TTL (+ optionally throughput, mirroring
        ``update_server_throughput_on_dht``). Returns False if unknown."""
        now = time.monotonic()
        with self._lock:
            rec = self._servers.get(peer_id)
            if rec is None:
                return False
            rec.timestamp = now
            rec.expires_at = now + self.ttl
            if throughput is not None:
                rec.throughput = throughput
            if cache_tokens_left is not None:
                rec.cache_tokens_left = cache_tokens_left
            if next_server_rtts is not None:
                rec.next_server_rtts = dict(next_server_rtts)
            return True

    def unregister(self, peer_id: str) -> None:
        with self._lock:
            self._servers.pop(peer_id, None)

    def set_state(self, peer_id: str, state: str) -> None:
        with self._lock:
            rec = self._servers.get(peer_id)
            if rec is not None:
                rec.state = state

    def age_records(self, seconds: float) -> int:
        """Rewind every record's freshness by `seconds` (timestamp AND
        expiry), as if the registry stopped seeing heartbeats that long ago.
        Fault-injection surface (``runtime.faults`` kind
        ``stale_registry``): models a partitioned/lagging control plane —
        discovery keeps answering from aged records until TTL expiry culls
        them, exactly the staleness window a real outage produces. Returns
        the number of records aged."""
        with self._lock:
            for rec in self._servers.values():
                rec.timestamp -= seconds
                rec.expires_at -= seconds
            return len(self._servers)

    # -- queries ------------------------------------------------------------

    def _live(self, now: Optional[float] = None,
              model: Optional[str] = None) -> List[ServerRecord]:
        now = now or time.monotonic()
        with self._lock:
            # Purge expired entries on read (the DHT does this implicitly).
            dead = [p for p, r in self._servers.items() if r.expired(now)]
            for p in dead:
                del self._servers[p]
            live = [r for r in self._servers.values()
                    if _model_ok(r, model)]
        for p in dead:
            _ev.emit("registry_expired", peer=p)
        return live

    def live_servers(self, model: Optional[str] = None) -> List[ServerRecord]:
        return self._live(model=model)

    def get(self, peer_id: str) -> Optional[ServerRecord]:
        with self._lock:
            rec = self._servers.get(peer_id)
            if rec is not None and rec.expired():
                del self._servers[peer_id]
                rec = None
                expired = True
            else:
                expired = False
        if expired:
            _ev.emit("registry_expired", peer=peer_id)
        return rec

    def discover_stage(self, stage_index: int,
                       exclude: Sequence[str] = (),
                       model: Optional[str] = None,
                       prefer_engine: Optional[str] = None,
                       avoid_engine=None,
                       min_context: Optional[int] = None,
                       affinity: Optional[str] = None) -> Optional[str]:
        """Pick a server for a fixed-split stage: random among the 5 newest
        live candidates, excluding known-failed peers
        (``src/rpc_transport.py:270-353``). `prefer_engine` narrows to that
        engine when any such candidate exists (soft); `avoid_engine` (one
        name or a sequence) drops those candidates unless nothing else
        remains (a session that a batched/sp peer would refuse should not be
        routed to one). `affinity` (a prompt-head digest) replaces the
        random choice with a rendezvous hash — see `_pick_newest`."""
        cands = [
            r for r in self._live(model=model)
            if r.stage_index == stage_index and r.peer_id not in exclude
            and r.state == ServerState.ONLINE
        ]
        if min_context is not None:
            # An sp peer advertising less context than the session needs
            # WILL refuse its prefill — hard-drop those.
            cands = [r for r in cands
                     if r.engine != "sp" or r.max_context is None
                     or r.max_context >= min_context]
        if avoid_engine is not None:
            avoid = ((avoid_engine,) if isinstance(avoid_engine, str)
                     else tuple(avoid_engine))
            kept = [r for r in cands if r.engine not in avoid]
            if kept:
                cands = kept
        if prefer_engine is not None:
            preferred = [r for r in cands if r.engine == prefer_engine]
            if preferred:
                cands = preferred
        return self._pick_newest(cands, affinity=affinity)

    def discover_block(self, block: int, exclude: Sequence[str] = (),
                       model: Optional[str] = None) -> List[ServerRecord]:
        """All live ONLINE servers covering `block` (module-routing mode)."""
        return [
            r for r in self._live(model=model)
            if r.start_block <= block < r.end_block and r.peer_id not in exclude
            and r.state == ServerState.ONLINE
        ]

    def _pick_newest(self, cands: List[ServerRecord],
                     affinity: Optional[str] = None) -> Optional[str]:
        if not cands:
            return None
        if affinity is not None and len(cands) > 1:
            # Prefix-cache-aware replica choice (no reference counterpart):
            # rendezvous hash over (affinity, peer) — every client holding
            # the same prompt head lands on the SAME replica with zero
            # coordination, so its prefix store actually gets hits across
            # clients; distinct prompt heads spread uniformly. When the
            # chosen replica dies it simply leaves the candidate set and
            # only its share of prompts re-hashes elsewhere. Hashes over
            # ALL live candidates — the freshness-pool restriction below
            # would make the winner depend on heartbeat ordering, breaking
            # cross-client stability exactly when replicas are plentiful.
            import hashlib

            return max(cands, key=lambda r: hashlib.sha1(
                (affinity + r.peer_id).encode()).digest()).peer_id
        cands.sort(key=lambda r: r.timestamp, reverse=True)
        pool = cands[:DISCOVERY_POOL]
        return self._rng.choice(pool).peer_id

    def coverage(self, total_blocks: int,
                 model: Optional[str] = None) -> List[List[ServerRecord]]:
        """Per-block server lists — the shape of ``get_remote_module_infos``
        (``src/dht_utils.py:147-242``); feeds load balancing."""
        live = self._live(model=model)
        return [
            [r for r in live if r.start_block <= b < r.end_block]
            for b in range(total_blocks)
        ]
