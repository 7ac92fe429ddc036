"""Gossip-replicated placement registry: epidemic anti-entropy over the
stage servers themselves, so the dedicated ``--mode registry`` processes
degrade from a hard dependency into a mere bootstrap seed.

The reference's control plane is a Kademlia DHT with no distinguished node
(``src/dht_utils.py:34-242``): any peer can bootstrap any other, and killing
every "well-known" node leaves the swarm discoverable through whoever is
still up. Our registry service replaced that DHT with primary+standby
processes — a coordinated failure domain the reference does not have
(VERDICT rec #5). This module restores the DHT's survivability WITHOUT
building a DHT, in the style of Demers et al., *Epidemic Algorithms for
Replicated Database Maintenance*: every serve process embeds a
`GossipNode` — a versioned mirror of the placement records — and
periodically runs a digest-then-delta anti-entropy exchange with a few
random live peers (piggybacked on its heartbeat cadence, over the same
framed TCP the data plane uses — `runtime.net.gossip_exchange`).

Versioning rules (the whole correctness story):

  * **Per-origin sequence numbers.** Each record is owned by exactly one
    origin peer, which stamps every refresh with a monotonically increasing
    ``seq``. Merge is newest-seq-wins per origin — order- and
    duplication-independent, so randomized delivery converges (the
    property test feeds the same churn in shuffled orders and asserts
    identical live sets).
  * **Relative-TTL encoding.** ``time.monotonic()`` values NEVER cross
    hosts (the registry's ``age_s`` precedent): a wire entry carries the
    seconds of liveness it has left, and the receiver re-anchors that
    against its own clock. Equal-seq merges keep the later local expiry,
    so a refresh seen twice via different paths never shortens a record's
    life.
  * **Grace-period tombstones.** ``unregister`` becomes a tombstone with
    the next seq, retained for ``tombstone_grace_s`` (default 2x TTL): an
    older live version still circulating cannot resurrect a deliberately
    removed record, while a genuine re-register (which takes a NEWER seq)
    beats the tombstone immediately. At equal seq the tombstone wins —
    deletion must dominate a concurrent refresh for the merge to be a
    semilattice join.

The mirror itself is a real `PlacementRegistry`, kept in lockstep with the
versioned entry table, so a stage server answers the registry service's
``register``/``heartbeat``/``list`` verbs (see `TcpStageServer`) with the
exact response shapes of `RegistryServer` — a client that lost every seed
can point `RemoteRegistry` at ANY live stage server and keep discovering.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .registry import (
    DEFAULT_TTL,
    PlacementRegistry,
    ServerRecord,
    dict_to_rec,
    rec_to_dict,
)

# How many random peers one anti-entropy tick exchanges with. Epidemic
# dissemination reaches the whole swarm in O(log N) rounds at any fanout
# >= 1; 2 keeps per-beat traffic trivial while halving the propagation
# constant vs. 1.
GOSSIP_FANOUT = 2


@dataclasses.dataclass
class _Entry:
    """One origin's latest known version (live record or tombstone)."""

    origin: str
    seq: int
    rec: Optional[dict]          # wire-form record; may be None on a tombstone
    dead: bool
    expires_at: float            # LOCAL monotonic deadline (ttl or grace)
    window: float                # full liveness window (ttl, or grace if dead)


class GossipNode:
    """Versioned, tombstoned mirror of the placement records. Thread-safe.

    Pure state machine: the wire work (framing, peer dialing, fault hooks)
    lives in ``runtime.net``; this class only versions, merges, and projects
    the entry table into its embedded `PlacementRegistry` mirror.
    """

    def __init__(self, peer_id: str, ttl: float = DEFAULT_TTL,
                 fanout: int = GOSSIP_FANOUT,
                 tombstone_grace_s: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        self.peer_id = peer_id
        self.ttl = float(ttl)
        self.fanout = int(fanout)
        self.tombstone_grace_s = (2.0 * self.ttl if tombstone_grace_s is None
                                  else float(tombstone_grace_s))
        # This process's own data-plane address: excluded from peer
        # selection (gossiping with yourself is a no-op round). Stamped by
        # the serve wiring once the listener is bound.
        self.self_address: Optional[str] = None
        # Seeded default keeps peer-selection order reproducible when the
        # caller does not inject an RNG (soaks pin token-identical reruns).
        self._rng = rng or random.Random(0)
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        # The query mirror: discovery-shaped reads (list verb, peer
        # selection) go through a real PlacementRegistry so TTL purge and
        # freshness ordering behave exactly like the dedicated registry.
        self.registry = PlacementRegistry(ttl=self.ttl, rng=random.Random(0))

    # -- local write surface (origin authority / mirror proxy) --------------

    def publish(self, rec: dict) -> int:
        """Register or refresh a record with the NEXT per-origin seq. Used
        by a serve process for its own record each heartbeat, and by the
        mirror when a peer writes ``register`` to us while the seeds are
        down (we become the introducing authority for that version)."""
        origin = rec["peer_id"]
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(origin)
            seq = (e.seq if e is not None else 0) + 1
            self._apply_locked(origin, seq, dict(rec), False,
                               self.ttl, self.ttl, now)
        return seq

    def apply_heartbeat(self, peer_id: str, throughput=None,
                        cache_tokens_left=None,
                        next_server_rtts=None) -> bool:
        """Mirror-side heartbeat: refresh a known live record under a new
        seq so the refresh propagates. Returns False for unknown (or
        tombstoned) peers — the caller's re-register repairs it, exactly
        the RegistryServer contract."""
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(peer_id)
            if e is None or e.dead or e.expires_at <= now or e.rec is None:
                return False
            rec = dict(e.rec)
            if throughput is not None:
                rec["throughput"] = throughput
            if cache_tokens_left is not None:
                rec["cache_tokens_left"] = cache_tokens_left
            if next_server_rtts is not None:
                rec["next_server_rtts"] = dict(next_server_rtts)
            self._apply_locked(peer_id, e.seq + 1, rec, False,
                               self.ttl, self.ttl, now)
            return True

    def apply_unregister(self, peer_id: str) -> None:
        """Tombstone a record under the next seq; the tombstone circulates
        for the grace window so older live versions cannot resurrect it."""
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(peer_id)
            seq = (e.seq if e is not None else 0) + 1
            self._apply_locked(peer_id, seq, e.rec if e is not None else None,
                               True, self.tombstone_grace_s,
                               self.tombstone_grace_s, now)
        _ev.emit("gossip_tombstone", peer=peer_id, seq=seq)

    # -- merge (the semilattice join) ---------------------------------------

    def _apply_locked(self, origin: str, seq: int, rec: Optional[dict],
                      dead: bool, ttl_left: float, window: float,
                      now: float) -> bool:
        """Apply one version; True if it changed the entry table. The order
        of application never matters: higher seq always wins, equal seq
        resolves tombstone-over-live then max-expiry — a deterministic join,
        which is what the convergence property test pins."""
        window = max(0.0, float(window))
        expires_at = now + max(0.0, min(float(ttl_left), window))
        e = self._entries.get(origin)
        if e is not None:
            if seq < e.seq:
                return False
            if seq == e.seq:
                if dead != e.dead:
                    if e.dead:          # tombstone wins the tie
                        return False
                elif expires_at > e.expires_at:
                    # Same version seen via a fresher path: extend liveness.
                    e.expires_at = expires_at
                    if not e.dead:
                        self._mirror_locked(e)
                    return False
                else:
                    return False
        self._entries[origin] = e = _Entry(origin, seq, rec, dead,
                                           expires_at, window)
        if dead:
            self.registry.unregister(origin)
        else:
            self._mirror_locked(e)
        return True

    def _mirror_locked(self, e: _Entry) -> None:
        """Project one live entry into the PlacementRegistry mirror with its
        true (relative) freshness restored — discovery's newest-first
        ordering and TTL purge then behave exactly like the seed registry."""
        rec = dict_to_rec(e.rec or {})
        self.registry.register(rec)
        rec.expires_at = e.expires_at
        rec.timestamp = e.expires_at - e.window

    def merge(self, entries: Sequence[dict]) -> int:
        """Apply a gossip delta; returns how many entries changed state."""
        now = time.monotonic()
        applied = 0
        with self._lock:
            for w in entries or ():
                origin = w.get("origin")
                if not origin:
                    continue
                dead = bool(w.get("dead"))
                window = float(w.get("window")
                               or (self.tombstone_grace_s if dead
                                   else self.ttl))
                applied += self._apply_locked(
                    origin, int(w.get("seq", 0)), w.get("rec"), dead,
                    float(w.get("ttl_s", window)), window, now)
        if applied:
            _tm.get("gossip_entries_merged_total").inc(applied)
        return applied

    # -- anti-entropy wire forms --------------------------------------------

    def digest(self) -> Dict[str, int]:
        """origin -> seq for every entry still circulating (tombstones
        included: a peer must learn the deletion, not just stop hearing
        refreshes)."""
        now = time.monotonic()
        with self._lock:
            self._gc_locked(now)
            return {o: e.seq for o, e in self._entries.items()}

    def delta_for(self, remote_digest: Dict[str, int]) -> List[dict]:
        """Entries the remote lacks (its digest shows no/older seq),
        relative-TTL encoded for transport."""
        remote_digest = remote_digest or {}
        now = time.monotonic()
        out = []
        with self._lock:
            self._gc_locked(now)
            for origin, e in self._entries.items():
                if int(remote_digest.get(origin, -1)) < e.seq:
                    out.append({"origin": origin, "seq": e.seq,
                                "dead": e.dead, "rec": e.rec,
                                "window": e.window,
                                "ttl_s": max(0.0, e.expires_at - now)})
        return out

    def _gc_locked(self, now: float) -> None:
        """Drop fully expired entries: a live record past its TTL (origin
        stopped heartbeating) and a tombstone past its grace. Keeping them
        longer would only re-announce dead state forever."""
        gone = [o for o, e in self._entries.items() if e.expires_at <= now]
        for o in gone:
            del self._entries[o]

    # -- queries -------------------------------------------------------------

    def live_servers(self, model: Optional[str] = None) -> List[ServerRecord]:
        return self.registry.live_servers(model=model)

    def live_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if not e.dead and e.expires_at > now)

    def live_records(self) -> List[dict]:
        """Verbatim wire-form record dicts of every live entry. Unlike
        ``live_servers()`` (which projects through ServerRecord and drops
        unknown keys), this keeps extras like the piggybacked ``stats``
        digest — the swarm-top view reads those."""
        now = time.monotonic()
        with self._lock:
            return [dict(e.rec) for e in self._entries.values()
                    if not e.dead and e.rec is not None
                    and e.expires_at > now]

    def select_peers(self, extra: Sequence[str] = ()) -> List[str]:
        """Up to `fanout` random peer addresses to exchange with this tick:
        the mirror's live records plus any `extra` addresses the caller
        knows (e.g. the seed registry's view during bootstrap, before the
        mirror has heard of anyone)."""
        cands = set(a for a in extra if a)
        for r in self.live_servers():
            if r.address and r.peer_id != self.peer_id:
                cands.add(r.address)
        cands.discard(self.self_address)
        if not cands:
            return []
        pool = sorted(cands)
        if len(pool) <= self.fanout:
            return pool
        return self._rng.sample(pool, self.fanout)


class GossipLoop(threading.Thread):
    """Anti-entropy driver: every `interval_s` (default TTL/3 — the same
    cadence as registry heartbeats, per the tentpole's piggyback contract)
    republish this server's own record into its node and run one exchange
    with each of a few random peers. `exchange` is injected from
    ``runtime.net`` (keeps this package wire-free): callable
    ``(node, address) -> (sent, merged)`` raising OSError-family on failure.
    """

    def __init__(self, node: GossipNode,
                 exchange: Callable[[GossipNode, str], tuple],
                 record_fn: Optional[Callable[[], Optional[dict]]] = None,
                 extra_peers_fn: Optional[Callable[[], Sequence[str]]] = None,
                 interval_s: Optional[float] = None):
        super().__init__(daemon=True, name=f"gossip-{node.peer_id}")
        self.node = node
        self.exchange = exchange
        self.record_fn = record_fn
        self.extra_peers_fn = extra_peers_fn
        self.interval_s = (node.ttl / 3.0 if interval_s is None
                           else float(interval_s))
        self._stop = threading.Event()

    def tick(self) -> int:
        """One anti-entropy round; returns entries merged (all peers)."""
        if self.record_fn is not None:
            rec = self.record_fn()
            if rec is not None:
                self.node.publish(rec)
        extra: Sequence[str] = ()
        if self.extra_peers_fn is not None:
            try:
                extra = self.extra_peers_fn() or ()
            except Exception:       # seed registry down — gossip continues
                extra = ()
        merged_total = 0
        for addr in self.node.select_peers(extra):
            try:
                _sent, merged = self.exchange(self.node, addr)
                merged_total += merged
            except (ConnectionError, OSError, TimeoutError):
                # A dead/faulted peer costs this round nothing but the
                # failed dial; its record ages out of selection via TTL.
                continue
        _tm.get("gossip_mirror_records").set(self.node.live_count())
        return merged_total

    def run(self) -> None:
        # First round runs IMMEDIATELY: a just-started server must seed its
        # mirror (and its RemoteRegistry's peers cache, via extra_peers_fn's
        # list read) before the seeds can die, not one interval later.
        while True:
            try:
                self.tick()
            except Exception:
                # The loop must outlive any single bad round: gossip is the
                # survivability layer, it cannot itself be fragile.
                import logging
                logging.getLogger(__name__).exception("gossip tick failed")
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
