"""Deterministic, seeded fault injection for the real TCP data plane.

The reference project validated fault tolerance by SIGTERM-ing server
processes and eyeballing logs (``scripts/kill_stage.py``,
``scripts/test_fault_tolerance.py`` — a MANUAL protocol, SURVEY.md §4).
Our `LocalTransport` made failover deterministic, but only for the fake
in-process backend; the framed-TCP stack (CRC'd frames, chunked tensors,
persistent streams, push chains, HA registry) never saw an injected
partial write or corrupt frame. This module closes that gap: a declarative
`FaultPlan` — seeded RNG plus a schedule of `FaultRule`s — that the real
socket paths in ``runtime/net.py`` consult at three seams:

  * ``connect`` — client-side dial (`TcpTransport._connect`);
  * ``send``    — every frame write, via the `FaultSocket` wrapper that
    replaces a raw socket's ``sendall`` (both client request frames and
    server response frames);
  * ``dispatch``/``registry`` — server-side frame handling
    (`_FramedTcpServer`'s per-connection loop, `RegistryServer`).

Every hook is a no-op when no plan is installed: the hot path pays one
attribute read (``plan is None``) and never wraps a socket, so the
zero-overhead acceptance bound (bench fused-decode / recorder_overhead
< 1%) holds by construction.

Fault kinds (`FaultRule.kind`):

  ``refuse_connect``      dial fails (ConnectionRefusedError -> the
                          transport's normal PeerUnavailable mapping);
  ``accept_hang``         server accepts the frame, sleeps ``delay_s``,
                          then closes without replying (hung host);
  ``reset_mid_frame``     half the frame is written, then the socket is
                          torn down (mid-stream RST);
  ``partial_write_stall`` half the frame, a ``delay_s`` stall, then the
                          rest (slow/bufferbloated link — no error, the
                          frame still arrives intact);
  ``corrupt_payload``     the frame's trailing CRC byte is flipped, so
                          the receiver's CRC-32C check fails closed
                          (WireError) — models on-the-wire corruption;
  ``delay``               the write/dispatch sleeps ``delay_s`` first;
  ``duplicate``           the verb is PROCESSED twice, replied once —
                          at-least-once delivery against idempotent
                          control verbs (registry heartbeat/register);
  ``stale_registry``      the registry rewinds every record's freshness
                          by ``age_s`` (`PlacementRegistry.age_records`)
                          before answering — models a partitioned /
                          lagging control plane.
  ``gossip_drop``         a stage server's gossip dispatch swallows the
                          anti-entropy frame (no merge, no reply) — the
                          initiator's round dies and convergence must
                          ride a later round with another peer.
                          ``duplicate`` also arms at the gossip site (the
                          delta merged twice proves merge idempotency on
                          the wire); delaying/hanging a gossip frame needs
                          no new kind — a ``delay``/``accept_hang`` rule
                          with ``verb="gossip"`` rides the generic
                          dispatch hook.
  ``relay_drop``          a relay volunteer drops the frame it was asked
                          to forward on behalf of a NAT'd peer and answers
                          with the push-chain error shape instead (blaming
                          itself via ``breaker_peer`` — the relayed peer's
                          breaker must stay closed);
  ``relay_stall``         the volunteer sleeps ``delay_s`` before
                          forwarding — a congested relay; the frame still
                          arrives and no failover is required.

Determinism: matching is pure counting (per-rule ``nth``/``every``/
``times``) plus an RNG seeded at plan construction for ``prob`` rules and
jitter, so the same plan against the same traffic fires identically —
which is what lets the chaos harness assert token-for-token equality with
a fault-free run (``--mode chaos``).

Plans serialize (`to_dict`/`from_dict`) so a controller can install them
over the wire: the ``fault`` admin verb (gated by
``--allow_fault_injection``) on stage servers and registries. Every
firing emits a ``fault_injected`` event (doctor treats it as a failure
trigger) and bumps ``transport_faults_injected_total{kind=...}``, and is
appended to an in-memory log the ``fault`` verb's ``report`` action
returns — the chaos soak diffs that log against the doctor's
reconstructed failure chains.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev

KINDS = (
    "refuse_connect",
    "accept_hang",
    "reset_mid_frame",
    "partial_write_stall",
    "corrupt_payload",
    "delay",
    "duplicate",
    "stale_registry",
    "gossip_drop",
    "relay_drop",
    "relay_stall",
)

# Which sites can act on which kinds (documentation + validation; the call
# sites pass the kinds they implement to `fire`). The registry's dispatch
# loop already consults the generic "dispatch" site for accept_hang/delay —
# its own site holds only the verbs-must-be-processed kinds, so one rule
# can never be double-counted at two seams of the same frame.
SITE_KINDS = {
    "connect": ("refuse_connect",),
    "send": ("reset_mid_frame", "partial_write_stall", "corrupt_payload",
             "delay"),
    "dispatch": ("accept_hang", "delay"),
    "registry": ("duplicate", "stale_registry"),
    # The gossip seam sits INSIDE a stage server's dispatch, after the
    # generic dispatch hooks (which already give gossip-verb rules
    # accept_hang/delay — a stalled or swallowed-with-hang exchange), and
    # consults only gossip-frame traffic: drop kills the exchange,
    # duplicate merges the delta twice (anti-entropy merge is idempotent;
    # this proves it on the wire).
    "gossip": ("gossip_drop", "duplicate"),
    # The relay seam is the volunteer's forward site (`TcpStageServer.
    # _relay_forward`): after the generic dispatch hooks, before the pooled
    # dial to the relayed peer. `peer` matches the relayed TARGET (not the
    # client), so a rule can break one NAT'd peer's circuit specifically.
    "relay": ("relay_drop", "relay_stall"),
}

SIDES = ("client", "server", "registry")


@dataclasses.dataclass
class FaultRule:
    """One scheduled fault. ``None`` match fields are wildcards."""

    kind: str
    side: Optional[str] = None       # where the rule arms: client|server|registry
    peer: Optional[str] = None       # remote peer_id (client-side sites only)
    verb: Optional[str] = None       # wire verb of the frame being handled
    nth: Optional[int] = None        # fire ONLY on the nth matching call (1-based)
    every: Optional[int] = None      # fire on every k-th matching call
    times: Optional[int] = 1         # max firings; None = unlimited
    prob: Optional[float] = None     # seeded coin per matching call
    delay_s: float = 0.05            # stall/hang duration
    age_s: float = 0.0               # stale_registry: seconds to rewind records

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {', '.join(KINDS)})")
        if self.side is not None and self.side not in SIDES:
            raise ValueError(f"unknown fault side {self.side!r}")


class FaultPlan:
    """A seeded schedule of `FaultRule`s with thread-safe match counting.

    One plan may hold rules for every side; each injection site passes its
    own (site, side, kinds) so only the rules it can act on are consulted.
    `fire` returns at most ONE rule per call (first match in declaration
    order) — keeps the fault sequence a deterministic function of the
    traffic, which the chaos harness's token-equality assertion relies on.
    """

    def __init__(self, rules, seed: int = 0):
        self.rules: Tuple[FaultRule, ...] = tuple(
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._matches = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)
        self.firings: List[Dict[str, Any]] = []

    # -- matching -----------------------------------------------------------

    def fire(self, site: str, kinds: Tuple[str, ...], *,
             side: Optional[str] = None, peer: Optional[str] = None,
             verb: Optional[str] = None,
             session: Optional[str] = None) -> Optional[FaultRule]:
        """Return the rule (if any) that fires for this call, recording it.

        `kinds` is the subset of fault kinds the CALLER implements at this
        site; rules of other kinds are never matched (and never counted)
        here, so a plan mixing send- and dispatch-level rules stays
        deterministic at each seam independently.
        """
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.kind not in kinds:
                    continue
                if rule.side is not None and side is not None \
                        and rule.side != side:
                    continue
                if rule.peer is not None and rule.peer != peer:
                    continue
                if rule.verb is not None and rule.verb != verb:
                    continue
                self._matches[i] += 1
                n = self._matches[i]
                if rule.times is not None and self._fired[i] >= rule.times:
                    continue
                if rule.nth is not None and n != rule.nth:
                    continue
                if rule.every is not None and n % rule.every != 0:
                    continue
                if rule.prob is not None \
                        and self._rng.random() >= rule.prob:
                    continue
                self._fired[i] += 1
                rec = {"kind": rule.kind, "site": site, "side": side,
                       "peer": peer, "verb": verb, "session": session,
                       "match_n": n, "rule": i}
                self.firings.append(rec)
                break
            else:
                return None
        # Telemetry outside the lock: emit/inc may take their own locks.
        _ev.emit("fault_injected", session_id=session, peer=peer,
                 kind=rule.kind, site=site, verb=verb)
        _tm.get("transport_faults_injected_total").labels(
            kind=rule.kind).inc()
        return rule

    # -- introspection / wire -----------------------------------------------

    def report(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(f) for f in self.firings]

    def fired_count(self) -> int:
        with self._lock:
            return sum(self._fired)

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "rules": [dataclasses.asdict(r) for r in self.rules]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(d.get("rules", ()), seed=d.get("seed", 0))


class FaultSocket:
    """A socket proxy that routes ``sendall`` through a `FaultPlan`.

    Installed ONLY when a plan is armed (`TcpTransport._connect` wraps new
    pooled sockets; `_FramedTcpServer`'s handler wraps the accepted
    connection), so the plan-less hot path never sees the indirection.
    ``ctx_verb``/``ctx_session`` are stamped by the call sites just before
    a frame write so send-level rules can target specific verbs/sessions.
    Everything except ``sendall`` delegates to the wrapped socket —
    streams, recv loops and connection-close bookkeeping are untouched.
    """

    __slots__ = ("_sock", "_plan", "side", "peer", "ctx_verb", "ctx_session")

    def __init__(self, sock, plan: FaultPlan, side: str,
                 peer: Optional[str] = None):
        self._sock = sock
        self._plan = plan
        self.side = side
        self.peer = peer
        self.ctx_verb: Optional[str] = None
        self.ctx_session: Optional[str] = None

    def __getattr__(self, name):
        return getattr(self._sock, name)

    # Hash/compare AS the wrapped socket: server-side per-connection state
    # (TcpStageServer._streams) is keyed on the object handed to _dispatch,
    # while socketserver's shutdown_request cleans up with the RAW accepted
    # socket — both must land on the same dict slot whether or not a plan
    # was armed mid-connection. (`__getattr__` never covers dunders.)

    def __hash__(self):
        return hash(self._sock)

    def __eq__(self, other):
        if isinstance(other, FaultSocket):
            return self._sock is other._sock
        return self._sock is other

    def sendall(self, data) -> None:
        rule = self._plan.fire(
            "send", SITE_KINDS["send"], side=self.side, peer=self.peer,
            verb=self.ctx_verb, session=self.ctx_session)
        if rule is None:
            self._sock.sendall(data)
            return
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
            self._sock.sendall(data)
            return
        buf = bytes(data)
        if rule.kind == "corrupt_payload":
            # Flip the frame's LAST byte — always inside the trailing
            # crc32c u32 (both whole frames and chunk segments end with
            # one), so the receiver fails closed with WireError and the
            # stream lengths stay consistent (no desync, no hang).
            self._sock.sendall(buf[:-1] + bytes((buf[-1] ^ 0xFF,)))
            return
        half = max(1, len(buf) // 2)
        if rule.kind == "partial_write_stall":
            self._sock.sendall(buf[:half])
            time.sleep(rule.delay_s)
            self._sock.sendall(buf[half:])
            return
        # reset_mid_frame: a prefix goes out, then the connection dies.
        # The local caller sees the same ConnectionError a kernel RST
        # delivers; the remote side's _recv_frame hits EOF mid-frame.
        self._sock.sendall(buf[:half])
        try:
            self._sock.close()
        except OSError:
            pass
        raise ConnectionResetError(
            f"fault: reset_mid_frame after {half}/{len(buf)} bytes")


def default_chaos_rules(peers, seed: int = 0) -> List[FaultRule]:
    """The stock soak schedule: >= 5 distinct RECOVERABLE fault kinds spread
    across the swarm's peers, deterministic for a given peer list. Chosen so
    every firing either recovers transparently (stall, delay, duplicate,
    stale registry) or drives the client's failover/replay path (refuse,
    hang, reset, corrupt) — never one that changes sampled tokens.
    """
    del seed  # reserved: the schedule is currently position-deterministic
    peers = list(peers)
    if not peers:
        raise ValueError("default_chaos_rules needs at least one peer")

    def peer(i):
        return peers[i % len(peers)]

    # nth values sit well inside the frame counts of even a SHORT soak
    # (a ~10-token generation sends >= 10 frames per peer and each server
    # answers >= 10), so every rule deterministically fires — the chaos
    # harness asserts coverage, and an unfireable rule would read as a
    # missed injection.
    return [
        # Dial-time refusal: the chaos transport's FIRST dial of peer 0.
        FaultRule("refuse_connect", side="client", peer=peer(0), nth=1),
        # One corrupt response frame from each armed server (the trailing
        # CRC byte flips -> the client fails closed with WireError).
        FaultRule("corrupt_payload", side="server", nth=2),
        # One mid-frame reset of a client request to the last peer.
        FaultRule("reset_mid_frame", side="client", peer=peer(-1), nth=4),
        # A server that accepts a frame then hangs once.
        FaultRule("accept_hang", side="server", nth=6, delay_s=0.1),
        # A slow link: partial write + stall (recovers without failover).
        FaultRule("partial_write_stall", side="client", peer=peer(0), nth=3,
                  delay_s=0.05),
        # At-least-once control-plane delivery.
        FaultRule("duplicate", side="registry", verb="heartbeat", times=2),
        # A lagging registry view.
        FaultRule("stale_registry", side="registry", verb="list", nth=2,
                  age_s=5.0),
    ]
