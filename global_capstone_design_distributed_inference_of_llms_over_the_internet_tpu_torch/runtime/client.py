"""Pipeline client: routing, journaled fault tolerance, the generation loop.

Port of the plain path of the JAX package's ``runtime/client.py``: the
tokenized prompt runs through the local first stage, then every remote hop
of a fixed stage-chain route; the final hop returns a sampled token. Every
activation sent to a hop is journaled (bounded by coalescing the oldest
entries). Stop rules: EOS, and 5 identical tokens in a row.

Fault tolerance as in the reference (``client.py:676-877``): a hop whose
call fails with a retryable error (``runtime/errors.retryable_types``) is
blacklisted for its stage, a replacement is discovered in the registry
(with an amnesty when every candidate is blacklisted), the hop's journal is
replayed to rebuild the replacement's KV cache, and the call is retried —
at most ``MAX_ATTEMPTS`` attempts, gated by a per-peer `CircuitBreaker`.

Telemetry as in the reference: the client's metrics live in a private,
always-on registry unless the caller passes one (``main.py`` passes the
process-global registry under ``--telemetry``); session, failover and
replay events go to the flight recorder; each pipeline step is one trace
(a ``pipeline_step`` root, a span per hop, each recording its server's
span). Every field is a host value the client already holds. Under the
phase profiler each hop attempt's transport call is the ``socket`` phase.

Routes as the reference's (``client.py:618-656``, ``:1432-1441``): a
session's replicas are picked by a rendezvous hash of its prompt head
(`prompt_affinity`), so shared-prefix prompts from any client land on the
peers whose prefix stores are warm; routes are cached by (kind,
min_context, affinity), the least recently used affinity route evicted
past ``route_cache_capacity`` (``client_route_cache_evictions_total``).
Every prefill is marked shareable: stage 0 with ``prefix_len`` the prompt's
length, each hop too (``prefix_len`` only on a prefill).

Burst generation (``generate(..., burst=N)``, the reference's
``_generate_steps_burst``): the whole session runs on one full-span
batched peer (``runtime/batching.py``), which answers each decode request
with up to N tokens sampled on its device; the journal holds one
multi-token entry a burst, so a replacement full-span peer replays the
session across burst boundaries, and the client's per-token stop scan
stays the authority. With no full-span batched peer live the session
falls back to the per-step loop and emits ``burst_fallback``.

Deadlines and priority as the reference's (``client.py:725-745``,
``:931-958``, ``:1599-1679``): ``generate(..., deadline_s=)`` sets an
end-to-end budget, ``generate_stepwise(..., deadline_at=, priority=)``
takes the gateway's absolute deadline and tenant priority. Every remote
hop, and every request of the burst path, carries the budget left when it
is sent (``deadline_budget_s``) and the session's priority; a spent budget
raises `DeadlineExceeded` before the hop is dialed, counted in
``client_deadline_expired_total`` with a ``deadline_expired`` event. As in
the reference, stage 0 (in process) and replays carry neither.

Module routing (``use_module_routing``, the reference's
``client.py:564-616``), for swarms of elastic servers whose spans overlap:
the route covers [stage 0's end, total_blocks) hop by hop, each hop the
live server that covers the next block and reaches furthest (then a
batched engine on equal reach, then throughput), its hop key
``blocks{n}``; a hop may enter a server mid-span (``start_block``), a
server whose reach does not grow the coverage stops the walk, and the last
hop must serve the final stage. A failed hop's replacement must cover the
hop's exact span. ``route_by_latency`` (which implies module routing)
plans the route of least estimated step time instead
(``scheduling/routing.plan_min_latency_route``: the servers' published
next-hop RTTs, the client's own pings of first-hop candidates, cached
``ping_cache_ttl`` seconds), falling back to the greedy walk when it finds
none. The module router ignores the prompt head's affinity.

Push chains (``use_push_chain``, the reference's ``client.py:1011-1266``):
the client makes one call a step, to the route's first hop, naming the
rest of the route in ``next_servers``; each server hands its output to the
next hop and relays the final token back. A hop behind a relay is named at
its volunteer's address with ``relay_via``. The journal holds stage 0's
outputs under ``CHAIN_KEY``, so a failed chain (the failed hop blamed,
read from the error, or by a liveness probe after a bare timeout) is
replayed whole through a freshly routed chain. Chain sessions route as
the reference's "exotic" kind, around the batched engines where another
peer serves the stage. Unlike the reference's chain, a prefill carries
``prefix_len`` along the chain, as the per-hop walk does.

Speculative decoding (``generate(..., speculative_k=K)``, the reference's
``client.py:1480-1560``): each decode round drafts up to K tokens
(``draft_fn(context, k)``, by default the n-gram prompt lookup of
``runtime/speculative.py``) and sends [last token, drafts] as one step of
K + 1 rows through every stage; the final stage verifies them and answers
with the accepted run and one correction or bonus token. Every speculative
step, stage 0's included, carries ``start_from_position = cur_len``, which
drops the previous round's rejected overhang; ``cur_len`` advances by the
tokens accepted, and the EOS and repeat stops are checked token by token
inside the run. Speculative sessions route as their own kind ("spec"): to
batched peers where a stage has one, as plain sessions do. After each
round the hop journals (or the chain journal) drop the step's rejected
rows (`_amend_speculative_journal`).

Beam search (``beam_search``, the reference's ``client.py:1747-1864``):
the prompt is prefilled once at batch 1; every later step sends the
surviving hypotheses' last tokens as one batch with ``hypo_ids``, the KV
row each continues from (``(0,) * num_beams`` at the first step grows every
stage's session to num_beams rows; an identity reorder is sent as None),
and ``num_logprobs = 2 * num_beams``, so the final stage answers each
row's top candidates. The client keeps the reference's candidate pool,
stable sort, EOS and length-penalty rules. Beam sessions route as the
"exotic" kind, around the batched engines, which refuse both fields.
Each hop journals its reorder with the activation; `_merge_entries`
composes the reorders of two coalesced entries, and a replay sends each
entry's reorder but the first's.

Inference-time deep prompts as in the reference (``client.py:705-722``,
Petals' client-side prompt split): ``deep_prompts`` ([total blocks,
pre_seq, D]) is kept per session, and stage 0's requests, each hop of the
walk and every journal replay chunk carry their span's slice of it. A
step that sits wholly past the region (``cur_len >= pre_seq``) carries
none: the injection is a no-op there, so it runs the plain graph and, over
TCP, the persistent-stream fast path. Such a session routes as "exotic"
(the batched engines refuse prompts) and never push-chains (a relay would
need the next hop's slice, which only the client holds).

Deliberate difference: journal entries keep the activation tensor on its
device (tensors are never modified after they are sent), where the
reference copies each one to host memory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import random
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.partition import StagePlan, StageSpec
from ..ops.sampling import SamplingParams
from ..scheduling.registry import PlacementRegistry, ServerRecord
from ..telemetry import MetricsRegistry, get_tracer
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from ..telemetry.profiling import get_profiler as _get_profiler
from . import errors as _errors
from .errors import register as _catalog
from .executor import StageExecutor
from .messages import StageRequest, StageResponse, clip_generated
from .transport import DeadlineExceeded, PeerUnavailable, Transport

logger = logging.getLogger(__name__)

MAX_ATTEMPTS = 3          # attempts per hop call before the call fails
SETTLE_SECONDS = 0.2      # pause after a replay, before the retried call
REPEAT_STOP = 5           # 5 consecutive identical tokens end a generation
# A coalesced replay chunk must stay replayable in one request.
MAX_COALESCED_TOKENS = 4096
# Journal and route key of the one full-span hop a burst session pins
# (`_generate_steps_burst`); rediscovery takes another full-span peer.
BURST_HOP_KEY = "burst"
# Engines that serve their full span only and refuse replay: a replacement
# peer receives the session's replay journal, so rediscovery avoids them.
SESSION_ONLY_ENGINES = ("batched", "sp")
# Prompt tokens the affinity digest covers: one prefix-store grain.
AFFINITY_TOKENS = 64
# The route cache's kind field: plain sessions; speculative sessions, which
# batched peers serve too (their draft steps verify in multi-token rounds);
# and push-chain sessions, whose retries and replays the single-session
# engines refuse ("exotic", as in the reference).
PLAIN = "plain"
SPEC = "spec"
EXOTIC = "exotic"


def _engine_usable(rec, kind: str = PLAIN, full_span: bool = True,
                   min_context: Optional[int] = None) -> bool:
    """Can a session of `kind` (needing `min_context` tokens) call `rec`'s
    engine for a hop that covers its full span iff `full_span`? A batched
    or sp engine serves its full span and plain sessions only (speculative
    ones the batched engine alone), and refuses a prefill past the context
    it advertises."""
    if rec.engine not in SESSION_ONLY_ENGINES:
        return True
    if kind == EXOTIC or not full_span:
        return False
    if (min_context is not None and rec.max_context is not None
            and rec.max_context < min_context):
        return False
    return kind != SPEC or rec.engine == "batched"


def _soft_filter(items, pred):
    """Keep the items matching `pred` unless that would leave none: a
    candidate that fails loudly at call time (a retryable stage error)
    beats an immediate NoRouteError when the swarm has nothing better."""
    kept = [it for it in items if pred(it)]
    return kept or items


def prompt_affinity(prompt_ids: Sequence[int]) -> str:
    """The prompt head's digest that steers replica choice (the
    reference's ``client.py:1432-1441``): sha1 of the first
    AFFINITY_TOKENS ids as int32 bytes."""
    head = np.asarray(list(prompt_ids[:AFFINITY_TOKENS]), np.int32)
    return hashlib.sha1(head.tobytes()).hexdigest()


@_catalog
class NoRouteError(RuntimeError):
    """No live server covers a required stage."""


class _BreakerOpen(PeerUnavailable):
    """Synthetic dial refusal: the peer's circuit breaker is open. A
    PeerUnavailable, so the recovery wrapper fails over, but not counted
    as a failure of the peer (it was never dialed)."""


class CircuitBreaker:
    """Per-peer circuit breaker for the client's recovery wrapper (port of
    the reference's ``client.py:118-220``).

      closed     normal; `threshold` CONSECUTIVE failures open it.
      open       dials are skipped until the backoff elapses:
                 ``base * 2**(opens-1)`` capped at ``max_backoff_s``, plus
                 seeded jitter so clients do not re-probe in lockstep.
      half_open  backoff elapsed: exactly one probe call is let through;
                 success closes the breaker, failure re-opens it with the
                 doubled backoff.

    Transitions emit breaker_open / breaker_half_open / breaker_close events
    and count in ``client_breaker_transitions_total{state}``; every skipped
    dial counts in ``client_breaker_open_skips_total``. `now` is injectable
    so tests drive the clock instead of sleeping."""

    def __init__(self, threshold: int = 3, base_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0, jitter: float = 0.1, seed: int = 0,
                 now: Callable[[], float] = time.monotonic, metrics=None):
        self.threshold = threshold
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.now = now
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # peer -> {"state", "fails", "opened_at", "backoff", "opens"}
        self._peers: Dict[str, dict] = {}
        self._m_transitions = _tm.get("client_breaker_transitions_total", metrics)
        self._m_skips = _tm.get("client_breaker_open_skips_total", metrics)

    def _st(self, peer_id: str) -> dict:
        return self._peers.setdefault(
            peer_id, {"state": "closed", "fails": 0, "opened_at": 0.0,
                      "backoff": 0.0, "opens": 0})

    def state(self, peer_id: str) -> str:
        with self._lock:
            return self._peers.get(peer_id, {}).get("state", "closed")

    def allow(self, peer_id: str) -> bool:
        """May the caller dial this peer now? Open with the backoff pending:
        no. Open with the backoff elapsed: yes, as the half-open probe.
        Half-open with the probe already granted: no (one probe at a time)."""
        with self._lock:
            st = self._st(peer_id)
            if st["state"] == "closed":
                return True
            if st["state"] == "open":
                if self.now() - st["opened_at"] < st["backoff"]:
                    self._m_skips.inc()
                    return False
                st["state"] = "half_open"
                self._m_transitions.labels(state="half_open").inc()
                _ev.emit("breaker_half_open", peer=peer_id, opens=st["opens"])
                return True
            self._m_skips.inc()
            return False

    def record_success(self, peer_id: str) -> None:
        with self._lock:
            st = self._st(peer_id)
            was = st["state"]
            st.update(state="closed", fails=0, backoff=0.0, opens=0)
        if was != "closed":
            self._m_transitions.labels(state="close").inc()
            _ev.emit("breaker_close", peer=peer_id)

    def record_failure(self, peer_id: str) -> None:
        with self._lock:
            st = self._st(peer_id)
            st["fails"] += 1
            if st["state"] != "half_open" and st["fails"] < self.threshold:
                return
            # Threshold reached (closed) or the half-open probe failed:
            # (re-)open with exponentially grown, jittered backoff.
            st["opens"] += 1
            backoff = min(self.base_backoff_s * (2 ** (st["opens"] - 1)),
                          self.max_backoff_s)
            backoff *= 1.0 + self._rng.uniform(0.0, self.jitter)
            st.update(state="open", opened_at=self.now(), backoff=backoff, fails=0)
            opens = st["opens"]
        self._m_transitions.labels(state="open").inc()
        _ev.emit("breaker_open", peer=peer_id, opens=opens,
                 backoff_s=round(backoff, 4))


@dataclasses.dataclass
class Hop:
    """One remote hop of the route: a pinned peer serving [start, end)."""

    key: str                 # stable hop identity ("stage1" / "blocks8")
    peer_id: str
    start_block: int
    end_block: int
    expect_token: bool       # final hop returns a sampled token


@dataclasses.dataclass
class JournalEntry:
    hidden: torch.Tensor     # [B, T, D] activation as sent
    seq_len: int
    cur_len: int             # session length before this entry
    # The beam reorder the entry's step applied before it (None: none).
    hypo_ids: Optional[Tuple[int, ...]] = None


def _merge_entries(a: JournalEntry, b: JournalEntry) -> JournalEntry:
    """Coalesce two adjacent journal entries into one replayable chunk.

    A reorder of `b` is hoisted to the front of the merged chunk by
    composition (the reference's ``client.py:222-243``): replaying
    ``[reorder p_a; A; reorder p_b; B]`` equals ``[reorder p_a∘p_b; A[p_b];
    B]``: merged row j takes its A rows from A's row ``p_b[j]`` and its
    prefix KV from row ``p_a[p_b[j]]`` (rows attend only to their own KV,
    so permuting whole rows commutes with the step). Without it no pair
    that carries a reorder could merge, and a beam session's journal would
    grow without bound."""
    if b.hypo_ids is None:
        hidden, hypo = torch.cat([a.hidden, b.hidden], dim=1), a.hypo_ids
    else:
        sel = torch.tensor(b.hypo_ids, dtype=torch.int64).to(a.hidden.device,
                                                              non_blocking=True)
        hidden = torch.cat([a.hidden.index_select(0, sel), b.hidden], dim=1)
        hypo = (tuple(b.hypo_ids) if a.hypo_ids is None
                else tuple(a.hypo_ids[i] for i in b.hypo_ids))
    return JournalEntry(hidden=hidden, seq_len=a.seq_len + b.seq_len,
                        cur_len=a.cur_len, hypo_ids=hypo)


@dataclasses.dataclass
class BeamResult:
    tokens: List[int]        # the best hypothesis (new tokens only)
    score: float             # its length-normalized log-probability
    num_beams: int
    ttft_s: float


@dataclasses.dataclass
class GenerationStep:
    """One yield of ``generate_stepwise``: the token(s) of one pipeline
    round; the final yield has ``done=True`` and the ``GenerationResult``."""

    new_tokens: List[int]
    done: bool = False
    result: Optional["GenerationResult"] = None


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    ttft_s: float
    decode_times_s: List[float]
    stopped_by: str          # "eos" | "repeat" | "max_tokens"

    @property
    def decode_tokens_per_s(self) -> float:
        total = sum(self.decode_times_s)
        decoded = max(len(self.tokens) - 1, 0)
        return (decoded / total) if total > 0 else 0.0


class PipelineClient:
    """Drives generation across the local stage0 + remote pipeline stages."""

    def __init__(self, cfg: ModelConfig, plan: StagePlan, stage0: StageExecutor,
                 transport: Transport, registry: PlacementRegistry, *,
                 use_module_routing: bool = False, route_by_latency: bool = False,
                 use_push_chain: bool = False,
                 total_blocks: Optional[int] = None,
                 request_timeout: float = 60.0,
                 settle_seconds: float = SETTLE_SECONDS,
                 journal_max_entries: int = 256,
                 seed: int = 0, model: Optional[str] = None, metrics=None,
                 route_cache_capacity: int = 64):
        self.cfg = cfg
        self.model = model
        self.plan = plan
        self.total_blocks = total_blocks or plan.stages[-1].end   # the model's layers
        if route_by_latency and not use_module_routing:
            # The latency planner runs inside module routing only.
            logger.warning("route_by_latency implies module routing; "
                           "enabling use_module_routing")
            use_module_routing = True
        self.use_module_routing = use_module_routing
        self.route_by_latency = route_by_latency
        self.use_push_chain = use_push_chain
        # peer -> (rtt_s, measured_at): the latency planner's first-hop
        # pings, reused for ping_cache_ttl seconds (a route is planned anew
        # on the recovery path, where re-pinging dead peers would add their
        # timeouts to the failover).
        self._ping_cache: Dict[str, Tuple[float, float]] = {}
        self.ping_cache_ttl = 30.0
        self.stage0 = stage0
        self.transport = transport
        self.registry = registry
        self.request_timeout = request_timeout
        self.settle_seconds = settle_seconds
        self.journal_max_entries = journal_max_entries
        self.seed = seed
        # hop key -> session -> activation journal
        self.journal: Dict[str, Dict[str, List[JournalEntry]]] = {}
        # hop key -> peers that failed for that hop
        self.failed_peers: Dict[str, set] = {}
        # session -> every peer that held KV for it (released at the end): a
        # peer failed over AWAY from may still be alive and hold a lease.
        self._session_peers: Dict[str, set] = {}
        # (kind, min_context, affinity) -> route, least recently used first.
        self.route_cache_capacity = int(route_cache_capacity)
        self._routes: Dict[tuple, List[Hop]] = {}
        self.last_prefill_stage_times: Dict[str, float] = {}
        # The client's metrics: a private always-on registry by default
        # (`recoveries` reads it), or the caller's (the process-global one
        # under --telemetry). Route plans go to the process-global registry,
        # as the reference's scheduler family does.
        self.metrics = metrics if metrics is not None else MetricsRegistry(enabled=True)
        self._m_ttft = _tm.get("client_ttft_seconds", self.metrics)
        self._m_step = _tm.get("client_step_seconds", self.metrics)
        self._m_stage_time = _tm.get("client_stage_time_seconds", self.metrics)
        self._m_retries = _tm.get("client_retries_total", self.metrics)
        self._m_recoveries = _tm.get("client_recoveries_total", self.metrics)
        self._m_generations = _tm.get("client_generations_total", self.metrics)
        self._m_tokens = _tm.get("client_tokens_generated_total", self.metrics)
        self._m_route_plans = _tm.get("scheduler_route_plans_total")
        self._m_route_hops = _tm.get("scheduler_route_hops")
        self._m_route_evictions = _tm.get("client_route_cache_evictions_total",
                                          self.metrics)
        self._m_deadline = _tm.get("client_deadline_expired_total", self.metrics)
        # Gateway-assigned tenant priority of each live session (lower = more
        # urgent), stamped on every request the session sends.
        self._session_priority: Dict[str, float] = {}
        # The deep prompts of each live session that has them.
        self._session_prompts: Dict[str, torch.Tensor] = {}
        # Seeded with the client seed so fault runs reproduce.
        self.breaker = CircuitBreaker(seed=seed, metrics=self.metrics)

    @property
    def recoveries(self) -> int:
        """Failovers to a replacement server so far: a view of
        ``client_recoveries_total``."""
        return int(self._m_recoveries.value)

    # ------------------------------------------------------------------
    # Routing
    # ------------------------------------------------------------------

    def _compute_route(self, kind: str = PLAIN, min_context: Optional[int] = None,
                       affinity: Optional[str] = None) -> List[Hop]:
        """Fixed stage-chain route: one discovered peer per remote stage, a
        batched peer where the stage has one for a plain or speculative
        session (not an sp peer for a speculative one), any other engine
        where the stage has one for an exotic (push-chain) session;
        with `affinity`, the replica its rendezvous hash picks. Under module
        routing, the block-coverage route instead."""
        if self.use_module_routing:
            return self._compute_module_route(kind, min_context)
        hops: List[Hop] = []
        for spec in self.plan.stages[1:]:
            key = f"stage{spec.index}"
            peer = self.registry.discover_stage(
                spec.index, exclude=tuple(self.failed_peers.get(key, ())),
                model=self.model,
                prefer_engine="batched" if kind in (PLAIN, SPEC) else None,
                avoid_engine=(SESSION_ONLY_ENGINES if kind == EXOTIC
                              else ("sp",) if kind == SPEC else None),
                min_context=min_context, affinity=affinity)
            if peer is None:
                raise NoRouteError(f"no live server for {key}")
            hops.append(Hop(key, peer, spec.start, spec.end, spec.is_last))
        self._m_route_plans.labels(planner="stage").inc()
        self._m_route_hops.observe(len(hops))
        return hops

    def _ping_candidates(self, peer_ids: Sequence[str]) -> Dict[str, float]:
        """Concurrent pings, each answer reused for ping_cache_ttl seconds.
        An unreachable peer is left out (the planner charges its default
        RTT) and not cached, so a recovering peer is pinged again."""
        now = time.monotonic()
        out: Dict[str, float] = {}
        to_ping: List[str] = []
        for pid in peer_ids:
            cached = self._ping_cache.get(pid)
            if cached is not None and now - cached[1] < self.ping_cache_ttl:
                out[pid] = cached[0]
            else:
                to_ping.append(pid)
        if to_ping:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(to_ping))) as pool:
                for pid, rtt in zip(to_ping, pool.map(self.transport.ping, to_ping)):
                    if rtt is not None:
                        out[pid] = rtt
                        self._ping_cache[pid] = (rtt, now)
        return out

    def _compute_latency_route(self, kind: str = PLAIN,
                               min_context: Optional[int] = None) -> Optional[List[Hop]]:
        """The route of least estimated step time over block coverage
        (``scheduling/routing.plan_min_latency_route``): the servers'
        published next-hop RTTs and the client's pings of the first-hop
        candidates. None when the planner finds no route that ends on a
        final stage (the caller falls back to the greedy walk)."""
        from ..scheduling.routing import plan_min_latency_route

        start = self.plan.stages[0].end
        exclude = set()
        for peers in self.failed_peers.values():
            exclude |= peers
        records = self.registry.live_servers(model=self.model)
        if kind == EXOTIC:
            records = _soft_filter(records, lambda r: r.engine not in SESSION_ONLY_ENGINES)
        elif kind == SPEC:
            # Batched peers verify drafts; sp peers refuse them.
            records = _soft_filter(records, lambda r: r.engine != "sp" and (
                min_context is None or r.max_context is None
                or r.max_context >= min_context))
        elif min_context is not None:
            # An sp peer advertising less context than the session needs
            # would refuse its prefill.
            records = _soft_filter(
                records, lambda r: (r.engine != "sp" or r.max_context is None
                                    or r.max_context >= min_context))
        cands = [rec.peer_id for rec in records
                 if rec.start_block <= start < rec.end_block
                 and rec.peer_id not in exclude]
        client_rtts = self._ping_candidates(cands)
        planned = plan_min_latency_route(records, start, self.total_blocks,
                                         client_rtts=client_rtts, exclude=tuple(exclude))
        if planned is not None and any(
                h.record.engine in SESSION_ONLY_ENGINES
                and (h.entry != h.record.start_block or h.end != h.record.end_block)
                for h in planned):
            # A batched or sp engine refuses a sub-span hop: plan without
            # them rather than ship a route that fails at call time.
            planned = plan_min_latency_route(
                [r for r in records if r.engine not in SESSION_ONLY_ENGINES],
                start, self.total_blocks, client_rtts=client_rtts,
                exclude=tuple(exclude))
        if planned is None:
            return None
        return [Hop(f"blocks{h.entry}", h.record.peer_id, h.entry, h.end,
                    h.end >= self.total_blocks) for h in planned]

    def _compute_module_route(self, kind: str = PLAIN,
                              min_context: Optional[int] = None) -> List[Hop]:
        """Greedy block-coverage routing: cover [stage 0's end,
        total_blocks) hop by hop, each hop the candidate covering the next
        block with the largest end_block (then a batched engine, then
        throughput), loop-guarded; the final hop must serve the final
        stage."""
        if self.route_by_latency:
            hops = self._compute_latency_route(kind, min_context)
            if hops is not None:
                return hops
            logger.warning("latency planner found no route; "
                           "falling back to greedy coverage routing")
        hops: List[Hop] = []
        covered = self.plan.stages[0].end
        while covered < self.total_blocks:
            key = f"blocks{covered}"
            cands = self.registry.discover_block(
                covered, exclude=tuple(self.failed_peers.get(key, ())), model=self.model)
            cands = [c for c in cands if c.end_block > covered]
            # A batched or sp engine serves its full span only: drop it
            # softly where the hop would enter it mid-span.
            cands = _soft_filter(cands, lambda c: _engine_usable(
                c, kind, full_span=c.start_block == covered, min_context=min_context))
            if not cands:
                raise NoRouteError(f"no live server covers block {covered}")
            best = max(cands, key=lambda c: (c.end_block,
                                             kind in (PLAIN, SPEC) and c.engine == "batched",
                                             c.throughput))
            if best.end_block <= covered:       # loop guard
                raise NoRouteError(f"route stuck at block {covered}")
            is_final = best.end_block >= self.total_blocks
            if is_final and not best.final_stage:
                raise NoRouteError(f"last hop {best.peer_id} does not serve the final stage")
            hops.append(Hop(key, best.peer_id, covered, best.end_block, is_final))
            covered = best.end_block
        self._m_route_plans.labels(planner="greedy").inc()
        self._m_route_hops.observe(len(hops))
        return hops

    def route(self, refresh: bool = False, kind: str = PLAIN,
              min_context: Optional[int] = None,
              affinity: Optional[str] = None) -> List[Hop]:
        """The cached route of (`kind`, `min_context`, `affinity`), planned
        anew with `refresh` (the reference's ``route``, ``client.py:618``).
        Past ``route_cache_capacity`` the least recently used route with an
        affinity goes: the affinity=None routes are a bounded handful that
        every session without one shares, and a session touches its own
        key every step, so no live generation loses its route. The module
        router ignores `affinity` (its pick is deterministic already)."""
        if self.use_module_routing:
            affinity = None
        key = (kind, min_context, affinity)
        if refresh or key not in self._routes:
            while len(self._routes) >= self.route_cache_capacity:
                victim = next((k for k in self._routes if k[2] is not None), None)
                if victim is None:
                    break
                self._routes.pop(victim)
                self._m_route_evictions.inc()
            self._routes.pop(key, None)
            self._routes[key] = self._compute_route(kind, min_context, affinity)
        else:
            self._routes[key] = self._routes.pop(key)      # LRU touch
        return self._routes[key]

    def _deadline_budget(self, deadline_at: Optional[float], session_id: str, *,
                         trace_id=None, peer: Optional[str] = None) -> Optional[float]:
        """The end-to-end budget left (seconds), or None for a session
        without a deadline. A spent budget raises `DeadlineExceeded` here,
        before any hop is dialed, with the ``deadline_expired`` event: the
        client's side of the server's ``deadline_rejected`` refusal."""
        if deadline_at is None:
            return None
        remaining = deadline_at - time.monotonic()
        if remaining <= 0.0:
            self._m_deadline.inc()
            _ev.emit("deadline_expired", session_id=session_id, trace_id=trace_id,
                     peer=peer, over_s=round(-remaining, 6))
            raise DeadlineExceeded(
                f"session {session_id}: deadline exceeded ({-remaining:.3f}s past) "
                f"before dialing {peer or 'the next hop'}")
        return remaining

    # ------------------------------------------------------------------
    # Journal
    # ------------------------------------------------------------------

    def _journal_append(self, key: str, session_id: str, entry: JournalEntry) -> None:
        entries = self.journal.setdefault(key, {}).setdefault(session_id, [])
        entries.append(entry)
        if len(entries) > self.journal_max_entries:
            # Coalesce the oldest adjacent pair that stays replayable.
            for i in range(len(entries) - 1):
                a, b = entries[i], entries[i + 1]
                if a.seq_len + b.seq_len <= MAX_COALESCED_TOKENS:
                    entries[i:i + 2] = [_merge_entries(a, b)]
                    break

    def _replay(self, hop: Hop, session_id: str, sampling: SamplingParams,
                max_length: int) -> None:
        """Rebuild a replacement peer's KV by replaying the hop's journal:
        the first chunk as a prefill, the rest as ``is_replay`` chunks with
        their cumulative cur_len."""
        entries = self.journal.get(hop.key, {}).get(session_id, [])
        tokens = sum(e.seq_len for e in entries)
        _ev.emit("replay_start", session_id=session_id, peer=hop.peer_id,
                 entries=len(entries), tokens=tokens)
        t0 = time.monotonic()
        for i, e in enumerate(entries):
            req = StageRequest(
                session_id=session_id, hidden=e.hidden, seq_len=e.seq_len,
                cur_len=e.cur_len, is_prefill=(i == 0), is_replay=True,
                max_length=max_length, sampling=sampling,
                start_block=hop.start_block, end_block=hop.end_block,
                hypo_ids=None if i == 0 else e.hypo_ids,
                prompts=self._hop_prompts(session_id, hop, e.cur_len))
            self.transport.call(hop.peer_id, req, self.request_timeout)
        _ev.emit("replay_done", session_id=session_id, peer=hop.peer_id,
                 tokens=tokens, seconds=round(time.monotonic() - t0, 4))

    def _hop_prompts(self, session_id: str, hop: Hop, cur_len: int = 0):
        return self._span_prompts(session_id, hop.start_block, hop.end_block, cur_len)

    def _stage0_prompts(self, session_id: str, cur_len: int) -> Optional[torch.Tensor]:
        """Stage 0's slice of the session's deep prompts (`_span_prompts`
        over its spec, read only for a session that has prompts)."""
        if session_id not in self._session_prompts:
            return None
        s0 = self.stage0.spec
        return self._span_prompts(session_id, s0.start, s0.end, cur_len)

    def _span_prompts(self, session_id: str, start: int, end: int,
                      cur_len: int = 0) -> Optional[torch.Tensor]:
        """One span's slice of the session's deep prompts (rows are
        absolute block indices: each server gets exactly its span's
        blocks), or None once the step sits entirely past the prompt
        region (``cur_len >= pre_seq``): the injection is an exact no-op
        there, and dropping the tensor keeps the step on the plain graph
        and off the classic frame that re-ships [span, pre, D] floats a
        hop. The slice is a view of the session's tensor."""
        pr = self._session_prompts.get(session_id)
        if pr is None or cur_len >= pr.shape[1] or start >= end:
            return None
        return pr[start:end]

    def _call_with_recovery(self, hop: Hop, req: StageRequest) -> StageResponse:
        """Up to MAX_ATTEMPTS attempts, gated by the per-peer circuit
        breaker: an open breaker turns the dial into a synthetic retryable
        failure (fail over without a dial), and only real observations feed
        the breaker. Retryable errors are the catalog's
        (``errors.retryable_types``); anything else surfaces at once."""
        last_exc: Optional[Exception] = None
        touched = self._session_peers.setdefault(req.session_id, set())
        for attempt in range(MAX_ATTEMPTS):
            touched.add(hop.peer_id)
            try:
                if not self.breaker.allow(hop.peer_id):
                    raise _BreakerOpen(f"peer {hop.peer_id}: circuit breaker open")
                # The "socket" phase: one request/response turnaround on the
                # wire, per attempt (the recovery machinery stays outside).
                with _get_profiler().phase("socket"):
                    resp = self.transport.call(hop.peer_id, req, self.request_timeout)
                self.breaker.record_success(hop.peer_id)
                return resp
            except _errors.retryable_types() as exc:
                if not isinstance(exc, _BreakerOpen):
                    self.breaker.record_failure(_errors.breaker_blame(exc, hop.peer_id))
                last_exc = exc
                self._m_retries.inc()
                trace_id = (req.trace.get("trace_id")
                            if isinstance(req.trace, dict) else None)
                _ev.emit("hop_retry", session_id=req.session_id,
                         trace_id=trace_id, hop=hop.key, peer=hop.peer_id,
                         attempt=attempt + 1,
                         error=f"{type(exc).__name__}: {exc}"[:200])
                _ev.emit("peer_failed", session_id=req.session_id,
                         trace_id=trace_id, hop=hop.key, peer=hop.peer_id,
                         reason=type(exc).__name__)
                failed = self.failed_peers.setdefault(hop.key, set())
                failed.add(hop.peer_id)
                logger.warning("hop %s peer %s failed (attempt %d/%d): %s",
                               hop.key, hop.peer_id, attempt + 1, MAX_ATTEMPTS, exc)
                old_peer = hop.peer_id
                try:
                    replacement = self._rediscover(hop)
                except NoRouteError:
                    continue  # a peer may re-register before we run out
                hop.peer_id = replacement
                self._m_recoveries.inc()
                _ev.emit("failover", session_id=req.session_id,
                         trace_id=trace_id, hop=hop.key, old_peer=old_peer,
                         new_peer=replacement)
                try:
                    self._replay(hop, req.session_id, req.sampling, req.max_length)
                except _errors.retryable_types() as replay_exc:
                    # The replacement died too: blacklist it, fail over again.
                    last_exc = replay_exc
                    failed.add(replacement)
                    continue
                if self.settle_seconds:
                    time.sleep(self.settle_seconds)
        raise RuntimeError(
            f"hop {hop.key}: all {MAX_ATTEMPTS} attempts failed") from last_exc

    def _rediscover(self, hop: Hop) -> str:
        peer = self._rediscover_excluding(
            hop, tuple(self.failed_peers.get(hop.key, ())))
        if peer is None:
            # Every candidate is blacklisted. Failures are often transient:
            # give the failed peers another chance rather than fail with
            # live servers present (the blacklist amnesty).
            _ev.emit("blacklist_amnesty", hop=hop.key,
                     cleared=len(self.failed_peers.get(hop.key, ())))
            self.failed_peers.get(hop.key, set()).clear()
            peer = self._rediscover_excluding(hop, ())
        if peer is None:
            raise NoRouteError(f"no replacement for {hop.key}")
        return peer

    def _rediscover_excluding(self, hop: Hop, exclude: Tuple[str, ...]) -> Optional[str]:
        """A live peer of the hop's stage, not in `exclude`, avoiding the
        engines that refuse a replay journal; under module routing the
        furthest-reaching live peer that covers the hop's whole span (a
        final-stage one for the last hop); for a burst hop, another
        full-span batched peer (a batched engine takes a replay: a prefill,
        then multi-token chunks)."""
        if hop.key == BURST_HOP_KEY:
            return self._discover_burst_peer(exclude=exclude)
        if self.use_module_routing:
            # The replacement must cover the hop's exact span: the later
            # hops already hold KV for theirs.
            cands = [c for c in self.registry.discover_block(
                        hop.start_block, exclude=exclude, model=self.model)
                     if c.start_block <= hop.start_block and c.end_block >= hop.end_block
                     and (not hop.expect_token or c.final_stage)]
            cands = _soft_filter(cands, lambda c: c.engine not in SESSION_ONLY_ENGINES)
            if not cands:
                return None
            return max(cands, key=lambda c: (c.end_block, c.throughput)).peer_id
        return self.registry.discover_stage(
            int(hop.key.removeprefix("stage")), exclude=exclude,
            model=self.model, avoid_engine=SESSION_ONLY_ENGINES)

    def _walk(self, hidden: torch.Tensor, seq_len: int, cur_len: int,
              session_id: str, *, is_prefill: bool, max_length: int,
              sampling: SamplingParams, generated: Sequence[int] = (),
              step_seed: int = 0, stage_times: Dict[str, float],
              root, prefix_len: int = 0, affinity: Optional[str] = None,
              deadline_at: Optional[float] = None, kind: str = PLAIN,
              draft_tokens: Optional[Tuple[int, ...]] = None,
              start_from_position: Optional[int] = None,
              hypo_ids: Optional[Tuple[int, ...]] = None,
              num_logprobs: int = 0) -> StageResponse:
        """Send the activation through every remote hop of the session's
        route (keyed by its `kind`, its `max_length` and prompt-head
        `affinity`), each call through the recovery wrapper; return the
        final hop's response (a sampled token, with `draft_tokens` the
        verified run, with ``num_logprobs > 0`` each row's top candidates).
        Every hop gets the drafts, `start_from_position`, the beam reorder
        `hypo_ids` (journaled with the activation), `num_logprobs` and its
        span's slice of the session's deep prompts.
        A prefill carries `prefix_len` to every hop;
        every hop the budget left of `deadline_at` as it is sent (earlier
        hops' time already spent) and the session's priority. `root` is
        the step's root span, opened by the generation loop so that stage 0
        and every hop share one trace (the no-op span with tracing off).
        A deep-prompt session never push-chains: a relay would need the
        next hop's prompt slice, which only the client holds (Petals'
        handler sets ``can_push = not has_prompts``)."""
        if self.use_push_chain and session_id not in self._session_prompts:
            return self._walk_chain(
                hidden, seq_len, cur_len, session_id, is_prefill=is_prefill,
                max_length=max_length, sampling=sampling, generated=generated,
                step_seed=step_seed, stage_times=stage_times, root=root,
                prefix_len=prefix_len, deadline_at=deadline_at, draft_tokens=draft_tokens,
                start_from_position=start_from_position)
        phase = "prefill" if is_prefill else "decode"
        tracer = get_tracer()
        cur = hidden
        for i, hop in enumerate(self.route(kind=kind, min_context=max_length,
                                           affinity=affinity)):
            budget = self._deadline_budget(deadline_at, session_id,
                                           trace_id=root.trace_id if root else None,
                                           peer=hop.peer_id)
            req = StageRequest(
                session_id=session_id, hidden=cur, seq_len=seq_len,
                cur_len=cur_len, is_prefill=is_prefill, max_length=max_length,
                sampling=sampling, generated_tokens=clip_generated(generated),
                step_seed=step_seed, start_block=hop.start_block,
                end_block=hop.end_block, draft_tokens=draft_tokens,
                start_from_position=start_from_position, hypo_ids=hypo_ids,
                num_logprobs=num_logprobs,
                prompts=self._hop_prompts(session_id, hop, cur_len),
                prefix_len=prefix_len if is_prefill else 0,
                trace=root.wire_context(hop=i) if root else None,
                deadline_budget_s=budget,
                priority=self._session_priority.get(session_id))
            hop_span = tracer.start_span(
                f"hop:{hop.key}", trace_id=root.trace_id,
                parent_id=root.span_id, kind="client", peer=hop.peer_id,
                phase=phase) if root else root
            t0 = time.monotonic()
            try:
                resp = self._call_with_recovery(hop, req)
            except BaseException as exc:
                hop_span.end(error=repr(exc))
                raise
            dt = time.monotonic() - t0
            hop_span.end(server=resp.span)
            stage_times[hop.key] = dt
            self._m_stage_time.labels(hop=hop.key, phase=phase).observe(dt)
            # Journal AFTER success: replay rebuilds exactly the applied
            # history.
            self._journal_append(hop.key, session_id,
                                 JournalEntry(cur, seq_len, cur_len, hypo_ids))
            if hop.expect_token:
                if num_logprobs > 0:
                    if not resp.is_beam:
                        raise RuntimeError(f"final hop {hop.key} returned no beam "
                                           "candidates")
                elif draft_tokens is not None:
                    if not resp.is_speculative:
                        raise RuntimeError(f"final hop {hop.key} returned no verified "
                                           "tokens")
                elif not resp.is_token:
                    raise RuntimeError(f"final hop {hop.key} returned no token")
                return resp
            if resp.hidden is None:
                raise RuntimeError(f"hop {hop.key} returned no hidden states")
            cur = resp.hidden
        raise RuntimeError("route had no final hop")

    # ------------------------------------------------------------------
    # Push chains: one client call a step; the servers relay the activation
    # hop to hop and the final token back. The journal holds stage 0's
    # outputs under CHAIN_KEY: recovery replays them through a freshly
    # routed chain, which rebuilds every hop's KV at once.
    # ------------------------------------------------------------------

    CHAIN_KEY = "chain"

    def _chain_request(self, hops: List[Hop], hidden: torch.Tensor, seq_len: int,
                       cur_len: int, session_id: str, *, is_prefill: bool,
                       is_replay: bool, max_length: int, sampling: SamplingParams,
                       generated: Sequence[int], step_seed: int, prefix_len: int = 0,
                       deadline_at: Optional[float] = None,
                       draft_tokens: Optional[Tuple[int, ...]] = None,
                       start_from_position: Optional[int] = None) -> StageRequest:
        """The request to the chain's first hop, naming the others in
        ``next_servers``; a relayed hop by its volunteer's address with
        ``relay_via`` (the pushing server dials the volunteer and stamps
        ``relay_to``)."""
        nxt = []
        for h in hops[1:]:
            rec = self.registry.get(h.peer_id)
            entry = {"peer_id": h.peer_id,
                     "address": getattr(rec, "address", None) if rec else None,
                     "start_block": h.start_block, "end_block": h.end_block}
            via = getattr(rec, "relay_via", None) if rec else None
            if via:
                rrec = self.registry.get(via)
                entry["relay_via"] = via
                entry["address"] = getattr(rrec, "address", None) if rrec else None
            nxt.append(entry)
        return StageRequest(
            session_id=session_id, hidden=hidden, seq_len=seq_len, cur_len=cur_len,
            is_prefill=is_prefill, is_replay=is_replay, max_length=max_length,
            sampling=sampling, generated_tokens=clip_generated(generated),
            step_seed=step_seed, start_block=hops[0].start_block,
            end_block=hops[0].end_block, next_servers=tuple(nxt),
            draft_tokens=draft_tokens, start_from_position=start_from_position,
            prefix_len=prefix_len if is_prefill else 0,
            deadline_budget_s=self._deadline_budget(deadline_at, session_id,
                                                    peer=hops[0].peer_id),
            priority=self._session_priority.get(session_id))

    def _replay_chain(self, hops: List[Hop], session_id: str,
                      sampling: SamplingParams, max_length: int) -> None:
        """Rebuild every hop's KV: the chain journal through `hops`, the
        first chunk as a prefill, the rest as replay chunks."""
        entries = self.journal.get(self.CHAIN_KEY, {}).get(session_id, [])
        tokens = sum(e.seq_len for e in entries)
        _ev.emit("replay_start", session_id=session_id, peer=hops[0].peer_id,
                 entries=len(entries), tokens=tokens)
        t0 = time.monotonic()
        for i, e in enumerate(entries):
            req = self._chain_request(
                hops, e.hidden, e.seq_len, e.cur_len, session_id, is_prefill=(i == 0),
                is_replay=True, max_length=max_length, sampling=sampling, generated=(),
                step_seed=0)
            self.transport.call(hops[0].peer_id, req, self.request_timeout)
        _ev.emit("replay_done", session_id=session_id, peer=hops[0].peer_id,
                 tokens=tokens, seconds=round(time.monotonic() - t0, 4))

    def _blame_chain_failure(self, hops: List[Hop], exc: Exception) -> None:
        """Blacklist the hop a chain failure names and drop the cached
        routes. A relayed error names its origin; a bare timeout names
        nobody, so the first hop that fails a liveness probe is blamed,
        else the entry hop."""
        blame = getattr(exc, "peer_id", None)
        if blame is None and isinstance(exc, TimeoutError):
            blame = next((h.peer_id for h in hops
                          if not self.transport.alive(h.peer_id)), None)
        blame = blame or hops[0].peer_id
        blamed_hop = next((h for h in hops if h.peer_id == blame), hops[0])
        self.failed_peers.setdefault(blamed_hop.key, set()).add(blame)
        _ev.emit("peer_failed", hop=blamed_hop.key, peer=blame, reason=type(exc).__name__)
        self._routes.clear()
        logger.warning("push chain failed at %s: %s", blame, exc)

    def _walk_chain(self, hidden: torch.Tensor, seq_len: int, cur_len: int,
                    session_id: str, *, is_prefill: bool, max_length: int,
                    sampling: SamplingParams, generated: Sequence[int], step_seed: int,
                    stage_times: Dict[str, float], root, prefix_len: int = 0,
                    deadline_at: Optional[float] = None,
                    draft_tokens: Optional[Tuple[int, ...]] = None,
                    start_from_position: Optional[int] = None) -> StageResponse:
        """One step as a push chain: up to MAX_ATTEMPTS chains, each a
        single call to the route's first hop (its breaker gates the dial).
        A retryable failure blames a hop (`_blame_chain_failure`), feeds the
        breaker of the component at fault (a relay volunteer rather than
        the peer behind it), re-routes and replays the chain journal before
        the next attempt, which is sent as a replay; with every candidate
        blacklisted the blacklist is cleared once (the amnesty)."""
        tracer = get_tracer()
        phase = "prefill" if is_prefill else "decode"
        touched = self._session_peers.setdefault(session_id, set())
        last_exc: Optional[Exception] = None
        blacklist_cleared = False
        for attempt in range(MAX_ATTEMPTS):
            try:
                hops = self.route(kind=EXOTIC)
            except NoRouteError as exc:
                last_exc = exc
                if blacklist_cleared:
                    continue
                blacklist_cleared = True
                _ev.emit("blacklist_amnesty", session_id=session_id, hop=self.CHAIN_KEY,
                         cleared=sum(len(v) for v in self.failed_peers.values()))
                self.failed_peers.clear()
                self._routes.clear()
                continue
            touched.update(h.peer_id for h in hops)
            if not self.breaker.allow(hops[0].peer_id):
                # An open breaker on the entry hop: route around it (the
                # breaker's half-open probe readmits it).
                last_exc = _BreakerOpen(f"peer {hops[0].peer_id}: circuit breaker open")
                self._m_retries.inc()
                self.failed_peers.setdefault(hops[0].key, set()).add(hops[0].peer_id)
                self._routes.clear()
                continue
            req = self._chain_request(
                hops, hidden, seq_len, cur_len, session_id, is_prefill=is_prefill,
                is_replay=attempt > 0, max_length=max_length, sampling=sampling,
                generated=generated, step_seed=step_seed, prefix_len=prefix_len,
                deadline_at=deadline_at, draft_tokens=draft_tokens,
                start_from_position=start_from_position)
            req.trace = root.wire_context(hop=0) if root else None
            chain_span = tracer.start_span(
                "hop:chain", trace_id=root.trace_id, parent_id=root.span_id,
                kind="client", peer=hops[0].peer_id, chain_len=len(hops)) if root else root
            t0 = time.monotonic()
            try:
                with _get_profiler().phase("socket"):
                    # The chain runs len(hops) computes before it answers.
                    resp = self.transport.call(hops[0].peer_id, req,
                                               self.request_timeout * max(1, len(hops)))
                self.breaker.record_success(hops[0].peer_id)
            except DeadlineExceeded:
                chain_span.end(error="deadline")
                raise
            except _errors.retryable_types() as exc:
                self.breaker.record_failure(_errors.breaker_blame(
                    exc, getattr(exc, "peer_id", None) or hops[0].peer_id))
                chain_span.end(error=repr(exc))
                last_exc = exc
                self._m_retries.inc()
                _ev.emit("hop_retry", session_id=session_id,
                         trace_id=root.trace_id if root else None, hop=self.CHAIN_KEY,
                         peer=hops[0].peer_id, attempt=attempt + 1,
                         error=f"{type(exc).__name__}: {exc}"[:200])
                self._blame_chain_failure(hops, exc)
                try:
                    new_hops = self.route(kind=EXOTIC)
                    self._replay_chain(new_hops, session_id, sampling, max_length)
                except NoRouteError as rexc:
                    last_exc = rexc
                    continue
                except _errors.retryable_types() as rexc:
                    # A peer died during the replay: blame it too.
                    last_exc = rexc
                    self._blame_chain_failure(new_hops, rexc)
                    continue
                self._m_recoveries.inc()
                _ev.emit("failover", session_id=session_id,
                         trace_id=root.trace_id if root else None, hop=self.CHAIN_KEY,
                         old_peer=hops[0].peer_id, new_peer=new_hops[0].peer_id)
                if self.settle_seconds:
                    time.sleep(self.settle_seconds)
                continue
            dt = time.monotonic() - t0
            chain_span.end(server=resp.span)
            stage_times[self.CHAIN_KEY] = dt
            self._m_stage_time.labels(hop=self.CHAIN_KEY, phase=phase).observe(dt)
            self._journal_append(self.CHAIN_KEY, session_id,
                                 JournalEntry(hidden, seq_len, cur_len))
            if draft_tokens is not None and not resp.is_speculative:
                raise RuntimeError("push chain returned no verified tokens")
            if draft_tokens is None and not resp.is_token:
                raise RuntimeError("push chain returned no token "
                                   "(the route must end at the final stage)")
            return resp
        raise RuntimeError(f"push chain: all {MAX_ATTEMPTS} attempts failed") from last_exc

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 64, *,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None,
                 session_id: Optional[str] = None,
                 max_length: Optional[int] = None,
                 speculative_k: int = 0, draft_fn=None, deep_prompts=None,
                 deadline_s: Optional[float] = None,
                 burst: int = 0) -> GenerationResult:
        """One generation. ``speculative_k > 0`` drafts up to K tokens a
        round (``draft_fn(context, k)``, by default the n-gram prompt
        lookup) and has the final stage verify them: greedy tokens equal a
        non-speculative run's, sampled ones keep its distribution.
        ``deadline_s`` sets an end-to-end wall-clock budget for the whole
        of it: each hop carries the seconds left, servers refuse work that
        arrives spent, and a spent budget raises `DeadlineExceeded` (not
        retryable) instead of burning failover attempts."""
        result: Optional[GenerationResult] = None
        for step in self.generate_stepwise(
                prompt_ids, max_new_tokens, sampling=sampling,
                eos_token_id=eos_token_id, session_id=session_id,
                max_length=max_length, speculative_k=speculative_k, draft_fn=draft_fn,
                deep_prompts=deep_prompts, deadline_s=deadline_s, burst=burst):
            if step.done:
                result = step.result
        assert result is not None  # the generator's final yield carries it
        return result

    def generate_stepwise(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
                          *, sampling: Optional[SamplingParams] = None,
                          eos_token_id: Optional[int] = None,
                          session_id: Optional[str] = None,
                          max_length: Optional[int] = None,
                          speculative_k: int = 0, draft_fn=None, deep_prompts=None,
                          deadline_s: Optional[float] = None,
                          deadline_at: Optional[float] = None,
                          priority: Optional[float] = None,
                          burst: int = 0) -> Iterator[GenerationStep]:
        """Incremental ``generate``: yields after the prefill and after every
        decode step (with ``burst > 0``, after every burst; with
        ``speculative_k``, after every round), so a caller (the
        serving gateway) can interleave many sessions a step at a time. The
        per-step sampling seed is ``self.seed + len(generated)``, purely
        session-local, so interleaving changes no session's tokens and a
        burst's tokens are the per-step loop's. ``deadline_at`` is an
        absolute ``time.monotonic()`` deadline (it overrides
        ``deadline_s``): the gateway stamps it at admission, so queue wait
        spends the budget. ``priority`` is the gateway's tenant priority
        (lower = more urgent), stamped on every request of the session.
        ``deep_prompts`` ([total blocks, pre_seq, D]) adds each block's
        learned prompts at its entry, at absolute positions < pre_seq, on
        every step (Petals' ``block_functions.py:57-65,171-226``); the
        session routes as "exotic", around the batched engines. Session
        state (KV leases, journal, priority, deep prompts) is released when
        the generator finishes or is closed. ``burst`` with deep prompts or
        ``speculative_k`` is a ``ValueError``, as in the reference."""
        if burst > 0 and (speculative_k > 0 or deep_prompts is not None):
            raise ValueError(
                "burst decode samples on-device and is incompatible with "
                "speculative drafting / deep prompts")
        session_id = session_id or f"sess-{time.monotonic_ns():x}"
        if deep_prompts is not None:
            self._session_prompts[session_id] = torch.as_tensor(deep_prompts)
        if priority is not None:
            self._session_priority[session_id] = float(priority)
        if deadline_at is None and deadline_s is not None:
            deadline_at = time.monotonic() + deadline_s
        _ev.emit("session_start", session_id=session_id,
                 prompt_len=len(prompt_ids), max_new_tokens=max_new_tokens)
        recoveries_before = self.recoveries
        tokens_out = 0
        generate_steps = self._generate_steps_burst if burst > 0 else self._generate_steps
        kw = ({"burst": burst} if burst > 0
              else {"speculative_k": speculative_k, "draft_fn": draft_fn})
        try:
            for step in generate_steps(
                    prompt_ids, max_new_tokens, sampling=sampling or SamplingParams(),
                    eos_token_id=eos_token_id, session_id=session_id,
                    max_length=max_length, deadline_at=deadline_at, **kw):
                tokens_out += len(step.new_tokens)
                yield step
        finally:
            self._session_priority.pop(session_id, None)
            self._end_session(session_id)
            _ev.emit("session_end", session_id=session_id,
                     tokens=tokens_out or None,
                     recoveries=self.recoveries - recoveries_before)

    def _generate_steps(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
                        sampling: SamplingParams, eos_token_id: Optional[int],
                        session_id: str, max_length: Optional[int],
                        deadline_at: Optional[float] = None, speculative_k: int = 0,
                        draft_fn=None) -> Iterator[GenerationStep]:
        """The per-step loop. A plain decode step is the speculative round
        with no drafts: with ``speculative_k == 0`` no step drafts or
        carries ``start_from_position``. The session kind is fixed at
        entry, so a speculative session's prefill already lands on peers
        that take its draft steps, and a deep-prompt session's routes
        around the engines that refuse prompts (by capability, with no
        prompt-head affinity)."""
        prompt_len = len(prompt_ids)
        if session_id in self._session_prompts:
            kind = EXOTIC
        else:
            kind = SPEC if speculative_k > 0 else PLAIN
        max_length = max_length or prompt_len + max_new_tokens + max(speculative_k, 0)
        affinity = None if kind == EXOTIC else prompt_affinity(prompt_ids)
        # Ids are made on the host: stage 0 copies them to its device
        # without a host sync (a device tensor made from a list would sync).
        ids = torch.tensor([list(prompt_ids)], dtype=torch.int64)
        generated: List[int] = []
        stopped_by = "max_tokens"

        tracer = get_tracer()
        t0 = time.monotonic()
        root = tracer.start_span("pipeline_step", kind="client",
                                 session_id=session_id, phase="prefill")
        s0_span = tracer.start_span(
            "hop:stage0", trace_id=root.trace_id, parent_id=root.span_id,
            kind="client", phase="prefill", peer=self.stage0.peer_id) if root else root
        s0_resp = self.stage0.forward(StageRequest(
            session_id=session_id, hidden=ids, seq_len=prompt_len, cur_len=0,
            is_prefill=True, max_length=max_length, sampling=sampling,
            prompts=self._stage0_prompts(session_id, 0),
            prefix_len=prompt_len))
        s0_span.end()
        times: Dict[str, float] = {}
        try:
            resp = self._walk(s0_resp.hidden, prompt_len, 0, session_id,
                              is_prefill=True, max_length=max_length,
                              sampling=sampling, generated=generated,
                              step_seed=self.seed, stage_times=times, root=root,
                              prefix_len=prompt_len, affinity=affinity,
                              deadline_at=deadline_at, kind=kind)
        finally:
            root.end()
        ttft = time.monotonic() - t0
        self._m_ttft.observe(ttft)
        self.last_prefill_stage_times = times
        generated.append(int(resp.token_id))
        yield GenerationStep(new_tokens=[generated[-1]])

        decode_times: List[float] = []
        cur_len = prompt_len
        if draft_fn is None and speculative_k > 0:
            from .speculative import ngram_draft as draft_fn
        context = [int(t) for t in prompt_ids] + generated
        while len(generated) < max_new_tokens:
            if eos_token_id is not None and generated[-1] == eos_token_id:
                stopped_by = "eos"
                break
            if (len(generated) >= REPEAT_STOP
                    and len(set(generated[-REPEAT_STOP:])) == 1):
                stopped_by = "repeat"
                break
            t0 = time.monotonic()
            drafts = tuple(draft_fn(context, speculative_k)) if speculative_k > 0 else ()
            # start_from_position rides every speculative step, stage 0's
            # too: it drops the previous round's rejected overhang.
            spos = cur_len if speculative_k > 0 else None
            t_in = 1 + len(drafts)
            step_ids = torch.tensor([[generated[-1], *drafts]], dtype=torch.int64)
            step_span = tracer.start_span(
                "pipeline_step", kind="client", session_id=session_id,
                phase="decode", step=len(generated))
            try:
                s0_resp = self.stage0.forward(StageRequest(
                    session_id=session_id, hidden=step_ids, seq_len=t_in,
                    cur_len=cur_len, is_prefill=False, max_length=max_length,
                    sampling=sampling, start_from_position=spos,
                    prompts=self._stage0_prompts(session_id, cur_len)))
                times = {}
                resp = self._walk(s0_resp.hidden, t_in, cur_len, session_id,
                                  is_prefill=False, max_length=max_length,
                                  sampling=sampling, generated=generated,
                                  step_seed=self.seed + len(generated),
                                  stage_times=times, root=step_span,
                                  affinity=affinity, deadline_at=deadline_at, kind=kind,
                                  draft_tokens=drafts or None, start_from_position=spos)
            finally:
                step_span.end()
            accepted = list(resp.tokens) if drafts else [resp.token_id]
            if drafts:
                # Replay must rebuild only valid KV rows.
                self._amend_speculative_journal(session_id, cur_len + t_in, t_in,
                                                len(accepted))
            dt = time.monotonic() - t0
            decode_times.append(dt)
            self._m_step.observe(dt)
            self._m_tokens.inc(len(accepted))
            cur_len += len(accepted)    # the last token and the accepted drafts
            # The stops are checked token by token inside the accepted run:
            # a round may overshoot the EOS or the repeat point.
            n_before = len(generated)
            stop = None
            for tok in accepted:
                if len(generated) >= max_new_tokens:
                    break
                generated.append(int(tok))
                context.append(int(tok))
                if eos_token_id is not None and tok == eos_token_id:
                    stop = "eos"
                    break
                if (len(generated) >= REPEAT_STOP
                        and len(set(generated[-REPEAT_STOP:])) == 1):
                    stop = "repeat"
                    break
            yield GenerationStep(new_tokens=generated[n_before:])
            if stop is not None:
                stopped_by = stop
                break

        self._m_generations.inc()
        yield GenerationStep(new_tokens=[], done=True, result=GenerationResult(
            tokens=generated, ttft_s=ttft, decode_times_s=decode_times,
            stopped_by=stopped_by))

    def _amend_speculative_journal(self, session_id: str, end: int, t_in: int,
                                   keep: int) -> None:
        """Drop the rejected rows of the round just journaled, which ends
        at position `end`: the step's last ``t_in - keep`` rows (`keep` =
        n_accepted + 1: the last token and the accepted drafts), from the
        last entry of every journal of the session (each hop's, or the
        chain's) that ends there. The tail is cut, not the head kept:
        `_journal_append` may have merged the step into the entry before
        it, whose rows the reference's cut to ``keep`` rows would drop."""
        drop = t_in - keep
        if drop <= 0:
            return
        for sessions in self.journal.values():
            entries = sessions.get(session_id)
            e = entries[-1] if entries else None
            if e is not None and e.cur_len + e.seq_len == end and e.seq_len > drop:
                n = e.seq_len - drop
                entries[-1] = JournalEntry(e.hidden[:, :n], n, e.cur_len, e.hypo_ids)

    def _discover_burst_peer(self, exclude: Tuple[str, ...] = ()) -> Optional[str]:
        """A live batched final-stage peer that spans the whole model, the
        only server that can run a burst (its sampled tokens feed its own
        embedding), not in `exclude`; the highest throughput wins."""
        cands = [
            r for r in self.registry.live_servers(model=self.model)
            if r.engine == "batched" and r.final_stage
            and r.start_block <= 0 and r.end_block >= self.total_blocks
            and r.peer_id not in exclude
            and getattr(r, "state", "online") == "online"
        ]
        if not cands:
            return None
        return max(cands, key=lambda r: r.throughput).peer_id

    def _generate_steps_burst(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
                              sampling: SamplingParams, eos_token_id: Optional[int],
                              session_id: str, max_length: Optional[int], burst: int,
                              deadline_at: Optional[float] = None
                              ) -> Iterator[GenerationStep]:
        """The burst counterpart of `_generate_steps` (the reference's
        ``_generate_steps_burst``, ``client.py:1589-1715``): the prompt's
        ids go straight to one full-span batched peer, and each decode
        request asks it for up to `burst` ticks. Each burst is journaled as
        one multi-token entry (the carried-in token and every emitted token
        but the last, whose KV the next burst writes), so a failover replays
        across burst boundaries; the host's per-token stop scan decides
        what is kept."""
        prompt_len = len(prompt_ids)
        max_length = max_length or (prompt_len + max_new_tokens)
        peer = self._discover_burst_peer()
        if peer is None:
            _ev.emit("burst_fallback", session_id=session_id,
                     reason="no full-span batched peer is live")
            yield from self._generate_steps(
                prompt_ids, max_new_tokens, sampling=sampling,
                eos_token_id=eos_token_id, session_id=session_id,
                max_length=max_length, deadline_at=deadline_at)
            return
        hop = Hop(key=BURST_HOP_KEY, peer_id=peer, start_block=0,
                  end_block=self.total_blocks, expect_token=True)
        generated: List[int] = []
        stopped_by = "max_tokens"

        t0 = time.monotonic()
        ids = torch.tensor([list(prompt_ids)], dtype=torch.int64)
        resp = self._call_with_recovery(hop, StageRequest(
            session_id=session_id, hidden=ids, seq_len=prompt_len, cur_len=0,
            is_prefill=True, max_length=max_length, sampling=sampling,
            step_seed=self.seed, start_block=hop.start_block,
            end_block=hop.end_block, prefix_len=prompt_len,
            deadline_budget_s=self._deadline_budget(deadline_at, session_id,
                                                    peer=hop.peer_id),
            priority=self._session_priority.get(session_id)))
        if not resp.is_token:
            raise RuntimeError(f"burst peer {hop.peer_id} returned no prefill token")
        self._journal_append(hop.key, session_id, JournalEntry(ids, prompt_len, 0))
        ttft = time.monotonic() - t0
        self._m_ttft.observe(ttft)
        generated.append(int(resp.token_id))
        yield GenerationStep(new_tokens=[generated[-1]])

        decode_times: List[float] = []
        cur_len = prompt_len
        while len(generated) < max_new_tokens:
            # The host's stop rules first, in the per-step loop's order: a
            # burst's last token may be an eos or a repeat that the device
            # could not act on (a stop gates the next tick only).
            if eos_token_id is not None and generated[-1] == eos_token_id:
                stopped_by = "eos"
                break
            if (len(generated) >= REPEAT_STOP
                    and len(set(generated[-REPEAT_STOP:])) == 1):
                stopped_by = "repeat"
                break
            t0 = time.monotonic()
            resp = self._call_with_recovery(hop, StageRequest(
                session_id=session_id,
                hidden=torch.tensor([[generated[-1]]], dtype=torch.int64),
                seq_len=1, cur_len=cur_len, is_prefill=False,
                max_length=max_length, sampling=sampling,
                generated_tokens=clip_generated(generated),
                step_seed=self.seed + len(generated),
                start_block=hop.start_block, end_block=hop.end_block,
                burst_len=burst,
                burst_budget=min(burst, max_new_tokens - len(generated)),
                eos_token_id=eos_token_id,
                deadline_budget_s=self._deadline_budget(deadline_at, session_id,
                                                        peer=hop.peer_id),
                priority=self._session_priority.get(session_id)))
            if not resp.is_burst:
                raise RuntimeError(f"burst peer {hop.peer_id} returned no token block")
            toks = list(resp.burst_tokens)
            self._journal_append(hop.key, session_id, JournalEntry(
                torch.tensor([[generated[-1], *toks[:-1]]], dtype=torch.int64),
                len(toks), cur_len))
            dt = time.monotonic() - t0
            decode_times.append(dt)
            self._m_step.observe(dt)
            self._m_tokens.inc(len(toks))
            cur_len += len(toks)
            # The per-token scan of the per-step loop: the device may run
            # past the host's stop point by ticks it could not see.
            n_before = len(generated)
            stop = None
            for tok in toks:
                if len(generated) >= max_new_tokens:
                    break
                generated.append(int(tok))
                if eos_token_id is not None and tok == eos_token_id:
                    stop = "eos"
                    break
                if (len(generated) >= REPEAT_STOP
                        and len(set(generated[-REPEAT_STOP:])) == 1):
                    stop = "repeat"
                    break
            yield GenerationStep(new_tokens=generated[n_before:])
            if stop is not None:
                stopped_by = stop
                break

        self._m_generations.inc()
        yield GenerationStep(new_tokens=[], done=True, result=GenerationResult(
            tokens=generated, ttft_s=ttft, decode_times_s=decode_times,
            stopped_by=stopped_by))

    # ------------------------------------------------------------------
    # Beam search: the client's bookkeeping; the servers reorder their KV
    # rows by hypo_ids and the final stage answers top-N log-probs.
    # ------------------------------------------------------------------

    def beam_search(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
                    num_beams: int = 4, *, length_penalty: float = 1.0,
                    eos_token_id: Optional[int] = None,
                    session_id: Optional[str] = None,
                    max_length: Optional[int] = None) -> BeamResult:
        """Distributed beam search (the reference's ``client.py:1747-1864``).
        The session holds num_beams KV rows on every stage; each step sends
        ``hypo_ids`` so the stages reorder their rows to the surviving
        hypotheses before computing. The prompt is prefilled once at batch
        1: the first decode step's ``(0,) * num_beams`` grows every stage's
        rows, so no stage runs num_beams - 1 redundant prefills. Candidates:
        each row's top ``2 * num_beams``, row-major, stably sorted by score;
        an EOS candidate finishes a hypothesis, scored ``score / length **
        length_penalty``; the search stops early once num_beams have
        finished and the best of them beats the best live beam. Every
        session lease is released at the end."""
        if self.use_push_chain:
            raise ValueError("beam search uses the per-hop walk; disable use_push_chain")
        session_id = session_id or f"beam-{time.monotonic_ns():x}"
        prompt_len = len(prompt_ids)
        max_length = max_length or (prompt_len + max_new_tokens)
        nb = num_beams
        topn = 2 * nb  # the candidate pool a row (HF's convention)
        tracer = get_tracer()

        def step(ids: torch.Tensor, cur_len: int, hypo) -> StageResponse:
            is_prefill = cur_len == 0
            root = tracer.start_span("pipeline_step", kind="client", session_id=session_id,
                                     phase="prefill" if is_prefill else "decode")
            try:
                s0_resp = self.stage0.forward(StageRequest(
                    session_id=session_id, hidden=ids, seq_len=ids.shape[1],
                    cur_len=cur_len, is_prefill=is_prefill, max_length=max_length,
                    hypo_ids=hypo))
                times: Dict[str, float] = {}
                resp = self._walk(s0_resp.hidden, ids.shape[1], cur_len, session_id,
                                  is_prefill=is_prefill, max_length=max_length,
                                  sampling=SamplingParams(), stage_times=times, root=root,
                                  kind=EXOTIC, hypo_ids=hypo, num_logprobs=topn)
            finally:
                root.end()
            if is_prefill:
                self.last_prefill_stage_times = times
            return resp

        def norm(score: float, length: int) -> float:
            return score / (max(length, 1) ** length_penalty)

        try:
            t0 = time.monotonic()
            # Ids are made on the host: stage 0 copies them without a sync.
            resp = step(torch.tensor([list(prompt_ids)], dtype=torch.int64), 0, None)
            ttft = time.monotonic() - t0
            self._m_ttft.observe(ttft)
            # The beams grow from the prefill's one row, under the EOS rule
            # of every later step (an EOS first token is a finished
            # one-token hypothesis, not a live beam).
            beams: List[List[int]] = []
            scores: List[float] = []
            finished: List[Tuple[float, List[int]]] = []
            for tok, lp in zip(resp.top_tokens[0], resp.top_logprobs[0]):
                if eos_token_id is not None and tok == eos_token_id:
                    finished.append((norm(float(lp), 1), [int(tok)]))
                    continue
                beams.append([int(tok)])
                scores.append(float(lp))
                if len(beams) == nb:
                    break
            identity = tuple(range(nb))
            parents: Tuple[int, ...] = (0,) * nb
            cur_len = prompt_len
            for _ in range(1, max_new_tokens):
                # An identity reorder carries nothing; as None it keeps the
                # journal's entries coalescible without composition.
                hypo = None if parents == identity else parents
                resp = step(torch.tensor([[b[-1]] for b in beams], dtype=torch.int64),
                            cur_len, hypo)
                cur_len += 1
                cands = []
                for i in range(len(beams)):
                    for tok, lp in zip(resp.top_tokens[i], resp.top_logprobs[i]):
                        cands.append((scores[i] + float(lp), i, int(tok)))
                cands.sort(key=lambda c: c[0], reverse=True)
                new_beams, new_scores, new_parents = [], [], []
                for score, parent, tok in cands:
                    if eos_token_id is not None and tok == eos_token_id:
                        finished.append((norm(score, len(beams[parent]) + 1),
                                         beams[parent] + [tok]))
                        continue
                    new_beams.append(beams[parent] + [tok])
                    new_scores.append(score)
                    new_parents.append(parent)
                    if len(new_beams) == nb:
                        break
                beams, scores, parents = new_beams, new_scores, tuple(new_parents)
                if finished and len(finished) >= nb:
                    if max(f[0] for f in finished) >= norm(max(scores), len(beams[0])):
                        break
            for score, beam in zip(scores, beams):
                finished.append((norm(score, len(beam)), beam))
            finished.sort(key=lambda f: f[0], reverse=True)
            return BeamResult(tokens=finished[0][1], score=finished[0][0], num_beams=nb,
                              ttft_s=ttft)
        finally:
            self._end_session(session_id)

    def _end_session(self, session_id: str) -> None:
        self.stage0.drop_session(session_id)
        self._session_prompts.pop(session_id, None)
        # Every peer that held the session's KV: the ones it called (failed
        # over from included) and those of the cached routes.
        peers = set(self._session_peers.pop(session_id, ()))
        for hops in self._routes.values():
            peers.update(hop.peer_id for hop in hops)
        for peer_id in peers:
            try:
                self.transport.end_session(peer_id, session_id)
            except Exception:  # a dead peer's lease dies with the peer
                pass
        for sessions in self.journal.values():
            sessions.pop(session_id, None)


def make_server_record(peer_id: str, spec: StageSpec, *, throughput: float = 1.0,
                       cache_tokens_left: Optional[int] = None,
                       model: Optional[str] = None,
                       engine: str = "session") -> ServerRecord:
    """Registry record for a fixed-split stage server."""
    return ServerRecord(peer_id=peer_id, start_block=spec.start,
                        end_block=spec.end, throughput=throughput,
                        final_stage=spec.is_last, stage_index=spec.index,
                        cache_tokens_left=cache_tokens_left, model=model,
                        engine=engine)
