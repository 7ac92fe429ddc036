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

Module and latency routing, push chains, burst, beam and speculative
decoding, deadlines and their telemetry hooks are not ported yet.

Deliberate difference: journal entries keep the activation tensor on its
device (tensors are never modified after they are sent), where the
reference copies each one to host memory.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

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
from .transport import PeerUnavailable, Transport

logger = logging.getLogger(__name__)

MAX_ATTEMPTS = 3          # attempts per hop call before the call fails
SETTLE_SECONDS = 0.2      # pause after a replay, before the retried call
REPEAT_STOP = 5           # 5 consecutive identical tokens end a generation
# A coalesced replay chunk must stay replayable in one request.
MAX_COALESCED_TOKENS = 4096
# Engines that serve their full span only and refuse replay: a replacement
# peer receives the session's replay journal, so rediscovery avoids them.
SESSION_ONLY_ENGINES = ("batched", "sp")


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

    key: str                 # stable hop identity ("stage1")
    peer_id: str
    start_block: int
    end_block: int
    expect_token: bool       # final hop returns a sampled token


@dataclasses.dataclass
class JournalEntry:
    hidden: torch.Tensor     # [B, T, D] activation as sent
    seq_len: int
    cur_len: int             # session length before this entry


def _merge_entries(a: JournalEntry, b: JournalEntry) -> JournalEntry:
    """Coalesce two adjacent journal entries into one replayable chunk."""
    return JournalEntry(hidden=torch.cat([a.hidden, b.hidden], dim=1),
                        seq_len=a.seq_len + b.seq_len, cur_len=a.cur_len)


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
                 request_timeout: float = 60.0,
                 settle_seconds: float = SETTLE_SECONDS,
                 journal_max_entries: int = 256,
                 seed: int = 0, model: Optional[str] = None, metrics=None):
        self.cfg = cfg
        self.model = model
        self.plan = plan
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
        self._route: Optional[List[Hop]] = None
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

    def _compute_route(self) -> List[Hop]:
        """Fixed stage-chain route: one discovered peer per remote stage."""
        hops: List[Hop] = []
        for spec in self.plan.stages[1:]:
            key = f"stage{spec.index}"
            peer = self.registry.discover_stage(
                spec.index, exclude=tuple(self.failed_peers.get(key, ())),
                model=self.model)
            if peer is None:
                raise NoRouteError(f"no live server for {key}")
            hops.append(Hop(key, peer, spec.start, spec.end, spec.is_last))
        self._m_route_plans.labels(planner="stage").inc()
        self._m_route_hops.observe(len(hops))
        return hops

    def route(self, refresh: bool = False) -> List[Hop]:
        if refresh or self._route is None:
            self._route = self._compute_route()
        return self._route

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
                start_block=hop.start_block, end_block=hop.end_block)
            self.transport.call(hop.peer_id, req, self.request_timeout)
        _ev.emit("replay_done", session_id=session_id, peer=hop.peer_id,
                 tokens=tokens, seconds=round(time.monotonic() - t0, 4))

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
        engines that refuse a replay journal (the stage branch of the
        reference's rediscovery)."""
        return self.registry.discover_stage(
            int(hop.key.removeprefix("stage")), exclude=exclude,
            model=self.model, avoid_engine=SESSION_ONLY_ENGINES)

    def _walk(self, hidden: torch.Tensor, seq_len: int, cur_len: int,
              session_id: str, *, is_prefill: bool, max_length: int,
              sampling: SamplingParams, generated: Sequence[int] = (),
              step_seed: int = 0, stage_times: Dict[str, float],
              root) -> StageResponse:
        """Send the activation through every remote hop, each call through
        the recovery wrapper; return the final hop's response (a sampled
        token). `root` is the step's root span, opened by the generation
        loop so that stage 0 and every hop share one trace (the no-op span
        with tracing off)."""
        phase = "prefill" if is_prefill else "decode"
        tracer = get_tracer()
        cur = hidden
        for i, hop in enumerate(self.route()):
            req = StageRequest(
                session_id=session_id, hidden=cur, seq_len=seq_len,
                cur_len=cur_len, is_prefill=is_prefill, max_length=max_length,
                sampling=sampling, generated_tokens=clip_generated(generated),
                step_seed=step_seed, start_block=hop.start_block,
                end_block=hop.end_block,
                trace=root.wire_context(hop=i) if root else None)
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
                                 JournalEntry(cur, seq_len, cur_len))
            if hop.expect_token:
                if not resp.is_token:
                    raise RuntimeError(f"final hop {hop.key} returned no token")
                return resp
            if resp.hidden is None:
                raise RuntimeError(f"hop {hop.key} returned no hidden states")
            cur = resp.hidden
        raise RuntimeError("route had no final hop")

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 64, *,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None,
                 session_id: Optional[str] = None,
                 max_length: Optional[int] = None) -> GenerationResult:
        result: Optional[GenerationResult] = None
        for step in self.generate_stepwise(
                prompt_ids, max_new_tokens, sampling=sampling,
                eos_token_id=eos_token_id, session_id=session_id,
                max_length=max_length):
            if step.done:
                result = step.result
        assert result is not None  # the generator's final yield carries it
        return result

    def generate_stepwise(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
                          *, sampling: Optional[SamplingParams] = None,
                          eos_token_id: Optional[int] = None,
                          session_id: Optional[str] = None,
                          max_length: Optional[int] = None
                          ) -> Iterator[GenerationStep]:
        """Incremental ``generate``: yields after the prefill and after every
        decode step. The per-step sampling seed is ``self.seed +
        len(generated)``, purely session-local. Session state (KV leases,
        journal) is released when the generator finishes or is closed."""
        session_id = session_id or f"sess-{time.monotonic_ns():x}"
        _ev.emit("session_start", session_id=session_id,
                 prompt_len=len(prompt_ids), max_new_tokens=max_new_tokens)
        recoveries_before = self.recoveries
        tokens_out = 0
        try:
            for step in self._generate_steps(
                    prompt_ids, max_new_tokens, sampling=sampling or SamplingParams(),
                    eos_token_id=eos_token_id, session_id=session_id,
                    max_length=max_length):
                tokens_out += len(step.new_tokens)
                yield step
        finally:
            self._end_session(session_id)
            _ev.emit("session_end", session_id=session_id,
                     tokens=tokens_out or None,
                     recoveries=self.recoveries - recoveries_before)

    def _generate_steps(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
                        sampling: SamplingParams, eos_token_id: Optional[int],
                        session_id: str, max_length: Optional[int]
                        ) -> Iterator[GenerationStep]:
        prompt_len = len(prompt_ids)
        max_length = max_length or prompt_len + max_new_tokens
        device = self.stage0.device
        ids = torch.tensor([list(prompt_ids)], dtype=torch.int64, device=device)
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
            is_prefill=True, max_length=max_length, sampling=sampling))
        s0_span.end()
        times: Dict[str, float] = {}
        try:
            resp = self._walk(s0_resp.hidden, prompt_len, 0, session_id,
                              is_prefill=True, max_length=max_length,
                              sampling=sampling, generated=generated,
                              step_seed=self.seed, stage_times=times, root=root)
        finally:
            root.end()
        ttft = time.monotonic() - t0
        self._m_ttft.observe(ttft)
        self.last_prefill_stage_times = times
        generated.append(int(resp.token_id))
        yield GenerationStep(new_tokens=[generated[-1]])

        decode_times: List[float] = []
        cur_len = prompt_len
        while len(generated) < max_new_tokens:
            if eos_token_id is not None and generated[-1] == eos_token_id:
                stopped_by = "eos"
                break
            if (len(generated) >= REPEAT_STOP
                    and len(set(generated[-REPEAT_STOP:])) == 1):
                stopped_by = "repeat"
                break
            t0 = time.monotonic()
            step_ids = torch.tensor([[generated[-1]]], dtype=torch.int64, device=device)
            step_span = tracer.start_span(
                "pipeline_step", kind="client", session_id=session_id,
                phase="decode", step=len(generated))
            try:
                s0_resp = self.stage0.forward(StageRequest(
                    session_id=session_id, hidden=step_ids, seq_len=1,
                    cur_len=cur_len, is_prefill=False, max_length=max_length,
                    sampling=sampling))
                times = {}
                resp = self._walk(s0_resp.hidden, 1, cur_len, session_id,
                                  is_prefill=False, max_length=max_length,
                                  sampling=sampling, generated=generated,
                                  step_seed=self.seed + len(generated),
                                  stage_times=times, root=step_span)
            finally:
                step_span.end()
            dt = time.monotonic() - t0
            decode_times.append(dt)
            self._m_step.observe(dt)
            self._m_tokens.inc(1)
            cur_len += 1
            generated.append(int(resp.token_id))
            yield GenerationStep(new_tokens=[generated[-1]])

        self._m_generations.inc()
        yield GenerationStep(new_tokens=[], done=True, result=GenerationResult(
            tokens=generated, ttft_s=ttft, decode_times_s=decode_times,
            stopped_by=stopped_by))

    def _end_session(self, session_id: str) -> None:
        self.stage0.drop_session(session_id)
        peers = set(self._session_peers.pop(session_id, ()))
        peers.update(hop.peer_id for hop in self._route or ())
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
