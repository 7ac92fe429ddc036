"""Pipeline client: routing, the activation journal, the generation loop.

Port of the plain path of the JAX package's ``runtime/client.py``: the
tokenized prompt runs through the local first stage, then every remote hop
of a fixed stage-chain route; the final hop returns a sampled token. Every
activation sent to a hop is journaled (bounded by coalescing the oldest
entries), which is what failover replay will consume. Stop rules: EOS, and
5 identical tokens in a row.

Failover (recovery wrapper, replay, rediscovery), the circuit breaker,
latency and module routing, push chains, burst, beam and speculative
decoding are not ported yet: a failed hop raises to the caller here.

Deliberate difference: journal entries keep the activation tensor on its
device (tensors are never modified after they are sent), where the
reference copies each one to host memory.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ..models.config import ModelConfig
from ..models.partition import StagePlan, StageSpec
from ..ops.sampling import SamplingParams
from ..scheduling.registry import PlacementRegistry, ServerRecord
from .errors import register as _catalog
from .executor import StageExecutor
from .messages import StageRequest, StageResponse, clip_generated
from .transport import Transport

logger = logging.getLogger(__name__)

REPEAT_STOP = 5           # 5 consecutive identical tokens end a generation
# A coalesced replay chunk must stay replayable in one request.
MAX_COALESCED_TOKENS = 4096


@_catalog
class NoRouteError(RuntimeError):
    """No live server covers a required stage."""


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
                 request_timeout: float = 60.0, journal_max_entries: int = 256,
                 seed: int = 0, model: Optional[str] = None):
        self.cfg = cfg
        self.model = model
        self.plan = plan
        self.stage0 = stage0
        self.transport = transport
        self.registry = registry
        self.request_timeout = request_timeout
        self.journal_max_entries = journal_max_entries
        self.seed = seed
        # hop key -> session -> activation journal
        self.journal: Dict[str, Dict[str, List[JournalEntry]]] = {}
        # session -> every peer that held KV for it (released at the end)
        self._session_peers: Dict[str, set] = {}
        self._route: Optional[List[Hop]] = None
        self.last_prefill_stage_times: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # Routing
    # ------------------------------------------------------------------

    def _compute_route(self) -> List[Hop]:
        """Fixed stage-chain route: one discovered peer per remote stage."""
        hops: List[Hop] = []
        for spec in self.plan.stages[1:]:
            key = f"stage{spec.index}"
            peer = self.registry.discover_stage(spec.index, model=self.model)
            if peer is None:
                raise NoRouteError(f"no live server for {key}")
            hops.append(Hop(key, peer, spec.start, spec.end, spec.is_last))
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

    def _walk(self, hidden: torch.Tensor, seq_len: int, cur_len: int,
              session_id: str, *, is_prefill: bool, max_length: int,
              sampling: SamplingParams, generated: Sequence[int] = (),
              step_seed: int = 0, stage_times: Dict[str, float]) -> StageResponse:
        """Send the activation through every remote hop; return the final
        hop's response (a sampled token)."""
        cur = hidden
        touched = self._session_peers.setdefault(session_id, set())
        for hop in self.route():
            req = StageRequest(
                session_id=session_id, hidden=cur, seq_len=seq_len,
                cur_len=cur_len, is_prefill=is_prefill, max_length=max_length,
                sampling=sampling, generated_tokens=clip_generated(generated),
                step_seed=step_seed, start_block=hop.start_block,
                end_block=hop.end_block)
            touched.add(hop.peer_id)
            t0 = time.monotonic()
            resp = self.transport.call(hop.peer_id, req, self.request_timeout)
            stage_times[hop.key] = time.monotonic() - t0
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
        try:
            yield from self._generate_steps(
                prompt_ids, max_new_tokens, sampling=sampling or SamplingParams(),
                eos_token_id=eos_token_id, session_id=session_id,
                max_length=max_length)
        finally:
            self._end_session(session_id)

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

        t0 = time.monotonic()
        s0_resp = self.stage0.forward(StageRequest(
            session_id=session_id, hidden=ids, seq_len=prompt_len, cur_len=0,
            is_prefill=True, max_length=max_length, sampling=sampling))
        times: Dict[str, float] = {}
        resp = self._walk(s0_resp.hidden, prompt_len, 0, session_id,
                          is_prefill=True, max_length=max_length,
                          sampling=sampling, generated=generated,
                          step_seed=self.seed, stage_times=times)
        ttft = time.monotonic() - t0
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
            s0_resp = self.stage0.forward(StageRequest(
                session_id=session_id, hidden=step_ids, seq_len=1,
                cur_len=cur_len, is_prefill=False, max_length=max_length,
                sampling=sampling))
            times = {}
            resp = self._walk(s0_resp.hidden, 1, cur_len, session_id,
                              is_prefill=False, max_length=max_length,
                              sampling=sampling, generated=generated,
                              step_seed=self.seed + len(generated),
                              stage_times=times)
            decode_times.append(time.monotonic() - t0)
            cur_len += 1
            generated.append(int(resp.token_id))
            yield GenerationStep(new_tokens=[generated[-1]])

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
