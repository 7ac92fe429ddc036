"""Per-stage executor: the server-side compute path.

Port of the plain engine of the JAX package's ``runtime/executor.py``:
manage per-session KV leases, run the stage's layer span, and either return
the next hidden states (intermediate stage) or sample a token (final stage,
with the sampling params and recent-token window taken from each request).

Replay semantics as in the reference: a prefill clears any existing session
cache; a decode with no cached session and ``is_replay=True`` is treated as
a prefill chunk; a decode with no cached session otherwise is a hard error.

Differences from the reference's engine: PyTorch runs eagerly, so the step
is a direct call and sequences are not padded to compile buckets (prefill
still runs in byte-bounded chunks). Offload, tensor parallelism, the prefix
cache, deep prompts, speculative verify, beam search, burst decode, push
chains, session rewind and training are not ported: a request that asks
for one is refused with a `StageExecutionError` naming its field (the TCP
server sends it back as a ``kind: "stage"`` error frame). Given
``act_dtype`` (the model's ``--dtype``), a float activation is cast to it
on arrival: the wire decodes to float32, so a bfloat16 model computes the
same numbers after a TCP hop as after an in-process one, where the
reference's engine would compute that stage in float32.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.partition import (
    ROLE_FULL,
    ROLE_LAST,
    ROLE_SEGMENT,
    ROLE_STAGE0,
    StageSpec,
    stage_forward,
)
from ..models.quant import tree_map
from ..models.transformer import fuse_qkv_params
from ..ops.sampling import RECENT_WINDOW, sample_token
from ..ops.threefry import fold_in, prng_key
from ..telemetry import events as _ev
from .errors import register as _catalog
from .kv_cache import AllocationFailed, KVArena, KVHandle
from .messages import StageRequest, StageResponse

logger = logging.getLogger(__name__)

SEQ_BUCKETS = (1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
# warmup(): a prefill of the first length, then steps of the others, in a
# session of this capacity.
WARMUP_SEQ_LENS = (16, 8, 1)
WARMUP_MAX_LENGTH = 128


@_catalog
class StageExecutionError(RuntimeError):
    """Server-side hard error (e.g. decode without a cached session)."""


def _sample_rows(logits: torch.Tensor, t_real: int, req: StageRequest) -> list:
    """Final-stage sampling from the last real token's logits, per batch
    row. logits: [B, T, V] -> list of B token ids. Row 0 draws with
    ``PRNGKey(step_seed)`` and row i with ``fold_in(base, i)``, the
    reference's key schedule (``executor.py:160-173``), so row 0 of a batch
    draws what a batch-1 request would. The recent-token window is per
    session, shared by the rows."""
    last = logits[:, t_real - 1]
    n = min(len(req.generated_tokens), RECENT_WINDOW)
    recent = torch.zeros(RECENT_WINDOW, dtype=torch.int32)
    if n:
        recent[:n] = torch.tensor(req.generated_tokens[-n:], dtype=torch.int32)
    recent = recent.to(last.device)
    sp = req.sampling
    base = prng_key(req.step_seed)
    return [sample_token(base if i == 0 else fold_in(base, i), row, recent, n,
                         sp.temperature, sp.top_p, sp.top_k,
                         sp.repetition_penalty)
            for i, row in enumerate(last)]


def _unported_field(req: StageRequest) -> Optional[str]:
    """The first request field this executor does not implement that the
    request sets, or None."""
    for name, is_set in (("hypo_ids", req.hypo_ids is not None),
                         ("num_logprobs", req.num_logprobs > 0),
                         ("draft_tokens", req.draft_tokens is not None),
                         ("prompts", req.prompts is not None),
                         ("burst_len", req.burst_len > 0),
                         ("next_servers", bool(req.next_servers)),
                         ("start_from_position", req.start_from_position is not None)):
        if is_set:
            return name
    return None


class StageExecutor:
    """One pipeline stage's compute engine (one 'server' in reference terms)."""

    def __init__(self, cfg: ModelConfig, spec: StageSpec, params: Dict[str, Any],
                 arena: Optional[KVArena] = None, *, device,
                 max_cache_bytes: int = 1 << 30,
                 cache_dtype: torch.dtype = torch.float32,
                 peer_id: str = "local",
                 max_chunk_bytes: int = 256 * 1024 * 1024,
                 act_dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        # Engine-side fused layout: one wqkv and one wgu matmul per layer.
        self.params = fuse_qkv_params(params)
        # The dtype float activations are cast to on arrival (None: as sent).
        self.act_dtype = act_dtype
        self.peer_id = peer_id
        self.max_chunk_bytes = max_chunk_bytes
        self.cache_dtype = cache_dtype
        # Forward calls that ran to the end (prefill, decode and replay).
        self.requests_served = 0
        self.arena = arena or KVArena(
            num_layers=max(spec.num_layers, 1), num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, max_bytes=max_cache_bytes,
            device=self.device, dtype=cache_dtype)
        # Sub-span execution units keyed by relative layer range (a, b): a
        # request may cover only part of the loaded span.
        self._subspans: Dict[tuple, tuple] = {}
        self._get_subspan(0, spec.num_layers)

    def _get_subspan(self, a: int, b: int):
        entry = self._subspans.get((a, b))
        if entry is not None:
            return entry
        spec = self.spec
        if a == 0 and b == spec.num_layers:
            sub_spec, sub_params = spec, self.params
        else:
            first = spec.is_first and a == 0
            last = spec.is_last and b == spec.num_layers
            role = (ROLE_FULL if first and last else ROLE_STAGE0 if first
                    else ROLE_LAST if last else ROLE_SEGMENT)
            sub_spec = StageSpec(spec.index, role, spec.start + a, spec.start + b)
            sub_params = {}
            if "layers" in self.params:
                sub_params["layers"] = tree_map(lambda x: x[a:b], self.params["layers"])
            if first and "embed" in self.params:
                sub_params["embed"] = self.params["embed"]
            if last:
                for k in ("final_norm", "lm_head"):
                    if k in self.params:
                        sub_params[k] = self.params[k]
                if self.cfg.tie_word_embeddings and "embed" in self.params:
                    sub_params["embed"] = {**sub_params.get("embed", {}),
                                           "wte": self.params["embed"]["wte"]}
        cfg = self.cfg

        def step(params, x, k_cache, v_cache, cache_len):
            return stage_forward(cfg, sub_spec, params, x, k_cache, v_cache, cache_len)

        entry = (sub_spec, sub_params, step)
        self._subspans[(a, b)] = entry
        return entry

    def _resolve_range(self, req: StageRequest) -> tuple:
        """Absolute request block range -> relative (a, b) within the span."""
        a = 0 if req.start_block is None else req.start_block - self.spec.start
        b = (self.spec.num_layers if req.end_block is None
             else req.end_block - self.spec.start)
        if not (0 <= a < b <= max(self.spec.num_layers, 1)):
            raise StageExecutionError(
                f"requested blocks [{req.start_block},{req.end_block}) outside "
                f"served span [{self.spec.start},{self.spec.end})")
        return a, b

    # ------------------------------------------------------------------
    # Session / cache management
    # ------------------------------------------------------------------

    def _allocate(self, req: StageRequest, num_layers: int, batch: int) -> KVHandle:
        """Arena lease as a STAGE error, so a full arena is retryable
        client-side rather than a crash."""
        try:
            handle = self.arena.allocate(req.session_id, req.max_length,
                                         num_layers=num_layers, batch=batch)
        except AllocationFailed as exc:
            raise StageExecutionError(str(exc)) from exc
        _ev.emit("server_session_open", session_id=req.session_id,
                 peer=self.peer_id, max_length=req.max_length,
                 replay=req.is_replay)
        return handle

    def _session_cache(self, req: StageRequest, num_layers: int,
                       batch: int = 1) -> KVHandle:
        handle = self.arena.get(req.session_id)
        if req.is_prefill:
            if handle is not None:
                self.arena.free(req.session_id)
            handle = self._allocate(req, num_layers, batch)
        elif handle is None:
            if req.is_replay:
                handle = self._allocate(req, num_layers, batch)
            else:
                raise StageExecutionError(
                    f"session {req.session_id}: decode step without KV cache "
                    "and not a replay")
        if not req.is_prefill and handle.cache_len != req.cur_len and not req.is_replay:
            logger.warning("session %s: past-len mismatch client=%d server=%d; "
                           "trusting server", req.session_id, req.cur_len,
                           handle.cache_len)
        return handle

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def forward(self, req: StageRequest) -> StageResponse:
        """Run one step of this stage for one session."""
        field = _unported_field(req)
        if field is not None:
            raise StageExecutionError(
                f"request field {field!r} is not ported: this stage serves "
                "plain prefill and decode steps")
        a, b = self._resolve_range(req)
        sub_spec, sub_params, step = self._get_subspan(a, b)
        x = req.hidden.to(self.device)
        if x.is_floating_point() and self.act_dtype not in (None, x.dtype):
            x = x.to(self.act_dtype)
        want_ndim = 2 if sub_spec.is_first else 3
        if x.ndim != want_ndim:
            raise StageExecutionError(
                f"stage {self.spec.index} expects ndim={want_ndim}, got {tuple(x.shape)}")
        handle = self._session_cache(req, num_layers=max(b - a, 1), batch=x.shape[0])
        if handle.k.shape[0] != max(b - a, 1):
            raise StageExecutionError(
                f"session {req.session_id} was allocated for {handle.k.shape[0]} "
                f"layers but the request covers {b - a}")
        if handle.k.shape[1] != x.shape[0]:
            raise StageExecutionError(
                f"session {req.session_id} holds KV for batch {handle.k.shape[1]}, "
                f"request batch is {x.shape[0]}")
        t_real = req.seq_len
        if x.shape[1] != t_real:
            raise StageExecutionError(f"seq_len {t_real} != tensor T {x.shape[1]}")
        handle.admit(t_real)

        # Chunked prefill: an oversized request runs as byte-bounded chunks
        # over the same session cache (identical numerics: each chunk
        # attends causally to everything already written). Intermediate
        # stages concatenate chunk outputs; the last samples from the last.
        chunk = self._max_chunk_tokens(x.shape[0])
        outs = []
        for off in range(0, t_real, chunk):
            n = min(chunk, t_real - off)
            out, _, _ = step(sub_params, x[:, off:off + n], handle.k, handle.v,
                             handle.cache_len)
            handle.advance(n)
            outs.append(out)
        self.requests_served += 1

        if sub_spec.is_last:
            tokens = _sample_rows(outs[-1], outs[-1].shape[1], req)
            return StageResponse(
                session_id=req.session_id, token_id=tokens[0],
                token_ids=tuple(tokens) if len(tokens) > 1 else None,
                cache_len=handle.cache_len)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return StageResponse(session_id=req.session_id, hidden=out,
                             cache_len=handle.cache_len)

    def _max_chunk_tokens(self, batch: int) -> int:
        """Tokens per prefill chunk: the byte budget over the per-token
        activation estimate (batch x hidden x fp32 x span layers), floored
        at 16 and aligned down to a sequence bucket."""
        per_token = batch * self.cfg.hidden_size * 4 * max(self.spec.num_layers, 1)
        est = max(16, min(self.max_chunk_bytes // max(per_token, 1), SEQ_BUCKETS[-1]))
        return max(b for b in SEQ_BUCKETS if b <= est)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """One throwaway session through the span before serving (prefill,
        then steps of the other lengths), as the reference's serve mode
        does: the first real request then pays no one-time device set-up
        (library handles, kernel modules) inside its client's deadline."""
        cur = 0
        for i, t in enumerate(WARMUP_SEQ_LENS):
            if self.spec.is_first:
                x = torch.zeros((1, t), dtype=torch.int64)
            else:
                x = torch.zeros((1, t, self.cfg.hidden_size), dtype=torch.float32)
            try:
                self.forward(StageRequest(
                    session_id="__warmup__", hidden=x, seq_len=t, cur_len=cur,
                    is_prefill=(i == 0), max_length=WARMUP_MAX_LENGTH))
                cur += t
            except Exception as exc:  # warmup must never kill a server
                logger.warning("warmup step (T=%d) failed: %s", t, exc,
                               exc_info=True)
        self.drop_session("__warmup__")

    def drop_session(self, session_id: str) -> None:
        if self.arena.get(session_id) is not None:
            _ev.emit("server_session_closed", session_id=session_id,
                     peer=self.peer_id)
        self.arena.free(session_id)
