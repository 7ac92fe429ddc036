"""Stage request/response schema (port of the JAX package's
``runtime/messages.py``, the fields the plain prefill/decode path uses).

The reference ships sampling params and the recent-token window in the
request metadata on EVERY step, so the final stage samples statelessly.
``hidden`` is a torch tensor: int token ids [B, T] into the first stage,
float activations [B, T, D] between stages. The trace context travels on
the request and the serving peer's span on the response.

The request carries every header field the reference's wire carries, with
the reference's defaults, so that the TCP plane (``runtime/net.py``) builds
one from any frame a client of either package sends. The deadline budget
and the priority are honoured; the exotic fields (beam ``hypo_ids`` and
``num_logprobs``, speculative ``draft_tokens``, deep ``prompts``, burst
decode, push-chain ``next_servers``, the ``start_from_position`` rewind)
are refused by the executor with a `StageExecutionError` that names the
field, never ignored. ``prefix_len`` is a sharing hint that a server
without a prefix store ignores, as in the reference. The training fields
and the backward messages are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops.sampling import SamplingParams


@dataclasses.dataclass
class StageRequest:
    """One hop's worth of work for a pipeline stage."""

    session_id: str
    hidden: torch.Tensor           # [B, T] ids or [B, T, D] activation
    seq_len: int                   # number of tokens in hidden
    cur_len: int                   # tokens already in this session before this step
    is_prefill: bool
    max_length: int                # session KV admission limit
    is_replay: bool = False        # replaying journal into a replacement peer
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    generated_tokens: Tuple[int, ...] = ()   # last <=50, for repetition penalty
    step_seed: int = 0             # deterministic per-step sampling seed
    # Absolute block sub-range to execute (None = the server's whole span).
    start_block: Optional[int] = None
    end_block: Optional[int] = None
    # Deep prompts [span_layers, pre_seq, D] (refused by the port's executor).
    prompts: Optional[torch.Tensor] = None
    # Session rewind to this position before the step (refused).
    start_from_position: Optional[int] = None
    # Beam search: KV row each hypothesis continues from, and top-N
    # logprobs instead of a sampled token (refused).
    hypo_ids: Optional[Tuple[int, ...]] = None
    num_logprobs: int = 0
    # Speculative decoding: the K client-drafted tokens to verify (refused).
    draft_tokens: Optional[Tuple[int, ...]] = None
    # Model identity declared by the originating client; a server holding
    # another model refuses the request.
    model: Optional[str] = None
    # Push-chain route: the hops after this one (refused).
    next_servers: Tuple[dict, ...] = ()
    # Prompt-prefix sharing hint: the leading prefix_len tokens of a prefill
    # may be shared across sessions. A server without a prefix store (every
    # port server) ignores it, as the reference's do.
    prefix_len: int = 0
    # Trace context (telemetry.tracing):
    # {"trace_id": <16 hex>, "parent": <client span_id>, "hop": <int>}.
    # None = tracing off; servers treat it as opaque.
    trace: Optional[dict] = None
    # Seconds of the end-to-end deadline left when the request left its
    # sender; a server that finds it spent refuses the work. None = none.
    deadline_budget_s: Optional[float] = None
    # Tenant priority (lower = more urgent) for the server's task pool.
    priority: Optional[float] = None
    # Burst decode: up to burst_len ticks in one call, at most burst_budget
    # tokens emitted, stopping at eos_token_id (refused).
    burst_len: int = 0
    burst_budget: int = 0
    eos_token_id: Optional[int] = None


@dataclasses.dataclass
class StageResponse:
    """What a stage returns: hidden states (intermediate) or a token (final)."""

    session_id: str
    hidden: Optional[torch.Tensor] = None  # [B, T, D]
    token_id: Optional[int] = None
    # Batch>1 sampling: one token per batch row (token_id mirrors row 0).
    token_ids: Optional[Tuple[int, ...]] = None
    cache_len: int = 0                     # server-side KV length after the step
    # The serving peer's span summary (telemetry.tracing Span.to_wire()):
    # its own start/end plus attrs. None when the request carried no trace.
    span: Optional[dict] = None

    @property
    def is_token(self) -> bool:
        return self.token_id is not None


def clip_generated(tokens: Sequence[int], window: int = 50) -> Tuple[int, ...]:
    """Only the last 50 generated tokens travel with a request."""
    return tuple(int(t) for t in tokens[-window:])
