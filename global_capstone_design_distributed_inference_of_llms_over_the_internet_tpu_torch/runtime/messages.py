"""Stage request/response schema (port of the JAX package's
``runtime/messages.py``, the fields the plain prefill/decode path uses).

The reference ships sampling params and the recent-token window in the
request metadata on EVERY step, so the final stage samples statelessly.
``hidden`` is a torch tensor: int token ids [B, T] into the first stage,
float activations [B, T, D] between stages. The trace context travels on
the request and the serving peer's span on the response. Beam, speculative,
deep-prompt, training, push-chain, deadline and burst fields are not ported
yet, nor are the backward messages.
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
    # Trace context (telemetry.tracing):
    # {"trace_id": <16 hex>, "parent": <client span_id>, "hop": <int>}.
    # None = tracing off; servers treat it as opaque.
    trace: Optional[dict] = None


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
