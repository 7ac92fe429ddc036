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
and the priority are honoured; so are speculative ``draft_tokens`` (the
final stage verifies them and answers with the accepted run,
``tokens`` / ``n_accepted``), the ``start_from_position`` rewind and beam
search: ``hypo_ids`` reorders (and may grow) a session's KV rows before
the step, and ``num_logprobs > 0`` has the final stage answer each row's
top-N candidates (``top_tokens`` / ``top_logprobs``) instead of a token;
deep ``prompts`` ([span layers, pre_seq, D]) are added at each block's
entry at absolute positions < pre_seq, on the session engines (the batched
engines refuse them, as the reference's). Burst decode on a session
engine is refused by the executor with a `StageExecutionError` that names
the field, never ignored; push-chain ``next_servers`` are served by the
transports.
``prefix_len`` marks a prefill's leading tokens shareable: a server with a
prefix store (``runtime/prefix_cache.py``) reuses their stored KV, one
without ignores it, as in the reference.

Training (the reference's ``rpc_forward`` / ``rpc_backward``): a request
with ``train`` is a cache-free forward of the span's blocks with the
client's ``prompts`` and ``lora`` adapters (scaled by ``lora_scale``) and
no head, served by the executor's ``train_forward``; a `BackwardRequest`
carries the span's input and the gradient of its output, and the
`BackwardResponse` the gradients of the input, the prompts and the
adapters. Servers keep nothing between training calls.

A full-span batched peer (``runtime/batching.py``) serves a burst
request (``burst_len > 0``) and answers it with a burst reply: the tokens one
burst emitted and why it stopped early.
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
    # Fine-tuning forward: cache-free, the span's blocks only (no head, no
    # sampling, no session), served by the executor's train_forward.
    train: bool = False
    # Deep prompts [span_layers, pre_seq, D]: with train, added at each
    # block's entry for the training forward; without, inference-time deep
    # prompts (session engines).
    prompts: Optional[torch.Tensor] = None
    # Client-owned LoRA adapters over the span ({target: {"a": [span, D, r],
    # "b": [span, r, O]}}), merged per step at lora_scale (train only).
    lora: Optional[dict] = None
    lora_scale: float = 1.0
    # Session rewind to this position before the step.
    start_from_position: Optional[int] = None
    # Beam search: KV row each hypothesis continues from, and top-N
    # logprobs instead of a sampled token.
    hypo_ids: Optional[Tuple[int, ...]] = None
    num_logprobs: int = 0
    # Speculative decoding: the K client-drafted tokens to verify.
    draft_tokens: Optional[Tuple[int, ...]] = None
    # Model identity declared by the originating client; a server holding
    # another model refuses the request.
    model: Optional[str] = None
    # Push-chain route: the hops after this one (the transports relay).
    next_servers: Tuple[dict, ...] = ()
    # Prompt-prefix sharing hint: the leading prefix_len tokens of a prefill
    # may be shared across sessions. A server with a prefix store reuses
    # them; one without ignores the hint, as the reference's do.
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
    # tokens emitted, stopping at eos_token_id (a full-span batched peer
    # serves it; the per-session executor refuses it).
    burst_len: int = 0
    burst_budget: int = 0
    eos_token_id: Optional[int] = None


@dataclasses.dataclass
class BackwardRequest:
    """The training backward (``rpc_backward``): the server re-forwards
    its span from the input it is given (nothing is kept between training
    calls) and returns the gradients of the input, the prompts and the
    adapters."""

    session_id: str
    hidden: torch.Tensor           # [B, T, D] span INPUT (what forward consumed)
    grad_output: torch.Tensor      # [B, T, D] dL/d(span output)
    seq_len: int                   # real tokens in hidden / grad_output
    prompts: Optional[torch.Tensor] = None   # [span_layers, pre_seq, D]
    start_block: Optional[int] = None
    end_block: Optional[int] = None
    # LoRA adapters, the layout of StageRequest.lora: the re-forward merges
    # them and their gradients come back.
    lora: Optional[dict] = None
    lora_scale: float = 1.0


@dataclasses.dataclass
class BackwardResponse:
    session_id: str
    grad_input: torch.Tensor                    # [B, T, D]
    grad_prompts: Optional[torch.Tensor] = None  # [span_layers, pre_seq, D]
    grad_lora: Optional[dict] = None             # the tree of lora


@dataclasses.dataclass
class StageResponse:
    """What a stage returns: hidden states (intermediate) or a token (final)."""

    session_id: str
    hidden: Optional[torch.Tensor] = None  # [B, T, D]
    token_id: Optional[int] = None
    # Batch>1 sampling: one token per batch row (token_id mirrors row 0).
    token_ids: Optional[Tuple[int, ...]] = None
    cache_len: int = 0                     # server-side KV length after the step
    # Beam mode (request.num_logprobs > 0): per batch row, the top-N
    # continuation candidates of the final stage's logits.
    top_tokens: Optional[Tuple[Tuple[int, ...], ...]] = None     # [B][N]
    top_logprobs: Optional[Tuple[Tuple[float, ...], ...]] = None  # [B][N]
    # Burst mode (request.burst_len > 0): the tokens one burst emitted
    # (<= burst_len; the device's stop rules truncate it) and why it ended
    # early: None (budget or burst boundary), "eos" or "repeat". cache_len
    # is the KV length after every emitted tick.
    burst_tokens: Optional[Tuple[int, ...]] = None
    burst_stop: Optional[str] = None
    # Speculative mode (request.draft_tokens set): n_accepted accepted
    # drafts, then one correction or bonus token (len == n_accepted + 1).
    # cache_len is the final stage's KV length after it rewound past the
    # rejected tail.
    tokens: Optional[Tuple[int, ...]] = None
    n_accepted: Optional[int] = None
    # The serving peer's span summary (telemetry.tracing Span.to_wire()):
    # its own start/end plus attrs. None when the request carried no trace.
    span: Optional[dict] = None

    @property
    def is_token(self) -> bool:
        return self.token_id is not None

    @property
    def is_burst(self) -> bool:
        return self.burst_tokens is not None

    @property
    def is_speculative(self) -> bool:
        return self.tokens is not None

    @property
    def is_beam(self) -> bool:
        return self.top_tokens is not None


def clip_generated(tokens: Sequence[int], window: int = 50) -> Tuple[int, ...]:
    """Only the last 50 generated tokens travel with a request."""
    return tuple(int(t) for t in tokens[-window:])
