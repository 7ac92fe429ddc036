"""Token sampling with the reference's semantics (port of the JAX package's
``ops/sampling.py``), run on the final stage:

  1. temperature <= 0  -> greedy argmax of the raw logits.
  2. count-scaled repetition penalty over the last 50 generated tokens:
     penalty = rp ** count(token); positive logits are divided, negative
     multiplied.
  3. triple-repeat guard: if the last 3 generated tokens are identical,
     apply a strong rp**3 penalty to that token.
  4. probs = softmax(logits / max(temperature, 1e-5)).
  5. top-k filter on probs (unrenormalized zero-out; ties at the k-th
     value are all kept).
  6. top-p nucleus on the sorted probs: keep cumsum <= top_p, always keep
     the first, renormalize the kept mass.
  7. renormalize and draw: Gumbel-max ``categorical`` over
     ``log(max(probs, 1e-20))`` with a threefry key (``ops.threefry``), the
     reference's own draw, so a seeded run samples the reference's tokens;
     on the card the draw is one kernel (``ops/draw_kernel.py``).

As in the reference, the sampler is a function of device values only: the
knobs (`sampling_scalars`), the recent-token window and its length, and
the key are tensors, every choice is a ``torch.where``, and nothing is
read back to the host. So one CUDA graph of it serves every knob setting
(``runtime/graphs.py`` captures it once per batch rows and vocabulary, as
the reference jits ``sample_token`` once). Python numbers are accepted
wherever a knob goes and become 0-d tensors by fills, never by copies
from host memory. Logits may carry a leading batch axis ``[B, V]``: the
rows share the window and the knobs and draw each with its own key.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from .draw_kernel import sample_draw
from .threefry import Key

RECENT_WINDOW = 50  # reference: generated_tokens[-50:]

Scalar = Union[int, float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-session sampling config; travels in request metadata."""

    temperature: float = 0.7
    top_p: float = 0.9
    top_k: int = 50
    repetition_penalty: float = 1.5

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _scalar(value: Scalar, dtype: torch.dtype, device) -> torch.Tensor:
    """`value` as a 0-d tensor of `dtype` on `device`: a tensor is cast
    (on its device), a Python number written by a fill."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def sampling_scalars(temperature: Scalar, top_p: Scalar, top_k: Scalar,
                     repetition_penalty: Scalar, device="cpu") -> Tuple[torch.Tensor, ...]:
    """The 0-d knob tensors every caller passes to `sample_token`: float32
    temperature, top_p and repetition_penalty, int32 top_k (reference
    ``ops/sampling.py:35-41``), so the knob order cannot skew between call
    sites."""
    return (_scalar(temperature, torch.float32, device),
            _scalar(top_p, torch.float32, device),
            _scalar(top_k, torch.int32, device),
            _scalar(repetition_penalty, torch.float32, device))


def make_recent_buffer(device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty recent-token buffer: (tokens[RECENT_WINDOW] int32, num_valid
    0-d int32)."""
    return (torch.zeros(RECENT_WINDOW, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def push_recent(tokens: torch.Tensor, num_valid: Scalar, new_token: Scalar):
    """Append a token, shifting left once the window is full: the window
    and its length as new tensors, chosen by ``torch.where`` (no branch
    on `num_valid`)."""
    dev = tokens.device
    nv = _scalar(num_valid, torch.int32, dev)
    new = _scalar(new_token, torch.int32, dev)
    full = nv >= RECENT_WINDOW
    shifted = torch.where(full, torch.roll(tokens, -1), tokens)
    idx = torch.where(full, RECENT_WINDOW - 1, nv).long().reshape(1)
    return (shifted.index_put((idx,), new.reshape(1)),
            torch.clamp(nv + 1, max=RECENT_WINDOW))


def apply_repetition_penalty(logits: torch.Tensor, recent_tokens: torch.Tensor,
                             num_valid: Scalar, repetition_penalty: Scalar) -> torch.Tensor:
    """Count-scaled, sign-aware repetition penalty over the recent window.
    logits: [..., V] float32; recent_tokens: [RECENT_WINDOW] int (newest
    last). The triple-repeat guard reads the three newest tokens at
    clamped device indices and writes the newest token's logit back
    penalized or unchanged (reference ``:93-101``)."""
    dev = logits.device
    vocab = logits.shape[-1]
    window = recent_tokens.shape[0]
    nv = _scalar(num_valid, torch.int64, dev)
    rp = _scalar(repetition_penalty, torch.float32, dev)
    valid = torch.arange(window, device=dev) < nv
    safe = torch.where(valid, recent_tokens.long(), 0)
    counts = torch.zeros(vocab, dtype=torch.float32, device=dev)
    counts.index_add_(0, safe, valid.float())
    penalty = rp ** counts
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    logits = torch.where(counts > 0, penalized, logits)

    newest = torch.clamp(nv - torch.arange(1, 4, device=dev), 0, window - 1)
    t = recent_tokens.index_select(0, newest).long()
    is_triple = (nv >= 3) & (t[0] == t[1]) & (t[1] == t[2])
    idx = t[:1]
    cur = logits.index_select(-1, idx)
    strong = rp ** 3
    hit = torch.where(cur > 0, cur / strong, cur * strong)
    return logits.index_copy(-1, idx, torch.where(is_triple, hit, cur))


def _top_k_filter(probs: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    vocab = probs.shape[-1]
    sorted_desc = torch.sort(probs, dim=-1, descending=True).values
    kth = sorted_desc.index_select(-1, torch.clamp(top_k.long() - 1, 0, vocab - 1).reshape(1))
    apply = (top_k > 0) & (top_k < vocab)
    return torch.where(apply & (probs < kth), 0.0, probs)


def _top_p_filter(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = probs.gather(-1, order)
    keep = torch.cumsum(sorted_probs, dim=-1) <= top_p
    keep[..., :1].fill_(True)       # a fill: no copy of a host scalar (capturable)
    filtered = sorted_probs * keep
    filtered = filtered / torch.clamp(filtered.sum(-1, keepdim=True), min=1e-20)
    scattered = torch.zeros_like(probs).scatter(-1, order, filtered)
    apply = (top_p > 0.0) & (top_p < 1.0)
    return torch.where(apply, scattered, probs)


def sample_probs(logits: torch.Tensor, recent_tokens: torch.Tensor, num_valid: Scalar,
                 temperature: Scalar, top_p: Scalar, top_k: Scalar,
                 repetition_penalty: Scalar) -> torch.Tensor:
    """Final categorical distribution after penalty + temperature + top-k +
    top-p. logits: [..., V] -> probs [..., V], each row summing to 1. The
    penalty applies where the device predicate ``rp != 1 and num_valid >
    0`` holds."""
    logits = logits.float()
    dev = logits.device
    temperature, top_p, top_k, rp = sampling_scalars(
        temperature, top_p, top_k, repetition_penalty, dev)
    nv = _scalar(num_valid, torch.int32, dev)
    apply_rp = (rp != 1.0) & (nv > 0)
    logits = torch.where(apply_rp,
                         apply_repetition_penalty(logits, recent_tokens, nv, rp), logits)
    probs = torch.softmax(logits / torch.clamp(temperature, min=1e-5), dim=-1)
    probs = _top_k_filter(probs, top_k)
    probs = _top_p_filter(probs, top_p)
    return probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-20)


def sample_token(key: Key, logits: torch.Tensor, recent_tokens: torch.Tensor,
                 num_valid: Scalar, temperature: Scalar, top_p: Scalar, top_k: Scalar,
                 repetition_penalty: Scalar) -> torch.Tensor:
    """One sampling step, logits [..., V] -> int32 tokens [...] on the
    logits' device: ``where(temperature <= 0, argmax(logits), draw)``,
    the draw ``categorical(key, log(max(probs, 1e-20)))`` of `sample_probs`
    (reference ``ops/sampling.py:291-311``), one key a row. Reads nothing
    back to the host; the caller's read of the token is its one sync."""
    dev = logits.device
    knobs = sampling_scalars(temperature, top_p, top_k, repetition_penalty, dev)
    probs = sample_probs(logits, recent_tokens, num_valid, *knobs)
    sampled = sample_draw(key, torch.log(torch.clamp(probs, min=1e-20)))
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(knobs[0] <= 0.0, greedy, sampled).to(torch.int32)
