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
     reference's own draw, so a seeded run samples the reference's tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .threefry import Key, categorical

RECENT_WINDOW = 50  # reference: generated_tokens[-50:]


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


def make_recent_buffer(device="cpu") -> Tuple[torch.Tensor, int]:
    """Empty recent-token buffer: (tokens[RECENT_WINDOW] int32, num_valid)."""
    return torch.zeros(RECENT_WINDOW, dtype=torch.int32, device=device), 0


def push_recent(tokens: torch.Tensor, num_valid: int, new_token: int):
    """Append a token, shifting left once the window is full."""
    tokens = tokens.clone()
    if num_valid >= RECENT_WINDOW:
        tokens = torch.roll(tokens, -1)
        tokens[RECENT_WINDOW - 1] = new_token
    else:
        tokens[num_valid] = new_token
    return tokens, min(num_valid + 1, RECENT_WINDOW)


def apply_repetition_penalty(logits: torch.Tensor, recent_tokens: torch.Tensor,
                             num_valid: int, repetition_penalty: float) -> torch.Tensor:
    """Count-scaled, sign-aware repetition penalty over the recent window.
    logits: [V] float32; recent_tokens: [RECENT_WINDOW] int (newest last).
    Runs on the logits' device and reads nothing back to the host."""
    vocab = logits.shape[-1]
    window = recent_tokens.shape[0]
    valid = torch.arange(window, device=logits.device) < num_valid
    safe = torch.where(valid, recent_tokens.long(), torch.zeros_like(recent_tokens.long()))
    counts = torch.zeros(vocab, dtype=torch.float32, device=logits.device)
    counts.index_add_(0, safe, valid.float())
    rp = torch.tensor(repetition_penalty, dtype=torch.float32, device=logits.device)
    penalty = rp ** counts
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    logits = torch.where(counts > 0, penalized, logits)

    n = num_valid
    if n < 3:
        return logits
    # Triple-repeat guard, decided on the device: the newest token's logit
    # takes the strong penalty where the three newest tokens agree, and is
    # written back unchanged where they do not.
    t1, t2, t3 = (recent_tokens[min(n - i, window - 1)].long() for i in (1, 2, 3))
    idx = t1.reshape(1)
    cur = logits.index_select(0, idx)
    strong = rp ** 3
    hit = torch.where(cur > 0, cur / strong, cur * strong)
    return logits.index_copy(0, idx, torch.where((t1 == t2) & (t2 == t3), hit, cur))


def _top_k_filter(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    vocab = probs.shape[-1]
    if not 0 < top_k < vocab:
        return probs
    kth = torch.sort(probs, descending=True).values[top_k - 1]
    return torch.where(probs < kth, torch.zeros_like(probs), probs)


def _top_p_filter(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    if not 0.0 < top_p < 1.0:
        return probs
    order = torch.argsort(-probs, stable=True)
    sorted_probs = probs[order]
    keep = torch.cumsum(sorted_probs, dim=-1) <= top_p
    keep[0] = True
    filtered = sorted_probs * keep
    filtered = filtered / torch.clamp(filtered.sum(), min=1e-20)
    return torch.zeros_like(probs).scatter(0, order, filtered)


def sample_probs(logits: torch.Tensor, recent_tokens: torch.Tensor, num_valid: int,
                 temperature: float, top_p: float, top_k: int,
                 repetition_penalty: float) -> torch.Tensor:
    """Final categorical distribution after penalty + temperature + top-k +
    top-p. logits: [V] -> probs [V] summing to 1."""
    logits = logits.float()
    if repetition_penalty != 1.0 and num_valid > 0:
        logits = apply_repetition_penalty(logits, recent_tokens, num_valid,
                                          repetition_penalty)
    probs = torch.softmax(logits / max(temperature, 1e-5), dim=-1)
    probs = _top_k_filter(probs, top_k)
    probs = _top_p_filter(probs, top_p)
    return probs / torch.clamp(probs.sum(), min=1e-20)


def sample_token(key: Key, logits: torch.Tensor, recent_tokens: torch.Tensor,
                 num_valid: int, temperature: float, top_p: float, top_k: int,
                 repetition_penalty: float) -> int:
    """One sampling step, logits [V] -> token id. Greedy is the argmax of
    the raw logits (no draw; `key` and the window unused); otherwise the
    threefry draw ``categorical(key, log(max(probs, 1e-20)))`` from
    `sample_probs` (reference ``ops/sampling.py:309``). The read of the
    token is its one host sync."""
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    probs = sample_probs(logits, recent_tokens, num_valid, temperature, top_p,
                         top_k, repetition_penalty)
    return int(categorical(key, torch.log(torch.clamp(probs, min=1e-20))))
