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

Speculative verification (the reference's ``speculative_verify``,
``ops/sampling.py:152-217``), in two versions of one function:

  * `speculative_verify`, the plain version, line for line the
    reference's host loop: for each draft ``rng, key_u, key_r =
    split(rng, 3)``; accept the draft if ``uniform(key_u) < p_i(d_i)``
    (the window grows by each accepted draft), else draw the correction
    from the residual (p_i with d_i zeroed, renormalized; p_i itself when
    nothing is left) and stop; with every draft accepted, draw the bonus
    from p_K with ``split(rng)[1]``.
  * `speculative_verify_rows`, the device form: the key chain and every
    position's window are known before any draw (position i is reached
    only if d_1..d_i were accepted; `verify_schedule` lists them from host
    ints), so all K + 1 target rows, the K uniforms, the residual rows and
    the bonus row are computed at once and every correction and bonus is
    drawn by one `sample_draw` over the rows, each with its own key; the
    first rejected position then picks the run. It reads nothing back, so
    a graph can hold it (``runtime/graphs.py``); a greedy row (temperature
    <= 0) verifies against the unpenalized argmax instead.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from .draw_kernel import sample_draw
from .threefry import Key, categorical, prng_key, split, uniform

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


def _penalize_rows(logits: torch.Tensor, recent: torch.Tensor, num_valid: torch.Tensor,
                   rp: torch.Tensor) -> torch.Tensor:
    """`apply_repetition_penalty` row by row: logits [R, V], each row under
    its own window ``recent[r]`` of ``num_valid[r]`` tokens and its own
    penalty ``rp[r]`` ([R, 1]); the same elementwise arithmetic, so a row
    equals the one-row call."""
    dev = logits.device
    window = recent.shape[1]
    nv = num_valid.long()[:, None]
    valid = torch.arange(window, device=dev)[None, :] < nv
    safe = torch.where(valid, recent.long(), 0)
    counts = torch.zeros_like(logits).scatter_add_(1, safe, valid.float())
    penalty = rp ** counts
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    logits = torch.where(counts > 0, penalized, logits)
    newest = torch.clamp(nv - torch.arange(1, 4, device=dev)[None, :], 0, window - 1)
    t = recent.gather(1, newest).long()
    is_triple = (nv >= 3) & (t[:, :1] == t[:, 1:2]) & (t[:, 1:2] == t[:, 2:3])
    idx = t[:, :1]
    cur = logits.gather(1, idx)
    strong = rp ** 3
    hit = torch.where(cur > 0, cur / strong, cur * strong)
    return logits.scatter(1, idx, torch.where(is_triple, hit, cur))


def sample_probs_rows(logits: torch.Tensor, recent: torch.Tensor, num_valid: torch.Tensor,
                      temperature: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor,
                      repetition_penalty: torch.Tensor) -> torch.Tensor:
    """`sample_probs` of logits [R, V], row r under its own window
    ``recent[r]`` (int [R, W]) of ``num_valid[r]`` tokens and its own knobs
    (each a tensor [R]): the one-row call's arithmetic, row by row."""
    logits = logits.float()
    vocab = logits.shape[-1]
    temperature, top_p, rp = (x.float()[:, None] for x in
                              (temperature, top_p, repetition_penalty))
    top_k = top_k.long()[:, None]
    apply_rp = (rp != 1.0) & (num_valid[:, None] > 0)
    logits = torch.where(apply_rp, _penalize_rows(logits, recent, num_valid, rp), logits)
    probs = torch.softmax(logits / torch.clamp(temperature, min=1e-5), dim=-1)
    sorted_desc = torch.sort(probs, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, torch.clamp(top_k - 1, 0, vocab - 1))
    probs = torch.where((top_k > 0) & (top_k < vocab) & (probs < kth), 0.0, probs)
    probs = _top_p_filter(probs, top_p)
    return probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-20)


def speculative_verify(rng: Key, logits: torch.Tensor, drafts, recent_tokens: torch.Tensor,
                       num_valid: int, temperature: float, top_p: float, top_k: int,
                       repetition_penalty: float):
    """Rejection-sampling verification of K drafted tokens under sampling,
    the plain version (the reference's host loop). logits: [K + 1, V]
    float32, row i computed after consuming [last accepted, d_1..d_i];
    drafts: K ints. Returns (tokens, n_accepted), ``len(tokens) ==
    n_accepted + 1``: the accepted run, then one correction or bonus.

    A deterministic draft is a point mass, so the accept rule min(1, p/q)
    becomes: accept d_i with probability p_i(d_i); on a reject draw the
    correction from the residual (p_i - q)+, p_i with d_i zeroed. Position
    i's target is taken against the window with the accepted prefix in it,
    what a plain decode would have used."""
    k = len(drafts)
    tokens = []
    dev = logits.device
    rt = recent_tokens.to(device=dev, dtype=torch.int32)
    nv = _scalar(num_valid, torch.int32, dev)
    knobs = sampling_scalars(temperature, top_p, top_k, repetition_penalty, dev)
    for i in range(k):
        rng, key_u, key_r = split(rng, 3)
        probs = sample_probs(logits[i], rt, nv, *knobs)
        d = int(drafts[i])
        if float(uniform(key_u, (), device=dev)) < float(probs[d]):
            tokens.append(d)
            rt, nv = push_recent(rt, nv, d)
            continue
        # Reject: the correction from the residual. p(d) == 1 leaves it
        # empty: fall back to p itself (measure-zero for real logits).
        residual = probs.clone()
        residual[d] = 0.0
        z = residual.sum()
        residual = torch.where(z > 0, residual / torch.clamp(z, min=1e-20), probs)
        tokens.append(int(categorical(key_r, torch.log(torch.clamp(residual, min=1e-20)))))
        return tokens, i
    # Every draft accepted: the bonus token from the last position's target.
    rng, key_b = split(rng, 2)
    probs = sample_probs(logits[k], rt, nv, *knobs)
    tokens.append(int(categorical(key_b, torch.log(torch.clamp(probs, min=1e-20)))))
    return tokens, k


def verify_schedule(window: Sequence[int], drafts: Sequence[int], step_seed: int):
    """What the host loop of `speculative_verify` needs at each position,
    known before any draw, from host ints: position i's window (the last
    RECENT_WINDOW tokens of `window` with d_1..d_i pushed), its uniform's
    key (i < K) and its draw's key (the correction's, and at i = K the
    bonus's), the chain of ``PRNGKey(step_seed)``. Returns (windows,
    key_u, key_r)."""
    base = [int(t) for t in window][-RECENT_WINDOW:]
    windows = [(base + [int(d) for d in drafts[:i]])[-RECENT_WINDOW:]
               for i in range(len(drafts) + 1)]
    rng = prng_key(step_seed)
    key_u, key_r = [], []
    for _ in drafts:
        rng, ku, kr = split(rng, 3)
        key_u.append(ku)
        key_r.append(kr)
    key_r.append(split(rng, 2)[1])
    return windows, key_u, key_r


def speculative_verify_rows(logits: torch.Tensor, drafts: torch.Tensor, windows: torch.Tensor,
                            counts: torch.Tensor, key_u: torch.Tensor, key_r: torch.Tensor,
                            temperature: torch.Tensor, top_p: torch.Tensor,
                            top_k: torch.Tensor, repetition_penalty: torch.Tensor
                            ) -> torch.Tensor:
    """The device form of `speculative_verify` for B requests at once, over
    `verify_schedule`'s windows and keys. logits [B, T, V] (T = K + 1),
    drafts int [B, K], windows int [B, T, W] of counts [B, T] tokens,
    key_u int64 [B, K, 2], key_r int64 [B, T, 2], knobs [B]. Every
    position's target (all B x T rows at once), the K uniforms, the
    residuals and the bonus rows, then one `sample_draw` over the B x T
    rows, each with its own key; the first rejected position picks the
    run. Returns int64 [B, T + 1]: the T tokens, entries past n_accepted +
    1 set to 0, then n_accepted. A request with temperature <= 0 accepts
    d_i while it equals the argmax of the raw logits of position i, and
    ends on that argmax. Device work only."""
    b_count, t, vocab = logits.shape
    k = t - 1
    dev = logits.device
    logits = logits.float()
    drafts = drafts.long()
    knobs = [x.repeat_interleave(t) for x in (temperature, top_p, top_k, repetition_penalty)]
    probs = sample_probs_rows(logits.reshape(b_count * t, vocab),
                              windows.reshape(b_count * t, -1), counts.reshape(-1),
                              *knobs).reshape(b_count, t, vocab)
    argmax = torch.argmax(logits, dim=-1)
    greedy = (temperature <= 0.0)[:, None]
    if k:
        d = drafts[..., None]
        u = uniform(key_u.reshape(b_count * k, 2), (), device=dev).reshape(b_count, k)
        accept = torch.where(greedy, drafts == argmax[:, :k],
                             u < probs[:, :k].gather(2, d)[..., 0])
        residual = probs[:, :k].scatter(2, d, 0.0)
        z = residual.sum(-1, keepdim=True)
        residual = torch.where(z > 0, residual / torch.clamp(z, min=1e-20), probs[:, :k])
        probs = torch.cat([residual, probs[:, k:]], dim=1)
    else:
        accept = torch.zeros((b_count, 0), dtype=torch.bool, device=dev)
    logp = torch.log(torch.clamp(probs, min=1e-20)).reshape(b_count * t, vocab)
    drawn = sample_draw(key_r.reshape(b_count * t, 2), logp).long().reshape(b_count, t)
    n_acc = torch.cumprod(accept.long(), dim=1).sum(1)
    last = torch.where(greedy, argmax, drawn)
    pos = torch.arange(t, device=dev)[None, :]
    run = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    tokens = torch.where(pos < n_acc[:, None], run,
                         torch.where(pos == n_acc[:, None], last, 0))
    return torch.cat([tokens, n_acc[:, None]], dim=1)
