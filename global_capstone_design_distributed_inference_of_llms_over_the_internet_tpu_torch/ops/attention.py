"""Cache-aware multi-head attention (MHA/GQA/MQA), plain PyTorch.

Port of the JAX package's ``ops/attention.py``, which leaves attention to
XLA by recorded decision; here it is written out as matmul, masked softmax,
matmul — not a kernel. Scores, softmax and the value product run in
float32; the output returns to the query dtype.

Deliberate difference from the reference: the KV cache is written IN PLACE
(the reference's arrays are immutable and every step returns new ones). A
layer's cache is a view into the stage's stacked ``[L, B, S, Hkv, Dh]``
buffer, so an in-place write costs the new rows only, not a copy of the
whole cache per layer per step.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    cache_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write T new tokens at positions [cache_len, cache_len+T), in place.

    k_cache/v_cache: [B, S, Hkv, Dh]; k_new/v_new: [B, T, Hkv, Dh]. Returns
    the same (updated) cache tensors."""
    t = k_new.shape[1]
    if cache_len < 0 or cache_len + t > k_cache.shape[1]:
        raise ValueError(f"cache write [{cache_len}, {cache_len + t}) outside "
                         f"cache of length {k_cache.shape[1]}")
    k_cache[:, cache_len:cache_len + t] = k_new.to(k_cache.dtype)
    v_cache[:, cache_len:cache_len + t] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     sliding_window=None, scale: float = 0.0,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal attention of T query tokens over a cache holding cache_len+T
    keys. q: [B, T, H, Dh] (query i at absolute position cache_len + i);
    k_cache/v_cache: [B, S, Hkv, Dh] with the new keys already written.
    Returns [B, T, H, Dh].

    Only the cache_len + T written rows are read: the rows past them are
    masked in the reference, and a masked softmax weight is exactly zero.
    sliding_window <= 0 (or None) disables the window; scale overrides
    head_dim ** -0.5; logit_softcap > 0 applies cap * tanh(s / cap)."""
    b, t, h, dh = q.shape
    hkv = k_cache.shape[2]
    groups = h // hkv
    s = cache_len + t
    q = q * (scale if scale else dh ** -0.5)
    qg = q.reshape(b, t, hkv, groups, dh).float()
    k = k_cache[:, :s].float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k)
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    q_pos = cache_len + torch.arange(t, device=q.device)
    k_pos = torch.arange(s, device=q.device)
    allowed = k_pos[None, :] <= q_pos[:, None]
    if sliding_window is not None:
        w = int(sliding_window)
        if w > 0:
            allowed &= k_pos[None, :] > (q_pos[:, None] - w)
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    v = v_cache[:, :s]
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, t, h, dh).to(q.dtype)
