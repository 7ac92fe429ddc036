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

``cache_len`` is a Python int or a 0-d int64 tensor on the cache's device.
With a tensor nothing here reads a value back to the host, so a step can
be captured as a CUDA graph and replayed at other lengths
(``runtime/graphs.py``): the write goes to device indices, attention reads
the whole cache bucket and the causal mask hides the rows at or past
``cache_len + T``, as the reference's jitted step does.

The slot-major engine (``runtime/batching.py``) has its own pair:
`slot_cache_write` writes each slot's rows at that slot's own length (an
``[S]`` device tensor) under an ``[S]`` active mask, and `slot_attention`
takes a per-slot mask ``[S, T, M]`` and keeps the reference's batched
operand dtypes (``runtime/batching.py:586-616``): the cache cast to the
query's dtype, scores summed in float32, probabilities cast to the cache's
dtype for the value product. The single-session functions above keep
their own (float32 throughout) and their bits.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

NEG_INF = -1e30

CacheLen = Union[int, torch.Tensor]


def check_cache_write(cache_len: int, t: int, capacity: int) -> None:
    """Raise unless rows [cache_len, cache_len + t) lie in a cache of
    `capacity` rows: the host-side range check of a write, made by whoever
    knows the host length (a device write would fail or, in a captured
    step, land out of bounds)."""
    if cache_len < 0 or cache_len + t > capacity:
        raise ValueError(f"cache write [{cache_len}, {cache_len + t}) outside "
                         f"cache of length {capacity}")


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    cache_len: CacheLen) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write T new tokens at positions [cache_len, cache_len+T), in place.

    k_cache/v_cache: [B, S, Hkv, Dh]; k_new/v_new: [B, T, Hkv, Dh]. Returns
    the same (updated) cache tensors. The rows are addressed by a device
    index, so a tensor `cache_len` is never read back; an int one is
    range-checked here, a tensor one by the caller."""
    t = k_new.shape[1]
    if not isinstance(cache_len, torch.Tensor):
        check_cache_write(cache_len, t, k_cache.shape[1])
    pos = cache_len + torch.arange(t, device=k_cache.device)
    k_cache.index_copy_(1, pos, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, pos, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: CacheLen, *,
                     sliding_window=None, scale: float = 0.0,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal attention of T query tokens over a cache holding cache_len+T
    keys. q: [B, T, H, Dh] (query i at absolute position cache_len + i);
    k_cache/v_cache: [B, S, Hkv, Dh] with the new keys already written.
    Returns [B, T, H, Dh].

    The whole cache is read, as in the reference: the causal mask hides
    the rows at or past cache_len + T, and a masked softmax weight is
    exactly zero. sliding_window (an int, or the per-layer 0-d tensor leaf
    of the alternating-window families) <= 0 or None disables the window;
    scale overrides head_dim ** -0.5; logit_softcap > 0 applies
    cap * tanh(s / cap)."""
    b, t, h, dh = q.shape
    s = k_cache.shape[1]
    hkv = k_cache.shape[2]
    groups = h // hkv
    q = q * (scale if scale else dh ** -0.5)
    qg = q.reshape(b, t, hkv, groups, dh).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.float())
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    q_pos = cache_len + torch.arange(t, device=q.device)
    k_pos = torch.arange(s, device=q.device)
    allowed = k_pos[None, :] <= q_pos[:, None]
    if isinstance(sliding_window, torch.Tensor):
        # A device value: the mask is built from it, never read back.
        allowed &= ((k_pos[None, :] > (q_pos[:, None] - sliding_window))
                    | (sliding_window <= 0))
    elif sliding_window is not None and sliding_window > 0:
        allowed &= k_pos[None, :] > (q_pos[:, None] - sliding_window)
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, t, h, dh).to(q.dtype)


def slot_cache_write(cache: torch.Tensor, new: torch.Tensor,
                     lengths: torch.Tensor, active: torch.Tensor) -> None:
    """Write T rows per slot at that slot's own length, in place: the
    reference's vmapped ``dynamic_update_slice`` (``runtime/batching.py:
    594-604``). cache: [S, M, Hkv, Dh] (one layer); new: [S, T, Hkv, Dh];
    lengths: [S] int; active: [S] bool, both on the cache's device. Each
    start is clamped to [0, M - T] as ``dynamic_update_slice`` clamps it,
    and an inactive slot writes back the rows already there, so a slot
    parked near M never loses its last rows."""
    s, t = new.shape[:2]
    dev = cache.device
    start = torch.clamp(lengths.long(), 0, cache.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=dev)
    slots = torch.arange(s, device=dev)[:, None].expand(s, t)
    old = cache[slots, rows]
    cache[slots, rows] = torch.where(active[:, None, None, None],
                                     new.to(cache.dtype), old)


def slot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   allowed: torch.Tensor, *, scale: float = 0.0,
                   logit_softcap: float = 0.0) -> torch.Tensor:
    """Attention of T queries per slot over M keys per slot. q: [S, T, H,
    Dh]; k/v: [S, M, Hkv, Dh] (a slot cache, or a prefill's fresh keys);
    allowed: [S, T, M] bool. Returns [S, T, H, Dh] in the promoted dtype
    of v's and q's, as the reference's einsum returns it. Scores sum in
    float32 over operands in q's dtype (the cache cast to it first); a
    masked score is NEG_INF, so its softmax weight is exactly zero."""
    s, t, h, dh = q.shape
    hkv = k.shape[2]
    qg = (q * (scale if scale else dh ** -0.5)).reshape(s, t, hkv, h // hkv, dh)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.to(q.dtype).float())
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    scores = torch.where(allowed[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vq = v.to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), vq.float())
    return out.to(torch.promote_types(probs.dtype, vq.dtype)).reshape(s, t, h, dh)
