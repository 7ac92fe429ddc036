"""Sparse MoE dispatch: capacity-bounded expert products (GShard-style).

Port of the JAX package's ``models/moe.py``. The dense formulation
(``models.transformer._moe_mlp_dense``) runs every expert on every token
and zero-weights the ones not selected; this is the sparse path, on by
default (``MOE_SPARSE=0`` is the dense kill switch):

  router top-k  ->  flatten the (token, choice) slots  ->  each slot's
  position among the earlier slots of its expert  ->  capacity-bounded
  write into a static ``[E, C, D]`` dispatch buffer  ->  expert products
  ->  each token's K slots gathered back and summed in slot order.

Every shape follows from N = B x T alone (capacity ``C`` is a Python int),
and nothing reads a device value to the host, so the dispatch runs inside
a captured step (``runtime/graphs.py``). The executed MLP work is ``E * C``
token-slots instead of ``N * E``.

Capacity: ``C = min(N, ceil(N * top_k / E * MOE_CAPACITY_FACTOR))``, factor
2.0 by default; ``MOE_CAPACITY_FACTOR <= 0`` is drop-free (``C = N``: a
token gives an expert at most one slot). Slots past an expert's capacity
are dropped and contribute zero, as in the reference.

Where the reference's order is not the framework's default, the port
fixes it:

  * the top-k is a stable descending sort, so equal logits (an all-zero
    row, an empty batched slot) choose the lower expert first, as
    ``lax.top_k`` does;
  * a slot's position in its expert is the count of earlier slots routed
    there (a cumulative sum of a one-hot), which is its rank in the
    reference's stable ``argsort`` by expert;
  * the dispatch writes each kept slot to its own cell and each dropped
    slot to a spare row of its own past the buffer, so no row is written
    twice and nothing accumulates;
  * the combine gathers each token's K slots and adds them in slot order,
    with no atomics, so a replay gives the eager step's bits.

Expert products (`_expert_dot`): int8 stacks stay packed and run one
``int8_dot`` a expert (the scale-folded contract of the reference's
grouped einsum, ``INT8_FOLD=0`` dequantizes the stack); NF4 stacks run one
``nf4_dot`` a expert under ``NF4_KERNEL=1``, else dequantize one expert at
a time as the reference does; plain stacks take ``torch.bmm``.

Expert-load telemetry (``moe_*`` families) is recorded on the host when
the registry is enabled and the dispatch ran on host tensors. On a card
the families stay dark: a record would read the counts back, a sync the
served path never makes, and a captured step cannot call the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.int8_kernel import int8_dot
from ..ops.nf4_kernel import nf4_dot
from ..utils.flags import bool_flag, float_flag
from .config import ModelConfig
from .quant import NF4Tensor, QuantizedTensor, int8_fold_enabled, nf4_kernel_enabled

Params = Dict[str, Any]


def moe_sparse_enabled() -> bool:
    """MOE_SPARSE=1 (the default) routes MoE layers through the sparse
    dispatch; 0 restores the dense all-expert products. Read when a step
    runs (a captured step keeps the path it was captured with)."""
    return bool_flag("MOE_SPARSE")


def moe_capacity_factor() -> float:
    """Per-expert slot budget over the perfectly balanced load
    (``MOE_CAPACITY_FACTOR``, default 2.0; <= 0 is drop-free)."""
    return float_flag("MOE_CAPACITY_FACTOR")


def moe_capacity(n_tokens: int, num_experts: int, top_k: int) -> int:
    """Static per-expert capacity C for a dispatch of `n_tokens` tokens:
    the balanced load ``n_tokens * top_k / num_experts`` times the factor,
    clamped to [1, n_tokens]."""
    full = max(1, n_tokens)
    cf = moe_capacity_factor()
    if cf <= 0:
        return full
    c = math.ceil(n_tokens * top_k / num_experts * cf)
    return max(1, min(full, c))


def top_k_stable(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, equal values
    lower index first (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """float32 logits -> top-k -> softmax over the chosen logits.

    xf: [N, D]. Returns (e_flat, w_flat), each [N*K]: the expert id and the
    float32 combine weight of every slot, token-major."""
    logits = xf.float() @ router.float()                   # [N, E]
    topv, topi = top_k_stable(logits, top_k)
    weights = torch.softmax(topv, dim=-1)
    return topi.reshape(-1), weights.reshape(-1)


def _positions(e_flat: torch.Tensor, num_experts: int):
    """(seg_pos, counts): each slot's rank among the slots routed to its
    expert, in slot order (the reference's stable sort by expert), and the
    slots routed to each expert [E]. No sort and no host value."""
    experts = torch.arange(num_experts, device=e_flat.device)
    onehot = (e_flat[:, None] == experts[None, :]).to(torch.int32)   # [NK, E]
    before = torch.cumsum(onehot, dim=0) - onehot                    # earlier slots
    seg_pos = before.gather(1, e_flat[:, None]).squeeze(1)
    return seg_pos, onehot.sum(dim=0)


def promoted(x: torch.Tensor, w: torch.Tensor):
    """x and w in their promoted dtype (a float32 activation after a TCP hop
    against bf16 experts computes in float32, as ``jnp.einsum`` promotes)."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _expert_dot(x: torch.Tensor, w) -> torch.Tensor:
    """Grouped product over the leading expert axis: [E, C, a] @ [E, a, b].

    int8 (`QuantizedTensor` [E, a, b]): one ``int8_dot`` a expert on the
    2-D view (q[e], s[e]): float32 sums, the scale on them, cast to x's
    dtype, the reference's scale-folded grouped einsum; ``INT8_FOLD=0``
    dequantizes the stack to x's dtype first, as the reference does. NF4:
    one ``nf4_dot`` a expert under ``NF4_KERNEL=1``; otherwise one expert
    dequantized at a time, rounded to x's dtype, as the reference's
    ``lax.map``. Plain stacks: ``torch.bmm`` in the promoted dtype."""
    if isinstance(w, QuantizedTensor):
        if int8_fold_enabled():
            return torch.stack([int8_dot(x[e], QuantizedTensor(w.q[e], w.s[e], w.dtype))
                                for e in range(x.shape[0])])
        return torch.bmm(x, w.dequant().to(x.dtype))
    if isinstance(w, NF4Tensor):
        if nf4_kernel_enabled():
            return torch.stack([nf4_dot(x[e], NF4Tensor(w.packed[e], w.scales[e], w.in_dim,
                                                        w.dtype))
                                for e in range(x.shape[0])])
        return torch.stack([x[e] @ NF4Tensor(w.packed[e], w.scales[e], w.in_dim,
                                             w.dtype).dequant().to(x.dtype)
                            for e in range(x.shape[0])])
    return torch.bmm(*promoted(x, w))


def sparse_moe_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Capacity-bounded sparse dispatch of a top-k routed SwiGLU MoE layer.

    x: [B, T, D]; p holds ``router`` [D, E] and the expert stacks ``wg`` /
    ``wu`` [E, D, I], ``wd`` [E, I, D]. Equal to the dense formulation
    wherever no slot is dropped (the sums run in another order, so equal
    within float rounding)."""
    e_total = cfg.num_experts
    top_k = cfg.num_experts_per_tok
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)

    e_flat, w_flat = _route(p["router"], xf, top_k)
    seg_pos, counts = _positions(e_flat, e_total)
    cap = moe_capacity(n, e_total, top_k)
    keep = seg_pos < cap

    # Dispatch: each kept slot to its own cell of the [E * C] rows, each
    # dropped slot to a spare row of its own past them, which nothing
    # reads: no row is written twice.
    cells = e_total * cap
    slot = torch.arange(n * top_k, device=x.device)
    cell = torch.where(keep, e_flat * cap + seg_pos, cells + slot)
    buf = torch.zeros((cells + n * top_k, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, cell, xf[slot // top_k])
    buf = buf[:cells].view(e_total, cap, d)

    gate = F.silu(_expert_dot(buf, p["wg"]))
    up = _expert_dot(buf, p["wu"])
    y = _expert_dot(gate * up, p["wd"])                    # [E, C, D]

    # Combine: each slot's expert row times its weight (0 where dropped),
    # a token's K slots added in slot order.
    comb_w = torch.where(keep, w_flat, torch.zeros_like(w_flat)).to(x.dtype)
    ys = (y.reshape(cells, -1)[cell.clamp(max=cells - 1)] * comb_w[:, None]).to(x.dtype)
    ys = ys.view(n, top_k, -1)
    out = ys[:, 0]
    for j in range(1, top_k):
        out = out + ys[:, j]

    if counts.device.type == "cpu" and _registry_enabled():
        _record_load(counts, keep.sum())
    return out.reshape(b, t, -1)


def dispatch_stats(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, int, int]:
    """The routing of a batch as the sparse path computes it, for tests,
    checks and capacity tuning: (counts [E], kept slots, capacity). Reads
    the kept count to the host."""
    b, t, _ = x.shape
    n = b * t
    e_flat, _ = _route(router, x.reshape(n, -1), cfg.num_experts_per_tok)
    seg_pos, counts = _positions(e_flat, cfg.num_experts)
    cap = moe_capacity(n, cfg.num_experts, cfg.num_experts_per_tok)
    return counts, int((seg_pos < cap).sum()), cap


def sparse_mlp_flops(n_tokens: int, cfg: ModelConfig) -> int:
    """MLP FLOPs one MoE layer executes a forward on the sparse path: three
    grouped [E, C, D] x [E, D, I] products."""
    cap = moe_capacity(n_tokens, cfg.num_experts, cfg.num_experts_per_tok)
    d, i = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_experts * cap * 3 * d * i * 2


def dense_mlp_flops(n_tokens: int, cfg: ModelConfig) -> int:
    """MLP FLOPs of the dense formulation: every expert on every token."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_experts * n_tokens * 3 * d * i * 2


# -- expert-load telemetry (host side) ---------------------------------------


def _registry_enabled() -> bool:
    from ..telemetry.metrics import get_registry

    return get_registry().enabled


def _record_load(counts, kept) -> None:
    """Fold one dispatch's routing histogram into the registry (the
    reference's ``_record_load``). counts: [E] slots routed per expert;
    kept: slots within capacity. Host tensors only."""
    import numpy as np

    from ..telemetry import catalog
    from ..telemetry.metrics import get_registry

    reg = get_registry()
    if not reg.enabled:
        return
    c = np.asarray(counts, dtype=np.float64)
    total = float(c.sum())
    if total <= 0:
        return
    e = c.shape[0]
    hist = catalog.get("moe_expert_load", reg)
    for share in c * (e / total):
        hist.observe(float(share))
    catalog.get("moe_tokens_total", reg).inc(total)
    catalog.get("moe_dropped_total", reg).inc(max(0.0, total - float(kept)))
    catalog.get("moe_max_expert_share", reg).set(float(c.max()) / total)
