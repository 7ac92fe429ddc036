"""Unified decoder-only transformer, stacked-layer layout, plain PyTorch.

Port of the forward half of the JAX package's ``models/transformer.py``,
keeping its layout so the two packages compare like with like:

  * weights are stored [in, out];
  * per-layer parameters are STACKED along a leading layer axis ``[L, ...]``
    in nested dicts of tensors (int8 weights as ``QuantizedTensor``, NF4
    weights as ``NF4Tensor``);
  * ``lax.scan`` over layers becomes a Python loop that slices each layer's
    leaves (views, no copies);
  * KV caches are preallocated ``[L, B, S, Hkv, Dh]`` tensors written in
    place (see ``ops.attention``);
  * ``cache_len`` is a Python int or a 0-d int64 tensor on the device, and
    positions are ``cache_len + arange(T)`` on the device: with a tensor
    the forward reads nothing back to the host, so it can be captured as a
    CUDA graph (``runtime/graphs.py``), the counterpart of the
    reference's jitted step.

Every projection goes through `_dot`, which sends packed int8 leaves to
``ops.int8_kernel.int8_dot`` and packed NF4 leaves to
``ops.nf4_kernel.nf4_dot``. With ``cfg.decode_kv_page`` set, a decode
step's attention reads the occupied pages of the cache only
(``ops.paged_attention_kernel``), under the reference's condition.
Inference-time deep prompts (``prompts=`` of `stack_forward` and
`full_forward`) are added at each layer's entry, at absolute positions, on
the device.

The training forward (`stack_forward_train`, the reference's
``models/transformer.py:598-650``) runs a span cache-free: each layer's
causal attention over the sequence itself (`layer_forward` with no cache),
deep prompts added to the first ``min(pre_seq, T)`` rows of each layer's
input, LoRA adapters merged for a layer inside that layer's body (one
layer's merged weights at a time, the rounding of `models.lora`), and with
``remat`` each layer checkpointed (``torch.utils.checkpoint``), its
activations recomputed in the backward.

Mixtral-style MoE layers (``router`` [D, E] and expert stacks ``wg`` /
``wu`` [E, D, I], ``wd`` [E, I, D]) run the sparse dispatch of
``models/moe.py`` by default, or the dense all-expert products under
``MOE_SPARSE=0``; their quantized expert stacks stay packed through the
layer (`dequant_tree` with ``keep_experts``). The training forward refuses
MoE spans (ROADMAP Queue 1 #4a-ii).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import CacheLen, cached_attention, causal_attention, update_kv_cache
from ..ops.int8_kernel import int8_dot
from ..ops.nf4_kernel import nf4_dot
from ..ops.paged_attention_kernel import paged_decode_attention
from ..ops.norms import layer_norm, rms_norm
from ..ops.rotary import apply_rope, rope_cos_sin
from .config import ModelConfig
from .lora import merge_lora_layer
from .quant import NF4Tensor, QuantizedTensor, dequant_tree, tree_map

Params = Dict[str, Any]


def _check_trainable(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            "training an MoE span is not ported (ROADMAP Queue 1 #4a-ii: MoE in "
            "training and on host-offloaded spans)")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _layer_schema(cfg: ModelConfig) -> Params:
    """One layer's leaves as (shape, init) with init "dense", "ones" or
    "zeros" — the key structure of the reference's `init_layer_params`."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Params = {"attn": {"wq": ((d, h * dh), "dense"),
                          "wk": ((d, hkv * dh), "dense"),
                          "wv": ((d, hkv * dh), "dense"),
                          "wo": ((h * dh, d), "dense")}}
    if cfg.norm == "layernorm":
        for ln in ("ln1", "ln2"):
            p[ln] = {"w": ((d,), "ones"), "b": ((d,), "zeros")}
    else:
        one = "zeros" if cfg.norm_offset else "ones"
        for ln in ("ln1", "ln2") + (("ln3", "ln4") if cfg.post_norms else ()):
            p[ln] = {"w": ((d,), one)}
    if cfg.use_bias or cfg.attn_qkv_bias:
        p["attn"]["bq"] = ((h * dh,), "zeros")
        p["attn"]["bk"] = ((hkv * dh,), "zeros")
        p["attn"]["bv"] = ((hkv * dh,), "zeros")
    if cfg.use_bias:
        p["attn"]["bo"] = ((d,), "zeros")
    if cfg.is_moe:
        e = cfg.num_experts
        p["mlp"] = {"router": ((d, e), "dense"), "wg": ((e, d, i), "dense"),
                    "wu": ((e, d, i), "dense"), "wd": ((e, i, d), "dense")}
    elif cfg.mlp == "swiglu":
        p["mlp"] = {"wg": ((d, i), "dense"), "wu": ((d, i), "dense"),
                    "wd": ((i, d), "dense")}
    else:
        p["mlp"] = {"wi": ((d, i), "dense"), "wo": ((i, d), "dense")}
        if cfg.use_bias:
            p["mlp"]["bi"] = ((i,), "zeros")
            p["mlp"]["bo"] = ((d,), "zeros")
    return p


def _dense(gen: torch.Generator, shape, dtype, device, scale: float = 0.02):
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device)).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cpu", layer_range: Optional[Tuple[int, int]] = None,
                stream: Optional[Tuple[int, Callable[[int, Params], None]]] = None
                ) -> Params:
    """Random init of the FULL model with stacked layers, N(0, 0.02) dense
    weights, drawn from `generator` (which must live on `device`).

    Built layer by layer on the device: each stacked leaf is allocated once
    in `dtype` and filled one layer at a time, so the float32 working copy
    never exceeds one layer's leaf. The draws differ from the reference's
    (torch's generator is not threefry); tests bridge JAX weights instead.

    ``layer_range=(a, b)`` keeps layers a..b-1 only (stacked from index 0):
    every layer is still drawn, in order, so the kept ones hold the values
    of the full init, and a process serving one span never holds the rest.

    ``stream=(k, sink)`` stacks the first k kept layers only: each later
    kept layer j is drawn into one one-layer tree (leaves ``[1, ...]``,
    reused) and handed to ``sink(j, tree)``, which must be done with it
    when it returns (a host-offloaded span, ``runtime/offload.py``)."""
    schema = _layer_schema(cfg)
    lo, hi = (0, cfg.num_layers) if layer_range is None else layer_range
    n = hi - lo if stream is None else min(stream[0], hi - lo)

    def alloc(node, rows):
        if isinstance(node, dict):
            return {k: alloc(v, rows) for k, v in node.items()}
        shape, init = node
        if init == "ones":
            return torch.ones((rows, *shape), dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros((rows, *shape), dtype=dtype, device=device)
        return torch.empty((rows, *shape), dtype=dtype, device=device)

    layers = alloc(schema, n)
    scratch = None

    def fill(node, out, li):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v, out[k], li)
            elif v[1] == "dense":
                out[k][li] = _dense(generator, v[0], dtype, device)

    def draw(node):
        for v in node.values():
            if isinstance(v, dict):
                draw(v)
            elif v[1] == "dense":
                _dense(generator, v[0], dtype, device)

    def window(first, last):
        return torch.tensor([cfg.altern_window if i % 2 == 0 else 0
                             for i in range(first, last)], dtype=torch.int32, device=device)

    for li in range(cfg.num_layers):
        if lo <= li < lo + n:
            fill(schema, layers, li - lo)
        elif lo <= li < hi:
            if scratch is None:
                scratch = alloc(schema, 1)
            fill(schema, scratch, 0)
            if cfg.altern_window:
                scratch["window"] = window(li, li + 1)
            stream[1](li - lo, scratch)
        else:
            draw(schema)   # advance the generator past a layer not kept
    if cfg.altern_window:
        layers["window"] = window(lo, lo + n)

    d = cfg.hidden_size
    embed: Params = {"wte": _dense(generator, (cfg.vocab_size, d), dtype, device)}
    if cfg.positional == "learned":
        embed["wpe"] = _dense(generator, (cfg.max_position_embeddings, d),
                              dtype, device)
    if cfg.norm == "layernorm":
        final_norm = {"w": torch.ones(d, dtype=dtype, device=device),
                      "b": torch.zeros(d, dtype=dtype, device=device)}
    elif cfg.norm_offset:
        final_norm = {"w": torch.zeros(d, dtype=dtype, device=device)}
    else:
        final_norm = {"w": torch.ones(d, dtype=dtype, device=device)}
    params: Params = {"embed": embed, "layers": layers, "final_norm": final_norm}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": _dense(generator, (d, cfg.vocab_size), dtype, device)}
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, embed: Params, input_ids: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """input_ids: [B, T] int; positions: [B, T] int -> hidden [B, T, D]."""
    h = embed["wte"][input_ids]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype)
    if cfg.positional == "learned":
        pos = positions.clamp(0, cfg.max_position_embeddings - 1)
        h = h + embed["wpe"][pos]
    return h


def _dot(x: torch.Tensor, w) -> torch.Tensor:
    """Weight matmul with quantized dispatch: a packed NF4Tensor leaf (left
    intact by dequant_tree under NF4_KERNEL=1) runs the fused NF4 kernel; a
    packed QuantizedTensor leaf (left intact under INT8_FOLD, the default)
    runs the scale-folded int8 kernel; plain tensors take the ordinary
    matmul, in the promoted dtype where x and w differ (float32 x against
    bf16 weights after a TCP hop, as ``jnp.matmul`` promotes)."""
    if isinstance(w, NF4Tensor):
        return nf4_dot(x, w)
    if isinstance(w, QuantizedTensor):
        return int8_dot(x, w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x: [B, T, D] -> q [B, T, H, Dh], k/v [B, T, Hkv, Dh], from either the
    canonical wq/wk/wv leaves or the engine-fused ``wqkv`` leaf."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    if "wqkv" in p:
        qkv = _dot(x, p["wqkv"])
        w = qkv.shape[-1]
        hd = w * cfg.num_heads // (cfg.num_heads + 2 * cfg.num_kv_heads)
        kd = (w - hd) // 2
        q, k, v = qkv[..., :hd], qkv[..., hd:hd + kd], qkv[..., hd + kd:]
    else:
        q, k, v = _dot(x, p["wq"]), _dot(x, p["wk"]), _dot(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, t, -1, dh), k.reshape(b, t, -1, dh),
            v.reshape(b, t, -1, dh))


def _concat_out_axis(leaves):
    """Concatenate projection weights along the OUTPUT axis — exact for
    plain tensors, for QuantizedTensors (q and the per-output-channel s
    concat together) and for NF4Tensors (packed codes and per-block scales:
    the absmax blocks lie on the input axis, untouched by an N concat).
    None for mixed or mismatched leaves: the fusions then no-op."""
    if all(isinstance(w, torch.Tensor) for w in leaves):
        return torch.cat(leaves, dim=-1)
    if all(isinstance(w, QuantizedTensor) for w in leaves):
        if len({w.dtype for w in leaves}) != 1:
            return None
        return QuantizedTensor(torch.cat([w.q for w in leaves], dim=-1),
                               torch.cat([w.s for w in leaves], dim=-1),
                               leaves[0].dtype)
    if all(isinstance(w, NF4Tensor) for w in leaves):
        if len({w.dtype for w in leaves}) != 1 or len({w.in_dim for w in leaves}) != 1:
            return None
        return NF4Tensor(torch.cat([w.packed for w in leaves], dim=-1),
                         torch.cat([w.scales for w in leaves], dim=-1),
                         leaves[0].in_dim, leaves[0].dtype)
    return None


def fuse_qkv_layers(layers: Params) -> Params:
    """`layers` with wq|wk|wv concatenated into one ``wqkv`` leaf — an
    engine-side layout (one projection launch per layer instead of three).
    No-op when already fused, mixed, or without attention weights."""
    if not isinstance(layers, dict) or "attn" not in layers:
        return layers
    attn = layers["attn"]
    if "wq" not in attn:
        return layers
    wqkv = _concat_out_axis([attn["wq"], attn["wk"], attn["wv"]])
    if wqkv is None:
        return layers
    fused = {k: v for k, v in attn.items() if k not in ("wq", "wk", "wv")}
    fused["wqkv"] = wqkv
    return {**layers, "attn": fused}


def fuse_gate_up_layers(layers: Params) -> Params:
    """`layers` with the swiglu wg|wu concatenated into one ``wgu`` leaf."""
    if not isinstance(layers, dict) or "mlp" not in layers:
        return layers
    mlp = layers["mlp"]
    if "wg" not in mlp or "wu" not in mlp or "router" in mlp:
        return layers
    wgu = _concat_out_axis([mlp["wg"], mlp["wu"]])
    if wgu is None:
        return layers
    fused = {k: v for k, v in mlp.items() if k not in ("wg", "wu")}
    fused["wgu"] = wgu
    return {**layers, "mlp": fused}


def fuse_qkv_params(params: Params) -> Params:
    """Both fusions over a whole param tree. The fused leaves are copies:
    drop the canonical tree after construction when residency matters."""
    if not isinstance(params, dict) or "layers" not in params:
        return params
    fused = fuse_gate_up_layers(fuse_qkv_layers(params["layers"]))
    if fused is params["layers"]:
        return params
    return dict(params, layers=fused)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.is_moe:
        return _moe_mlp(cfg, p, x)
    if cfg.mlp == "swiglu":
        act = _gelu_tanh if cfg.activation == "gelu_tanh" else F.silu
        if "wgu" in p:
            gu = _dot(x, p["wgu"])
            i = gu.shape[-1] // 2
            gate, up = act(gu[..., :i]), gu[..., i:]
        else:
            gate, up = act(_dot(x, p["wg"])), _dot(x, p["wu"])
        return _dot(gate * up, p["wd"])
    y = _dot(x, p["wi"])
    if "bi" in p:
        y = y + p["bi"]
    y = _dot(_gelu_tanh(y), p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    return y


def _moe_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Mixtral-style top-k routed SwiGLU experts: the sparse dispatch
    (``models.moe.sparse_moe_mlp``), or under ``MOE_SPARSE=0`` the dense
    formulation below. The switch is read when the step runs."""
    from .moe import moe_sparse_enabled, sparse_moe_mlp

    if moe_sparse_enabled():
        return sparse_moe_mlp(cfg, p, x)
    return _moe_mlp_dense(cfg, p, x)


def _moe_mlp_dense(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Dense MoE formulation (the reference's ``_moe_mlp_dense``): every
    expert runs on every token and the router's weights, softmax over the
    top k and zero elsewhere, combine them. Work scales with the number of
    experts: the kill switch behind ``MOE_SPARSE=0``."""
    from .moe import promoted, top_k_stable

    logits = x.float() @ p["router"].float()                       # [B, T, E]
    topv, topi = top_k_stable(logits, cfg.num_experts_per_tok)
    dense_w = torch.zeros_like(logits).scatter(-1, topi, torch.softmax(topv, dim=-1))

    def einsum(eq, a, w):
        return torch.einsum(eq, *promoted(a, w))

    gate = F.silu(einsum("btd,edi->btei", x, p["wg"]))
    up = einsum("btd,edi->btei", x, p["wu"])
    per_expert = einsum("btei,eid->bted", gate * up, p["wd"])
    return einsum("bted,bte->btd", per_expert, dense_w.to(x.dtype))


def make_rope(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin tables for a batch of positions (once per forward), or None
    for learned-position models."""
    if cfg.positional != "rope":
        return None
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)


def _attention(cfg: ModelConfig, p: Params, x: torch.Tensor, rope,
               k_cache: Optional[torch.Tensor], v_cache: Optional[torch.Tensor],
               cache_len: CacheLen, window=None) -> torch.Tensor:
    """k_cache None selects the training path: causal attention of the
    fresh keys over themselves, nothing written."""
    b, t, _ = x.shape
    q, k, v = qkv_proj(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if k_cache is None:
        out = causal_attention(q, k, v, sliding_window=window, scale=cfg.query_scale,
                               logit_softcap=cfg.attn_softcap)
    elif (cfg.decode_kv_page and t == 1 and window is None
            and not cfg.attn_softcap and not cfg.query_scale
            and k_cache.shape[1] % cfg.decode_kv_page == 0):
        # The reference's condition (models/transformer.py:436-440): the
        # decode step reads only the pages that hold real rows.
        update_kv_cache(k_cache, v_cache, k, v, cache_len)
        out = paged_decode_attention(q, k_cache, v_cache, cache_len,
                                     cfg.decode_kv_page)
    else:
        update_kv_cache(k_cache, v_cache, k, v, cache_len)
        out = cached_attention(q, k_cache, v_cache, cache_len,
                               sliding_window=window, scale=cfg.query_scale,
                               logit_softcap=cfg.attn_softcap)
    y = _dot(out.reshape(b, t, -1), p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    return y


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    if cfg.norm_offset:
        return rms_norm(x, 1.0 + p["w"].float(), cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def layer_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, rope,
                  k_cache: Optional[torch.Tensor], v_cache: Optional[torch.Tensor],
                  cache_len: CacheLen) -> torch.Tensor:
    """Pre-norm residual block. x: [B, T, D] -> [B, T, D]; writes this
    layer's new keys/values into k_cache/v_cache ([B, S, Hkv, Dh]) in place,
    or, with no cache, attends over x's own positions (the training path)."""
    p = dequant_tree(p, keep_experts=cfg.is_moe)
    window = p.get("window", cfg.sliding_window)
    attn_out = _attention(cfg, p["attn"], _norm(cfg, p["ln1"], x), rope,
                          k_cache, v_cache, cache_len, window=window)
    if cfg.post_norms:
        attn_out = _norm(cfg, p["ln3"], attn_out)
    x = x + attn_out
    mlp_out = _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
    if cfg.post_norms:
        mlp_out = _norm(cfg, p["ln4"], mlp_out)
    return x + mlp_out


def _apply_deep_prompt(h: torch.Tensor, pr: torch.Tensor,
                       cache_len: CacheLen) -> torch.Tensor:
    """Add a learned per-layer deep prompt to ABSOLUTE positions < pre_seq.

    h: [B, T, D] hidden states at absolute positions cache_len ..
    cache_len+T; pr: [pre_seq, D]. Petals adds prompts to the first pre_seq
    positions of each block's input; indexing by absolute position extends
    that to a chunked prefill and makes a step past the region an exact
    no-op. Everything stays on the device (`cache_len` may be a 0-d device
    tensor), so the step can be captured. The rows are cast to h's dtype
    before the add, as the reference does."""
    t = h.shape[1]
    pre = pr.shape[0]
    idx = cache_len + torch.arange(t, device=h.device)          # [T] absolute
    rows = pr[idx.clamp(0, pre - 1)]                            # [T, D]
    add = torch.where((idx < pre)[:, None], rows,
                      torch.zeros((), dtype=rows.dtype, device=rows.device))
    return h + add.to(h.dtype)[None]


def stack_forward(cfg: ModelConfig, layers: Params, x: torch.Tensor,
                  positions: torch.Tensor, k_caches: torch.Tensor,
                  v_caches: torch.Tensor, cache_len: CacheLen,
                  prompts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a span of stacked layers (a loop over the leading axis L).
    k_caches/v_caches: [L, B, S, Hkv, Dh], updated in place and returned.
    prompts: optional [L, pre_seq, D] inference-time deep prompts, added
    into each layer's input at absolute positions < pre_seq
    (`_apply_deep_prompt`), for prefill and decode alike."""
    rope = make_rope(cfg, positions)
    for li in range(k_caches.shape[0]):
        lp = tree_map(lambda a: a[li], layers)
        if prompts is not None:
            x = _apply_deep_prompt(x, prompts[li], cache_len)
        x = layer_forward(cfg, lp, x, rope, k_caches[li], v_caches[li], cache_len)
    return x, k_caches, v_caches


def _stack_depth(layers: Params) -> int:
    """The leading (layer) axis of a stacked layer tree."""
    node = layers
    while isinstance(node, dict):
        node = next(iter(node.values()))
    if isinstance(node, QuantizedTensor):
        return node.q.shape[0]
    if isinstance(node, NF4Tensor):
        return node.packed.shape[0]
    return node.shape[0]


def _train_layer(cfg: ModelConfig, lp: Params, h: torch.Tensor, rope,
                 prompt: Optional[torch.Tensor], lora: Optional[Params],
                 lora_scale: float) -> torch.Tensor:
    """One layer of the training forward: its adapters merged, its deep
    prompt rows [n, D] added to the first n rows of h (cast to h's dtype,
    as the reference casts them), then the cache-free block."""
    if lora:
        lp = {**lp, "attn": merge_lora_layer(cfg, lp["attn"], lora, lora_scale)}
    if prompt is not None and prompt.shape[0]:
        n = prompt.shape[0]
        h = torch.cat([(h[:, :n] + prompt[None]).to(h.dtype), h[:, n:]], dim=1)
    return layer_forward(cfg, lp, h, rope, None, None, 0)


def stack_forward_train(cfg: ModelConfig, layers: Params, x: torch.Tensor,
                        positions: torch.Tensor, remat: bool = True,
                        prompts: Optional[torch.Tensor] = None,
                        lora: Optional[Params] = None,
                        lora_scale: float = 0.0) -> torch.Tensor:
    """Training forward of a span of stacked layers: no KV cache, causal
    attention over the sequence (the reference's ``stack_forward_train``).

    remat=True checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant): the backward recomputes the layer instead of keeping
    its activations; remat=False keeps them (the oracle's form).

    prompts: optional [L, pre_seq, D] deep prompts, added into the first
    ``min(pre_seq, T)`` positions of each layer's input; a sequence shorter
    than pre_seq uses the first T rows and the rest get zero gradients.
    lora: optional adapters over the span's L layers (``{target: {"a": [L,
    D, r], "b": [L, r, O]}}``), merged for each layer inside its body at
    ``lora_scale``. MoE spans are refused (ROADMAP Queue 1 #4a-ii)."""
    _check_trainable(cfg)
    rope = make_rope(cfg, positions)
    pre = 0 if prompts is None else min(prompts.shape[1], x.shape[1])
    for li in range(_stack_depth(layers)):
        lp = tree_map(lambda a: a[li], layers)
        prompt = None if prompts is None else prompts[li, :pre]
        lora_l = ({t: {k: v[li] for k, v in ab.items()} for t, ab in lora.items()}
                  if lora else None)
        if remat:
            x = checkpoint(_train_layer, cfg, lp, x, rope, prompt, lora_l, lora_scale,
                           use_reentrant=False)
        else:
            x = _train_layer(cfg, lp, x, rope, prompt, lora_l, lora_scale)
    return x


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + projection to vocab. x: [B, T, D] -> [B, T, V] float32."""
    x = _norm(cfg, params["final_norm"], x)
    w = (params["embed"]["wte"].T if cfg.tie_word_embeddings
         else params["lm_head"]["w"])
    logits = x.float() @ w.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def init_kv_cache(cfg: ModelConfig, num_layers: int, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, device="cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def full_forward(cfg: ModelConfig, params: Params, input_ids: torch.Tensor,
                 k_caches: torch.Tensor, v_caches: torch.Tensor,
                 cache_len: CacheLen, prompts: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole unpartitioned model (the single-device oracle path). Returns
    (logits [B, T, V] float32, caches updated in place). prompts: optional
    [num_layers, pre_seq, D] deep prompts (the monolithic oracle for the
    distributed injection)."""
    t = input_ids.shape[1]
    positions = cache_len + torch.arange(t, device=input_ids.device)[None, :]
    x = embed_tokens(cfg, params["embed"], input_ids, positions)
    x, k_caches, v_caches = stack_forward(cfg, params["layers"], x, positions,
                                          k_caches, v_caches, cache_len,
                                          prompts=prompts)
    return lm_head(cfg, params, x), k_caches, v_caches
