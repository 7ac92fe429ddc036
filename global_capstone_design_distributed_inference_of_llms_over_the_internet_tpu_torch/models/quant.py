"""Weight-only quantization for serving (port of the JAX package's
``models/quant.py``): int8 and NF4.

  * int8: per-output-channel float32 absmax scales (`QuantizedTensor`).
    With ``INT8_FOLD`` on (the default) every per-layer 2-D int8 leaf stays
    packed and the matmul sites apply the scale in the epilogue
    (``ops.int8_kernel.int8_dot``); ``INT8_FOLD=0`` dequantizes and
    materializes the weight first, the reference's own kill switch.
  * NF4: 4-bit NormalFloat codes, two per byte along the input axis, and
    one bf16 absmax scale per 64-weight input block (`NF4Tensor`, 4.25
    bits per weight). With ``NF4_KERNEL=1`` per-layer 2-D NF4 leaves stay
    packed and the matmul sites run ``ops.nf4_kernel.nf4_dot``; by default
    (``NF4_KERNEL=0``) they are dequantized first.

Norms, biases, embeddings and the LM head stay in full precision.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from ..utils.flags import bool_flag
from .config import ModelConfig

Params = Dict[str, Any]

# Bits per weight for sizing (the reference's ``block_utils.py:46``): int8
# is 8, NF4 4.25 (a 4-bit code and one bf16 scale per 64 weights), "none"
# the weights' dtype.
QUANT_BITS = {"none": None, "int8": 8, "nf4": 4.25}


class QuantizedTensor:
    """int8 weight + per-output-channel float32 scale.

    Layout: q is int8 with the original weight shape [..., in, out]; s is
    float32 [..., 1, out], so ``q * s`` reconstructs. `dtype` names the
    original weight dtype ("float32" or "bfloat16")."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, dtype: str = "float32"):
        self.q = q
        self.s = s
        self.dtype = dtype

    def dequant(self) -> torch.Tensor:
        return (self.q.float() * self.s).to(getattr(torch, self.dtype))

    def __repr__(self):
        return f"QuantizedTensor(shape={tuple(self.q.shape)}, dtype={self.dtype})"


# The 16 NormalFloat4 levels (quantiles of N(0,1), endpoints at +-1: the
# QLoRA code book), and the weights per absmax block. Copied from the
# reference (`quant.py:43-50`); tests/test_torch_isolation.py holds them to it.
NF4_LEVELS = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.4407098591327667, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_BLOCK = 64


@functools.lru_cache(maxsize=None)
def _nf4_levels(device: torch.device) -> torch.Tensor:
    """NF4_LEVELS as a float32 tensor on `device`, made once per device: a
    captured step (``runtime/graphs.py``) that dequantizes cannot copy
    from the host, and its eager warm-up run makes this first."""
    return torch.tensor(NF4_LEVELS, dtype=torch.float32, device=device)


class NF4Tensor:
    """4-bit NormalFloat weight: packed codes + per-block bf16 absmax scales.

    Layout, for an original weight [..., in, out] (the reference's):
      * ``packed``: uint8 [..., in_pad/2, out], two 4-bit codes per byte
        along the input axis (high nibble = row 2r, low nibble = row 2r+1);
      * ``scales``: bfloat16 [..., in_pad/64, out], the absmax of each
        64-weight input block (in_pad = in rounded up to 64).
    `dtype` names the original weight dtype."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor, in_dim: int,
                 dtype: str = "float32"):
        self.packed = packed
        self.scales = scales
        self.in_dim = in_dim
        self.dtype = dtype

    @property
    def shape(self):
        return (*self.packed.shape[:-2], self.in_dim, self.packed.shape[-1])

    def dequant_f32(self) -> torch.Tensor:
        """level * scale in float32, [..., in, out]: the values every
        version rounds to its working dtype."""
        lead = self.packed.shape[:-2]
        pairs, out = self.packed.shape[-2:]
        in_pad = 2 * pairs
        codes = torch.stack([self.packed >> 4, self.packed & 0xF], dim=-2)
        levels = _nf4_levels(self.packed.device)
        vals = levels[codes.reshape(*lead, in_pad, out).long()]
        vals = vals.reshape(*lead, in_pad // NF4_BLOCK, NF4_BLOCK, out)
        vals = vals * self.scales.float()[..., :, None, :]
        return vals.reshape(*lead, in_pad, out)[..., :self.in_dim, :]

    def dequant(self) -> torch.Tensor:
        return self.dequant_f32().to(getattr(torch, self.dtype))

    def __repr__(self):
        return f"NF4Tensor(shape={tuple(self.shape)}, dtype={self.dtype})"


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Map `fn` over every tensor of a param tree (nested dicts whose
    leaves are tensors, QuantizedTensors — fn sees q and s — or NF4Tensors
    — fn sees packed and scales)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q), fn(tree.s), tree.dtype)
    if isinstance(tree, NF4Tensor):
        return NF4Tensor(fn(tree.packed), fn(tree.scales), tree.in_dim, tree.dtype)
    return fn(tree)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _quantize_2d(w32: torch.Tensor):
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, s


def _quantize_leaf(w: torch.Tensor) -> QuantizedTensor:
    """Per-output-channel absmax int8: channel axis = last, reduce over the
    input axis (-2). Stacked [L, in, out] weights quantize one layer at a
    time (each layer's channels are independent), so the float32 working
    copy never exceeds one layer."""
    if w.ndim == 2:
        q, s = _quantize_2d(w.float())
        return QuantizedTensor(q, s, dtype_name(w.dtype))
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((flat.shape[0], 1, w.shape[-1]), dtype=torch.float32,
                    device=w.device)
    for i in range(flat.shape[0]):
        q[i], s[i] = _quantize_2d(flat[i].float())
    return QuantizedTensor(q.reshape(w.shape), s.reshape(*lead, 1, w.shape[-1]),
                           dtype_name(w.dtype))


def _quantize_nf4_2d(w32: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor) -> None:
    """One [in, out] float32 layer into `packed` [in_pad/2, out] and
    `scales` [in_pad/64, out]: block the input axis by 64, scale each block
    to [-1, 1] by its absmax rounded to bf16 (the scale the dequant uses),
    snap to the nearest level by boundary search, pack two codes a byte."""
    in_dim, out = w32.shape
    in_pad = 2 * packed.shape[0]
    if in_pad != in_dim:
        w32 = F.pad(w32, (0, 0, 0, in_pad - in_dim))
    blocks = w32.reshape(in_pad // NF4_BLOCK, NF4_BLOCK, out)
    scales.copy_(blocks.abs().amax(dim=1).to(torch.bfloat16))
    scale32 = scales.float()[:, None, :]
    norm = torch.where(scale32 > 0, blocks / scale32, torch.zeros_like(blocks))
    levels = torch.tensor(NF4_LEVELS, dtype=torch.float32, device=w32.device)
    bounds = (levels[1:] + levels[:-1]) / 2.0
    # right=False: bounds[i-1] < v <= bounds[i], np.searchsorted's side="left".
    codes = torch.bucketize(norm, bounds, out_int32=True, right=False)
    codes = codes.reshape(in_pad, out).to(torch.uint8)
    packed.copy_((codes[0::2] << 4) | codes[1::2])


def _quantize_leaf_nf4(w: torch.Tensor) -> NF4Tensor:
    """NF4 quantization of an [..., in, out] weight, on its own device, one
    layer of a stacked weight at a time (reference `quant.py:162-190`)."""
    *lead, in_dim, out = w.shape
    in_pad = -(-in_dim // NF4_BLOCK) * NF4_BLOCK
    packed = torch.empty((*lead, in_pad // 2, out), dtype=torch.uint8,
                         device=w.device)
    scales = torch.empty((*lead, in_pad // NF4_BLOCK, out), dtype=torch.bfloat16,
                         device=w.device)
    flat = w.reshape(-1, in_dim, out)
    pk = packed.view(-1, in_pad // 2, out)
    sc = scales.view(-1, in_pad // NF4_BLOCK, out)
    for i in range(flat.shape[0]):
        _quantize_nf4_2d(flat[i].float(), pk[i], sc[i])
    return NF4Tensor(packed, scales, in_dim, dtype_name(w.dtype))


# The matmul weight names of models/transformer.py's layer schema. Norms,
# biases and the MoE "router" stay full precision.
_MATMUL_KEYS = frozenset(
    {"wq", "wk", "wv", "wqkv", "wo", "wg", "wu", "wgu", "wd", "wi"})


def quantize_layers(layers: Params, quant: str = "int8") -> Params:
    """Quantize a `layers` subtree by leaf NAME (norm weights and biases
    share the ndim of stacked matmul weights)."""
    if quant in (None, "none"):
        return layers
    if quant not in ("int8", "nf4"):
        raise NotImplementedError(
            f"quant={quant!r}: int8 and nf4 execution are implemented")
    leaf = _quantize_leaf if quant == "int8" else _quantize_leaf_nf4

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if key in _MATMUL_KEYS and getattr(tree, "ndim", 0) >= 2:
            return leaf(tree)
        return tree

    return walk(layers)


def quantize_params(params: Params, quant: str = "int8") -> Params:
    """Quantize a full/stage param tree: blocks only."""
    out = dict(params)
    if "layers" in params:
        out["layers"] = quantize_layers(params["layers"], quant)
    return out


def nf4_kernel_enabled() -> bool:
    """NF4_KERNEL=1 keeps per-layer 2-D NF4 leaves packed so the matmul
    sites run the fused dequant-matmul kernel (ops.nf4_kernel.nf4_dot);
    the default, 0, dequantizes and materializes the weight first."""
    return bool_flag("NF4_KERNEL")


def int8_fold_enabled() -> bool:
    """INT8_FOLD=1 (default) keeps per-layer 2-D int8 leaves packed so the
    matmul sites stream the int8 bytes and apply the per-channel scale in
    the epilogue; INT8_FOLD=0 dequantizes and materializes the weight."""
    return bool_flag("INT8_FOLD")


def dequant_tree(tree: Params) -> Params:
    """Materialize full-precision weights for quantized leaves, except that
    per-layer (2-D) NF4 leaves stay packed under `nf4_kernel_enabled()` and
    per-layer int8 leaves under `int8_fold_enabled()`."""
    keep_nf4 = nf4_kernel_enabled()
    keep_int8 = int8_fold_enabled()

    def f(x):
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        if isinstance(x, NF4Tensor):
            return x if keep_nf4 and x.packed.ndim == 2 else x.dequant()
        if isinstance(x, QuantizedTensor):
            return x if keep_int8 and x.q.ndim == 2 else x.dequant()
        return x

    return f(tree)


# ---------------------------------------------------------------------------
# Quantization-aware sizing and server auto-capacity (the reference's
# ``block_utils.get_block_size`` and ``server.py`` ``_choose_num_blocks``)
# ---------------------------------------------------------------------------

def params_per_block(cfg: ModelConfig) -> int:
    """Parameter count of ONE transformer block (no embed/head)."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
    if cfg.use_bias or cfg.attn_qkv_bias:
        attn += h * dh + 2 * hkv * dh   # q/k/v biases (gpt2 and qwen2)
    if cfg.use_bias:
        attn += d                        # o bias (gpt2 only)
    if cfg.is_moe:
        mlp = cfg.num_experts * 3 * d * i + d * cfg.num_experts
    elif cfg.mlp == "swiglu":
        mlp = 3 * d * i
    else:
        mlp = 2 * d * i + (i + d if cfg.use_bias else 0)
    norms = (4 if cfg.norm == "layernorm" else 2) * d
    return attn + mlp + norms


def block_bytes(cfg: ModelConfig, dtype_bytes: int = 2, quant: str = "none") -> int:
    """Bytes one block occupies resident under `quant`."""
    if quant not in QUANT_BITS:
        raise ValueError(f"unknown quant mode {quant!r} "
                         f"(expected one of {sorted(QUANT_BITS)})")
    n = params_per_block(cfg)
    bits = QUANT_BITS[quant]
    if bits is None:
        return n * dtype_bytes
    return int(n * bits / 8)


def choose_num_blocks(cfg: ModelConfig, memory_budget_bytes: int, *,
                      dtype_bytes: int = 2, quant: str = "none",
                      attn_cache_bytes: int = 0,
                      reserve_fraction: float = 0.05) -> int:
    """How many blocks fit a device budget after the KV-cache arena and a
    safety reserve: the server auto-capacity rule."""
    usable = int(memory_budget_bytes * (1.0 - reserve_fraction))
    usable -= attn_cache_bytes
    per = block_bytes(cfg, dtype_bytes, quant)
    return max(1, min(cfg.num_layers, usable // max(per, 1)))
