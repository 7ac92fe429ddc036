"""Weight-only int8 quantization for serving (port of the int8 half of the
JAX package's ``models/quant.py``).

int8 weights with per-output-channel float32 absmax scales. Norms, biases,
embeddings and the LM head stay in full precision. With ``INT8_FOLD`` on
(the default) every per-layer 2-D int8 leaf stays packed and the matmul
sites apply the scale in the epilogue (``ops.int8_kernel.int8_dot``);
``INT8_FOLD=0`` dequantizes and materializes the weight first, the
reference's own kill switch.

NF4 (``NF4Tensor``, the NF4 quantizer) is not ported yet; it comes with
the ``nf4_dot`` kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..utils.flags import bool_flag

Params = Dict[str, Any]


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


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Map `fn` over every tensor of a param tree (nested dicts whose
    leaves are tensors or QuantizedTensors — fn sees q and s)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q), fn(tree.s), tree.dtype)
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


# The matmul weight names of models/transformer.py's layer schema. Norms,
# biases and the MoE "router" stay full precision.
_MATMUL_KEYS = frozenset(
    {"wq", "wk", "wv", "wqkv", "wo", "wg", "wu", "wgu", "wd", "wi"})


def quantize_layers(layers: Params, quant: str = "int8") -> Params:
    """Quantize a `layers` subtree by leaf NAME (norm weights and biases
    share the ndim of stacked matmul weights)."""
    if quant in (None, "none"):
        return layers
    if quant != "int8":
        raise NotImplementedError(f"quant={quant!r}: the port executes int8 only")

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if key in _MATMUL_KEYS and getattr(tree, "ndim", 0) >= 2:
            return _quantize_leaf(tree)
        return tree

    return walk(layers)


def quantize_params(params: Params, quant: str = "int8") -> Params:
    """Quantize a full/stage param tree: blocks only."""
    out = dict(params)
    if "layers" in params:
        out["layers"] = quantize_layers(params["layers"], quant)
    return out


def int8_fold_enabled() -> bool:
    """INT8_FOLD=1 (default) keeps per-layer 2-D int8 leaves packed so the
    matmul sites stream the int8 bytes and apply the per-channel scale in
    the epilogue; INT8_FOLD=0 dequantizes and materializes the weight."""
    return bool_flag("INT8_FOLD")


def dequant_tree(tree: Params) -> Params:
    """Materialize full-precision weights for quantized leaves, except that
    per-layer (2-D) int8 leaves stay packed under `int8_fold_enabled()`."""
    keep_int8 = int8_fold_enabled()

    def f(x):
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        if not isinstance(x, QuantizedTensor):
            return x
        if keep_int8 and x.q.ndim == 2:
            return x
        return x.dequant()

    return f(tree)

