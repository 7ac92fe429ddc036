"""LoRA adapters: serving a fine-tune, and the trainer's wire helpers.

Port of the JAX package's ``models/lora.py``. Adapters are client-owned
trainables, shipped with each training RPC as prompt slices are, so the
server stays stateless and frozen; a finished pure-LoRA fine-tune is one
``.npz`` that ``--lora PATH`` folds into the attention weights at load,
before ``--quant``.

A LoRA adapter for target weight ``W: [D, O]`` is a pair ``a: [D, r]``,
``b: [r, O]`` with effective weight ``W + (alpha / r) * a @ b``. ``b`` is
zero-initialized so training starts from the frozen model exactly.

Tree layout mirrors the stacked layer params: per target name (a key into
``layers["attn"]``, e.g. ``wq``/``wv``), ``{"a": [L, D, r], "b": [L, r, O]}``
with the leading layer axis, sliceable per block span as prompts are.

`merge_lora` keeps the reference's rounding order (the delta a float32
product, cast to the weight's dtype, times ``scale`` in that dtype, added
in that dtype) but merges one layer at a time: the reference's single
``[L, D, O]`` einsum holds every layer's float32 delta at once (2.1 GB for
``wq`` of a 32-layer 4096-wide model), one layer's is 64 MB. The files and
the wire manifest are the reference's, so an adapter written by either
package loads in the other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ModelConfig

Params = Dict[str, Any]

DEFAULT_TARGETS = ("wq", "wv")  # the classic LoRA attention pair


def target_out_dim(cfg: ModelConfig, target: str) -> int:
    """Output width of an attention projection target."""
    dh = cfg.head_dim
    if target == "wq":
        return cfg.num_heads * dh
    if target in ("wk", "wv"):
        return cfg.num_kv_heads * dh
    if target == "wo":
        return cfg.hidden_size
    raise ValueError(f"unsupported LoRA target {target!r} "
                     "(expected wq/wk/wv/wo)")


def init_lora(generator: torch.Generator, cfg: ModelConfig, num_layers: int,
              rank: int, targets: Sequence[str] = DEFAULT_TARGETS,
              init_scale: float = 0.01, dtype: torch.dtype = torch.float32) -> Params:
    """a ~ N(0, init_scale), b = 0: the standard LoRA start (delta == 0).
    Draws from `generator`, on its device, targets in sorted order; the
    draws differ from the reference's threefry ones."""
    dev = generator.device
    tree: Params = {}
    for t in sorted(targets):
        o = target_out_dim(cfg, t)
        a = torch.randn((num_layers, cfg.hidden_size, rank), generator=generator,
                        dtype=torch.float32, device=dev)
        tree[t] = {"a": (init_scale * a).to(dtype),
                   "b": torch.zeros((num_layers, rank, o), dtype=dtype, device=dev)}
    return tree


def slice_lora(lora: Params, start: int, end: int) -> Params:
    """The [start, end) block span's adapter slice (views; the same
    semantics as the per-hop prompt slice)."""
    return {t: {leaf: x[start:end] for leaf, x in ab.items()} for t, ab in lora.items()}


def _fused_qkv_offset(cfg: ModelConfig, wqkv_width: int, target: str) -> int:
    """Column offset of a q/k/v target inside an engine-fused ``wqkv``
    (layout [q | k | v], ``transformer.fuse_qkv_layers``)."""
    hd = wqkv_width * cfg.num_heads // (cfg.num_heads + 2 * cfg.num_kv_heads)
    kd = (wqkv_width - hd) // 2
    return {"wq": 0, "wk": hd, "wv": hd + kd}[target]


def _check_dense(w) -> None:
    if not isinstance(w, torch.Tensor) or not w.is_floating_point():
        raise ValueError("merge_lora takes dense weights: merge before --quant")


def _merged_cols(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """One layer's columns `w` [D, o] plus ``s * a @ b`` (a [D, r], b [r,
    o]) in the reference's rounding order: the float32 product, cast to
    w's dtype, times the scale `s` in that dtype, added in that dtype."""
    delta = a.to(w.device, torch.float32) @ b.to(w.device, torch.float32)
    return w + s * delta.to(w.dtype)


def _add_delta(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float,
               cols: Optional[slice] = None) -> torch.Tensor:
    """A copy of the stacked weight `w` [L, D, N] with ``scale * a[l] @
    b[l]`` added to each layer's columns `cols` (all of them by default),
    one layer's float32 delta at a time."""
    _check_dense(w)
    out = w.clone()
    s = torch.tensor(scale, dtype=w.dtype, device=w.device)
    cols = cols if cols is not None else slice(None)
    for li in range(w.shape[0]):
        out[li, :, cols] = _merged_cols(w[li, :, cols], a[li], b[li], s)
    return out


def merge_lora(cfg: ModelConfig, layers: Params, lora: Optional[Params],
               scale: float) -> Params:
    """Stacked layer params with each target's effective weight ``W +
    scale * a @ b``. Leaves everything else aliased: only adapted targets
    are new tensors.

    Handles both weight layouts: canonical per-projection ``wq/wk/wv/wo``
    and the engine-fused ``wqkv`` (the executors fuse at construction);
    there the delta lands on the target's column slice of the fused
    matrix, which is exactly equivalent (fusing along N never mixes
    columns)."""
    if not lora:
        return layers
    attn = dict(layers["attn"])
    for t, ab in lora.items():
        if t in attn:
            attn[t] = _add_delta(attn[t], ab["a"], ab["b"], scale)
        elif "wqkv" in attn and t in ("wq", "wk", "wv"):
            w = attn["wqkv"]
            off = _fused_qkv_offset(cfg, w.shape[-1], t)
            o = ab["b"].shape[-1]
            attn["wqkv"] = _add_delta(w, ab["a"], ab["b"], scale, slice(off, off + o))
        else:
            raise ValueError(f"LoRA target {t!r} not present in layer params")
    return {**layers, "attn": attn}


def merge_lora_layer(cfg: ModelConfig, attn: Params, lora: Optional[Params],
                     scale: float) -> Params:
    """One layer's attention params (2-D leaves) with each target's ``W +
    scale * a @ b``, `lora` holding that layer's ``a`` [D, r] and ``b`` [r,
    O]: the bits `merge_lora` gives that layer, on either layout. Nothing
    is written in place, so the result is differentiable in a and b: the
    training forward (``models/transformer.stack_forward_train``) merges
    each layer inside its checkpointed body, so at most one layer's merged
    weights live at a time."""
    if not lora:
        return attn
    attn = dict(attn)
    for t, ab in lora.items():
        if t in attn:
            w = attn[t]
            _check_dense(w)
            s = torch.tensor(scale, dtype=w.dtype, device=w.device)
            attn[t] = _merged_cols(w, ab["a"], ab["b"], s)
        elif "wqkv" in attn and t in ("wq", "wk", "wv"):
            w = attn["wqkv"]
            _check_dense(w)
            s = torch.tensor(scale, dtype=w.dtype, device=w.device)
            off = _fused_qkv_offset(cfg, w.shape[-1], t)
            o = ab["b"].shape[-1]
            attn["wqkv"] = torch.cat(
                [w[:, :off], _merged_cols(w[:, off:off + o], ab["a"], ab["b"], s),
                 w[:, off + o:]], dim=-1)
        else:
            raise ValueError(f"LoRA target {t!r} not present in layer params")
    return attn


# ---------------------------------------------------------------------------
# Adapter files: one .npz serves a finished fine-tune
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_lora(path: str, lora: Params, scale: float) -> None:
    """Write adapters and their scale as one flat .npz ("target/leaf" keys,
    ``__scale__`` float32), the reference's format. For a pure-LoRA
    fine-tune this file plus the base checkpoint is the tuned model: serve
    it with ``--lora path``."""
    if not path.endswith(".npz"):
        path += ".npz"
    flat = {"__scale__": np.float32(scale)}
    for t, ab in lora.items():
        flat[f"{t}/a"] = _host(ab["a"])
        flat[f"{t}/b"] = _host(ab["b"])
    np.savez(path, **flat)


def load_lora(path: str) -> Tuple[Params, float]:
    """Inverse of `save_lora`: (tree of CPU tensors, scale)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        scale = float(data["__scale__"])
        tree: Params = {}
        for name in data.files:
            if name == "__scale__":
                continue
            t, leaf = name.split("/", 1)
            tree.setdefault(t, {})[leaf] = torch.from_numpy(data[name])
    for t, ab in tree.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"adapter file {path}: target {t!r} missing a/b pair")
    return tree, scale


# ---------------------------------------------------------------------------
# Wire helpers: a deterministic flatten so adapters ride multi-tensor frames
# ---------------------------------------------------------------------------

def lora_to_list(lora: Params) -> Tuple[List[str], List[torch.Tensor]]:
    """(manifest, arrays): manifest entries are "target/leaf" in sorted
    order; inverse of `lora_from_list`."""
    manifest: List[str] = []
    arrays: List[torch.Tensor] = []
    for t in sorted(lora):
        for leaf in ("a", "b"):
            manifest.append(f"{t}/{leaf}")
            arrays.append(lora[t][leaf])
    return manifest, arrays


def lora_from_list(manifest: Sequence[str], arrays: Sequence) -> Params:
    if len(manifest) != len(arrays):
        raise ValueError(
            f"lora manifest has {len(manifest)} entries, {len(arrays)} arrays")
    tree: Params = {}
    for name, arr in zip(manifest, arrays):
        t, leaf = name.split("/", 1)
        if leaf not in ("a", "b"):
            raise ValueError(f"bad lora manifest entry {name!r}")
        tree.setdefault(t, {})[leaf] = (arr if isinstance(arr, torch.Tensor)
                                        else torch.from_numpy(np.array(arr)))
    for t, ab in tree.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"lora target {t!r} missing a/b pair")
    return tree
