"""Import Hugging Face checkpoints into the port's stacked-layer layout.

Port of the JAX package's ``models/hf_import.py``. Two reference paths are
one operation here, as there: a full-checkpoint load pruned to a stage span
(``src/llama_partition.py:477-550``) and per-block weight streaming
(``petals/server/from_pretrained.py:81-128``): ``convert_state_dict(...,
layer_range)`` touches only the tensors a stage needs, and `LazyCheckpoint`
reads a tensor only when it is touched, from the shard that holds it.

Weight layout, as in the reference:
  * GPT-2 uses Conv1D ([in, out]): taken as it is; its fused ``c_attn`` is
    split into wq / wk / wv.
  * LLaMA-family ``nn.Linear`` weights are [out, in]: taken transposed.

The output is the tree `models.transformer.init_params` returns (the same
keys, shapes, dtypes and stacking), so LoRA, ``--quant`` and the
executors' qkv / gate-up fusing run on it unchanged. Only float leaves take
the target dtype: gemma2's per-layer ``window`` leaf stays int32.

Neither ``transformers`` nor ``safetensors`` is needed:
  * a ``.safetensors`` file (an 8-byte little-endian header length, a JSON
    header of ``dtype`` / ``shape`` / ``data_offsets``, then the raw bytes)
    is mapped and each tensor taken with ``torch.frombuffer`` at its own
    dtype, bfloat16 included (`SafetensorsFile`);
  * ``config.json`` is read with `json` into an attribute view
    (`HFConfig`) over a table of each model type's defaults
    (`HF_DEFAULTS`), because ``save_pretrained`` leaves out values that
    equal them (``tie_word_embeddings`` of gemma, for one);
  * ``pytorch_model.bin`` and its ``.index.json`` shards load with
    ``torch.load(weights_only=True)`` through the same conversion, where
    the reference loads the whole model with ``AutoModelForCausalLM``.

On the card a stage's stacked leaves are allocated once in the target
dtype and filled a layer at a time from the mapped file, as ``init_params``
fills them: each tensor crosses to the device in row blocks of at most
`COPY_CHUNK_BYTES` in its own dtype and is cast (and transposed) there. So
the device never holds the span twice, and the host never stacks it.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
import warnings
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import (
    ModelConfig,
    gemma2_config,
    gemma_config,
    gpt2_config,
    llama_config,
    mistral_config,
    mixtral_config,
    qwen2_config,
)

Params = Dict[str, Any]

# The most a tensor's bytes stage on the device before they are cast and
# transposed into their leaf.
COPY_CHUNK_BYTES = 64 << 20

# The default of every attribute `config_from_hf` reads, per HF model type:
# the value of that type's config class built with no arguments (transformers
# 4.57; tests/test_torch_checkpoint.py holds the table to it). An attribute
# the class lacks is absent here too, so getattr's default applies as it does
# on the class.
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt2": {"vocab_size": 50257, "n_embd": 768, "n_layer": 12, "n_head": 12,
             "n_positions": 1024, "n_inner": None, "layer_norm_epsilon": 1e-5},
    "llama": {"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "intermediate_size": 11008, "max_position_embeddings": 2048,
              "rope_theta": 10000.0, "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
              "rope_scaling": None},
    "mistral": {"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "intermediate_size": 14336, "max_position_embeddings": 131072,
                "rope_theta": 10000.0, "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
                "sliding_window": 4096},
    "qwen2": {"vocab_size": 151936, "hidden_size": 4096, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "intermediate_size": 22016, "max_position_embeddings": 32768,
              "rope_theta": 10000.0, "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
              "rope_scaling": None, "use_sliding_window": False, "max_window_layers": 28,
              "sliding_window": None},
    "gemma": {"vocab_size": 256000, "hidden_size": 3072, "num_hidden_layers": 28,
              "num_attention_heads": 16, "num_key_value_heads": 16,
              "intermediate_size": 24576, "max_position_embeddings": 8192,
              "rope_theta": 10000.0, "tie_word_embeddings": True, "rms_norm_eps": 1e-6,
              "head_dim": 256},
    "gemma2": {"vocab_size": 256000, "hidden_size": 2304, "num_hidden_layers": 26,
               "num_attention_heads": 8, "num_key_value_heads": 4,
               "intermediate_size": 9216, "max_position_embeddings": 8192,
               "rope_theta": 10000.0, "tie_word_embeddings": True, "rms_norm_eps": 1e-6,
               "head_dim": 256, "query_pre_attn_scalar": 256,
               "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
               "sliding_window": 4096},
    "mixtral": {"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "intermediate_size": 14336, "max_position_embeddings": 131072,
                "rope_theta": 1000000.0, "tie_word_embeddings": False, "rms_norm_eps": 1e-5,
                "num_local_experts": 8, "num_experts_per_tok": 2, "sliding_window": None},
}


class HFConfig:
    """Attribute view of a checkpoint's ``config.json``: its values over
    the defaults of its ``model_type`` (`HF_DEFAULTS`)."""

    def __init__(self, values: Mapping):
        self.__dict__.update(HF_DEFAULTS.get(values.get("model_type"), {}))
        self.__dict__.update(values)


def config_from_hf(hf_cfg) -> ModelConfig:
    """Build a ModelConfig from a transformers PretrainedConfig or an
    `HFConfig`."""
    mt = hf_cfg.model_type
    if mt == "gpt2":
        return gpt2_config(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.n_embd,
            num_layers=hf_cfg.n_layer,
            num_heads=hf_cfg.n_head,
            max_position_embeddings=hf_cfg.n_positions,
            intermediate_size=getattr(hf_cfg, "n_inner", None) or 4 * hf_cfg.n_embd,
            norm_eps=getattr(hf_cfg, "layer_norm_epsilon", 1e-5),
        )
    common = dict(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-5),
    )
    rs = getattr(hf_cfg, "rope_scaling", None)
    if rs and mt != "llama":
        # Only the llama3 remap is implemented; any other family shipping
        # rope_scaling (yarn on long-context qwen2, say) would get wrong
        # positions past the base window without a word: refuse.
        rtype = rs.get("rope_type", rs.get("type"))
        if rtype not in (None, "default"):
            raise ValueError(
                f"{mt} checkpoint carries rope_scaling type {rtype!r} — "
                "unsupported (llama3-type scaling on llama only)")
    if mt == "llama":
        cfg = llama_config(**common)
        if rs:
            rtype = rs.get("rope_type", rs.get("type"))
            if rtype == "llama3":
                # The Llama-3.1/3.2 frequency remap (ops.rotary's llama3 rule).
                cfg = dataclasses.replace(cfg, rope_scaling=(
                    float(rs["factor"]),
                    float(rs.get("low_freq_factor", 1.0)),
                    float(rs.get("high_freq_factor", 4.0)),
                    int(rs.get("original_max_position_embeddings", 8192)),
                ))
            elif rtype not in (None, "default"):
                # Linear or dynamic-NTK would change positions: refuse
                # rather than generate subtly wrong long contexts.
                raise ValueError(
                    f"unsupported rope_scaling type {rtype!r} "
                    "(supported: llama3)")
        return cfg
    if mt == "qwen2":
        common["norm_eps"] = getattr(hf_cfg, "rms_norm_eps", 1e-6)
        cfg = qwen2_config(**common)
        # Qwen2 configs carry sliding_window but apply it only with
        # use_sliding_window, and then only to the layers from
        # max_window_layers on. The window here is global, so only the
        # uniform cases map; a mixed checkpoint is refused.
        if getattr(hf_cfg, "use_sliding_window", False):
            mwl = getattr(hf_cfg, "max_window_layers", hf_cfg.num_hidden_layers)
            if mwl <= 0:  # every layer windowed
                cfg = dataclasses.replace(
                    cfg, sliding_window=getattr(hf_cfg, "sliding_window", None))
            elif mwl < hf_cfg.num_hidden_layers:  # mixed full / windowed
                raise ValueError(
                    "qwen2 checkpoint uses per-layer sliding windows "
                    f"(max_window_layers={mwl} of "
                    f"{hf_cfg.num_hidden_layers} layers) — unsupported")
            # mwl >= the layers: no layer is windowed; full attention.
        return cfg
    if mt == "mistral":
        return mistral_config(
            sliding_window=getattr(hf_cfg, "sliding_window", None), **common)
    if mt == "gemma":
        # GemmaConfig's hidden_act "gelu" and the checkpoints'
        # gelu_pytorch_tanh both map to the tanh approximation.
        return gemma_config(head_dim=hf_cfg.head_dim, **common)
    if mt == "gemma2":
        return gemma2_config(
            head_dim=hf_cfg.head_dim,
            query_pre_attn_scalar=float(
                getattr(hf_cfg, "query_pre_attn_scalar", 0.0) or 0.0),
            attn_softcap=float(
                getattr(hf_cfg, "attn_logit_softcapping", 0.0) or 0.0),
            final_softcap=float(
                getattr(hf_cfg, "final_logit_softcapping", 0.0) or 0.0),
            sliding_window=int(getattr(hf_cfg, "sliding_window", 0) or 0),
            **common)
    if mt == "mixtral":
        cfg = mixtral_config(
            num_experts=hf_cfg.num_local_experts,
            num_experts_per_tok=hf_cfg.num_experts_per_tok,
            **common,
        )
        sw = getattr(hf_cfg, "sliding_window", None)
        if sw is not None:
            cfg = dataclasses.replace(cfg, sliding_window=sw)
        return cfg
    # The reference's model_type guard (src/llama_partition.py:82-83).
    raise ValueError(
        f"unsupported model_type: {mt} "
        "(expected gpt2/llama/mistral/mixtral/qwen2/gemma)")


def _t(x) -> torch.Tensor:
    """A state dict's value (torch tensor or numpy array) as a tensor."""
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _gpt2_layer(sd: Mapping[str, Any], i: int) -> Params:
    pre = f"transformer.h.{i}."
    c_attn_w = _t(sd[pre + "attn.c_attn.weight"])  # [D, 3D]
    c_attn_b = _t(sd[pre + "attn.c_attn.bias"])  # [3D]
    wq, wk, wv = torch.chunk(c_attn_w, 3, dim=1)
    bq, bk, bv = torch.chunk(c_attn_b, 3, dim=0)
    return {
        "ln1": {"w": _t(sd[pre + "ln_1.weight"]), "b": _t(sd[pre + "ln_1.bias"])},
        "ln2": {"w": _t(sd[pre + "ln_2.weight"]), "b": _t(sd[pre + "ln_2.bias"])},
        "attn": {
            "wq": wq, "wk": wk, "wv": wv,
            "bq": bq, "bk": bk, "bv": bv,
            "wo": _t(sd[pre + "attn.c_proj.weight"]),
            "bo": _t(sd[pre + "attn.c_proj.bias"]),
        },
        "mlp": {
            "wi": _t(sd[pre + "mlp.c_fc.weight"]),
            "bi": _t(sd[pre + "mlp.c_fc.bias"]),
            "wo": _t(sd[pre + "mlp.c_proj.weight"]),
            "bo": _t(sd[pre + "mlp.c_proj.bias"]),
        },
    }


def _llama_layer(sd: Mapping[str, Any], i: int, cfg: ModelConfig) -> Params:
    pre = f"model.layers.{i}."
    p: Params = {
        "ln1": {"w": _t(sd[pre + "input_layernorm.weight"])},
        "attn": {
            "wq": _t(sd[pre + "self_attn.q_proj.weight"]).T,
            "wk": _t(sd[pre + "self_attn.k_proj.weight"]).T,
            "wv": _t(sd[pre + "self_attn.v_proj.weight"]).T,
            "wo": _t(sd[pre + "self_attn.o_proj.weight"]).T,
        },
    }
    if cfg.post_norms:
        # gemma2's sandwich norms: HF's "post_attention_layernorm" is the
        # POST-attention norm (ln3 here); the pre-MLP norm is
        # "pre_feedforward_layernorm" (ln2).
        p["ln2"] = {"w": _t(sd[pre + "pre_feedforward_layernorm.weight"])}
        p["ln3"] = {"w": _t(sd[pre + "post_attention_layernorm.weight"])}
        p["ln4"] = {"w": _t(sd[pre + "post_feedforward_layernorm.weight"])}
    else:
        p["ln2"] = {"w": _t(sd[pre + "post_attention_layernorm.weight"])}
    if cfg.altern_window:
        # Even layers windowed, odd ones global (HF Gemma2Attention's
        # layer_idx rule): the per-layer window leaf.
        p["window"] = torch.tensor(cfg.altern_window if i % 2 == 0 else 0,
                                   dtype=torch.int32)
    if cfg.attn_qkv_bias:  # qwen2: q/k/v biases, no o bias
        p["attn"]["bq"] = _t(sd[pre + "self_attn.q_proj.bias"])
        p["attn"]["bk"] = _t(sd[pre + "self_attn.k_proj.bias"])
        p["attn"]["bv"] = _t(sd[pre + "self_attn.v_proj.bias"])
    if cfg.is_moe:
        experts = range(cfg.num_experts)
        moe = pre + "block_sparse_moe."
        p["mlp"] = {
            "router": _t(sd[moe + "gate.weight"]).T,  # [D, E]
            **{name: torch.stack([_t(sd[moe + f"experts.{e}.{w}.weight"]).T
                                  for e in experts])
               for name, w in (("wg", "w1"), ("wu", "w3"), ("wd", "w2"))},
        }
    else:
        p["mlp"] = {
            "wg": _t(sd[pre + "mlp.gate_proj.weight"]).T,
            "wu": _t(sd[pre + "mlp.up_proj.weight"]).T,
            "wd": _t(sd[pre + "mlp.down_proj.weight"]).T,
        }
    return p


def _fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy `src` (a host tensor, possibly the transposed view of an [out,
    in] weight) into `dst`, casting to dst's dtype. Onto a device it moves
    in row blocks of its own storage order of at most COPY_CHUNK_BYTES:
    straight into `dst` where nothing changes, else staged on the device
    in its own dtype and cast (and transposed) there."""
    if dst.device.type == "cpu" or src.dim() == 0:
        dst.copy_(src)
        return
    transposed = src.dim() == 2 and not src.is_contiguous() and src.t().is_contiguous()
    rows, out = (src.t(), dst.t()) if transposed else (src.contiguous(), dst)
    direct = not transposed and src.dtype == dst.dtype
    step = max(1, COPY_CHUNK_BYTES // max(1, rows[0].numel() * rows.element_size()))
    for r in range(0, rows.shape[0], step):
        block = rows[r:r + step]
        out[r:r + step].copy_(block if direct else block.to(dst.device))


def _tree(fn: Callable, *trees):
    """`fn` over the leaves of trees of nested dicts with the first one's keys."""
    if isinstance(trees[0], dict):
        return {k: _tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _target(t: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """Float leaves take the target dtype; the int32 window leaf stays."""
    return dtype if t.is_floating_point() else t.dtype


def _load(t, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One tensor on `device` in `dtype`."""
    t = _t(t)
    out = torch.empty(t.shape, dtype=_target(t, dtype), device=device)
    _fill(out, t)
    return out


def _stack_layers(layer: Callable[[int], Params], start: int, end: int,
                  dtype: torch.dtype, device: torch.device,
                  stream: Optional[Tuple[int, Callable[[int, Params], None]]] = None
                  ) -> Params:
    """Layers start..end-1 stacked from index 0: each leaf allocated once
    on `device` from the first layer's shapes, filled a layer at a time.

    ``stream=(k, sink)`` stacks the first k only: each later layer n is
    filled into one one-layer tree (leaves ``[1, ...]``, reused) and handed
    to ``sink(n, tree)``, which must be done with it when it returns."""
    keep = end - start if stream is None else min(stream[0], end - start)
    out = scratch = None
    for n, i in enumerate(range(start, end)):
        leaves = layer(i)
        if out is None:
            out = _tree(lambda t: torch.empty((keep, *t.shape),
                                              dtype=_target(t, dtype), device=device),
                        leaves)
        if n < keep:
            _tree(lambda dst, src: _fill(dst[n], src), out, leaves)
            continue
        if scratch is None:
            scratch = _tree(lambda t: torch.empty((1, *t.shape), dtype=_target(t, dtype),
                                                  device=device), leaves)
        _tree(lambda dst, src: _fill(dst[0], src), scratch, leaves)
        stream[1](n, scratch)
    return out


def convert_state_dict(
    cfg: ModelConfig,
    sd: Mapping[str, Any],
    dtype: torch.dtype = torch.float32,
    layer_range: Optional[Tuple[int, int]] = None,
    include_embed: bool = True,
    include_head: bool = True,
    device="cuda",
    stream: Optional[Tuple[int, Callable[[int, Params], None]]] = None,
) -> Params:
    """Convert an HF state dict (tensors or numpy arrays, or a
    `LazyCheckpoint`) to the stacked layout on `device`.

    layer_range=(start, end) keeps only that span of layers; include_embed /
    include_head decide whether the embeddings and the final norm + LM head
    are read (the stage-role pruning of ``src/llama_partition.py:506-525``).
    ``stream=(k, sink)`` stacks the span's first k layers only and hands
    each later one to `sink` as `_stack_layers` does (a host-offloaded
    span, ``runtime/offload.py``).
    """
    device = torch.device(device)
    start, end = layer_range if layer_range is not None else (0, cfg.num_layers)
    is_gpt2 = cfg.model_type == "gpt2"

    params: Params = {}
    if end > start:
        layer = ((lambda i: _gpt2_layer(sd, i)) if is_gpt2
                 else (lambda i: _llama_layer(sd, i, cfg)))
        params["layers"] = _stack_layers(layer, start, end, dtype, device, stream)

    wte_key = "transformer.wte.weight" if is_gpt2 else "model.embed_tokens.weight"
    if include_embed:
        params["embed"] = {"wte": _load(sd[wte_key], dtype, device)}
        if is_gpt2:
            params["embed"]["wpe"] = _load(sd["transformer.wpe.weight"], dtype, device)

    if include_head:
        if is_gpt2:
            params["final_norm"] = {
                "w": _load(sd["transformer.ln_f.weight"], dtype, device),
                "b": _load(sd["transformer.ln_f.bias"], dtype, device),
            }
        else:
            params["final_norm"] = {"w": _load(sd["model.norm.weight"], dtype, device)}
        if not cfg.tie_word_embeddings:
            # A checkpoint with no lm_head.weight ties the embeddings even
            # where its config says otherwise.
            head = sd.get("lm_head.weight")
            head = sd[wte_key] if head is None else head
            params["lm_head"] = {"w": _load(_t(head).T, dtype, device)}
        if cfg.tie_word_embeddings and not include_embed:
            # A last stage with tied embeddings still needs wte for the head.
            params["embed"] = {"wte": _load(sd[wte_key], dtype, device)}

    return params


def import_hf_model(hf_model, dtype: torch.dtype = torch.float32,
                    device="cuda") -> Tuple[ModelConfig, Params]:
    """Convert an in-memory transformers model (a test's oracle, say)."""
    cfg = config_from_hf(hf_model.config)
    return cfg, convert_state_dict(cfg, hf_model.state_dict(), dtype, device=device)


# ---------------------------------------------------------------------------
# Per-stage checkpoint streaming (petals/server/from_pretrained.py:81-128): a
# stage reads ONLY the shards holding its span's tensors; no host holds the
# full model.
# ---------------------------------------------------------------------------

# safetensors dtype names -> torch dtypes.
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsFile:
    """One ``.safetensors`` file, mapped read-only. `get_tensor` returns a
    CPU tensor viewing the mapped bytes at the tensor's own dtype (nothing
    is read until it is used); never write to one."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                         if size > 8 + n else None)
        header.pop("__metadata__", None)
        self._header = header
        self._base = 8 + n

    def keys(self):
        return list(self._header)

    def get_tensor(self, key: str) -> torch.Tensor:
        info = self._header[key]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        with warnings.catch_warnings():
            # The map is read-only, and torch warns of that on every view.
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(self._map, dtype=dtype,
                                    count=(end - begin) // dtype.itemsize,
                                    offset=self._base + begin)
        return flat.view(shape)


class LazyCheckpoint(Mapping):
    """Lazy Mapping over a local HF checkpoint directory.

    Keys resolve through ``model.safetensors.index.json`` (sharded), the
    single ``model.safetensors``, or failing both ``pytorch_model.bin
    .index.json`` / ``pytorch_model.bin``. A tensor is read only when
    ``convert_state_dict`` touches its key, and only from the shard that
    holds it (the reference's per-block shard filtering,
    ``petals/server/from_pretrained.py:100-108``). ``opened`` is the set of
    shard files a load read: a middle stage must not touch the embedding
    or head shards. Each shard is opened once and kept."""

    LAYOUTS = (("model.safetensors.index.json", "model.safetensors"),
               ("pytorch_model.bin.index.json", "pytorch_model.bin"))

    def __init__(self, path: str):
        self.path = path
        self.opened: set = set()
        self._files: Dict[str, Any] = {}  # shard -> its open file
        for index, single in self.LAYOUTS:
            if os.path.exists(os.path.join(path, index)):
                with open(os.path.join(path, index)) as f:
                    self._weight_map = dict(json.load(f)["weight_map"])
                break
            if os.path.exists(os.path.join(path, single)):
                self._weight_map = {k: single for k in self._shard(single).keys()}
                break
        else:
            raise FileNotFoundError(
                f"no model.safetensors[.index.json] or pytorch_model.bin"
                f"[.index.json] under {path}")
        # GPT-2-era checkpoints (and any save of the BASE model) store keys
        # without the LM wrapper's prefix ('h.0...', 'wte...' instead of
        # 'transformer.h.0...'); llama's drop 'model.'. Alias the prefixed
        # names convert_state_dict asks for onto them.
        self._alias: Dict[str, str] = {}
        for prefix in ("transformer.", "model."):
            if not any(k.startswith(prefix) for k in self._weight_map):
                self._alias.update({prefix + k: k for k in self._weight_map})

    def _shard(self, fname: str):
        handle = self._files.get(fname)
        if handle is None:
            full = os.path.join(self.path, fname)
            handle = (SafetensorsFile(full) if fname.endswith(".safetensors")
                      else torch.load(full, map_location="cpu", weights_only=True,
                                      mmap=True))
            self._files[fname] = handle
        return handle

    def __getitem__(self, key: str) -> torch.Tensor:
        key = self._alias.get(key, key)
        fname = self._weight_map[key]
        self.opened.add(fname)
        shard = self._shard(fname)
        return shard.get_tensor(key) if isinstance(shard, SafetensorsFile) else shard[key]

    def __iter__(self):
        return iter(self._weight_map)

    def __len__(self) -> int:
        return len(self._weight_map)


def read_hf_config(path: str) -> HFConfig:
    """A checkpoint directory's ``config.json`` as an `HFConfig`."""
    with open(os.path.join(path, "config.json")) as f:
        return HFConfig(json.load(f))


def config_from_checkpoint(path: str) -> ModelConfig:
    return config_from_hf(read_hf_config(path))


def load_stage_checkpoint(path: str, cfg: ModelConfig, spec,
                          dtype: torch.dtype = torch.float32, device="cuda",
                          stream: Optional[Tuple[int, Callable[[int, Params], None]]] = None
                          ) -> Params:
    """Exactly one stage's parameters from a local HF checkpoint, on
    `device`, reading only the shards its span touches (never the full
    model). `spec` is a ``models.partition.StageSpec``; `stream` as in
    `convert_state_dict`."""
    sd = LazyCheckpoint(path)
    return convert_state_dict(
        cfg, sd, dtype,
        layer_range=(spec.start, spec.end),
        include_embed=spec.is_first,
        include_head=spec.is_last,
        device=device,
        stream=stream,
    )
