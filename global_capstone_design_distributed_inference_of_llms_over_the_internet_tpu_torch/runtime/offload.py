"""Host-offloaded span execution: layers streamed from pinned host memory.

Port of the JAX package's ``runtime/offload.py``, the reference's CPU
offload (``--use_cpu_offload`` moving each layer to the GPU just in time,
``src/llama_partition.py:188-293``, the first N layers kept there with
``--keep_layers_on_gpu``, ``:209-211``): a stage whose span does not fit
the card keeps its layers in host memory and streams them in, one at a
time, every step.

  * Resident on the card: the first ``keep_resident`` layers, stacked; the
    embedding, final norm and head; and two device SLOTS of one layer each,
    allocated once by the runner, outside any graph's memory pool.
  * In host memory: every later layer, as one flat byte buffer in PINNED
    memory with the layer's leaves as views of it (`PackedLayer`), in the
    engine's layout: the fused ``wqkv`` / ``wgu`` and the quantized leaves
    as they are. A streamed layer therefore runs the same ``int8_dot`` /
    ``nf4_dot`` routes, as often, as a resident one.
  * Streaming, one-way (weights are immutable, nothing goes back): the copy
    of streamed layer i+1 into slot (i+1) % 2 runs on a copy stream while
    layer i computes; it waits for an event recorded after layer i-1's
    compute, which last read that slot, and layer i's compute waits for its
    own copy's event. Each copy is one ``cudaMemcpyAsync`` of the layer's
    buffer (``Tensor.copy_(non_blocking=True)``). The reference issues the
    next ``jax.device_put`` before dispatching the current layer.
  * Inside the captured step: the executor captures the runner's call like
    any other step (``runtime/graphs.py``); the copy stream forks from the
    capturing stream and joins it through the events, so the graph records
    each copy as a memcpy node from the pinned address, and every replay
    streams the layers again with the same overlap. The runner keeps the
    pinned buffers alive as long as the graphs that read them (the graphs
    hold the runner).
  * On the CPU, where no graph and no stream exist, the same function runs
    directly and the copies are plain ``copy_``.

No fallback: on a CUDA device a host layer that is not in pinned memory is
a `ValueError`, and a capture that fails raises as every capture does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ..models.config import ModelConfig
from ..models.partition import StageSpec
from ..models.quant import tree_map
from ..models.transformer import (
    _apply_deep_prompt,
    _stack_depth,
    embed_tokens,
    fuse_gate_up_layers,
    fuse_qkv_layers,
    layer_forward,
    lm_head,
    make_rope,
)

Params = Dict[str, Any]

# Each leaf of a packed layer starts at a multiple of this many bytes.
ALIGN_BYTES = 256

# MoE layers are not streamed: their packed layout and the expert products
# on a streamed slot are a later slice. The executor that owns the offload
# refuses them (`StageExecutor`), before a runner is built.
MOE_REFUSAL = ("host offload of an MoE model is not ported (ROADMAP Queue 1 #4a-ii: "
               "MoE in training and on host-offloaded spans); serve its spans resident")


def _fused(layer: Params) -> Params:
    """The engine's layout of a layer tree: wq|wk|wv as ``wqkv`` and wg|wu
    as ``wgu`` (``models/transformer.py``; exact, and a no-op when fused)."""
    return fuse_gate_up_layers(fuse_qkv_layers(layer))


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


class PackedLayer:
    """One layer's leaves as views of one flat byte buffer `flat` (`tree`
    has the layer's structure, QuantizedTensor and NF4Tensor leaves
    included), so that the whole layer moves in one copy."""

    def __init__(self, flat: torch.Tensor, tree: Params, layout):
        self.flat = flat
        self.tree = tree
        self.layout = layout   # (offset, shape, dtype) a leaf, in tree_map order

    @staticmethod
    def _views(flat: torch.Tensor, tree: Params, layout) -> Params:
        it = iter(layout)

        def view(_):
            off, shape, dtype = next(it)
            n = math.prod(shape) * dtype.itemsize
            return flat[off:off + n].view(dtype).view(shape)

        return tree_map(view, tree)

    @classmethod
    def of(cls, tree: Params, device, pin: bool) -> "PackedLayer":
        """A packed copy of `tree` (tensors on any device) on `device`,
        in pinned memory with `pin`."""
        layout, off = [], 0
        for t in _leaves(tree):
            off = -(-off // ALIGN_BYTES) * ALIGN_BYTES
            layout.append((off, tuple(t.shape), t.dtype))
            off += t.numel() * t.element_size()
        # Zeroed: the padding between leaves is part of every copy.
        flat = torch.zeros(max(off, 1), dtype=torch.uint8, device=device, pin_memory=pin)
        packed = cls(flat, cls._views(flat, tree, layout), layout)
        for dst, src in zip(_leaves(packed.tree), _leaves(tree)):
            dst.copy_(src)
        return packed

    def empty_like(self, device) -> "PackedLayer":
        """A buffer of this layout on `device`, its values unset."""
        flat = torch.empty_like(self.flat, device=device)
        return PackedLayer(flat, self._views(flat, self.tree, self.layout), self.layout)

    @property
    def nbytes(self) -> int:
        return self.flat.numel()


def host_layer(layer: Params, device) -> PackedLayer:
    """One layer (unstacked leaves, on any device) in the engine's fused
    layout, packed into host memory: pinned when `device` is a CUDA device,
    where the runner streams it from."""
    return PackedLayer.of(_fused(layer), "cpu", pin=torch.device(device).type == "cuda")


class OffloadedLayers:
    """A span's layers split for host offload: `resident`, the first
    `keep` stacked (leaves ``[keep, ...]``; keep may be 0) on the device,
    and `host`, one `PackedLayer` a later layer, in host memory."""

    def __init__(self, resident: Params, host: List[PackedLayer]):
        self.resident = resident
        self.host = host
        self.keep = _stack_depth(resident) if resident else 0

    @property
    def num_layers(self) -> int:
        return self.keep + len(self.host)

    def slice(self, a: int, b: int) -> "OffloadedLayers":
        """Layers [a, b) of the span (views and shared host buffers)."""
        k = self.keep
        resident = tree_map(lambda t: t[min(a, k):min(b, k)], self.resident)
        return OffloadedLayers(resident, self.host[max(a - k, 0):max(b - k, 0)])


def offload_layers(layers, keep: int, device) -> OffloadedLayers:
    """`layers` for host offload: an `OffloadedLayers` (built a layer at a
    time by the loader, ``main._stage_params``) with its resident part in
    the fused layout, or a stacked tree (on any device) split here: the
    first `keep` layers fused on `device`, each later one packed into host
    memory, one at a time. The loader's form never holds the span on the
    device; a stacked tree already does (the reference's order: load, then
    move to the host)."""
    device = torch.device(device)
    if isinstance(layers, OffloadedLayers):
        if min(max(keep, 0), layers.num_layers) != layers.keep:
            raise ValueError(f"offloaded layers keep {layers.keep} resident, the "
                             f"executor was asked for {keep}")
        return OffloadedLayers(_fused(layers.resident), layers.host)
    n = _stack_depth(layers)
    k = min(max(keep, 0), n)
    resident = _fused(tree_map(lambda t: t[:k].to(device), layers))
    host = [host_layer(tree_map(lambda t, i=i: t[i], layers), device) for i in range(k, n)]
    return OffloadedLayers(resident, host)


class OffloadedSpanRunner:
    """The step of an offloaded (sub)span, with the call signature of the
    executor's step, ``step(params_ignored, x, k_caches, v_caches,
    cache_len, prompts=None) -> (out, k_caches, v_caches)``: the runner
    owns its weights, so the params argument is ignored.

    `params` is a stage tree (on `device` but for the layers) whose
    ``layers`` is an `OffloadedLayers`, taken as split, or a stacked tree,
    of which the first `keep_resident` stay on `device` (`offload_layers`)."""

    def __init__(self, cfg: ModelConfig, spec: StageSpec, params: Params, *,
                 keep_resident: int = 0, device):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        layers = params.get("layers")
        if layers is None:
            layers = OffloadedLayers({}, [])
        elif not isinstance(layers, OffloadedLayers):
            layers = offload_layers(layers, keep_resident, self.device)
        self.layers = layers
        self.keep_resident = self.layers.keep
        # The embedding, final norm and head stay resident (the reference
        # pins the norm and head too, llama_partition.py:350-354).
        self.aux: Params = {k: v for k, v in params.items() if k != "layers"}
        cuda = self.device.type == "cuda"
        host = self.layers.host
        if cuda:
            unpinned = [i for i, h in enumerate(host) if not h.flat.is_pinned()]
            if unpinned:
                raise ValueError(f"offloaded layers {unpinned} are not in pinned host "
                                 "memory: the copy engine streams from pinned memory only")
        self.slots = [host[0].empty_like(self.device) for _ in range(min(2, len(host)))]
        self._copy_stream: Optional[torch.cuda.Stream] = None
        if cuda and host:
            self._copy_stream = torch.cuda.Stream(self.device)
            for slot in self.slots:
                # The copy stream writes the slots: their memory is not
                # handed back while a copy may still be in flight.
                slot.flat.record_stream(self._copy_stream)

    @property
    def streamed_bytes(self) -> int:
        """Bytes copied to the device a call: every streamed layer's."""
        return sum(h.nbytes for h in self.layers.host)

    def _layer(self, lp: Params, h: torch.Tensor, rope, k_all, v_all, li: int,
               cache_len, prompts) -> torch.Tensor:
        if prompts is not None:
            h = _apply_deep_prompt(h, prompts[li], cache_len)
        return layer_forward(self.cfg, lp, h, rope, k_all[li], v_all[li], cache_len)

    def _copy(self, i: int, freed) -> Optional[torch.cuda.Event]:
        """Issue streamed layer i's copy into slot i % 2, after the compute
        that last read that slot (`freed`'s event); its ready event. On
        the CPU a plain copy, done when this returns (None)."""
        slot, src = self.slots[i % 2], self.layers.host[i]
        copy = self._copy_stream
        if copy is None:
            slot.flat.copy_(src.flat)
            return None
        with torch.cuda.stream(copy):
            if freed[i % 2] is not None:
                copy.wait_event(freed[i % 2])
            slot.flat.copy_(src.flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy)
        return ready

    def _stack(self, h: torch.Tensor, positions: torch.Tensor, k_all, v_all, cache_len,
               prompts, ready, freed) -> torch.Tensor:
        """``stack_forward`` over the span: the resident layers, then each
        streamed layer from its slot, the copy of the next one in flight."""
        rope = make_rope(self.cfg, positions)
        host = self.layers.host
        resident = self.layers.resident
        for r in range(self.keep_resident):
            h = self._layer(tree_map(lambda a: a[r], resident), h, rope, k_all, v_all, r,
                            cache_len, prompts)
        for i in range(len(host)):
            # Layer i+1's copy overlaps layer i's compute.
            nxt = self._copy(i + 1, freed) if i + 1 < len(host) else None
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            h = self._layer(self.slots[i % 2].tree, h, rope, k_all, v_all,
                            self.keep_resident + i, cache_len, prompts)
            if self._copy_stream is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                freed[i % 2] = done
            ready = nxt
        return h

    def __call__(self, _params_ignored, x, k_all, v_all, cache_len, prompts=None):
        """``stage_forward`` over the span, its layers streamed: the same
        operations in the same order as the resident step, so the same
        bits. `prompts` ([span, pre_seq, D]) adds each layer's deep prompt
        at its entry, resident or streamed."""
        cfg, spec = self.cfg, self.spec
        # An event after the compute that last read each slot.
        freed: List[Optional[torch.cuda.Event]] = [None, None]
        ready = None
        if self.layers.host:
            if self._copy_stream is not None:
                # Fork: the copies come after everything the compute stream
                # holds, the previous call's reads of the slots included.
                self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
            # The first streamed layer's copy overlaps the resident layers.
            ready = self._copy(0, freed)
        t = x.shape[1]
        positions = cache_len + torch.arange(t, device=x.device)[None, :]
        h = embed_tokens(cfg, self.aux["embed"], x, positions) if spec.is_first else x
        if spec.num_layers > 0:
            h = self._stack(h, positions, k_all, v_all, cache_len, prompts, ready, freed)
        if spec.is_last:
            h = lm_head(cfg, self.aux, h)
        return h, k_all, v_all
