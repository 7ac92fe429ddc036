"""Per-stage executor: the server-side compute path.

Port of the plain engine of the JAX package's ``runtime/executor.py``:
manage per-session KV leases, run the stage's layer span, and either return
the next hidden states (intermediate stage) or sample a token (final stage,
with the sampling params and recent-token window taken from each request).

Replay semantics as in the reference: a prefill clears any existing session
cache; a decode with no cached session and ``is_replay=True`` is treated as
a prefill chunk; a decode with no cached session otherwise is a hard error.

As in the reference, each prefill chunk and decode step is padded to a
sequence bucket and run by one step per (seq bucket, cache bucket): on the
card a CUDA graph, captured at its first use or in `warmup` and replayed
from then on (``runtime/graphs.py``), the counterpart of the reference's
jitted step; on the CPU the same step function runs directly. Right-padded
chunks are safe: padded queries only produce output rows, trimmed here,
and padded cache rows sit past ``cache_len``, masked until a real token
overwrites them. A chunk whose bucket would reach past the lease runs at
its exact length instead (one more graph at the tail of a session).

Given ``prefix_cache_bytes``, a prefill marked with ``prefix_len`` reuses
the stored KV of its leading grains (``runtime/prefix_cache.py``, the
reference's ``executor.py:544-661``): the chain's rows are copied into the
fresh lease and only the tail runs, as a chunk at ``cache_len = p``.

Speculative decoding as in the reference (``executor.py:101-139``,
``:721-760``): a step that carries ``start_from_position`` first rewinds
the session to it (the previous round's rejected overhang); on the final
stage a step with ``draft_tokens`` (T = K + 1 positions: the last accepted
token and the K drafts) reads the logits of all T rows, verifies the
drafts (`verify_drafts_from_logits`) and rewinds its own cache past the
rejected tail. Greedy verification is the argmax of the raw logits, read
back in one sync; sampled verification is the captured sampler's verify
form (``runtime/graphs.py``, ``ops.sampling.speculative_verify_rows``):
every position's target, uniform, residual and draw on the device, one
`sample_draw` over the T rows, one sync.

Beam search as in the reference (``executor.py:504-531``, ``:638-650``):
a decode step with ``hypo_ids`` first reorders the session's KV rows, row
j continuing from row ``hypo_ids[j]`` (range-checked on the host), in place
in the lease's buffers (`KVHandle.reorder`), or, when the step's batch is
another one (the first beam step grows a batch-1 prefill to num_beams
rows), by moving the session to a buffer pair of the new shape with the
rows gathered into it (`KVArena.resize_batch`; a full arena is a
`StageExecutionError`, so the client fails over). On the final stage a
step with ``num_logprobs > 0`` answers each row's top-N candidates of the
float32 log-softmax of its last position instead of a token, from the
captured top-N form of the sampler, read back in one sync.

Inference-time deep prompts as in the reference (``executor.py:361-393``,
``:467-477``; Petals' ``block_functions.py:57-65,171-226``): a request
with ``prompts`` ([span layers, pre_seq, D]) runs the prompt form of the
span's step, which adds each layer's rows at absolute positions < pre_seq
at the layer's entry (``models.transformer._apply_deep_prompt``), through
every chunk of a chunked prefill. On the card it is its own graph, keyed
by pre_seq and the prompts' dtype beside the plain key, its prompts a
static input copied in before each replay; the plain step keeps its
graphs. Such a prefill skips the prefix store.

Fine-tuning as in the reference (``executor.py:764-894``, Petals'
``rpc_forward`` / ``rpc_backward``): `train_forward` runs blocks [a, b) of
the span cache-free (``models.transformer.stack_forward_train``) with the
request's deep prompts and LoRA adapters, padded to a sequence bucket, and
returns the hidden states; `backward` re-forwards the same blocks from the
input it is given, with each layer checkpointed, and returns the
gradients of the input, the prompts and the adapters (``torch.autograd
.grad``; zero cotangents on the padding). Nothing is kept between the two:
the weights are frozen and the server is stateless. LoRA on a quantized
span is refused, as in the reference. These steps run eagerly: no graph
is captured for them.

Host offload as in the reference (``executor.py:238-251``, ``:338-345``;
``--use_cpu_offload`` / ``--keep_layers_on_gpu``): with ``offload`` set
each sub-span's step is an ``OffloadedSpanRunner`` (``runtime/offload.py``)
that keeps the first ``keep_layers_resident`` layers on the device and
streams the rest from pinned host memory into two device slots inside the
captured step; the executor keeps no device copy of the streamed layers.
Deep prompts, beam reorders, batch growth, speculative verification and
the prefix store work on the arena and run unchanged. Two differences:
the span's layers arrive already split (`runtime.offload.OffloadedLayers`,
built a layer at a time by ``main._stage_params``) where the reference
loads the span onto the device and then moves it to the host; and the
training verbs are refused on an offloaded span with a
`StageExecutionError` naming offload (the reference runs them over its
host copy of the span).

Differences from the reference's engine: tensor parallelism and burst
decode (the batched engine's) are not ported: a request that asks for one
is refused with a `StageExecutionError` naming its field (the TCP server
sends it back as a ``kind: "stage"`` error frame). A push chain's
``next_servers`` is the transport's business (``runtime/net.py``,
``runtime/transport.py``), above the engine, as in the reference: the
executor computes its own span and ignores them.

A float activation computes in the dtype it arrives in, as in the
reference: after a TCP hop that is the float32 the wire decodes to, so a
bfloat16 model's stages behind ``--mode serve`` compute in float32 (bf16
weights times float32 activations). Given ``act_dtype``, an arrival is
cast to it instead: ``main``'s in-process executors pass the model's
``--dtype``, so their hops hand bfloat16 along unchanged.

The final stage samples with the captured sampler (``runtime/graphs.py``
`Sampler`): the request's window and knobs go to the device in one copy,
every row's token comes back in one read.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..models.partition import (
    ROLE_FULL,
    ROLE_LAST,
    ROLE_SEGMENT,
    ROLE_STAGE0,
    StageSpec,
    stage_forward,
)
from ..models.quant import NF4Tensor, QuantizedTensor, tree_map
from ..models.transformer import fuse_qkv_params, stack_forward_train
from ..ops.attention import check_cache_write
from ..ops.sampling import SamplingParams
from ..telemetry import events as _ev
from .errors import register as _catalog
from .graphs import Sampler, StepGraphs
from .kv_cache import AllocationFailed, KVArena, KVHandle, round_to_bucket
from .messages import BackwardRequest, BackwardResponse, StageRequest, StageResponse
from .offload import MOE_REFUSAL, OffloadedLayers, OffloadedSpanRunner, offload_layers
from .prefix_cache import PrefixStore, chain_digests, grain_blocks

logger = logging.getLogger(__name__)

SEQ_BUCKETS = (1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
# warmup(): a prefill of the first length, then steps of the others, in a
# session of this capacity (on the card, each captures its graph).
WARMUP_SEQ_LENS = (16, 8, 1)
WARMUP_MAX_LENGTH = 128


@_catalog
class StageExecutionError(RuntimeError):
    """Server-side hard error (e.g. decode without a cached session)."""


def _sample_rows(logits: torch.Tensor, t_real: int, req: StageRequest,
                 sampler: Sampler) -> list:
    """Final-stage sampling from the last real token's logits, per batch
    row. logits: [B, T, V] -> list of B token ids. Row 0 draws with
    ``PRNGKey(step_seed)`` and row i with ``fold_in(base, i)``, the
    reference's key schedule (``executor.py:160-178``), so row 0 of a batch
    draws what a batch-1 request would. The recent-token window (the
    request's ``generated_tokens``) is per session, shared by the rows.
    Sampled rows go through `sampler` (the executor's); greedy rows
    are the argmax alone and build no window. All rows' tokens are read
    back at once: the call's one host sync."""
    last = logits[:, t_real - 1]
    sp = req.sampling
    if sp.greedy:
        return torch.argmax(last, dim=-1).tolist()
    return sampler(last.float(), req.generated_tokens, sp, req.step_seed)


def greedy_verify(preds, drafts) -> Tuple[Tuple[int, ...], int]:
    """Greedy verification on the host: accept while draft i equals
    ``preds[i]`` (the argmax of row i), then that row's argmax."""
    n_acc = 0
    while n_acc < len(drafts) and preds[n_acc] == int(drafts[n_acc]):
        n_acc += 1
    return tuple(preds[:n_acc + 1]), n_acc


def verify_drafts_from_logits(logits2d: torch.Tensor, req: StageRequest,
                              sampler: Sampler) -> Tuple[Tuple[int, ...], int]:
    """Final-stage verification of one session's drafts. logits2d: [T, V]
    for the T = K + 1 positions [last accepted, d_1..d_K], row i predicting
    the token after position i. Returns (tokens, n_accepted), ``len(tokens)
    == n_accepted + 1``. Shared by the session executor and the batched
    adapter, so both engines verify alike.

    Greedy: accept while d_{i+1} equals the argmax of row i (the raw
    logits, as the reference applies greedy before the penalties), then
    that argmax: the tokens a non-speculative greedy run gives. Sampled:
    `sampler.verify`, the device form of the reference's rejection
    sampling (accept d_i with probability p_i(d_i), else a draw from the
    residual), keyed ``PRNGKey(step_seed)``, the window the request's
    ``generated_tokens``. One host sync either way."""
    if req.sampling.greedy:
        return greedy_verify(torch.argmax(logits2d, dim=-1).tolist(), req.draft_tokens)
    return sampler.verify(logits2d[None].float(), [(
        req.generated_tokens, req.sampling, req.step_seed, req.draft_tokens)])[0]


def _unported_field(req: StageRequest) -> Optional[str]:
    """The first request field this executor does not implement that the
    request sets, or None."""
    return "burst_len" if req.burst_len > 0 else None


class StageExecutor:
    """One pipeline stage's compute engine (one 'server' in reference terms)."""

    def __init__(self, cfg: ModelConfig, spec: StageSpec, params: Dict[str, Any],
                 arena: Optional[KVArena] = None, *, device,
                 max_cache_bytes: int = 1 << 30,
                 cache_dtype: torch.dtype = torch.float32,
                 peer_id: str = "local",
                 max_chunk_bytes: int = 256 * 1024 * 1024,
                 act_dtype: Optional[torch.dtype] = None,
                 prefix_cache_bytes: int = 0,
                 offload: bool = False,
                 keep_layers_resident: int = 0):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        # Host offload (--use_cpu_offload / --keep_layers_on_gpu): the span's
        # layers past the first keep_layers_resident live in pinned host
        # memory and stream through the device a layer at a time.
        self.offload = offload
        self.keep_layers_resident = max(keep_layers_resident, 0)
        layers = params.get("layers")
        if offload and cfg.is_moe:
            raise NotImplementedError(MOE_REFUSAL)
        if offload and layers is not None:
            self.params = dict(params, layers=offload_layers(
                layers, self.keep_layers_resident, self.device))
        elif isinstance(layers, OffloadedLayers):
            raise ValueError("offloaded layers need an executor with offload=True")
        else:
            # Engine-side fused layout: one wqkv and one wgu matmul per layer.
            self.params = fuse_qkv_params(params)
        # The dtype float activations are cast to on arrival (None: as they
        # arrive, float32 after a TCP hop, as the reference computes them).
        self.act_dtype = act_dtype
        self.peer_id = peer_id
        self.max_chunk_bytes = max_chunk_bytes
        self.cache_dtype = cache_dtype
        # Forward calls that ran to the end (prefill, decode and replay).
        self.requests_served = 0
        # The prompt-prefix KV store (None: off, the default).
        self.prefix_store = (PrefixStore(prefix_cache_bytes)
                             if prefix_cache_bytes > 0 else None)
        self.arena = arena or KVArena(
            num_layers=max(spec.num_layers, 1), num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, max_bytes=max_cache_bytes,
            device=self.device, dtype=cache_dtype)
        # The captured steps; a graph goes when its lease buffers do.
        self.graphs = StepGraphs(self.device)
        # The captured sampler of the final stage.
        self.sampler = Sampler(self.device)
        self.arena.add_release_hook(self.graphs.drop_slot)
        # Sub-span execution units keyed by relative layer range (a, b): a
        # request may cover only part of the loaded span.
        self._subspans: Dict[tuple, tuple] = {}
        self._get_subspan(0, spec.num_layers)

    def _get_subspan(self, a: int, b: int):
        entry = self._subspans.get((a, b))
        if entry is not None:
            return entry
        spec = self.spec
        if a == 0 and b == spec.num_layers:
            sub_spec, sub_params = spec, self.params
        else:
            first = spec.is_first and a == 0
            last = spec.is_last and b == spec.num_layers
            role = (ROLE_FULL if first and last else ROLE_STAGE0 if first
                    else ROLE_LAST if last else ROLE_SEGMENT)
            sub_spec = StageSpec(spec.index, role, spec.start + a, spec.start + b)
            sub_params = {}
            if "layers" in self.params:
                layers = self.params["layers"]
                sub_params["layers"] = (layers.slice(a, b) if isinstance(layers, OffloadedLayers)
                                        else tree_map(lambda x: x[a:b], layers))
            if first and "embed" in self.params:
                sub_params["embed"] = self.params["embed"]
            if last:
                for k in ("final_norm", "lm_head"):
                    if k in self.params:
                        sub_params[k] = self.params[k]
                if self.cfg.tie_word_embeddings and "embed" in self.params:
                    sub_params["embed"] = {**sub_params.get("embed", {}),
                                           "wte": self.params["embed"]["wte"]}
        cfg = self.cfg
        if self.offload:
            # The runner owns the sub-span's weights: its split of the
            # layers, its slots and its copy stream.
            step = OffloadedSpanRunner(cfg, sub_spec, sub_params,
                                       keep_resident=self.keep_layers_resident,
                                       device=self.device)
        else:
            def step(params, x, k_cache, v_cache, cache_len, prompts=None):
                return stage_forward(cfg, sub_spec, params, x, k_cache, v_cache,
                                     cache_len, prompts=prompts)

        entry = (sub_spec, sub_params, step)
        self._subspans[(a, b)] = entry
        return entry

    def _resolve_range(self, req: StageRequest) -> tuple:
        """Absolute request block range -> relative (a, b) within the span."""
        a = 0 if req.start_block is None else req.start_block - self.spec.start
        b = (self.spec.num_layers if req.end_block is None
             else req.end_block - self.spec.start)
        if not (0 <= a < b <= max(self.spec.num_layers, 1)):
            raise StageExecutionError(
                f"requested blocks [{req.start_block},{req.end_block}) outside "
                f"served span [{self.spec.start},{self.spec.end})")
        return a, b

    # ------------------------------------------------------------------
    # Session / cache management
    # ------------------------------------------------------------------

    def _allocate(self, req: StageRequest, num_layers: int, batch: int) -> KVHandle:
        """Arena lease as a STAGE error, so a full arena is retryable
        client-side rather than a crash."""
        try:
            handle = self.arena.allocate(req.session_id, req.max_length,
                                         num_layers=num_layers, batch=batch)
        except AllocationFailed as exc:
            raise StageExecutionError(str(exc)) from exc
        _ev.emit("server_session_open", session_id=req.session_id,
                 peer=self.peer_id, max_length=req.max_length,
                 replay=req.is_replay)
        return handle

    def _session_cache(self, req: StageRequest, num_layers: int,
                       batch: int = 1) -> KVHandle:
        handle = self.arena.get(req.session_id)
        if req.is_prefill:
            if handle is not None:
                self.arena.free(req.session_id)
            handle = self._allocate(req, num_layers, batch)
        elif handle is None:
            if req.is_replay:
                handle = self._allocate(req, num_layers, batch)
            else:
                raise StageExecutionError(
                    f"session {req.session_id}: decode step without KV cache "
                    "and not a replay")
        if (not req.is_prefill and handle.cache_len != req.cur_len
                and not req.is_replay and req.start_from_position is None):
            # A rewinding step (cur_len == start_from_position < cache_len)
            # is no mismatch: forward() adopts the client's position.
            logger.warning("session %s: past-len mismatch client=%d server=%d; "
                           "trusting server", req.session_id, req.cur_len,
                           handle.cache_len)
        return handle

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def forward(self, req: StageRequest) -> StageResponse:
        """Run one step of this stage for one session."""
        field = _unported_field(req)
        if field is not None:
            raise StageExecutionError(
                f"request field {field!r} is not ported: this stage serves "
                "plain prefill and decode steps")
        a, b = self._resolve_range(req)
        sub_spec, sub_params, step = self._get_subspan(a, b)
        prompts = None
        if req.prompts is not None:
            # Inference-time deep prompt tuning: the client's per-block
            # prompts are injected at every block entry, every step.
            prompts = req.prompts
            if prompts.ndim != 3 or prompts.shape[0] != b - a:
                raise StageExecutionError(
                    f"prompts shape {tuple(prompts.shape)} does not cover "
                    f"the requested {b - a} blocks (want [span, pre, D])")
            prompts = prompts.to(self.device, non_blocking=True)
        # An id tensor from the host crosses without a host sync.
        x = req.hidden.to(self.device, non_blocking=True)
        if x.is_floating_point() and self.act_dtype not in (None, x.dtype):
            x = x.to(self.act_dtype)
        want_ndim = 2 if sub_spec.is_first else 3
        if x.ndim != want_ndim:
            raise StageExecutionError(
                f"stage {self.spec.index} expects ndim={want_ndim}, got {tuple(x.shape)}")
        handle = self._session_cache(req, num_layers=max(b - a, 1), batch=x.shape[0])
        if handle.k.shape[0] != max(b - a, 1):
            raise StageExecutionError(
                f"session {req.session_id} was allocated for {handle.k.shape[0]} "
                f"layers but the request covers {b - a}")
        t_real = req.seq_len
        if x.shape[1] != t_real:
            raise StageExecutionError(f"seq_len {t_real} != tensor T {x.shape[1]}")
        if (sub_spec.is_last and req.draft_tokens is not None
                and t_real != len(req.draft_tokens) + 1):
            raise StageExecutionError(
                f"speculative step carries {t_real} positions for "
                f"{len(req.draft_tokens)} drafts (want K+1)")
        if sub_spec.is_last and req.num_logprobs > self.cfg.vocab_size:
            raise StageExecutionError(
                f"num_logprobs {req.num_logprobs} exceeds the vocabulary "
                f"({self.cfg.vocab_size})")
        if req.start_from_position is not None and not req.is_prefill:
            # Session rewind: drop the rows past the client's position (the
            # previous speculative round's rejected overhang).
            try:
                handle.rewind(req.start_from_position)
            except ValueError as exc:
                raise StageExecutionError(str(exc)) from exc
        if req.hypo_ids is not None and not req.is_prefill:
            handle = self._reorder(req, handle, x.shape[0])
        if handle.k.shape[1] != x.shape[0]:
            raise StageExecutionError(
                f"session {req.session_id} holds KV for batch {handle.k.shape[1]}, "
                f"request batch is {x.shape[0]}")
        handle.admit(t_real)

        skip, pfx_outs, pfx_register = 0, [], []
        if (self.prefix_store is not None and req.is_prefill and req.prefix_len > 0
                and prompts is None):
            skip, pfx_outs, pfx_register = self._reuse_prefix(req, x, handle, a, b,
                                                              sub_spec.is_last)

        # Chunked prefill: an oversized request runs as byte-bounded chunks
        # over the same session cache (identical numerics: each chunk
        # attends causally to everything already written). Intermediate
        # stages concatenate chunk outputs; the last samples from the last.
        chunk = self._max_chunk_tokens(x.shape[0])
        with_prompts = () if prompts is None else (prompts,)
        outs = []
        for off in range(skip, t_real, chunk):
            n = min(chunk, t_real - off)
            outs.append(self._dispatch_chunk((a, b), step, sub_params,
                                             x[:, off:off + n], handle, n, *with_prompts))
        self.requests_served += 1

        if pfx_register:
            # The grains the chain did not cover: KV rows from the lease
            # (written by the chunks), and off the final stage the output
            # rows a later hit forwards. Clones: an entry outlives the
            # lease, whose buffers the arena hands to the next session.
            full = None
            if not sub_spec.is_last:
                full = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
                outs = [full]
            for key, g0, g1 in pfx_register:
                self.prefix_store.put(
                    key, handle.k[:, :, g0:g1].clone(), handle.v[:, :, g0:g1].clone(),
                    None if full is None else full[:, g0 - skip:g1 - skip].clone())

        if sub_spec.is_last:
            if req.draft_tokens is not None:
                return self._verify_drafts(req, outs, handle)
            if req.num_logprobs > 0:
                # Beam mode: each row's top-N candidates, no sampling.
                top, logp = self.sampler.top_logprobs(outs[-1][:, -1], req.num_logprobs)
                return StageResponse(session_id=req.session_id, cache_len=handle.cache_len,
                                     top_tokens=top, top_logprobs=logp)
            tokens = _sample_rows(outs[-1], outs[-1].shape[1], req, self.sampler)
            return StageResponse(
                session_id=req.session_id, token_id=tokens[0],
                token_ids=tuple(tokens) if len(tokens) > 1 else None,
                cache_len=handle.cache_len)
        # On a hit the next hop still needs every row: the stored prefix
        # rows go before the computed ones.
        outs = pfx_outs + outs
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return StageResponse(session_id=req.session_id, hidden=out,
                             cache_len=handle.cache_len)

    def _reorder(self, req: StageRequest, handle: KVHandle, batch: int) -> KVHandle:
        """The beam reorder before the step (petals ``backend.py:154-158``):
        hypothesis j continues from KV row ``hypo_ids[j]``. The ids are
        range-checked on the host first: on the card an out-of-range
        `index_select` is a device-side assert that ends the process's CUDA
        context (the reference checks because ``jnp.take`` clamps). A step
        of another batch (``(0,) * nb`` grows a batch-1 prefill) moves the
        session to a buffer pair of that shape, the rows gathered into it;
        an arena too full to grow is a stage error, so the client fails
        over to a replica that can hold the rows."""
        ids = tuple(int(i) for i in req.hypo_ids)
        if len(ids) != batch:
            raise StageExecutionError(f"hypo_ids has {len(ids)} rows, batch is {batch}")
        old_batch = handle.k.shape[1]
        if ids and (min(ids) < 0 or max(ids) >= old_batch):
            raise StageExecutionError(
                f"hypo_ids {ids} out of range for KV batch {old_batch}")
        if batch == old_batch:
            handle.reorder(ids)
            return handle
        try:
            return self.arena.resize_batch(req.session_id, batch, ids)
        except AllocationFailed as exc:
            raise StageExecutionError(str(exc)) from exc

    def _verify_drafts(self, req: StageRequest, outs, handle: KVHandle) -> StageResponse:
        """The final stage's speculative verification over the logits of
        all K + 1 rows of the step; the session's cache then rewinds to
        ``cur_len + n_accepted + 1``, past the rejected drafts, and the
        stages before this one drop theirs through the next step's
        ``start_from_position``."""
        logits = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        tokens, n_acc = verify_drafts_from_logits(logits[0], req, self.sampler)
        handle.rewind(req.cur_len + n_acc + 1)
        return StageResponse(session_id=req.session_id, tokens=tokens,
                             n_accepted=n_acc, cache_len=handle.cache_len)

    def _reuse_prefix(self, req: StageRequest, x: torch.Tensor, handle: KVHandle,
                      a: int, b: int, is_last: bool):
        """The store's part of a prefill marked ``prefix_len``: hash
        ``min(prefix_len, T - 1) // grain`` grains of the arriving rows (the
        clamp leaves the final stage a computed row to sample from) under
        the coordinates (blocks, batch, x dtype, cache dtype, model), copy
        the longest stored chain's KV into the lease's leading rows and
        advance the lease past it. The host tensor is hashed where the
        request carries one (behind TCP); a device arrival's prefix rows
        are read to the host once. Returns (the rows reused, the chain's
        stored output rows, (digest, first row, end row) of each grain to
        register)."""
        grain = self.prefix_store.grain
        n_grains = min(req.prefix_len, req.seq_len - 1) // grain
        if n_grains <= 0:
            return 0, [], []
        coords = (self.spec.start + a, self.spec.start + b, x.shape[0], str(x.dtype),
                  str(self.cache_dtype), req.model)
        src = req.hidden if req.hidden.device.type == "cpu" else x
        keys = chain_digests(grain_blocks(src, n_grains, grain), coords)
        chain = self.prefix_store.lookup_chain(keys, need_out=not is_last)
        p = len(chain) * grain
        if chain:
            for lease, part in ((handle.k, "k"), (handle.v, "v")):
                segs = [getattr(e, part) for e in chain]
                lease[:, :, :p].copy_(segs[0] if len(segs) == 1 else torch.cat(segs, dim=2))
            handle.advance(p)
        return (p, [e.out for e in chain if e.out is not None],
                [(keys[g], g * grain, (g + 1) * grain) for g in range(len(chain), n_grains)])

    def _dispatch_chunk(self, span: tuple, step, sub_params, x: torch.Tensor,
                        handle: KVHandle, n: int,
                        prompts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ONE bucket-padded step of n real tokens against the session
        cache (the reference's ``_dispatch_chunk``, ``executor.py:690``):
        advances the cache and returns the output trimmed to n rows. With
        `prompts` the step is the prompt form, its graph keyed by pre_seq
        and the prompts' dtype too; bucket-padded tail rows may get the
        injection as well, harmless as in the reference: their outputs are
        trimmed and their KV rows sit past ``cache_len``."""
        tb = round_to_bucket(n, SEQ_BUCKETS)
        if handle.cache_len + tb > handle.bucket_len:
            # Padding would write past the lease: run the exact length (its
            # own graph), as the reference pays one more compile here.
            tb = n
        check_cache_write(handle.cache_len, tb, handle.bucket_len)
        if tb != n:
            x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, tb - n))
        key = (span, tb, handle.bucket_len, handle.slot, x.dtype)
        with_prompts = ()
        if prompts is not None:
            key += (prompts.shape[1], prompts.dtype)
            with_prompts = (prompts,)
        out = self.graphs.run(
            key, handle.slot,
            lambda xs, k, v, cache_len, *pr: step(sub_params, xs, k, v, cache_len, *pr)[0],
            x, handle.k, handle.v, handle.cache_len, n, *with_prompts)
        handle.advance(n)
        return out

    def _max_chunk_tokens(self, batch: int) -> int:
        """Tokens per prefill chunk: the byte budget over the per-token
        activation estimate (batch x hidden x fp32 x span layers), floored
        at 16 and aligned down to a sequence bucket."""
        per_token = batch * self.cfg.hidden_size * 4 * max(self.spec.num_layers, 1)
        est = max(16, min(self.max_chunk_bytes // max(per_token, 1), SEQ_BUCKETS[-1]))
        return max(b for b in SEQ_BUCKETS if b <= est)

    # ------------------------------------------------------------------
    # Fine-tuning (the reference's rpc_forward / rpc_backward)
    # ------------------------------------------------------------------

    def _train_fns(self, a: int, b: int):
        """(forward, backward) over blocks [a, b) of the loaded span, made
        once per range: views of the span's stacked weights (no copy),
        frozen; the gradients flow to the input, the prompts and the LoRA
        adapters."""
        key = ("train", a, b)
        entry = self._subspans.get(key)
        if entry is not None:
            return entry
        cfg = self.cfg
        layers = self.params["layers"]
        if not (a == 0 and b == self.spec.num_layers):
            layers = tree_map(lambda w: w[a:b], layers)

        def run(x, prompts, lora, lora_scale, remat):
            bsz, t = x.shape[:2]
            positions = torch.arange(t, device=x.device)[None, :].expand(bsz, t)
            return stack_forward_train(cfg, layers, x, positions, remat=remat,
                                       prompts=prompts, lora=lora, lora_scale=lora_scale)

        def fwd(x, prompts, lora, lora_scale):
            with torch.no_grad():
                return run(x, prompts, lora, lora_scale, remat=False)

        def bwd(x, prompts, lora, lora_scale, grad_out):
            x = x.detach().requires_grad_()
            prompts = None if prompts is None else prompts.detach().requires_grad_()
            lora = None if lora is None else {
                t: {k: v.detach().requires_grad_() for k, v in ab.items()}
                for t, ab in lora.items()}
            wrt = [x] + ([] if prompts is None else [prompts]) + (
                [] if lora is None else [lora[t][k] for t in sorted(lora) for k in ("a", "b")])
            with torch.enable_grad():
                out = run(x, prompts, lora, lora_scale, remat=True)
                grads = torch.autograd.grad(out, wrt, grad_out.to(out.dtype),
                                            allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)]
            gx, rest = grads[0], grads[1:]
            gp = None
            if prompts is not None:
                gp, rest = rest[0], rest[1:]
            gl = None if lora is None else {
                t: {"a": rest[2 * i], "b": rest[2 * i + 1]} for i, t in enumerate(sorted(lora))}
            return gx, gp, gl

        entry = (fwd, bwd)
        self._subspans[key] = entry
        return entry

    def _train_args(self, req) -> tuple:
        """The training verbs' shared checks, with the reference's messages:
        (a, b, x, prompts, lora) on the device. x is cast to ``act_dtype``
        as a forward's arrival is. An offloaded span refuses them: its
        streamed layers are not on the device outside the captured step."""
        if self.offload:
            raise StageExecutionError(
                "training verbs (train_forward / backward) are not served on a "
                "host-offloaded span (--use_cpu_offload); serve this span resident "
                "to fine-tune against it")
        if self.cfg.is_moe:
            raise StageExecutionError(
                "training verbs (train_forward / backward) are not served on an MoE "
                "span (ROADMAP Queue 1 #4a-ii: MoE in training and on host-offloaded "
                "spans)")
        a, b = self._resolve_range(req)
        x = req.hidden.to(self.device, non_blocking=True)
        if x.ndim != 3 or not x.is_floating_point():
            raise StageExecutionError(
                f"training forward expects hidden [B, T, D], got {tuple(x.shape)}")
        if self.act_dtype not in (None, x.dtype):
            x = x.to(self.act_dtype)
        if x.shape[1] != req.seq_len:
            raise StageExecutionError(f"seq_len {req.seq_len} != tensor T {x.shape[1]}")
        prompts = None if req.prompts is None else req.prompts.to(self.device)
        if prompts is not None and (prompts.ndim != 3 or prompts.shape[0] != b - a):
            raise StageExecutionError(
                f"prompts cover {prompts.shape[0] if prompts.ndim else 0} layers, "
                f"request spans {b - a}")
        lora = req.lora or None
        if lora:
            attn = self.params["layers"].get("attn", {})
            if any(isinstance(w, (QuantizedTensor, NF4Tensor)) for w in attn.values()):
                # The merge adds deltas to dense weights; a --quant span's
                # are packed: a clean stage error, not a TypeError the
                # client would take for a dead peer.
                raise StageExecutionError(
                    "LoRA training is unsupported on a quantized span "
                    "(serve this span unquantized to fine-tune against it)")
            for t, ab in lora.items():
                if t not in attn and not ("wqkv" in attn and t in ("wq", "wk", "wv")):
                    raise StageExecutionError(
                        f"LoRA target {t!r} not in this span's attn params")
                for leaf in ("a", "b"):
                    arr = ab.get(leaf)
                    if arr is None or arr.shape[0] != b - a:
                        raise StageExecutionError(
                            f"LoRA {t}/{leaf} covers "
                            f"{None if arr is None else arr.shape[0]} layers, "
                            f"request spans {b - a}")
            lora = {t: {k: v.to(self.device) for k, v in ab.items()} for t, ab in lora.items()}
        return a, b, x, prompts, lora

    def train_forward(self, req: StageRequest) -> StageResponse:
        """Cache-free forward of the span's BLOCKS only (no head, no
        sampling): the training ``rpc_forward``. The sequence is padded to a
        bucket, as the reference pads it to bound its compiles."""
        a, b, x, prompts, lora = self._train_args(req)
        fwd, _ = self._train_fns(a, b)
        t_real = req.seq_len
        tb = round_to_bucket(t_real, SEQ_BUCKETS)
        if tb != t_real:
            x = F.pad(x, (0, 0, 0, tb - t_real))
        out = fwd(x, prompts, lora, float(req.lora_scale))
        self.requests_served += 1
        return StageResponse(session_id=req.session_id, hidden=out[:, :t_real], cache_len=0)

    def backward(self, req: BackwardRequest) -> BackwardResponse:
        """Re-forward blocks [a, b) from the given input and return the
        gradients of the input, the prompts and the adapters: activations
        are recomputed, never kept between training calls (the reference's
        ``run_rpc_backward`` re-forward)."""
        a, b, x, prompts, lora = self._train_args(req)
        g = req.grad_output.to(self.device, non_blocking=True)
        if tuple(g.shape) != tuple(x.shape):
            raise StageExecutionError(
                f"grad_output shape {tuple(g.shape)} != hidden shape {tuple(x.shape)}")
        _, bwd = self._train_fns(a, b)
        t_real = req.seq_len
        tb = round_to_bucket(t_real, SEQ_BUCKETS)
        if tb != t_real:
            x = F.pad(x, (0, 0, 0, tb - t_real))
            g = F.pad(g, (0, 0, 0, tb - t_real))   # zero cotangents on the padding
        gx, gp, gl = bwd(x, prompts, lora, float(req.lora_scale), g)
        self.requests_served += 1
        return BackwardResponse(session_id=req.session_id, grad_input=gx[:, :t_real],
                                grad_prompts=gp, grad_lora=gl)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self, speculative_k: int = 0) -> None:
        """One throwaway session through the span before serving (prefill,
        then steps of the other lengths), as the reference's serve mode
        does: the first real request then pays no one-time device set-up
        (library handles, kernel modules) inside its client's deadline. On
        the card each step captures its graph, at the 128-token cache
        bucket; the session's buffers then go to the arena's free list, and
        the next lease of that shape takes them and their graphs. With
        ``speculative_k`` the final stage also captures the sampled
        verification of every width 2..K+1 (a drafter may propose fewer
        than K tokens)."""
        cur = 0
        for i, t in enumerate(WARMUP_SEQ_LENS):
            if self.spec.is_first:
                x = torch.zeros((1, t), dtype=torch.int64)
            else:
                x = torch.zeros((1, t, self.cfg.hidden_size), dtype=torch.float32)
            try:
                self.forward(StageRequest(
                    session_id="__warmup__", hidden=x, seq_len=t, cur_len=cur,
                    is_prefill=(i == 0), max_length=WARMUP_MAX_LENGTH))
                cur += t
            except Exception as exc:  # warmup must never kill a server
                logger.warning("warmup step (T=%d) failed: %s", t, exc,
                               exc_info=True)
        self.drop_session("__warmup__")
        if self.spec.is_last and speculative_k > 0:
            vocab = self.cfg.vocab_size
            for t in range(2, speculative_k + 2):
                self.sampler.verify(
                    torch.zeros((1, t, vocab), dtype=torch.float32, device=self.device),
                    [((1, 2, 3), SamplingParams(), 0, (0,) * (t - 1))])

    def drop_session(self, session_id: str) -> None:
        if self.arena.get(session_id) is not None:
            _ev.emit("server_session_closed", session_id=session_id,
                     peer=self.peer_id)
        self.arena.free(session_id)
