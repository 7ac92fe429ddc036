"""CLI entry point of the PyTorch port: ``--mode local``, ``oracle``,
``doctor``, ``registry``, ``serve``, ``client``, ``gateway``, ``submit`` and
``status``.

Port of the JAX package's ``main.py`` for these modes:

  * ``--mode local``  — in-process cluster: fixed-split stage servers
    (``StageExecutor`` over a ``KVArena``) behind ``LocalTransport``, and
    the pipeline client running stage 0, one generation end to end. With
    no ``--splits`` the model is cut into 4 even stages. With
    ``--use_load_balancing``, ``--num_servers`` elastic servers
    (``runtime/server.ElasticStageServer``) join one after another, each
    choosing a span of ``--num_blocks`` from the coverage the ones before
    it left, and the client routes over block coverage.
  * ``--mode oracle`` — the unpartitioned model, the port's own
    single-device reference: greedy generation on the fused engine
    (``runtime/fused_decode.py``; on the card one captured decode step
    replayed per token, the tokens read back once per chunk of up to 32),
    sampled generation one ``full_forward`` per token.
  * ``--mode doctor`` — post-mortem over flight-recorder dumps
    (``--dumps f1.jsonl,f2.jsonl``, written by ``--events-dump``): failure
    chains, replay cost, anomalies, and with ``--critical_path`` each
    request's wall time split by layer. The reference's live scrape of
    servers (no ``--dumps``) is not ported yet.
  * ``--mode registry`` — the registry service (``runtime/net.py``
    ``RegistryServer``); prints ``REGISTRY_ADDR=host:port``.
  * ``--mode serve --stage K`` — one fixed-split stage server over TCP: the
    stage's executor behind a ``StageRuntime`` and a ``TcpStageServer``,
    registered at ``--registry_addr`` with a heartbeat every TTL/3 and the
    next hops' RTTs; prints ``SERVING stage=K span=[a,b) addr=... peer=...``.
    With ``--batched`` the stage runs the slot-batched engine
    (``runtime/batching.py``: ``--slots`` sessions of up to
    ``--max_session_len`` tokens, one captured decode round for every live
    session) behind a ``BatchingStageAdapter``, with compute inline on the
    handler threads, advertised as ``engine=batched``. ``--stage 0
    --batched`` serves the whole model from one batched engine, the one
    server shape that runs burst decode (N decode ticks with sampling on
    the device in one captured graph); ``--burst N`` captures the N-tick
    burst in its warm-up. ``--stage 0`` without ``--batched`` exits, as the
    reference's does: stage 0 runs inside the client. With
    ``--use_load_balancing`` the server is elastic: it chooses its span
    of ``--num_blocks`` (default: what the card's free memory holds) from
    the swarm's coverage past ``--splits``' first cut, re-spans when the
    swarm would gain (``--balance_quality``, checked every randomized
    ``--mean_balance_check_period``), swaps the executor on its socket,
    and prints ``SERVING elastic span=[a,b) addr=... peer=...``.
  * ``--mode client`` — the pipeline client with stage 0 in process and the
    remote stages over ``TcpTransport``, discovered through the registry.
    With ``--burst N`` (``client`` and ``local``) the session asks a
    full-span batched peer for N tokens a request, and falls back to the
    per-step loop (a ``burst_fallback`` event) when none is live. With
    ``--use_load_balancing`` (``client``, ``gateway``, ``local``) it routes
    over block coverage, by least estimated latency with
    ``--route_by_latency``.
  * ``--mode gateway`` — the multi-tenant serving front door
    (``serving/gateway.py``): ``--gateway_clients`` pipeline clients, each
    with its own stage 0 as ``client`` builds one, against the swarm at
    ``--registry_addr``, behind the framed-TCP ``submit`` verb; tenants
    from ``--tenants`` (inline JSON or a file: weight, rate, burst,
    max_concurrency, SLOs, and the global max_queue_depth / max_active);
    prints ``GATEWAY addr=... tenants=...``.
  * ``--mode submit`` — ``--submit_requests`` requests to
    ``--gateway_addr`` as ``--tenant``, one after another, each printing
    its tokens (``TOKENS=[..]``) or its shed reason; no weights load. Exit
    1 only when every request was shed.
  * ``--mode status`` — the swarm at ``--registry_addr``: a line a live
    server (its ``info`` probed), the coverage from the client-local prefix
    (``--splits``) to ``--total_blocks`` with uncovered runs marked, and
    the health summary; exit 1 with no live server, 2 when the swarm is
    unhealthy or a server does not answer. No weights load.
  ``--deadline_s`` gives ``client``, ``local`` and ``submit`` requests an
  end-to-end budget. ``--speculative_k K`` (``client`` and ``local``; the
  oracle warns and ignores it) drafts up to K tokens a round by n-gram
  prompt lookup and has the final stage verify them: greedy tokens equal
  the plain run's. ``serve`` with ``--speculative_k`` captures the K + 1
  draft widths (batched) and the final stage's verification in its
  warm-up.
  ``serve`` and ``client`` hold only their stage's weights (streamed from
  ``--checkpoint``, or drawn with every layer still drawn, so the weights
  equal the full init's; an elastic ``serve`` loads each span it takes the
  same way), print their peak
  and held device memory as ``PEAK_MEMORY_BYTES=N ALLOCATED_BYTES=M
  RESERVED_BYTES=R`` and
  build the kernels and the wire codec before they serve; ``serve`` runs
  one throwaway session through its span first, as the reference does.
  Every ``serve`` process, fixed or elastic, embeds a gossip mirror of the
  placement records (``scheduling/gossip.py``): it answers the registry
  service's verbs and gossips with its peers every TTL/3, so a client
  with every registry down still discovers the swarm through any server
  (its ``--peers_cache`` file lists them). A fixed ``serve`` first asks its
  live peers to dial its advertised address back (the dial-back vote);
  when the vote fails it attaches to a relay volunteer (a server started
  with ``--relay_capacity N``), advertises ``relay_via`` with its
  throughput discounted by the relay penalty, renews the circuit every
  heartbeat and prints ``RELAY: serving via volunteer <peer> ...``. The
  flags of the engines the port lacks (``--sp``, ``--tp``) exit naming
  themselves.

Host offload as in the reference: with ``--use_cpu_offload`` every server
of ``local`` (fixed and elastic) and every per-session ``serve`` (fixed and
elastic) keeps the layers of its span past the first
``--keep_layers_on_gpu`` in pinned host memory and streams them through two
device slots inside its captured step (``runtime/offload.py``); each such
layer is built on the card alone, merged and quantized, and moved to the
host before the next. The client's stage 0 stays resident. ``--batched``
refuses both flags, as the reference's does.

``--prefix_cache_mb N`` gives every executor of ``local`` (stage 0
included) and each ``serve`` executor, session or batched (``--stage 0
--batched`` included), a prompt-prefix KV store of N MiB
(``runtime/prefix_cache.py``); the ``info`` verb reports its counters.

On the card every stage executor (``local``, ``serve`` and the client's
stage 0) pads each prefill chunk and decode step to a sequence bucket and
replays a CUDA graph of its step, captured at the first step of that
shape (``serve`` captures the common shapes in its warmup): see
``runtime/executor.py`` and ``runtime/graphs.py``.

Telemetry as in the reference: ``--telemetry`` turns on the process-global
metrics registry, tracer and flight recorder (the client folds its series
into that registry); ``--events-dump PATH`` records events and writes them
to PATH at exit, on a fatal exception and on SIGTERM/SIGINT;
``--profile_phases`` turns on the phase profiler; ``--log-json`` logs one
JSON object per line.

Weights: ``--checkpoint DIR`` loads a local Hugging Face checkpoint
directory (``models/hf_import.py``: safetensors, sharded or not, or
``pytorch_model.bin``; read without ``transformers``): ``oracle`` reads the
full model, while ``local``, ``serve`` (fixed and elastic: each span it
takes), ``client`` and ``gateway`` stream each stage's span alone, reading
only the shards that hold it. The config comes from the checkpoint's
``config.json``; ``--model`` then names the swarm only. An ``http(s)://``
checkpoint is a remote weight store (``models/remote_store.py``, any static
file server over a checkpoint directory): each role fetches the config,
the tokenizer files and the shards of its span alone into a cache
directory (``--weight_cache_dir``, LRU-bounded by ``--weight_cache_bytes``,
sha256-checked against the store's ``digests.json``) and loads from there.
Without a checkpoint, weights are random-initialized from the ``--model``
preset and ``--seed``. ``--lora PATH`` folds a saved adapter into the attention
weights before ``--quant`` (``models/lora.py``), in every mode that loads
weights. Tokenization uses the checkpoint's tokenizer
(``AutoTokenizer``, offline) when ``transformers`` loads one, else the
UTF-8 byte fallback, with a warning.
Runs on ``--device cuda`` (the default) unless asked for ``cpu``; with no
GPU and no ``--device cpu`` it refuses rather than quietly using the CPU.

    python -m global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.main \\
        --mode local --model llama-3.1-8b --quant int8 --dtype bfloat16
    NF4_KERNEL=1 python -m ...main --mode local --model llama-3.1-8b --quant nf4
    python -m ...main --mode local --telemetry --events-dump ev.jsonl
    python -m ...main --mode doctor --dumps ev.jsonl --critical_path
    python -m ...main --mode registry --registry_port 31330
    python -m ...main --mode serve --stage 1 --registry_addr 127.0.0.1:31330 \\
        --model llama-3.1-8b --quant int8 --dtype bfloat16      (stages 1..3)
    python -m ...main --mode serve --stage 1 --batched --slots 8 ...
    python -m ...main --mode serve --stage 0 --batched --burst 8 ...
    python -m ...main --mode client --burst 8 ...
    python -m ...main --mode local --speculative_k 4 --temperature 0 ...
    python -m ...main --mode local --lora adapter.npz --quant int8 ...
    python -m ...main --mode local --checkpoint /path/to/hf-dir --quant int8 ...
    python -m ...main --mode serve --stage 1 --checkpoint http://host:8000/llama \
        --weight_cache_dir /var/cache/shards --weight_cache_bytes 20000000000 ...
    python -m ...main --mode serve --stage 2 --use_cpu_offload --keep_layers_on_gpu 2 ...
    python -m ...main --mode serve --stage 3 --batched --speculative_k 4 ...
    python -m ...main --mode client --registry_addr 127.0.0.1:31330 \\
        --model llama-3.1-8b --quant int8 --dtype bfloat16 --prompt "Hi"
    python -m ...main --mode gateway --registry_addr 127.0.0.1:31330 \\
        --tenants '{"tenants": {"gold": {"weight": 4}, "bronze": {}}}' ...
    python -m ...main --mode submit --gateway_addr 127.0.0.1:31340 \\
        --tenant gold --prompt "Hi" --deadline_s 30
    python -m ...main --mode serve --use_load_balancing --num_blocks 8 \\
        --splits 8 --registry_addr 127.0.0.1:31330 ...   (each elastic server)
    python -m ...main --mode client --use_load_balancing --splits 8 ...
    python -m ...main --mode status --registry_addr 127.0.0.1:31330 --splits 8
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import random
import re
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .models.config import ModelConfig, get_config
from .models.hf_import import config_from_checkpoint, load_stage_checkpoint
from .models.lora import load_lora, merge_lora, slice_lora
from .models.partition import ROLE_FULL, StagePlan, StageSpec, parse_splits, slice_stage_params
from .models.quant import params_per_block, quantize_params, tree_map
from .models.transformer import full_forward, init_kv_cache, init_params
from .ops.sampling import RECENT_WINDOW, SamplingParams, sample_token
from .ops.threefry import prng_key
from .runtime.client import REPEAT_STOP, GenerationResult, PipelineClient, make_server_record
from .runtime.executor import StageExecutor
from .runtime.fused_decode import make_fused_decode, make_fused_sample_decode
from .runtime.kv_cache import DEFAULT_BUCKETS, round_to_bucket
from .runtime.transport import LocalTransport
from .scheduling.registry import PlacementRegistry

logger = logging.getLogger("mini_petals_torch")

_DTYPE_MAP = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _emit(*parts, **kwargs) -> None:
    """CLI output boundary: the report a mode exists to print."""
    print(*parts, **kwargs)  # noqa: T201 — the one sanctioned print


def resolve_device(name: str) -> torch.device:
    """``cuda`` needs a GPU and never falls back to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return torch.device(name)


# ---------------------------------------------------------------------------
# Tokenizer (the checkpoint's, else the byte-level fallback)
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """UTF-8 byte fallback: token id = byte value."""

    eos_token_id: Optional[int] = None

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


# The files a saved tokenizer leaves in its directory, one of them at least.
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model",
                   "vocab.json", "vocab.txt", "spiece.model")


def load_tokenizer(checkpoint: Optional[str] = None):
    """The checkpoint's tokenizer through ``transformers`` (offline), or on
    any failure (no tokenizer file in the directory, no ``transformers``)
    the byte fallback, with a warning. Unlike the reference, which asks
    ``AutoTokenizer`` whatever the directory holds, a directory with none
    of `TOKENIZER_FILES` is not asked: transformers 5 answers it with a
    tokenizer of a few special tokens, where 4.x raises."""
    if checkpoint:
        try:
            if not any(os.path.exists(os.path.join(checkpoint, f)) for f in TOKENIZER_FILES):
                raise FileNotFoundError(f"no tokenizer file under {checkpoint}")
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        except Exception as exc:
            logger.warning("tokenizer load failed (%s); using byte fallback", exc)
    return ByteTokenizer()


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

# One RemoteShardStore a (checkpoint, cache directory) in the process.
_STORES: dict = {}


def _remote_store(args):
    """The memoized ``RemoteShardStore`` of an http(s):// ``--checkpoint``:
    one cache and one LRU state a process, shared by `model_config`,
    `load_model` and `_stage_params`. The cache is ``--weight_cache_dir``,
    by default ``~/.cache/mini_petals_tpu/<the URL, sanitized>`` (the
    reference's directory, so that both packages' servers on one host share
    it), bounded by ``--weight_cache_bytes``."""
    from .models.remote_store import RemoteShardStore

    key = (args.checkpoint, args.weight_cache_dir)
    store = _STORES.get(key)
    if store is None:
        cache = args.weight_cache_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "mini_petals_tpu",
            re.sub(r"[^A-Za-z0-9._-]+", "_", args.checkpoint))
        store = RemoteShardStore(args.checkpoint, cache,
                                 max_cache_bytes=args.weight_cache_bytes)
        _STORES[key] = store
    return store


def _is_remote(checkpoint) -> bool:
    return bool(checkpoint) and checkpoint.startswith(("http://", "https://"))


def _checkpoint_dir(args) -> Optional[str]:
    """The local directory of ``--checkpoint``: the store's cache, with
    ``config.json`` and any tokenizer file fetched, for a remote one."""
    if _is_remote(args.checkpoint):
        return _remote_store(args).fetch_config()
    return args.checkpoint


def model_config(args) -> ModelConfig:
    """The checkpoint's config (a remote store's fetched), or the
    ``--model`` preset."""
    return (config_from_checkpoint(_checkpoint_dir(args)) if args.checkpoint
            else get_config(args.model))


def load_model(args) -> Tuple[ModelConfig, Optional[dict]]:
    """The full model on the device: from ``--checkpoint`` (every shard,
    read as a one-stage span; a remote store's fetched first), or the
    random init of the ``--model`` preset from ``--seed``. With a
    checkpoint only ``oracle`` reads the full tree; the serving modes get
    None for the params, as in the reference (``main.py:119-155``), and
    each stage then streams its own span (`_stage_params`). So does
    ``--mode local --use_cpu_offload`` on random weights: each stage draws
    its own span, and an offloaded one never holds it on the card; and
    ``--mode local`` on a preset whose whole tree would take more than
    WHOLE_INIT_SHARE of the device's memory (`_whole_init_fits`; e.g.
    mixtral-8x7b, 93 GB at bf16, on an 80 GB card)."""
    device = resolve_device(args.device)
    if args.checkpoint:
        cfg = model_config(args)
        if args.mode != "oracle":
            return cfg, None
        logger.info("loading %s (%d layers) on %s", args.checkpoint, cfg.num_layers, device)
        full = StageSpec(0, ROLE_FULL, 0, cfg.num_layers)
        if _is_remote(args.checkpoint):
            return cfg, _remote_store(args).load_stage(cfg, full, dtype=_DTYPE_MAP[args.dtype],
                                                       device=device)
        return cfg, load_stage_checkpoint(args.checkpoint, cfg, full,
                                          dtype=_DTYPE_MAP[args.dtype], device=device)
    cfg = get_config(args.model)
    dtype = _DTYPE_MAP[args.dtype]
    if args.mode == "local" and (args.use_cpu_offload
                                 or not _whole_init_fits(cfg, dtype, device)):
        return cfg, None
    logger.info("random-initializing %s (%d layers) on %s", args.model,
                cfg.num_layers, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return cfg, init_params(cfg, gen, dtype=dtype, device=device)


# `--mode local` draws a preset's whole random init (each stage then a
# slice of it) only while that tree takes at most this share of the
# device's memory: the stages' quantized copies are built beside it.
WHOLE_INIT_SHARE = 0.5


def device_memory_bytes(device: torch.device) -> int:
    """A CUDA device's memory, or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _whole_init_fits(cfg: ModelConfig, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether the whole tree (the layers, the embedding and a head) at
    `dtype` takes at most WHOLE_INIT_SHARE of the device's memory."""
    count = cfg.num_layers * params_per_block(cfg) + 2 * cfg.vocab_size * cfg.hidden_size
    size = torch.tensor([], dtype=dtype).element_size()
    return count * size <= WHOLE_INIT_SHARE * device_memory_bytes(device)


def load_stage_model(args, spec: StageSpec) -> Tuple[ModelConfig, dict]:
    """One stage's shard only, LoRA-merged and quantized as ``--lora`` and
    ``--quant`` ask: its layers, the embeddings for the first stage, the
    final norm and head for the last (`_stage_params`: streamed from
    ``--checkpoint``, local or remote, or the span of the random init). A
    ``serve`` process's layers are split for host offload under
    ``--use_cpu_offload``; the stage 0 of ``client`` and ``gateway`` stays
    resident. What the load left is freed before this returns."""
    cfg = model_config(args)
    offload = bool(args.use_cpu_offload) and args.mode == "serve"
    shard = _stage_params(args, cfg, None, spec, offload=offload)
    gc.collect()
    if resolve_device(args.device).type == "cuda":
        torch.cuda.empty_cache()
    return cfg, shard


def _maybe_quantize(args, params):
    """Apply ``--quant`` weight-only quantization to the layer blocks."""
    if args.quant == "none":
        return params
    return quantize_params(params, args.quant)


def _maybe_lora(args, cfg: ModelConfig, params, start=None, end=None):
    """Apply ``--lora``: fold a saved adapter's deltas (a ``save_lora``
    .npz) into the attention weights at load time, before ``--quant``, so
    quantized weights include them and serving needs no adapter support.
    `start`/`end` select the span's slice of the adapter, merged into
    `params`' stacked layers (a stage's, stacked from index 0); None, the
    full model. The file is loaded once per process."""
    path = getattr(args, "lora", None)
    if not path or "layers" not in params:
        return params
    cached = _maybe_lora._cache.get(path)
    if cached is None:
        cached = _maybe_lora._cache[path] = load_lora(path)
    tree, scale = cached
    # The adapter's FULL depth first: a wrong model's adapter could slice
    # to a span's width and merge another model's layers silently.
    for t, ab in tree.items():
        if ab["a"].shape[0] != cfg.num_layers:
            raise SystemExit(
                f"--lora: adapter {t!r} covers {ab['a'].shape[0]} layers, "
                f"the model has {cfg.num_layers} (adapter trained for a "
                "different model?)")
    if start is not None:
        tree = slice_lora(tree, start, end)
    return {**params, "layers": merge_lora(cfg, params["layers"], tree, scale)}


_maybe_lora._cache = {}


def _stage_params(args, cfg: ModelConfig, params, spec, offload: bool = False):
    """A serving role's stage weights, then ``--lora`` merged and
    ``--quant`` applied: sliced from the loaded tree `params`, or when it
    is None streamed from ``--checkpoint`` (a local directory, or a remote
    store's span of shards, `_remote_store`), or without a checkpoint the
    span of the random init of the ``--model`` preset from ``--seed``
    (every layer is drawn in order, so the shard equals that stage's slice
    of `load_model`'s weights).

    With `offload` (``--use_cpu_offload``) the layers past
    ``--keep_layers_on_gpu`` are built on the device one at a time (loaded
    or drawn, merged, quantized) and each is moved to pinned host memory
    before the next is built; the tree's ``layers`` is then a
    ``runtime.offload.OffloadedLayers``. The values are the resident
    span's, and the device never holds more than the resident part and one
    layer's working set of them (the reference loads the span onto the
    device, then moves it to the host)."""
    device = resolve_device(args.device)
    dtype = _DTYPE_MAP[args.dtype]
    n = spec.num_layers
    keep = min(max(args.keep_layers_on_gpu, 0), n) if offload else n

    def finish(tree, first, last):
        """--lora over the stacked layers [first, last), then --quant."""
        return _maybe_quantize(args, _maybe_lora(args, cfg, tree, first, last))

    host, stream = [], None
    if keep < n:
        from .runtime.offload import host_layer

        def sink(j, layer):
            one = finish({"layers": layer}, spec.start + j, spec.start + j + 1)["layers"]
            host.append(host_layer(tree_map(lambda a: a[0], one), device))

        stream = (keep, sink)
    if params is not None:
        sp = slice_stage_params(cfg, params, spec)
        if stream is not None:
            layers = sp["layers"]
            for j in range(keep, n):
                sink(j, tree_map(lambda a, j=j: a[j:j + 1], layers))
            sp["layers"] = tree_map(lambda a: a[:keep], layers)
    elif _is_remote(args.checkpoint):
        sp = _remote_store(args).load_stage(cfg, spec, dtype=dtype, device=device,
                                            stream=stream)
    elif args.checkpoint:
        sp = load_stage_checkpoint(args.checkpoint, cfg, spec, dtype=dtype, device=device,
                                   stream=stream)
    else:
        logger.info("random-initializing %s layers [%d, %d) of %d on %s",
                    args.model, spec.start, spec.end, cfg.num_layers, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        full = init_params(cfg, gen, dtype=dtype, device=device,
                           layer_range=(spec.start, spec.end), stream=stream)
        # The kept layers are stacked from index 0: slice them as a span
        # that starts there.
        sp = slice_stage_params(cfg, full, StageSpec(spec.index, spec.role, 0, n))
        del full
    # The span's slice of the adapter merges into the local stack, before
    # the quantization.
    sp = finish(sp, spec.start, spec.start + keep)
    if stream is not None:
        from .runtime.offload import OffloadedLayers

        sp["layers"] = OffloadedLayers(sp["layers"], host)
    return sp


# ---------------------------------------------------------------------------
# Modes
# ---------------------------------------------------------------------------

def _model_id(args) -> str:
    """The registry scope of every record and query: ``--model_name``, or
    the ``--model`` preset."""
    return args.model_name or args.model


def _client_metrics(args):
    """Under ``--telemetry`` the client folds its series into the
    process-global registry; otherwise it keeps its private one."""
    if args.telemetry:
        from . import telemetry

        return telemetry.get_registry()
    return None


def stage_plan(args, cfg: ModelConfig) -> StagePlan:
    """``--splits``, or 4 even stages."""
    splits = parse_splits(args.splits) if args.splits else None
    return (StagePlan.even(cfg.num_layers, 4) if splits is None
            else StagePlan.from_splits(cfg.num_layers, splits))


def build_local_swarm(args, cfg: ModelConfig, params, **server_kw):
    """The in-process cluster of ``--mode local``: stage 0 inside the client
    and the remote blocks behind ``LocalTransport``. Fixed splits: one
    executor per stage >= 1. ``--use_load_balancing``: ``--num_servers``
    elastic servers that join one after another, each choosing its span
    over [stage 0's end, total blocks) from the coverage the ones before it
    left (``--num_blocks`` each, by default the remote blocks over the
    remote stages), `server_kw` passed on to each (a throughput probe, a
    warm-up), and a module-routing client. Returns (client, the elastic
    servers or [])."""
    device = resolve_device(args.device)
    plan = stage_plan(args, cfg)
    transport = LocalTransport()
    # In-process peers live as long as the client and send no heartbeat:
    # their records never expire. A client routes each prompt head anew
    # (its route cache is keyed by the head's affinity), so a record that
    # expired after the reference's 45 s would leave a later prompt with
    # no route.
    registry = PlacementRegistry(ttl=float("inf"), rng=random.Random(args.seed))
    executor_kwargs = {"device": device, "act_dtype": _DTYPE_MAP[args.dtype],
                       "prefix_cache_bytes": args.prefix_cache_mb << 20}
    # The servers' spans, host-offloaded under --use_cpu_offload; stage 0,
    # inside the client, stays resident, as in the reference.
    offload = bool(args.use_cpu_offload)
    server_kwargs = dict(executor_kwargs, offload=offload,
                         keep_layers_resident=args.keep_layers_on_gpu)
    total = args.total_blocks or cfg.num_layers
    servers = []
    if args.use_load_balancing:
        from .runtime.server import ElasticStageServer

        min_block = plan.stages[0].end
        num_blocks = args.num_blocks or max(
            1, (cfg.num_layers - min_block) // max(plan.num_stages - 1, 1))
        for i in range(args.num_servers):
            server = ElasticStageServer(
                f"server-{i}", cfg,
                lambda spec: _stage_params(args, cfg, params, spec, offload=offload),
                registry, transport, executor_kwargs=server_kwargs,
                num_blocks=num_blocks, total_blocks=total, min_block=min_block,
                balance_quality=args.balance_quality,
                mean_balance_check_period=args.mean_balance_check_period,
                bandwidth_mbps=args.network_bandwidth_mbps,
                rng=random.Random(args.seed + i), model=_model_id(args), **server_kw)
            server.start_serving()
            servers.append(server)
    else:
        for spec in plan.stages[1:]:
            peer = f"server-stage{spec.index}"
            ex = StageExecutor(cfg, spec, _stage_params(args, cfg, params, spec, offload=offload),
                               peer_id=peer, **server_kwargs)
            transport.add_peer(peer, ex)
            registry.register(make_server_record(peer, spec, model=_model_id(args)))
    stage0 = StageExecutor(cfg, plan.stages[0],
                           _stage_params(args, cfg, params, plan.stages[0]),
                           peer_id="client-local", **executor_kwargs)
    client = PipelineClient(cfg, plan, stage0, transport, registry,
                            use_module_routing=bool(args.use_load_balancing),
                            route_by_latency=args.route_by_latency, total_blocks=total,
                            seed=args.seed, model=_model_id(args),
                            metrics=_client_metrics(args))
    return client, servers


def build_local_client(args, cfg: ModelConfig, params) -> PipelineClient:
    """The client of `build_local_swarm`."""
    return build_local_swarm(args, cfg, params)[0]


def run_local(args, cfg: ModelConfig, params) -> int:
    """In-process cluster: fixed-split servers + client, one generation."""
    client = build_local_client(args, cfg, params)
    return _generate_and_report(args, client.generate, cfg, pipeline_client=True)


def oracle_cache_len(prompt_len: int, max_new_tokens: int) -> int:
    """The oracle's KV cache rows: room for the prompt and the new tokens
    (at least 128), rounded up to a cache bucket. Both oracle loops use it:
    attention reads the whole cache, so the two see the same shapes."""
    return round_to_bucket(max(128, prompt_len + max_new_tokens + 1), DEFAULT_BUCKETS)


def _drive_chunks(prompt_ids, max_new_tokens: int, eos_token_id, *,
                  prefill_first_token, run_chunk, chunk: int) -> GenerationResult:
    """Chunked generation (the reference's ``_drive_chunks``,
    ``main.py:412-465``). ``prefill_first_token(prompt_ids) -> token`` runs
    the prompt; ``run_chunk(last_token, cur_len, n, step) -> tokens`` runs
    n fused steps, ``step`` being the key schedule's index of the chunk's
    first token (the tokens so far; the greedy engine ignores it). The stop
    rules (EOS, 5 identical tokens) are checked per token inside a chunk,
    since the fused steps may overshoot a stop and the kept tokens must be
    the per-token loop's; each chunk's whole wall time is spread over the
    tokens kept."""
    t0 = time.monotonic()
    tokens = [prefill_first_token(prompt_ids)]
    ttft = time.monotonic() - t0
    cur = len(prompt_ids)
    decode_times: List[float] = []
    stopped = "max_tokens"
    while len(tokens) < max_new_tokens and stopped == "max_tokens":
        if eos_token_id is not None and tokens[-1] == eos_token_id:
            stopped = "eos"
            break
        if len(tokens) >= REPEAT_STOP and len(set(tokens[-REPEAT_STOP:])) == 1:
            stopped = "repeat"
            break
        n = min(chunk, max_new_tokens - len(tokens))
        t0 = time.monotonic()
        got = run_chunk(tokens[-1], cur, n, len(tokens))
        dt = time.monotonic() - t0
        kept = 0
        for tok in got:
            tokens.append(tok)
            cur += 1
            kept += 1
            if eos_token_id is not None and tok == eos_token_id:
                stopped = "eos"
                break
            if len(tokens) >= REPEAT_STOP and len(set(tokens[-REPEAT_STOP:])) == 1:
                stopped = "repeat"
                break
        decode_times.extend([dt / max(kept, 1)] * kept)
    return GenerationResult(tokens=tokens[:max_new_tokens], ttft_s=ttft,
                            decode_times_s=decode_times[:max(len(tokens) - 1, 0)],
                            stopped_by=stopped)


def make_oracle_generate(args, cfg: ModelConfig, params):
    """Unpartitioned generation with the pipeline's sampling rules (per-step
    seed ``seed + len(tokens)``, EOS and 5x-repeat stops). Returns
    ``generate(prompt_ids, max_new_tokens, sampling, eos_token_id=None)``
    -> GenerationResult, with the weights it runs as its ``params``
    attribute and the per-token loop as its ``per_token`` attribute.

    Generation runs on the fused engines (``runtime/fused_decode.py``), as
    the reference's oracle does (``main.py:492-522``): the prompt through
    ``full_forward``, then chunks of min(max_new_tokens, 32) decode steps,
    on the card each a replay of one captured step, the tokens read back
    once a chunk. Greedy takes the argmax of the reference's ``exact_head``
    head; sampled runs the full sampler inside the step, its first token
    drawn by the captured sampler with ``PRNGKey(seed)`` and step i with
    ``PRNGKey(seed + i)``. The per-token loop, one eager ``full_forward``
    and sampler call per token with the same key schedule, is what the
    engines are held to (``per_token``; the tests and ``chip_smoke.py``).

    As in the reference (``main.py:431-432``), the KV cache takes the
    weights' dtype, where the stage executors keep a float32 cache; under
    ``--dtype bfloat16`` the oracle therefore computes other numbers than
    ``--mode local``."""
    params = _maybe_quantize(args, _maybe_lora(args, cfg, params))
    wte = params["embed"]["wte"]
    device = wte.device
    engines = {}

    def per_token(prompt_ids, max_new_tokens, sampling, eos_token_id=None, **_kw):
        max_len = oracle_cache_len(len(prompt_ids), max_new_tokens)
        kc, vc = init_kv_cache(cfg, cfg.num_layers, 1, max_len,
                               dtype=wte.dtype, device=device)
        tokens: List[int] = []
        decode_times: List[float] = []
        stopped = "max_tokens"
        ids = torch.tensor([list(prompt_ids)], dtype=torch.int64, device=device)
        cur = 0
        t0 = time.monotonic()
        ttft = 0.0
        while True:
            logits, kc, vc = full_forward(cfg, params, ids, kc, vc, cur)
            cur += ids.shape[1]
            window = tokens[-RECENT_WINDOW:]
            recent = torch.zeros(RECENT_WINDOW, dtype=torch.int32)
            recent[:len(window)] = torch.tensor(window, dtype=torch.int32)
            tok = int(sample_token(prng_key(args.seed + len(tokens)), logits[0, -1],
                                   recent.to(device), len(window), sampling.temperature,
                                   sampling.top_p, sampling.top_k,
                                   sampling.repetition_penalty))
            tokens.append(tok)
            dt = time.monotonic() - t0
            if len(tokens) == 1:
                ttft = dt
            else:
                decode_times.append(dt)
            t0 = time.monotonic()
            if len(tokens) >= max_new_tokens:
                break
            if eos_token_id is not None and tok == eos_token_id:
                stopped = "eos"
                break
            if len(tokens) >= REPEAT_STOP and len(set(tokens[-REPEAT_STOP:])) == 1:
                stopped = "repeat"
                break
            ids = torch.tensor([[tok]], dtype=torch.int64, device=device)
        return GenerationResult(tokens=tokens, ttft_s=ttft,
                                decode_times_s=decode_times, stopped_by=stopped)

    def generate(prompt_ids, max_new_tokens, sampling, eos_token_id=None, **_kw):
        chunk = min(max_new_tokens, 32)
        max_len = oracle_cache_len(len(prompt_ids), max_new_tokens)
        key = (sampling.greedy, chunk, max_len)
        engine = engines.get(key)
        if engine is None:
            make = make_fused_decode if sampling.greedy else make_fused_sample_decode
            engine = engines[key] = make(cfg, params, chunk, max_len)
        if sampling.greedy:
            def prefill_first(ids):
                logits = engine.prefill(torch.tensor([list(ids)], dtype=torch.int64))
                return int(torch.argmax(logits[0, -1]))

            def run_chunk(last, cur, n, step):
                return engine(last, cur, n)[:n].tolist()
        else:
            engine.begin(sampling)

            def prefill_first(ids):
                logits = engine.prefill(torch.tensor([list(ids)], dtype=torch.int64))
                return engine.first_token(logits[0, -1:], args.seed)

            def run_chunk(last, cur, n, step):
                return engine(last, cur, n, args.seed + step)[:n].tolist()

        return _drive_chunks(prompt_ids, max_new_tokens, eos_token_id,
                             prefill_first_token=prefill_first,
                             run_chunk=run_chunk, chunk=chunk)

    generate.params = params
    generate.per_token = per_token
    return generate


def run_oracle(args, cfg: ModelConfig, params) -> int:
    """Single-device unpartitioned generation (the correctness baseline)."""
    return _generate_and_report(args, make_oracle_generate(args, cfg, params), cfg)


# Flags of the reference's serve and client modes whose engines or
# features the port does not have, with their defaults: any other value
# exits naming the flag.
UNPORTED_FLAGS = (("sp", 1), ("tp", 1))


def refuse_unported_flags(args) -> None:
    for dest, default in UNPORTED_FLAGS:
        if getattr(args, dest) != default:
            raise SystemExit(f"--{dest} is not ported: the port's servers run "
                             "the per-session or the batched engine on one "
                             "device, with no tensor or sequence parallelism")


def _report_peak_memory(device: torch.device) -> None:
    """This process's peak device memory, what its tensors hold now and
    what its allocator reserves now (the captured steps' memory pools
    included), on a line of its own."""
    if device.type == "cuda":
        _emit(f"PEAK_MEMORY_BYTES={torch.cuda.max_memory_allocated(device)} "
              f"ALLOCATED_BYTES={torch.cuda.memory_allocated(device)} "
              f"RESERVED_BYTES={torch.cuda.memory_reserved(device)}", flush=True)


def _build_native(args, device: torch.device) -> None:
    """Build the wire codec, and on the card the kernels ``--quant`` runs,
    before serving: a build inside a request would count against its
    compute timeout."""
    from . import native

    native.build()
    if device.type == "cuda" and args.quant != "none":
        from importlib import import_module

        import_module(f"{__package__}.ops.{args.quant}_kernel").build()


def run_registry(args) -> int:
    """The registry service until interrupted; prints its address."""
    from .runtime.net import RegistryServer

    from . import native

    native.build()   # the codec checksums every frame
    srv = RegistryServer(host=args.host, port=args.registry_port, ttl=args.ttl,
                         allow_fault_injection=args.allow_fault_injection)
    srv.start()
    _emit(f"REGISTRY_ADDR={srv.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


def _gossip_loop(registry, gnode, record_fn):
    """The serve process's anti-entropy loop (started): every TTL/3 it
    republishes `record_fn()` (this server's record with its stats digest,
    or None to skip a beat) and gossips with a few peers, drawn from its
    mirror and whatever discovery still answers."""
    from .runtime.net import gossip_exchange
    from .scheduling.gossip import GossipLoop

    loop = GossipLoop(gnode, gossip_exchange, record_fn=record_fn,
                      extra_peers_fn=lambda: [r.address for r in registry.live_servers()
                                              if r.address])
    loop.start()
    return loop


def _with_stats(rec) -> dict:
    """A record as the gossip wire carries it, with this process's stats
    digest (``--mode top``'s input), which ``dict_to_rec`` ignores."""
    from .scheduling.registry import rec_to_dict
    from .telemetry.profiling import stats_digest

    return dict(rec_to_dict(rec), stats=stats_digest())


def _join_via_relay(args, cfg, spec, server, ping_tx, registry, bind_address: str) -> None:
    """The dial-back vote on the advertised address; when it fails, attach
    to a relay volunteer and advertise it as ``relay_via``, with the
    throughput discounted by the relay penalty (the network-bound model's
    relayed / direct ratio). A vote nobody answered (a server alone) counts
    as reachable."""
    from .runtime.net import attach_via_relay, check_direct_reachability
    from .scheduling.throughput import get_server_throughput
    from .telemetry import events as _events

    if check_direct_reachability(ping_tx, registry, server.address) is not False:
        return
    got = attach_via_relay(ping_tx, registry, server.peer_id, bind_address)
    if got is None:
        _emit("WARNING: dial-back vote says this server is unreachable and no relay "
              "volunteer accepted an attach; clients will not reach it (start a peer "
              "with --relay_capacity N or fix --public_ip)", flush=True)
        return
    server.relay_via = got["relay"]
    nb = max(1, spec.end - spec.start)
    server.throughput *= (get_server_throughput(None, cfg.hidden_size, use_relay=True,
                                                num_blocks=nb)
                          / get_server_throughput(None, cfg.hidden_size, num_blocks=nb))
    _events.emit("relay_attach", peer=server.peer_id, relay=server.relay_via,
                 address=bind_address)
    _emit(f"RELAY: serving via volunteer {server.relay_via} (dial-back vote failed "
          f"for {server.address})", flush=True)


def _renew_relay(server, ping_tx, registry, gnode, bind_address: str) -> None:
    """A relay circuit is a lease: renew it every heartbeat. With the
    volunteer gone, attach to another and advertise it."""
    from .runtime.net import PeerUnavailable, attach_via_relay
    from .scheduling.registry import rec_to_dict
    from .telemetry import events as _events

    try:
        ping_tx.relay_attach(server.relay_via, server.peer_id, bind_address)
    except (PeerUnavailable, TimeoutError, ConnectionError, OSError):
        got = attach_via_relay(ping_tx, registry, server.peer_id, bind_address,
                               exclude=(server.relay_via,))
        if got is not None:
            server.relay_via = got["relay"]
            _events.emit("relay_attach", peer=server.peer_id, relay=server.relay_via,
                         address=bind_address)
            rec = server._record()
            registry.register(rec)
            gnode.publish(rec_to_dict(rec))


def run_serve(args) -> int:
    """One fixed-split stage server over TCP until interrupted (an elastic
    one under ``--use_load_balancing``), with its gossip mirror and loop
    and, after a failed dial-back vote, a relay volunteer; prints its peak
    device memory again when it stops."""
    from .runtime.net import RemoteRegistry, TcpStageServer, TcpTransport
    from .runtime.server import FixedStageServer, _pinger_from_transport
    from .runtime.task_pool import StageRuntime
    from .scheduling.gossip import GossipNode
    from .scheduling.registry import rec_to_dict

    if args.batched and (args.use_cpu_offload or args.keep_layers_on_gpu):
        raise SystemExit(
            "--batched keeps its span resident in HBM (the batched step "
            "reads every layer every round); host offload is a "
            "per-session-executor feature — drop --use_cpu_offload/"
            "--keep_layers_on_gpu or serve without --batched")
    if args.use_load_balancing:
        return _run_serve_elastic(args)
    device = resolve_device(args.device)
    cfg = model_config(args)
    plan = stage_plan(args, cfg)
    if args.stage == 0:
        # The full-span server, the only shape that runs burst decode: its
        # sampled tokens feed its own embedding. --splits is ignored.
        if not args.batched:
            raise SystemExit(
                "--stage 0 serves the FULL model span and requires "
                "--batched (the burst-capable continuous-batching engine); "
                "classic stage 0 runs inside the client")
        spec = StagePlan.even(cfg.num_layers, 1).stages[0]
    elif not 1 <= args.stage < plan.num_stages:
        raise SystemExit(f"--stage must be 1..{plan.num_stages - 1} for serve "
                         "mode (stage 0 runs inside the client; --stage 0 "
                         "--batched serves the full span for --burst)")
    else:
        spec = plan.stages[args.stage]
    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    peer_id = args.peer_id or f"stage{args.stage}-{os.getpid()}"
    ping_tx = TcpTransport(registry, wire_dtype=args.wire_dtype)
    cfg, shard = load_stage_model(args, spec)
    executor = None
    if args.batched:
        from .runtime.batching import BatchedStageExecutor, BatchingStageAdapter

        # The slot caches take the serve dtype, as the reference's
        # (main.py:937).
        engine = BatchedStageExecutor(
            cfg, spec, shard, device=device, slots=args.slots,
            max_len=args.max_session_len, dtype=_DTYPE_MAP[args.dtype],
            prefix_cache_bytes=args.prefix_cache_mb << 20, model=_model_id(args))
        executor = BatchingStageAdapter(engine, peer_id=peer_id)
    # No act_dtype: an arriving activation computes in the float32 the wire
    # decodes to, as the reference's server computes it.
    server = FixedStageServer(peer_id, cfg, spec, shard, registry,
                              executor_kwargs={
                                  "device": device,
                                  "prefix_cache_bytes": args.prefix_cache_mb << 20,
                                  "offload": args.use_cpu_offload,
                                  "keep_layers_resident": args.keep_layers_on_gpu},
                              pinger=_pinger_from_transport(ping_tx),
                              model=_model_id(args), executor=executor)
    del shard
    ex = server.executor
    _build_native(args, device)
    if args.batched:
        # The K + 1 draft widths and the N-tick burst too, so that no
        # capture happens in a round.
        ex.warmup(speculative_k=args.speculative_k, burst=args.burst)
    else:
        ex.warmup(speculative_k=args.speculative_k)
    # One compute thread owns the device; the handler threads own sockets.
    # Not for the batched engine: concurrent handler calls are how its
    # round window coalesces, and its own lock guards the device.
    runtime = (None if args.batched else
               StageRuntime(high_water=args.queue_high_water,
                            low_water=args.queue_low_water))
    gnode = GossipNode(peer_id, ttl=registry.ttl,
                       rng=random.Random(args.seed + os.getpid()))
    srv = TcpStageServer(ex, runtime, host=args.host, port=args.rpc_port,
                         wire_dtype=args.wire_dtype, model=_model_id(args),
                         allow_fault_injection=args.allow_fault_injection,
                         gossip=gnode, relay_capacity=args.relay_capacity)
    srv.start()
    server.address = (f"{args.public_ip}:{srv.address.rsplit(':', 1)[1]}"
                      if args.public_ip else srv.address)
    gnode.self_address = server.address
    if args.relay_capacity > 0:
        server.relay_capacity = args.relay_capacity
    _join_via_relay(args, cfg, spec, server, ping_tx, registry, srv.address)
    server.start_serving()
    gnode.publish(rec_to_dict(server._record()))
    gloop = _gossip_loop(registry, gnode, lambda: _with_stats(server._record()))
    _report_peak_memory(device)
    _emit(f"SERVING stage={args.stage} span=[{spec.start},{spec.end}) "
          f"addr={server.address} peer={peer_id}", flush=True)
    try:
        while True:
            time.sleep(registry.ttl / 3.0)
            try:
                server.heartbeat_once()
            except (ConnectionError, OSError) as exc:
                logger.warning("heartbeat failed: %s", exc)
            if server.relay_via is not None:
                # Renewed whether or not a registry answered the heartbeat.
                try:
                    _renew_relay(server, ping_tx, registry, gnode, srv.address)
                except (ConnectionError, OSError) as exc:
                    logger.warning("relay renewal failed: %s", exc)
    except KeyboardInterrupt:
        pass
    finally:
        gloop.stop()
        try:
            registry.unregister(peer_id)
        except (ConnectionError, OSError):
            pass
        gnode.apply_unregister(peer_id)
        ping_tx.close()
        srv.stop()
        _report_peak_memory(device)
    return 0


def _run_serve_elastic(args) -> int:
    """An elastic (load-balancing) stage server over TCP until interrupted:
    the span is chosen from the swarm's live coverage (rule 1), chosen anew
    when the swarm would gain (rule 2), and the executor is swapped on the
    listening socket, which answers "server is re-spanning" in between.
    Each span's weights are streamed from ``--checkpoint`` (its shards
    alone), or drawn from ``--seed`` as `load_stage_model` draws a fixed
    stage's, so they equal the fixed split's slice; every
    span (re)load warms its executor up before it goes ONLINE. Its gossip
    mirror and loop run throughout: the socket answers gossip and the
    registry verbs while it re-spans, and the loop skips the beats when no
    span is set. Prints ``SERVING elastic span=[a,b) addr=.. peer=..``."""
    from .runtime.net import RemoteRegistry, TcpStageServer, TcpTransport
    from .runtime.server import ElasticStageServer, derive_num_blocks
    from .runtime.task_pool import StageRuntime
    from .scheduling.gossip import GossipNode

    device = resolve_device(args.device)
    cfg = model_config(args)
    peer = args.peer_id or f"lb-{os.getpid()}"
    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    _build_native(args, device)
    gnode = GossipNode(peer, ttl=registry.ttl, rng=random.Random(args.seed + os.getpid()))
    # One compute thread owns the card: an elastic server takes whatever
    # concurrency the swarm sends it.
    srv = TcpStageServer(None, StageRuntime(high_water=args.queue_high_water,
                                            low_water=args.queue_low_water),
                         host=args.host, port=args.rpc_port, wire_dtype=args.wire_dtype,
                         model=_model_id(args), peer_id=peer,
                         allow_fault_injection=args.allow_fault_injection, gossip=gnode)
    srv.start()
    advert = (f"{args.public_ip}:{srv.address.rsplit(':', 1)[1]}"
              if args.public_ip else srv.address)
    gnode.self_address = advert

    class _Membership:
        """The transport surface an elastic server joins, backed by the
        listening socket: add_peer swaps the served executor in,
        remove_peer unsets it."""

        def add_peer(self, peer_id, executor):
            srv.executor = executor

        def remove_peer(self, peer_id):
            srv.executor = None

    splits = parse_splits(args.splits) if args.splits else None
    min_block = splits[0] if splits else 0          # the client-local prefix
    total = args.total_blocks or cfg.num_layers
    num_blocks = args.num_blocks
    if num_blocks is None:
        # From the card's free memory (weights, KV arena, headroom), else
        # (the CPU) a third of the remote blocks.
        num_blocks = derive_num_blocks(
            cfg, dtype_bytes=torch.empty((), dtype=_DTYPE_MAP[args.dtype]).element_size(),
            quant=args.quant, device=device)
        if num_blocks is not None:
            num_blocks = min(num_blocks, max(total - min_block, 1))
    num_blocks = num_blocks or max(1, (total - min_block) // 3)
    ping_tx = TcpTransport(registry, wire_dtype=args.wire_dtype)
    es = ElasticStageServer(
        peer, cfg, lambda spec: load_stage_model(args, spec)[1], registry, _Membership(),
        pinger=lambda rec: ping_tx.ping(rec.peer_id),
        num_blocks=num_blocks, total_blocks=total, min_block=min_block,
        balance_quality=args.balance_quality,
        mean_balance_check_period=args.mean_balance_check_period,
        bandwidth_mbps=args.network_bandwidth_mbps,
        # No act_dtype: an arriving activation computes in the float32 the
        # wire decodes to, as the fixed server's.
        executor_kwargs={"device": device,
                         "prefix_cache_bytes": args.prefix_cache_mb << 20,
                         "offload": args.use_cpu_offload,
                         "keep_layers_resident": args.keep_layers_on_gpu},
        advertise_address=advert, warmup=True,
        rng=random.Random(args.seed + os.getpid()), model=_model_id(args))
    gloop = None
    try:
        es.start()
        # The record is None, and the beat skipped, while no span is set.
        gloop = _gossip_loop(registry, gnode,
                             lambda: None if es.spec is None else _with_stats(es._record()))
        _report_peak_memory(device)
        _emit(f"SERVING elastic span=[{es.spec.start},{es.spec.end}) "
              f"addr={advert} peer={peer}", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if gloop is not None:
            gloop.stop()
        es.stop()
        gnode.apply_unregister(peer)
        ping_tx.close()
        srv.stop()
        _report_peak_memory(device)
    return 0


def run_client(args) -> int:
    """One generation through the TCP swarm at ``--registry_addr``."""
    from .runtime.net import RemoteRegistry, TcpTransport

    device = resolve_device(args.device)
    plan = stage_plan(args, model_config(args))
    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    transport = TcpTransport(registry, wire_dtype=args.wire_dtype,
                             model=_model_id(args))
    cfg, shard = load_stage_model(args, plan.stages[0])
    stage0 = StageExecutor(cfg, plan.stages[0], shard, peer_id="client-local",
                           device=device, act_dtype=_DTYPE_MAP[args.dtype])
    del shard
    _build_native(args, device)
    client = PipelineClient(cfg, plan, stage0, transport, registry,
                            use_module_routing=bool(args.use_load_balancing),
                            route_by_latency=args.route_by_latency,
                            total_blocks=args.total_blocks or cfg.num_layers,
                            request_timeout=args.request_timeout,
                            seed=args.seed, model=_model_id(args),
                            metrics=_client_metrics(args))
    try:
        return _generate_and_report(args, client.generate, cfg, pipeline_client=True)
    finally:
        transport.close()
        _report_peak_memory(device)


def _load_tenants_config(raw: Optional[str]):
    """Parse --tenants: inline JSON (starts with '{') or a file path;
    omitted means one 'default' tenant with the library defaults."""
    from .serving import parse_tenants_config

    raw = raw or '{"default": {}}'
    if not raw.lstrip().startswith("{"):
        with open(raw) as f:
            raw = f.read()
    return parse_tenants_config(json.loads(raw))


def run_gateway(args) -> int:
    """--mode gateway: the multi-tenant serving front door. Owns
    ``--gateway_clients`` pipeline clients against the swarm at
    --registry_addr, each with its own stage 0 over one copy of stage 0's
    weights, and serves the framed-TCP ``submit`` verb until interrupted."""
    from .runtime.net import RemoteRegistry, TcpTransport
    from .serving import GatewayServer

    tenants, max_queue_depth, max_active = _load_tenants_config(args.tenants)
    device = resolve_device(args.device)
    plan = stage_plan(args, model_config(args))
    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    cfg, shard = load_stage_model(args, plan.stages[0])
    _build_native(args, device)
    transports, clients = [], []
    for i in range(max(1, args.gateway_clients)):
        tx = TcpTransport(registry, wire_dtype=args.wire_dtype, model=_model_id(args))
        transports.append(tx)
        stage0 = StageExecutor(cfg, plan.stages[0], shard, peer_id=f"gateway-local-{i}",
                               device=device, act_dtype=_DTYPE_MAP[args.dtype])
        clients.append(PipelineClient(cfg, plan, stage0, tx, registry,
                                      use_module_routing=bool(args.use_load_balancing),
                                      route_by_latency=args.route_by_latency,
                                      total_blocks=args.total_blocks or cfg.num_layers,
                                      request_timeout=args.request_timeout,
                                      seed=args.seed, model=_model_id(args),
                                      metrics=_client_metrics(args)))
    del shard
    gw = GatewayServer(clients, tenants, host=args.host, port=args.rpc_port,
                       max_queue_depth=max_queue_depth, max_active=max_active,
                       allow_fault_injection=args.allow_fault_injection)
    gw.start()
    _report_peak_memory(device)
    _emit(f"GATEWAY addr={gw.address} tenants={','.join(sorted(tenants))} "
          f"clients={len(clients)} max_queue_depth={max_queue_depth} "
          f"max_active={max_active}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()
        for tx in transports:
            tx.close()
        _report_peak_memory(device)
    return 0


def run_submit(args) -> int:
    """--mode submit: --submit_requests requests to --gateway_addr as
    --tenant, one after another. No weights load here (the gateway's swarm
    holds the model): only the tokenizer, and the preset for its vocabulary."""
    from .serving import GatewaySubmitClient, Overloaded

    cfg = get_config(args.model)
    tokenizer = load_tokenizer(_checkpoint_dir(args))
    prompt_ids = [i % cfg.vocab_size for i in tokenizer.encode(args.prompt)]
    client = GatewaySubmitClient(args.gateway_addr)
    shed = 0
    for i in range(args.submit_requests):
        t0 = time.perf_counter()
        try:
            res = client.submit(
                args.tenant, prompt_ids, args.max_new_tokens,
                temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
                repetition_penalty=args.repetition_penalty,
                deadline_s=args.deadline_s, timeout=args.request_timeout)
        except Overloaded as exc:
            shed += 1
            _emit(f"[{i}] SHED ({exc.reason}): retry after "
                  f"{exc.retry_after_s:.3f}s -- {exc}")
            continue
        dt = time.perf_counter() - t0
        _emit(f"[{i}] {len(res['tokens'])} tokens in {dt:.2f}s "
              f"(ttft={res['ttft_s'] or 0:.3f}s "
              f"queue_wait={res['queue_wait_s'] or 0:.3f}s "
              f"stopped_by={res['stopped_by']}): "
              f"{tokenizer.decode(res['tokens'])!r}")
        _emit(f"TOKENS={res['tokens']}")
    # Shedding is the gateway doing its job; only all-shed is a failure.
    return 1 if shed == args.submit_requests else 0


def _print_swarm_health(infos: dict, total_servers: int = 0) -> None:
    """The swarm's health from every probed server's ``info``: the peers
    with the most failed requests in their recent-request rings, the
    slowest hops, the prefix stores' hit rate and the least KV room left."""
    if not infos:
        return
    unreachable = max(0, total_servers - len(infos))
    _emit(f"swarm health ({len(infos)}/{total_servers or len(infos)} "
          "server rings probed):")
    if unreachable:
        # The unreachable one is the likeliest to be failing: a clean
        # summary of the others must not read as all clear.
        _emit(f"  WARNING: {unreachable} server(s) unreachable for info — "
              "their rings are NOT included below")
    errs = []     # (count, peer, last failed record)
    slows = []    # (max_dur_ms, peer, verb)
    for peer, inf in infos.items():
        recs = inf.get("recent_requests") or []
        bad = [r for r in recs if r.get("outcome") != "ok"]
        if bad:
            errs.append((len(bad), peer, bad[-1]))
        durs = [(r.get("dur_ms"), r.get("verb")) for r in recs
                if r.get("dur_ms") is not None]
        if durs:
            d, v = max(durs)
            slows.append((d, peer, v))
    if errs:
        errs.sort(reverse=True)
        for n, peer, last in errs[:3]:
            _emit(f"  errors: {peer} x{n} (last: {last.get('verb')} "
                  f"{last.get('outcome')} {last.get('detail', '')})")
    else:
        _emit(f"  errors: none in the {len(infos)} probed ring(s)")
    if slows:
        slows.sort(reverse=True)
        _emit("  slowest hops: " + ", ".join(
            f"{peer} {d:.1f}ms ({v})" for d, peer, v in slows[:3]))
    pfx = [(peer, inf["prefix_cache"]) for peer, inf in infos.items()
           if isinstance(inf.get("prefix_cache"), dict)]
    if pfx:
        hits = sum(st.get("hits", 0) for _, st in pfx)
        misses = sum(st.get("misses", 0) for _, st in pfx)
        total = hits + misses
        rate = f"{hits / total:.0%}" if total else "n/a"
        _emit(f"  prefix cache: {len(pfx)} server(s), hit rate {rate} "
              f"({hits}/{total}), "
              f"{sum(st.get('grains_reused', 0) for _, st in pfx)} grains reused, "
              f"{sum(st.get('bytes', 0) for _, st in pfx) >> 20} MiB resident")
    pressure = [(inf.get("cache_tokens_left"), peer) for peer, inf in infos.items()
                if inf.get("cache_tokens_left") is not None]
    if pressure:
        lo, lo_peer = min(pressure)
        _emit(f"  cache pressure: min {lo} tokens left ({lo_peer}); "
              f"total {sum(p for p, _ in pressure)} across "
              f"{len(pressure)} server(s)")


def _status_telemetry_line(tele) -> str:
    """One line of a server's telemetry summary for ``--mode status``
    (empty when its telemetry is off or it served no step yet)."""
    if not tele or not tele.get("steps_total"):
        return ""
    parts = [f"steps={tele['steps_total']}"]
    if tele.get("steps_per_s") is not None:
        parts.append(f"{tele['steps_per_s']:.1f}/s")
    if tele.get("step_p50_ms") is not None:
        parts.append(f"p50={tele['step_p50_ms']:.1f}ms")
    if tele.get("step_p95_ms") is not None:
        parts.append(f"p95={tele['step_p95_ms']:.1f}ms")
    if tele.get("cache_hit_rate") is not None:
        parts.append(f"cache_hit={tele['cache_hit_rate'] * 100:.0f}%")
    return "\n" + " " * 26 + "telemetry: " + " ".join(parts)


def run_status(args) -> int:
    """--mode status: the swarm at ``--registry_addr`` as an operator reads
    it. One registry snapshot gives a line a live record (span, state,
    throughput, KV room, the final stage, engine, model, published RTTs and
    its ``info`` probe), the coverage as runs of equal replica count from
    the client-local prefix (``--splits``) to ``--total_blocks`` (inferred
    from the live records when not given, with a warning), each uncovered
    run marked, and the swarm's health. Exit 1 when no server is live, 2
    when a block is uncovered, no final stage is live or a server does not
    answer its ``info``, else 0. No weights load."""
    from .runtime.net import RemoteRegistry, TcpTransport

    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    # An explicit --model_name scopes the report; by default the whole swarm.
    records = registry.live_servers(model=args.model_name)
    st = registry.stale_info()
    if st["seeds_down"]:
        line = (f"registry seeds DOWN for {st['seeds_down_s']:.1f}s "
                f"(every --registry_addr address unreachable)")
        if st["stale"]:
            line += (f"; serving STALE cached records for "
                     f"{st['stale_s']:.1f}s (TTL grace)")
        else:
            line += "; records served via a stage server's gossip mirror"
        _emit(line)
    if not records:
        _emit("no live servers")
        return 1
    total = args.total_blocks or max(r.end_block for r in records)
    if not args.total_blocks:
        _emit("warning: total_blocks inferred from LIVE records — dead "
              "tail-stage servers shrink it; pass --total_blocks for a "
              "reliable health check")
    _emit(f"{len(records)} live server(s); total_blocks={total}")
    snap = PlacementRegistry()
    for r in records:
        snap.register(r)
    tx = TcpTransport(snap, wire_dtype=args.wire_dtype)
    infos = {}
    unreachable = []
    for r in sorted(records, key=lambda r: (r.start_block, r.peer_id)):
        extra = ""
        if r.address:
            try:
                inf = tx.info(r.peer_id, timeout=3.0)
                infos[r.peer_id] = inf
                extra = f" served={inf.get('requests_served')} rtt_probe_ok"
                extra += _status_telemetry_line(inf.get("telemetry"))
            except Exception as exc:
                extra = f" info_probe_failed({type(exc).__name__})"
                unreachable.append((r.peer_id, r.address, f"{type(exc).__name__}: {exc}"))
        rtts = ("" if not r.next_server_rtts else
                " rtts=" + ",".join(f"{p}:{v * 1e3:.1f}ms"
                                    for p, v in r.next_server_rtts.items()))
        mdl = f" model={r.model}" if r.model else ""
        eng = f" eng={r.engine}" if r.engine and r.engine != "session" else ""
        _emit(f"  {r.peer_id:24s} [{r.start_block:3d},{r.end_block:3d}) "
              f"{r.state:8s} thr={r.throughput:8.2f} "
              f"cache_left={r.cache_tokens_left}"
              f"{' FINAL' if r.final_stage else ''}{eng}{mdl}{rtts}{extra}")
    # Runs of equal server count from the client-local prefix, which comes
    # from --splits and is never inferred: a dead low server must not read
    # as client-local.
    base = parse_splits(args.splits)[0] if args.splits else 0
    cov = [sum(1 for r in records if r.start_block <= b < r.end_block)
           for b in range(total)]
    runs, start = [], base
    for b in range(base + 1, total + 1):
        if b == total or cov[b] != cov[start]:
            runs.append((start, b, cov[start]))
            start = b
    prefix = f"[0,{base}) client-local; " if base else ""
    _emit("coverage: " + prefix + ", ".join(
        f"[{a},{b})x{n}" + ("  <-- UNCOVERED" if n == 0 else "")
        for a, b, n in runs))
    _print_swarm_health(infos, total_servers=len(records))
    tx.close()
    healthy = all(n > 0 for _, _, n in runs)
    if not any(r.final_stage for r in records):
        # No live final stage finishes no request, whatever the coverage.
        _emit("no live FINAL-stage server  <-- UNHEALTHY")
        healthy = False
    if unreachable:
        for peer, addr, err in unreachable:
            _emit(f"error: server {peer} at {addr} unreachable: {err}",
                  file=sys.stderr)
        healthy = False
    return 0 if healthy else 2


def run_doctor(args) -> int:
    """Merge flight-recorder dumps onto one timeline and report failure
    chains (error -> retry -> failover -> replay), per-session replay cost
    and metric anomalies; with ``--critical_path``, the per-request
    attribution of wall time from the spans the dumps carry."""
    from .telemetry import doctor as _doc

    if not args.dumps:
        _emit("error: --mode doctor needs --dumps: the live scrape of the TCP "
              "swarm servers' event rings is not ported yet (ROADMAP Queue 1 "
              "#8)", file=sys.stderr)
        return 2
    paths = [p.strip() for p in args.dumps.split(",") if p.strip()]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        _emit("error: dump file(s) not found: " + ", ".join(missing),
              file=sys.stderr)
        return 1
    streams = _doc.load_dumps(paths)
    _emit(_doc.diagnose_streams(streams), end="")
    if args.critical_path:
        _emit(_doc.render_critical_path(_doc.critical_path_reports(streams)), end="")
    return 0


def _generate_and_report(args, generate_fn, cfg: ModelConfig,
                         pipeline_client: bool = False) -> int:
    # A remote checkpoint's tokenizer files are in the store's cache.
    tokenizer = load_tokenizer(_checkpoint_dir(args))
    prompt_ids = [i % cfg.vocab_size for i in tokenizer.encode(args.prompt)]
    sampling = SamplingParams(temperature=args.temperature, top_p=args.top_p,
                              top_k=args.top_k,
                              repetition_penalty=args.repetition_penalty)
    kw = {}
    for flag in ("deadline_s", "burst", "speculative_k"):
        if getattr(args, flag):
            if pipeline_client:
                kw[flag] = getattr(args, flag)
            else:
                logger.warning("--%s is ignored in --mode %s "
                               "(pipeline-client modes only)", flag, args.mode)
    res = generate_fn(prompt_ids, args.max_new_tokens, sampling=sampling,
                      eos_token_id=tokenizer.eos_token_id, **kw)
    _emit(f"\n=== Generation ({len(res.tokens)} tokens, "
          f"stopped by {res.stopped_by}) ===")
    _emit(tokenizer.decode(res.tokens))
    _emit(f"TOKENS={res.tokens}")
    _emit(f"\nTTFT: {res.ttft_s:.3f}s")
    _emit(f"Decode: {sum(res.decode_times_s):.3f}s total, "
          f"{res.decode_tokens_per_s:.2f} tokens/s")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.main",
        description="PyTorch/CUDA port of the distributed LLM inference pipeline")
    p.add_argument("--mode", choices=["local", "oracle", "doctor", "registry",
                                      "serve", "client", "gateway", "submit",
                                      "status"],
                   default="local")
    p.add_argument("--model", default="gpt2",
                   help="architecture preset (gpt2, llama-3.1-8b, ...)")
    p.add_argument("--checkpoint", default=None,
                   help="local HF checkpoint dir, or an http(s):// weight "
                        "store (an HF checkpoint layout behind any static "
                        "file server) — servers then fetch ONLY the shards "
                        "covering their span; omit for random init")
    p.add_argument("--weight_cache_dir", default=None,
                   help="remote --checkpoint: local shard cache directory")
    p.add_argument("--weight_cache_bytes", type=int, default=None,
                   help="remote --checkpoint: LRU-evict cached shards "
                        "beyond this many bytes")
    p.add_argument("--splits", default=None,
                   help='stage boundaries, e.g. "10,20,30" (default: 4 even stages)')
    p.add_argument("--dtype", choices=sorted(_DTYPE_MAP), default="float32")
    p.add_argument("--quant", choices=["none", "int8", "nf4"], default="none",
                   help="weight-only block quantization; int8 runs every "
                        "projection through the int8_dot kernel, nf4 through "
                        "the nf4_dot kernel when NF4_KERNEL=1")
    p.add_argument("--lora", default=None, metavar="PATH",
                   help="serve a fine-tune: fold the adapters of a save_lora "
                        ".npz into the attention weights at load (merged "
                        "before --quant; every mode that loads weights "
                        "honors it)")
    p.add_argument("--prompt", default="Hello, my name is")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--repetition_penalty", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs; cuda never falls back to the CPU")
    p.add_argument("--telemetry", action="store_true",
                   help="enable the process-global metrics registry, request "
                        "tracer and flight recorder; the client folds its "
                        "series into the same registry. Default off: every "
                        "instrument site is a cheap boolean check.")
    p.add_argument("--events-dump", dest="events_dump", default=None,
                   metavar="PATH",
                   help="enable the flight recorder and write its event ring "
                        "to PATH as JSONL on fatal exceptions, SIGTERM/SIGINT "
                        "and normal exit: the file --mode doctor reads. "
                        "Records even without --telemetry.")
    p.add_argument("--dumps", default=None, metavar="PATHS",
                   help="doctor mode: comma-separated event-dump files "
                        "(--events-dump output) to diagnose")
    p.add_argument("--critical_path", action="store_true",
                   help="doctor mode: also report each request's critical "
                        "path, its wall time split into network / queue / "
                        "compute / replay / client (the parts sum to the "
                        "wall time). Needs dumps from runs with --telemetry.")
    p.add_argument("--profile_phases", action="store_true",
                   help="enable the host-side phase profiler: per-phase "
                        "latency histograms (server_phase_seconds) over the "
                        "serving path")
    p.add_argument("--log-json", dest="log_json", action="store_true",
                   help="emit every log record as one JSON object per line "
                        "instead of the structured text format")
    # Network roles (registry / serve / client), the reference's flags.
    p.add_argument("--stage", type=int, default=0,
                   help="serve mode: which pipeline stage this server runs "
                        "(1..N; stage 0 lives in the client; 0 with "
                        "--batched serves the full model span for --burst)")
    p.add_argument("--registry_addr", default="127.0.0.1:31330",
                   help="serve/client: the registry's host:port; "
                        "comma-separate a primary and standbys")
    p.add_argument("--registry_port", type=int, default=31330,
                   help="registry mode: listen port (0 = ephemeral)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--rpc_port", type=int, default=0,
                   help="serve mode: data-plane port (0 = ephemeral)")
    p.add_argument("--public_ip", default=None,
                   help="serve mode: advertise this IP instead of --host")
    p.add_argument("--peer_id", default=None)
    p.add_argument("--wire_dtype", choices=["bf16", "f32"], default="bf16",
                   help="activation encoding on the wire")
    p.add_argument("--ttl", type=float, default=45.0,
                   help="registry mode: record TTL seconds; servers learn it "
                        "from heartbeat responses")
    p.add_argument("--peers_cache", default=None, metavar="PATH",
                   help="serve/client: persist the last-known live server "
                        "addresses to PATH (JSON) and load them at start")
    p.add_argument("--request_timeout", type=float, default=60.0)
    p.add_argument("--deadline_s", type=float, default=None,
                   help="end-to-end wall-clock budget for the WHOLE "
                        "generation: each hop ships the seconds remaining, "
                        "servers refuse already-expired work, and "
                        "exhaustion raises DeadlineExceeded instead of "
                        "burning retries (pipeline-client modes and submit)")
    # The multi-tenant serving gateway (--mode gateway / submit).
    p.add_argument("--tenants", default=None, metavar="JSON_OR_PATH",
                   help="gateway mode: tenant table as inline JSON (starts "
                        "with '{') or a path to a JSON file. Per tenant: "
                        "weight (fair share), rate + burst (admission "
                        "token bucket), max_concurrency; top-level "
                        "max_queue_depth / max_active set the global "
                        "watermark and the interleaving width. Omitted: "
                        "one 'default' tenant with library defaults.")
    p.add_argument("--gateway_addr", default="127.0.0.1:31340",
                   help="submit mode: the gateway's host:port "
                        "(--mode gateway prints it at startup)")
    p.add_argument("--gateway_clients", type=int, default=1,
                   help="gateway mode: number of PipelineClients the "
                        "gateway round-robins new sessions across")
    p.add_argument("--tenant", default="default",
                   help="submit mode: tenant to submit as")
    p.add_argument("--submit_requests", type=int, default=1,
                   help="submit mode: how many requests to fire "
                        "sequentially")
    p.add_argument("--allow_fault_injection", action="store_true",
                   help="accept the `fault` admin verb (registry and serve "
                        "roles); never on a production swarm")
    p.add_argument("--queue_high_water", type=int, default=None,
                   help="serve mode: task-pool depth that fires "
                        "`queue_pressure level=high` (default 16)")
    p.add_argument("--queue_low_water", type=int, default=None,
                   help="serve mode: task-pool depth at which pressure "
                        "relaxes to `level=normal` (default 8)")
    p.add_argument("--batched", action="store_true",
                   help="serve mode: the continuous slot-batched engine — "
                        "concurrent plain sessions coalesce into ONE "
                        "captured decode step per round; advertised as "
                        "engine=batched so clients route plain sessions "
                        "here and replays to per-session replicas")
    p.add_argument("--slots", type=int, default=8,
                   help="serve --batched: max concurrent sessions")
    p.add_argument("--max_session_len", type=int, default=2048,
                   help="serve --batched: per-slot KV capacity (tokens)")
    p.add_argument("--burst", type=int, default=0,
                   help="burst decode: N decode ticks per request, sampled on "
                        "a full-span batched peer's device (client and local "
                        "modes; serve --stage 0 --batched captures the N-tick "
                        "burst in its warm-up). 0 = per-step decode")
    p.add_argument("--speculative_k", type=int, default=0,
                   help="speculative decoding: draft up to K tokens per "
                        "round trip (n-gram prompt lookup), verified by the "
                        "final stage (greedy: token-identical; temperature>0: "
                        "distribution-preserving rejection sampling)")
    p.add_argument("--prefix_cache_mb", type=int, default=0,
                   help="enable the content-addressed prompt-prefix KV "
                        "store with this byte budget (MiB) on every stage "
                        "executor, session or batched: repeat prefills reuse "
                        "cached KV for shared prompt prefixes at 64-token "
                        "granularity (runtime.prefix_cache). 0 = off")
    # The reference's flags for engines the port does not have: accepted by
    # the parser so that a reference command line fails with a clear
    # message (refuse_unported_flags), never silently.
    p.add_argument("--model_name", default=None,
                   help="the registry scope of every record and query "
                        "(default: --model); two models can share a registry")
    # Load balancing (elastic servers, module routing).
    p.add_argument("--use_load_balancing", action="store_true",
                   help="local/serve: elastic servers that choose their span "
                        "from the swarm's coverage and re-span when it would "
                        "gain; client/gateway/local: route over block coverage")
    p.add_argument("--route_by_latency", action="store_true",
                   help="module routing minimizes the estimated step time "
                        "(servers' published next-hop RTTs and the client's "
                        "pings) instead of the greedy coverage walk")
    p.add_argument("--num_blocks", type=int, default=None,
                   help="an elastic server's span length (serve: from the "
                        "card's free memory when omitted)")
    p.add_argument("--total_blocks", type=int, default=None,
                   help="blocks of the model (default: its layers); status: "
                        "the range the coverage check spans")
    p.add_argument("--num_servers", type=int, default=3,
                   help="local --use_load_balancing: elastic servers")
    p.add_argument("--balance_quality", type=float, default=0.75)
    p.add_argument("--mean_balance_check_period", type=float, default=120.0)
    p.add_argument("--network_bandwidth_mbps", type=float, default=None)
    p.add_argument("--sp", type=int, default=1, help="not ported")
    p.add_argument("--tp", type=int, default=1, help="not ported")
    p.add_argument("--use_cpu_offload", action="store_true",
                   help="local/serve: each server keeps its span's layers in "
                        "pinned host memory and streams them through the "
                        "device a layer at a time, the next layer's copy "
                        "overlapping the current layer's compute (stage 0, "
                        "inside the client, stays resident)")
    p.add_argument("--keep_layers_on_gpu", type=int, default=0,
                   help="--use_cpu_offload: the first N layers of each "
                        "offloaded span stay on the device")
    p.add_argument("--relay_capacity", type=int, default=0,
                   help="serve mode: volunteer to relay traffic for up to N "
                        "peers that fail the dial-back reachability vote (0 = "
                        "do not volunteer); attaches beyond N are shed")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .telemetry import setup_logging

    setup_logging(json_mode=args.log_json, level=logging.INFO)
    if args.telemetry:
        # Before any component fetches a metric handle; register_all()
        # inside makes every family visible, zero-valued ones too.
        from . import telemetry

        telemetry.enable()
    if args.profile_phases:
        # After the telemetry flip, so the phase histograms land in the
        # enabled registry.
        from .telemetry.profiling import enable_phase_profiling

        enable_phase_profiling()
    if args.events_dump:
        # The recorder alone (the registry stays off unless --telemetry),
        # the crash hooks, and a dump at normal exit.
        import atexit

        from .telemetry import events as _events

        _events.get_recorder().enable()
        _events.emit("process_start", mode=args.mode, pid=os.getpid())
        reg = None
        if args.telemetry:
            from . import telemetry as _t

            reg = _t.get_registry()
        _events.install_crash_hooks(args.events_dump, registry=reg)
        atexit.register(
            lambda: _events.get_recorder().dump(args.events_dump, registry=reg))
    refuse_unported_flags(args)
    try:
        return _run_mode(args)
    except NotImplementedError as exc:
        # What a layer refuses as not ported (MoE on a host-offloaded
        # span) ends the process with its message.
        raise SystemExit(str(exc)) from exc


def _run_mode(args) -> int:
    if args.mode == "doctor":
        return run_doctor(args)  # no model needed
    if args.mode == "registry":
        return run_registry(args)
    if args.mode == "status":
        return run_status(args)  # no model: the swarm's records and info
    if args.mode == "submit":
        return run_submit(args)  # no model: the gateway's swarm holds it
    if args.mode in ("serve", "client", "gateway"):
        # Each loads its own stage's weights only.
        return {"serve": run_serve, "client": run_client,
                "gateway": run_gateway}[args.mode](args)
    cfg, params = load_model(args)
    run = {"local": run_local, "oracle": run_oracle}[args.mode]
    return run(args, cfg, params)


if __name__ == "__main__":
    sys.exit(main())
