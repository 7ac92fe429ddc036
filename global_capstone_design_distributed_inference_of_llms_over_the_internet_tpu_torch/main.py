"""CLI entry point of the PyTorch port: ``--mode local``, ``oracle``,
``doctor``, ``registry``, ``serve`` and ``client``.

Port of the JAX package's ``main.py`` for these modes:

  * ``--mode local``  — in-process cluster: fixed-split stage servers
    (``StageExecutor`` over a ``KVArena``) behind ``LocalTransport``, and
    the pipeline client running stage 0, one generation end to end. With
    no ``--splits`` the model is cut into 4 even stages.
  * ``--mode oracle`` — the unpartitioned model, one ``full_forward`` per
    token: the port's own single-device reference.
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
  * ``--mode client`` — the pipeline client with stage 0 in process and the
    remote stages over ``TcpTransport``, discovered through the registry.
  ``serve`` and ``client`` hold only their stage's weights (every layer is
  still drawn, so the weights equal the full init's), print their peak
  and held device memory as ``PEAK_MEMORY_BYTES=N ALLOCATED_BYTES=M`` and
  build the kernels and the wire codec before they serve; ``serve`` runs
  one throwaway session through its span first, as the reference does. The reference's gossip mirror, dial-back
  reachability vote and relay attach are not ported (ROADMAP Queue 1 #4),
  nor are the flags of the engines the port lacks (``--batched``, ``--sp``,
  ``--tp``, ``--use_load_balancing``, ``--use_cpu_offload``,
  ``--prefix_cache_mb``, ``--relay_capacity``): each exits naming itself.

Telemetry as in the reference: ``--telemetry`` turns on the process-global
metrics registry, tracer and flight recorder (the client folds its series
into that registry); ``--events-dump PATH`` records events and writes them
to PATH at exit, on a fatal exception and on SIGTERM/SIGINT;
``--profile_phases`` turns on the phase profiler; ``--log-json`` logs one
JSON object per line.

Weights are random-initialized from the ``--model`` preset and ``--seed``
(no checkpoint loading yet); tokenization is the UTF-8 byte fallback.
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
    python -m ...main --mode client --registry_addr 127.0.0.1:31330 \\
        --model llama-3.1-8b --quant int8 --dtype bfloat16 --prompt "Hi"
"""

from __future__ import annotations

import argparse
import gc
import logging
import os
import random
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .models.config import ModelConfig, get_config
from .models.partition import StagePlan, StageSpec, parse_splits, slice_stage_params
from .models.quant import quantize_params
from .models.transformer import full_forward, init_kv_cache, init_params
from .ops.sampling import RECENT_WINDOW, SamplingParams, sample_token
from .ops.threefry import prng_key
from .runtime.client import REPEAT_STOP, GenerationResult, PipelineClient, make_server_record
from .runtime.executor import StageExecutor
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
# Tokenizer (byte-level fallback)
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """UTF-8 byte fallback: token id = byte value."""

    eos_token_id: Optional[int] = None

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def load_tokenizer():
    """The byte fallback (checkpoint tokenizers are not ported yet)."""
    return ByteTokenizer()


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def load_model(args) -> Tuple[ModelConfig, dict]:
    """Random init of the ``--model`` preset from ``--seed`` on the device."""
    device = resolve_device(args.device)
    cfg = get_config(args.model)
    logger.info("random-initializing %s (%d layers) on %s", args.model,
                cfg.num_layers, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return cfg, init_params(cfg, gen, dtype=_DTYPE_MAP[args.dtype], device=device)


def load_stage_model(args, spec: StageSpec) -> Tuple[ModelConfig, dict]:
    """Random init of the ``--model`` preset from ``--seed`` that keeps one
    stage's shard only, quantized as ``--quant`` asks: its layers, the
    embeddings for the first stage, the final norm and head for the last.
    Every layer is drawn in order, so the shard equals that stage's slice
    of `load_model`'s weights; the rest is freed before this returns."""
    device = resolve_device(args.device)
    cfg = get_config(args.model)
    logger.info("random-initializing %s layers [%d, %d) of %d on %s",
                args.model, spec.start, spec.end, cfg.num_layers, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dtype=_DTYPE_MAP[args.dtype], device=device,
                         layer_range=(spec.start, spec.end))
    # The kept layers are stacked from index 0: slice them as a span that
    # starts there.
    local = StageSpec(spec.index, spec.role, 0, spec.num_layers)
    shard = _maybe_quantize(args, slice_stage_params(cfg, params, local))
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cfg, shard


def _maybe_quantize(args, params):
    """Apply ``--quant`` weight-only quantization to the layer blocks."""
    if args.quant == "none":
        return params
    return quantize_params(params, args.quant)


def _stage_params(args, cfg: ModelConfig, params, spec):
    return _maybe_quantize(args, slice_stage_params(cfg, params, spec))


# ---------------------------------------------------------------------------
# Modes
# ---------------------------------------------------------------------------

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


def build_local_client(args, cfg: ModelConfig, params) -> PipelineClient:
    """The in-process cluster of ``--mode local``, fixed splits: one
    executor per stage >= 1 registered behind ``LocalTransport``, stage 0
    inside the client."""
    device = resolve_device(args.device)
    plan = stage_plan(args, cfg)
    transport = LocalTransport()
    registry = PlacementRegistry(rng=random.Random(args.seed))
    for spec in plan.stages[1:]:
        peer = f"server-stage{spec.index}"
        ex = StageExecutor(cfg, spec, _stage_params(args, cfg, params, spec),
                           peer_id=peer, device=device,
                           act_dtype=_DTYPE_MAP[args.dtype])
        transport.add_peer(peer, ex)
        registry.register(make_server_record(peer, spec, model=args.model))
    stage0 = StageExecutor(cfg, plan.stages[0],
                           _stage_params(args, cfg, params, plan.stages[0]),
                           peer_id="client-local", device=device,
                           act_dtype=_DTYPE_MAP[args.dtype])
    return PipelineClient(cfg, plan, stage0, transport, registry,
                          seed=args.seed, model=args.model,
                          metrics=_client_metrics(args))


def run_local(args, cfg: ModelConfig, params) -> int:
    """In-process cluster: fixed-split servers + client, one generation."""
    client = build_local_client(args, cfg, params)
    return _generate_and_report(args, client.generate, cfg)


def make_oracle_generate(args, cfg: ModelConfig, params):
    """Unpartitioned generation, one ``full_forward`` per token, with the
    pipeline's sampling rules (per-step seed ``seed + len(tokens)``, EOS
    and 5x-repeat stops). Returns ``generate(prompt_ids, max_new_tokens,
    sampling, eos_token_id=None)`` -> GenerationResult, with the weights it
    runs as its ``params`` attribute.

    As in the reference (``main.py:431-432``), the KV cache takes the
    weights' dtype, where the stage executors keep a float32 cache; under
    ``--dtype bfloat16`` the oracle therefore computes other numbers than
    ``--mode local``. The draw of step i uses ``PRNGKey(seed + i)``."""
    params = _maybe_quantize(args, params)
    wte = params["embed"]["wte"]
    device = wte.device

    def generate(prompt_ids, max_new_tokens, sampling, eos_token_id=None, **_kw):
        max_len = max(128, len(prompt_ids) + max_new_tokens + 1)
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
            tok = sample_token(prng_key(args.seed + len(tokens)), logits[0, -1],
                               recent.to(device), len(window), sampling.temperature,
                               sampling.top_p, sampling.top_k,
                               sampling.repetition_penalty)
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

    generate.params = params
    return generate


def run_oracle(args, cfg: ModelConfig, params) -> int:
    """Single-device unpartitioned generation (the correctness baseline)."""
    return _generate_and_report(args, make_oracle_generate(args, cfg, params), cfg)


# Flags of the reference's serve and client modes whose engines or
# features the port does not have, with their defaults: any other value
# exits naming the flag.
UNPORTED_FLAGS = (("batched", False), ("sp", 1), ("tp", 1),
                  ("use_load_balancing", False), ("use_cpu_offload", False),
                  ("prefix_cache_mb", 0), ("relay_capacity", 0))


def refuse_unported_flags(args) -> None:
    for dest, default in UNPORTED_FLAGS:
        if getattr(args, dest) != default:
            raise SystemExit(f"--{dest} is not ported: the port's servers run "
                             "the per-session engine on one device, with no "
                             "relays")


def _report_peak_memory(device: torch.device) -> None:
    """This process's peak device memory and what it holds now, on a line
    of its own."""
    if device.type == "cuda":
        _emit(f"PEAK_MEMORY_BYTES={torch.cuda.max_memory_allocated(device)} "
              f"ALLOCATED_BYTES={torch.cuda.memory_allocated(device)}", flush=True)


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


def run_serve(args) -> int:
    """One fixed-split stage server over TCP until interrupted; prints its
    peak device memory again when it stops."""
    from .runtime.net import RemoteRegistry, TcpStageServer, TcpTransport
    from .runtime.server import FixedStageServer, _pinger_from_transport
    from .runtime.task_pool import StageRuntime

    device = resolve_device(args.device)
    plan = stage_plan(args, get_config(args.model))
    if not 1 <= args.stage < plan.num_stages:
        raise SystemExit(f"--stage must be 1..{plan.num_stages - 1} for serve "
                         "mode (stage 0 runs inside the client)")
    spec = plan.stages[args.stage]
    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    peer_id = args.peer_id or f"stage{args.stage}-{os.getpid()}"
    ping_tx = TcpTransport(registry, wire_dtype=args.wire_dtype)
    cfg, shard = load_stage_model(args, spec)
    server = FixedStageServer(peer_id, cfg, spec, shard, registry,
                              executor_kwargs={"device": device,
                                               "act_dtype": _DTYPE_MAP[args.dtype]},
                              pinger=_pinger_from_transport(ping_tx),
                              model=args.model)
    del shard
    ex = server.executor
    _build_native(args, device)
    ex.warmup()
    # One compute thread owns the device; the handler threads own sockets.
    runtime = StageRuntime(high_water=args.queue_high_water,
                           low_water=args.queue_low_water)
    srv = TcpStageServer(ex, runtime, host=args.host, port=args.rpc_port,
                         wire_dtype=args.wire_dtype, model=args.model,
                         allow_fault_injection=args.allow_fault_injection)
    srv.start()
    server.address = (f"{args.public_ip}:{srv.address.rsplit(':', 1)[1]}"
                      if args.public_ip else srv.address)
    server.start_serving()
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
    except KeyboardInterrupt:
        pass
    finally:
        ping_tx.close()
        srv.stop()
        _report_peak_memory(device)
    return 0


def run_client(args) -> int:
    """One generation through the TCP swarm at ``--registry_addr``."""
    from .runtime.net import RemoteRegistry, TcpTransport

    device = resolve_device(args.device)
    plan = stage_plan(args, get_config(args.model))
    registry = RemoteRegistry(args.registry_addr, peers_cache=args.peers_cache)
    transport = TcpTransport(registry, wire_dtype=args.wire_dtype,
                             model=args.model)
    cfg, shard = load_stage_model(args, plan.stages[0])
    stage0 = StageExecutor(cfg, plan.stages[0], shard, peer_id="client-local",
                           device=device, act_dtype=_DTYPE_MAP[args.dtype])
    del shard
    _build_native(args, device)
    client = PipelineClient(cfg, plan, stage0, transport, registry,
                            request_timeout=args.request_timeout,
                            seed=args.seed, model=args.model,
                            metrics=_client_metrics(args))
    try:
        return _generate_and_report(args, client.generate, cfg)
    finally:
        transport.close()
        _report_peak_memory(device)


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


def _generate_and_report(args, generate_fn, cfg: ModelConfig) -> int:
    tokenizer = load_tokenizer()
    prompt_ids = [i % cfg.vocab_size for i in tokenizer.encode(args.prompt)]
    sampling = SamplingParams(temperature=args.temperature, top_p=args.top_p,
                              top_k=args.top_k,
                              repetition_penalty=args.repetition_penalty)
    res = generate_fn(prompt_ids, args.max_new_tokens, sampling=sampling,
                      eos_token_id=tokenizer.eos_token_id)
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
                                      "serve", "client"], default="local")
    p.add_argument("--model", default="gpt2",
                   help="architecture preset (gpt2, llama-3.1-8b, ...)")
    p.add_argument("--splits", default=None,
                   help='stage boundaries, e.g. "10,20,30" (default: 4 even stages)')
    p.add_argument("--dtype", choices=sorted(_DTYPE_MAP), default="float32")
    p.add_argument("--quant", choices=["none", "int8", "nf4"], default="none",
                   help="weight-only block quantization; int8 runs every "
                        "projection through the int8_dot kernel, nf4 through "
                        "the nf4_dot kernel when NF4_KERNEL=1")
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
                        "(1..N; stage 0 lives in the client)")
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
    p.add_argument("--allow_fault_injection", action="store_true",
                   help="accept the `fault` admin verb (registry and serve "
                        "roles); never on a production swarm")
    p.add_argument("--queue_high_water", type=int, default=None,
                   help="serve mode: task-pool depth that fires "
                        "`queue_pressure level=high` (default 16)")
    p.add_argument("--queue_low_water", type=int, default=None,
                   help="serve mode: task-pool depth at which pressure "
                        "relaxes to `level=normal` (default 8)")
    # The reference's flags for engines the port does not have: accepted by
    # the parser so that a reference command line fails with a clear
    # message (refuse_unported_flags), never silently.
    p.add_argument("--batched", action="store_true", help="not ported")
    p.add_argument("--sp", type=int, default=1, help="not ported")
    p.add_argument("--tp", type=int, default=1, help="not ported")
    p.add_argument("--use_load_balancing", action="store_true", help="not ported")
    p.add_argument("--use_cpu_offload", action="store_true", help="not ported")
    p.add_argument("--prefix_cache_mb", type=int, default=0, help="not ported")
    p.add_argument("--relay_capacity", type=int, default=0, help="not ported")
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
    if args.mode == "doctor":
        return run_doctor(args)  # no model needed
    if args.mode == "registry":
        return run_registry(args)
    if args.mode in ("serve", "client"):
        # Each loads its own stage's weights only.
        return {"serve": run_serve, "client": run_client}[args.mode](args)
    cfg, params = load_model(args)
    run = {"local": run_local, "oracle": run_oracle}[args.mode]
    return run(args, cfg, params)


if __name__ == "__main__":
    sys.exit(main())
