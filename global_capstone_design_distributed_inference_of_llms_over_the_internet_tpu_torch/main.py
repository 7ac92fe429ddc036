"""CLI entry point of the PyTorch port: ``--mode local``, ``oracle`` and ``doctor``.

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
    servers (no ``--dumps``) needs the TCP swarm, which is not ported yet.

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
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .models.config import ModelConfig, get_config
from .models.partition import StagePlan, parse_splits, slice_stage_params
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


def build_local_client(args, cfg: ModelConfig, params) -> PipelineClient:
    """The in-process cluster of ``--mode local``, fixed splits: one
    executor per stage >= 1 registered behind ``LocalTransport``, stage 0
    inside the client."""
    device = resolve_device(args.device)
    splits = parse_splits(args.splits) if args.splits else None
    plan = (StagePlan.even(cfg.num_layers, 4) if splits is None
            else StagePlan.from_splits(cfg.num_layers, splits))
    transport = LocalTransport()
    registry = PlacementRegistry(rng=random.Random(args.seed))
    for spec in plan.stages[1:]:
        peer = f"server-stage{spec.index}"
        ex = StageExecutor(cfg, spec, _stage_params(args, cfg, params, spec),
                           peer_id=peer, device=device)
        transport.add_peer(peer, ex)
        registry.register(make_server_record(peer, spec, model=args.model))
    stage0 = StageExecutor(cfg, plan.stages[0],
                           _stage_params(args, cfg, params, plan.stages[0]),
                           peer_id="client-local", device=device)
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


def run_doctor(args) -> int:
    """Merge flight-recorder dumps onto one timeline and report failure
    chains (error -> retry -> failover -> replay), per-session replay cost
    and metric anomalies; with ``--critical_path``, the per-request
    attribution of wall time from the spans the dumps carry."""
    from .telemetry import doctor as _doc

    if not args.dumps:
        _emit("error: --mode doctor needs --dumps: the live scrape of servers' "
              "event rings comes with the TCP swarm, which the port does not "
              "have yet (ROADMAP Queue 1 #2)", file=sys.stderr)
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
    _emit(f"\nTTFT: {res.ttft_s:.3f}s")
    _emit(f"Decode: {sum(res.decode_times_s):.3f}s total, "
          f"{res.decode_tokens_per_s:.2f} tokens/s")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.main",
        description="PyTorch/CUDA port of the distributed LLM inference pipeline")
    p.add_argument("--mode", choices=["local", "oracle", "doctor"], default="local")
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
    if args.mode == "doctor":
        return run_doctor(args)  # no model needed
    cfg, params = load_model(args)
    run = {"local": run_local, "oracle": run_oracle}[args.mode]
    return run(args, cfg, params)


if __name__ == "__main__":
    sys.exit(main())
