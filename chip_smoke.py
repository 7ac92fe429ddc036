#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py
(``--kernels-only``: steps 1-3b and stop, a development aid for iterating
on the kernels; it never prints the last line of a smoke pass.)

1. Card: prints ``nvidia-smi``'s name and power limit, torch and CUDA versions.
2. Build: compiles every CUDA kernel of the port from ``csrc/``, one nvcc per
   source, all at once.
3. Kernels: calls each kernel's wrapper (``int8_dot``, ``nf4_dot``) at the
   shapes the main paths give it (llama-3.1-8b projections at M = 1, 2, 8,
   16, the prompt length, the prompt's sequence bucket (the M a padded
   prefill runs at), 128 and 512, each row with the route it took), holds
   it against its plain PyTorch version on the same card, and times the
   kernel, the plain version and one PyTorch library call computing the
   same function. Each is also held at ragged shapes of every route and
   at an x view 2 bytes into its storage (``int8_dot``: on the tensor-core
   and the decode routes). Each kernel's three routes (decode "gemv" at
   M <= 2, "simt", "mma") are timed at M = 1..8 (``int8_dot``) or 1..4
   (``nf4_dot``) on wgu and wd (the crossover scans behind each
   ``MMA_MIN_M``). Each decode kernel is also held at every site with
   float32 x at M = 1 and 2 (``F32_TOL``), must give the same bits on two
   launches in both dtypes (``int8_dot``'s also the same bits for a fused
   weight's columns as for its parts alone), is timed at M = 1 in both
   dtypes beside the old CUDA-core kernel, the plain version and the library
   (``<kernel>_decode``), and at every cluster size (``<kernel>_gemv_plans``,
   the scan behind ``_gemv_plan``); the SASS opcode counts of the decode
   kernels (``int8_dot``'s old CUDA-core kernel beside its new one) are
   printed. The batched engine's regime, M = 8 (every slot of a round), is
   held and timed at every site in float32 x (stages 1-3: each kernel's
   "f32mma" route; F32_TOL) and bf16 x (the tensor cores), beside the
   plain version, the library (``torch.matmul(x32, q.float()) * s`` and
   NF4's counterpart) and the old CUDA-core kernel in the same run, with
   its bound (``<kernel>_batched``; float32 x's operations at a third of
   the bf16 rate, F32_TERMS); so is float32 x at the prompt's bucket (the
   prefill of the stages behind TCP: each kernel's "f32mma" beside the
   CUDA-core kernel it replaced).
   ``nf4_dot``'s "f32mma" is also held at every site at M = 3, 8, 16, 32,
   33, 64 and 512 (F32_TOL), must give the same bits on two launches, for
   rows 0-2 at M = 3 as at M = 32 whatever the other rows hold, for rows
   of a later M tile alone, and for a fused weight's columns as for its
   parts alone (``nf4_dot_f32mma``); its crossover scan against "simt"
   runs at M = 3..16 on wgu and wd with float32 x
   (``nf4_dot_f32mma_crossover``); its SASS (8- and 16-row tiles) must be
   read, hold HMMA and no STL / LDL, and ptxas must report no spill
   (``nf4_f32mma_sass``). ``int8_dot``'s "f32mma"
   is also held at every site at M = 3, 4, 8, 9, 16, 32, 33, 64, 512 and
   2048 (F32_TOL) and timed at M = 3, 8, 16, 32, 33, 64 and 512 beside the
   CUDA-core kernel, the library and the bound; it must give the same bits
   on two launches, for rows 0-2 at M = 3 as at M = 32 whatever the other
   rows hold, for rows of a later M tile alone, and for a fused weight's
   columns as for its parts alone (at M = 8 and the prompt's bucket); it
   is timed at M = 1 and 2 beside the decode kernel with float32 x
   (``int8_dot_f32mma``); its crossover scan against "simt" runs at M =
   3..64 on wgu and wd (``int8_dot_f32mma_crossover``); its SASS (8- and
   16-row tiles) must be read, hold HMMA, no I2F and no STL / LDL, and
   ptxas must report no spill (``int8_gemv_sass``).
   Prints JSON lines of shapes, crossover scan and per-layer sums per
   kernel.
3b. The draw kernel (``sample_draw``, ``csrc/sample_draw.cu``): at V =
   128256 and 1000, B = 1 and 4, temperatures 0.7 and 1.5, 8 seeds each,
   its Gumbel noise must be bit-equal to the plain ``threefry.gumbel`` and
   its tokens equal to the plain draw; planted ties in far-apart blocks go
   to the first index. Times of the kernel, the plain version and
   ``torch.multinomial`` on the same probs (a yardstick), and its bound.
4. Sampler: the captured sampler (``runtime/graphs.Sampler``, one graph
   per batch rows and vocabulary) must give the eager device sampler's
   tokens at llama-3.1-8b's vocabulary for B = 1 and 2 over greedy and
   every top_k 0 / 1 / 50, top_p 0.9 / 1.0, rp 1.0 / 1.5, with windows of
   0, 2, 3 identical and 60 tokens; host ms a call of both (each ends in
   its one read), the draws alone, a replay's device ms.
5. int8 path: builds the port's in-process ``--mode local`` cluster through
   ``main.py``'s own functions (llama-3.1-8b at full width and depth, random
   weights from a seed, ``--quant int8``, bfloat16, 4 even stages), serves 3
   requests (two greedy, one sampled), checks that every projection went
   through ``int8_dot`` (launch counts reset just before, read just after),
   whose every prefill projection must take the tensor-core route
   (``_launches_mma``) and every launch the tensor cores or the decode
   kernel (``_launches == _launches_mma + _launches_gemv``), and every
   sampled token through one ``sample_draw``
   (launches and the last stage's sampler replays >= sampled tokens), and
   holds the greedy tokens to an unsplit greedy loop over ``full_forward``
   with the executors' float32 cache and the sampled request's to the
   same loop sampling with the plain sampler and the pipeline's step seeds
   (equal, or a first difference where the reference's two best perturbed
   scores are within the near-tie tolerance, or where its draw or the
   run's lies within it of the top-k / top-p cut). Every
   stage replays CUDA graphs of its step (``runtime/graphs.py``): the
   launch counts are the ones the graphs hold, added per replay; captures
   and replays are counted per path (set to 0 with the launch counts) and
   replays must reach stages x tokens; TTFT of the first request (which
   pays the captures) is reported apart from the later ones, with the
   peak and held device memory. Then, on this path: the capture check
   (for every key the run captured, one replay and the eager step on
   copies of the same cache must be bit-equal), the host syncs of one more
   greedy and one more sampled request (one a token: the read of the
   token), a
   ``torch.profiler`` trace of 8 captured decode steps (device busy ms and
   idle share), and two sessions open at once (a greedy request while
   another session holds its lease: its lease slot is new, so it pays
   captures of its own; its TTFT, captures and reserved memory beside a
   request on a reused slot, whose tokens it must equal).
6. NF4 path: the same with ``--quant nf4`` and ``NF4_KERNEL=1``, through
   ``nf4_dot``, with the same gates (every launch a prefill on the tensor
   cores or a decode step on the decode kernel) and the capture check.
   Both serve phases run with telemetry
   off; the NF4 client is built as under ``--telemetry``, so its metrics go
   to the process-global registry, which stays disabled until step 7.
7. Telemetry on the NF4 path, same client: one greedy request run with
   telemetry off and on in turn (4 pairs, ABBA order) must give the same
   tokens and the same ``nf4_dot`` launch counts of both routes; the median
   decode ms/token and TTFT of each side are printed, not gated. One more
   pair under torch's sync debug mode must report as many host syncs with
   telemetry on as off. Then failover with
   telemetry and the flight recorder on: a second stage-2 executor joins,
   the pinned stage-2 peer is killed after its 3rd decode step of a greedy
   request, and the client must recover onto the replica with the
   fault-free tokens. The recorder must hold the session's start, transport
   error / peer failure, failover, replay start and end, and end; its dump
   (with the registry) goes through the doctor, whose one failure chain must
   name the tokens the client replayed, and each request's critical-path
   parts must sum to its wall time. Prints the registry's summary and the
   per-layer families (client TTFT, step and per-hop times, server step
   latency per phase and per stage, KV bytes, transport bytes) and the
   hooks' own host cost (client and transport over stub stages, telemetry
   off and on), then turns telemetry off and clears it.
8. In-process TCP drive, after each of the int8 and NF4 paths (before the
   telemetry phase on the NF4 one). The path's stage executors, with no
   act_dtype (as ``--mode serve`` builds them: an arrival computes in the
   float32 the wire decodes to), behind ``TcpStageServer``s (each with its
   own ``StageRuntime``) registered at a ``RegistryServer``, and the same
   3 requests through a ``TcpTransport`` client (``RemoteRegistry``
   discovery). int8 runs at wire f32, so each hop hands on the float32 it
   computed: first the requests run in process with every executor after
   stage 0 given ``act_dtype=torch.float32`` (held to the references as in
   step 5), and the TCP tokens must equal that chain's exactly. NF4 runs at
   wire bf16, ``--wire_dtype``'s default, so each hop rounds to bfloat16:
   its requests are held to the float32-cache references as in step 5.
   Both with the launch,
   draw and graph-replay gates of steps 5-6 (counts set to 0 just before
   the requests, read just after; tensor-core launches: stage 0's prefill
   sites, the only ones still given bf16 x; on both every decode step on
   the decode kernel, and stages 1-3's float32 prefill exactly on the
   route `_route` gives it, "f32mma" for both kernels, with no launch on
   any other route) and the
   native wire codec loaded. On the int8 path a stage-2 replica joins and the pinned stage-2
   server is ``stop()``ped after its 3rd decode step of a greedy request:
   the client must recover onto the replica with the fault-free tokens.
8b. Oracle (after the int8 TCP drive): ``--mode oracle --quant int8``'s
   generation of the first prompt, greedy and then sampled, through the
   fused engines (``runtime/fused_decode.py``, one captured decode step
   replayed per token; the sampled one holds the sampler) twice, and
   through the oracle's eager per-token loop: the tokens must be equal;
   decode ms/token and TTFT of both.
9. CLI drive: ``--mode registry``, then ``--mode serve --stage 1..3 --quant
   int8 --dtype bfloat16 --seed 0 --wire_dtype f32`` and ``--mode client``
   with the first greedy prompt, each a process of its own on the card,
   started one after another (handshake lines scraped, port 0
   everywhere). The client's printed generation must equal the in-process
   int8 float32 chain's for that prompt (step 8), and the token ids on its
   ``TOKENS=`` line must equal that run's.
   Each process's peak device memory is read from its ``PEAK_MEMORY_BYTES``
   lines (a server prints one when it starts serving and one when it stops
   on SIGINT, after the request); every child is killed at the end,
   whatever happens.
   ``tcp_path`` and ``cli_path`` JSON lines carry TTFT, decode ms/token,
   the per-hop ``client_stage_time_seconds``, the client's ``socket``
   phase and the peaks.
10. Batched path (after the oracle; ``batched_path``): the int8 path's
   stages 1-3 as ``--mode serve --batched`` builds them (batched engines,
   ``runtime/batching.py``: bfloat16 slot caches of 8 slots x 2048 rows,
   each warmed up, adapters with the default round window) and 8 clients
   on threads, each with its own warmed-up stage-0 executor, over a
   ``LocalTransport`` that hands each hop float32 (as a TCP hop at wire
   f32 does; stage 1's round window covers the clients' stage-0 steps,
   which share the card: STAGE0_STEP_S): 8 requests at once (6 greedy, 2
   sampled), each held to its
   float32-cache reference as in step 5; no capture after the warm-ups;
   each stage's rounds at most MAX_NEW_TOKENS - 1 + ROUND_SLACK (not one a
   session and token); ``int8_dot`` launches by route (stage 0's prefill
   on the tensor cores and decode on the decode kernel; on stages 1-3
   exactly one "f32mma" launch a site and layer for each round and for
   each float32 prefill, and none on the CUDA cores); a
   ``sample_draw`` a sampled token; at most one host sync a prefill and
   one a round of the last stage; each stage's ``arrivals`` are logged (a
   step's spread against the round window, the hops between stages). Then
   the fill scan (1, 2, 4, 8 sessions
   at once: ms a round, tokens/s; each fill's tokens equal the fill-8
   run's), the same 8 requests one after another on the session engines,
   every captured key's replay bit-equal to its eager step (outputs, head
   logits, cache writes), the same 8 sessions over in-process TCP
   (``TcpStageServer`` with no runtime, wire f32; stages 2 and 3 there
   take a round window of TCP_HOP_S a session: tokens equal to the
   in-process run's, the same gates; in every batched run the sessions
   start decoding together, once each has its first token), and each
   stage's round alone (device
   ms at fills 1/2/4/8, the last stage's leader round and its syncs, top
   kernels). Prints ``batched_path``.
10b. Burst path (after the batched path, whose engines are released
   first; ``burst_path``): one full-span batched engine on the int8 path's
   weights (all 32 layers, bf16 slot caches of 8 slots x 2048 rows),
   warmed up as ``--mode serve --stage 0 --batched --burst 8`` warms it
   (the reserved memory before and after the 8-tick burst's capture
   printed). The batched path's 8 requests per step on that engine
   (``decode_batch`` + ``sample_round``), through ``decode_burst`` (8
   ticks a burst) and through ``burst_stream``: both bursts' tokens must
   equal the per-step tokens, which are held to the float32-cache
   references as in step 5; one host sync and one replay a burst, no
   capture; ``int8_dot`` launches exactly 4 x 32 x 8 a burst, counted by
   route, none on the CUDA cores; ``sample_draw`` one a slot row a tick.
   Then 8 client threads asking for ``burst=8`` through the adapter over
   ``LocalTransport``: no ``burst_fallback`` event, a dispatch a round,
   the engine's tokens, <= one host sync a prefill and a round, no
   capture, and the launches of the prefills and rounds exactly; the same
   8 clients over in-process TCP (``TcpStageServer`` with no runtime, wire
   f32, beside a second full-span peer): equal tokens; one more greedy
   request whose pinned peer is ``stop()``ped after its first burst: it
   recovers onto the other peer with the fault-free tokens (the recovery
   step's wall printed); the device ms of a burst replay at fills
   1/2/4/8 and of a tick at N = 1, 4, 8, 16 (each N's capture seconds and
   reserved memory). Prints ``burst_path``.
11. Batched CLI drive (after step 9): ``--mode registry``, 3 x ``--mode
   serve --batched``, and two ``--mode client`` processes at once, whose
   generations and ``TOKENS=`` ids must equal the in-process batched run's
   for their prompts; prints ``batched_cli_path``.
11b. Burst CLI drive: ``--mode registry``, one ``--mode serve --stage 0
   --batched --burst 8`` and two ``--mode client --burst 8`` processes at
   once, whose generations and ``TOKENS=`` ids must equal the in-process
   burst clients'; prints ``burst_cli_path``.
12. Prints the ``kernels`` JSON line (``int8_dot``, ``nf4_dot``,
   ``sample_draw``; each matmul with its launches by route in process and
   over TCP, the batched path's and the burst path's launches by route,
   and its M = 8 and float32 prefill layers) and
   ``{"ok": true, "device": {...}}`` as its last line.

Any failure raises and the script exits non-zero without the last line. It
refuses to run without a CUDA device, and outside a checkout of the repo.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

PORT = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch"
MODEL = "llama-3.1-8b"
PROMPTS = ("The quick brown fox jumps over", "Pipeline stages pass activations",
           "Sampling with a seed: once upon")
MAX_NEW_TOKENS = 32
# The batched path: `--mode serve --batched`'s defaults (slots a stage, KV
# rows a slot), its 8 requests (the three above and five more prompts of
# 30-32 bytes; 6 greedy, 2 sampled), and the rounds a stage may take beyond
# one a decode step: sessions that finish their prefill apart decode alone
# until they meet in a round, and a round that closes before a straggler
# arrives starts another (at most two each, say, for 8 sessions).
SLOTS = 8
MAX_SESSION_LEN = 2048
BATCH_PROMPTS = PROMPTS + ("Eight sessions share one round", "Slot caches keep every session",
                           "A batched step serves them all", "Stage servers hand on hidden st",
                           "Tokens come back in one read ok")
BATCH_SAMPLED = (2, 7)   # indices of BATCH_PROMPTS sampled; the rest greedy
ROUND_SLACK = 2 * SLOTS
# The batched drives' clients share the card with the servers: each
# client's stage-0 decode step runs after the others' (3-4.5 ms each with
# its host work; scripts/torch_batched_rounds.py), so the last session
# reaches stage 1 up to ~36 ms after the first at 8 sessions, and the
# default 3 ms window splits them into 2-3 rounds a step. Stage 1's window
# covers that spread (STAGE0_STEP_S a session). In process stages 2 and 3
# keep the default: a round's sessions leave stage 1 together and a step's
# arrivals at stages 2 and 3 spread 0.7-1.2 ms at the median and 3.4 at most
# on the H100 (`arrivals`, PERF.md).
STAGE0_STEP_S = 0.005
# Over in-process TCP each hop of every session is Python work on this one
# interpreter (a handler's reply, the client's receive and send, the next
# handler's receive): 18-24 ms a hop at the median, and a step's arrivals at
# stages 2 and 3 spread 2.1-3.0 ms at the median, 3.2-5.7 at the p90 and up
# to 9.8. A 3 ms window splits such a step, and a session left behind stays
# a round behind its step's others, so splits pile up: at the default stages
# 2 and 3 ran 44-59 rounds in both runs of one H100 call (the gate allows
# 47), 31-32 at 1 ms a session, 8 ms at 8 sessions
# (scripts/torch_batched_tcp.py, PERF.md). Over TCP stages 2 and 3 take
# TCP_HOP_S a session; in process the default holds.
TCP_HOP_S = 0.001
# The burst path: a full-span server's engine (`--mode serve --stage 0
# --batched`'s defaults, SLOTS x MAX_SESSION_LEN), BURST_TICKS decode ticks a
# replay; the tick counts whose device ms a tick is scanned at fill 8.
BURST_TICKS = 8
BURST_TICK_SCAN = (1, 4, 8, 16)
# (site, K, N) of llama-3.1-8b's four projection launches per layer after the
# executor's fusion: wqkv = wq|wk|wv, wgu = wg|wu.
SITES = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("wgu", 4096, 28672),
         ("wd", 14336, 4096))
# Published dense peaks (data sheets): bytes/s of device memory, and bf16
# tensor-core FLOP/s, the rate of the kernel's input type.
PEAKS = (("H200", 4.8e12, 989e12), ("H100 NVL", 3.9e12, 835e12),
         ("H100 PCIe", 2.0e12, 756e12), ("H100", 3.35e12, 989e12))
# A float32-x call's operations at their least: x as three bf16 terms on the
# bf16 tensor cores gives each float32 x times int8 product exactly
# (int8_dot's batched route), so the bound takes three times the operations
# at the bf16 rate (a third of the rate), not the CUDA cores' float32 rate.
F32_TERMS = 3
BF16_TOL = 2.0 ** -7   # max|kernel - plain| <= BF16_TOL * max|plain|: one
#                        bf16 ulp at the output's scale (sums in other orders)
F32_TOL = 1e-5         # float32 activations, relative to max|plain|
# int8_dot's float32 route: the M it is held at (the batched rounds, both
# tile sizes, the prompt's bucket, failover replays, prefill chunks) and
# the M it is timed at beside the CUDA-core kernel it replaced.
F32_CHECKED_M = (3, 4, 8, 9, 16, 32, 33, 64, 512, 2048)
F32_TIMED_M = (3, 8, 16, 32, 33, 64, 512)
LOGIT_GAP_TOL = 2.0 ** -6  # a near-tie: top-2 gap <= this * max|logit|
KILL_AFTER_DECODES = 3  # the failover drives kill the pinned peer after this
#                         many decode steps it served
CLI_STEP_TIMEOUT_S = 300  # each CLI process: its handshake line, or the client's run
TELEMETRY_PAIRS = 4     # telemetry off / on runs of one request, in ABBA order
HOOK_STEPS = 2000       # decode steps of the stub pipeline that prices the hooks
LIBRARY_NOTE = ("torch.matmul(x, dequantized bf16 weight): a yardstick that "
                "reads the weight as bf16; the port never calls it")
REPLACES = {"int8_dot": "ops/int8_kernel.py:98", "nf4_dot": "ops/nf4_kernel.py:132",
            # Not a Pallas kernel: the reference leaves the draw to XLA in
            # sample_token (jitted as sample_token_jit).
            "sample_draw": "ops/sampling.py:309"}
# The draw's bound: the integer instructions an element needs on sm_90,
# against the CUDA cores' int32 rate: 64 int32 lanes an SM (NVIDIA's Hopper
# architecture white paper) x 132 SMs x 1.98 GHz (the H100 SXM's boost
# clock). An element: the counter's low word plus the key (1 IADD3; the
# high word is 0 and x0 starts at the key) + 20 rounds x 3 (IADD3, one
# SHF.L.W funnel shift for the constant rotate, LOP3 xor) + 5 key
# injections x 2 words (one IADD3 each, the round constant folded in) + the
# uniform's bits (the output xor, the shift, the or) = 74. The float work
# (the uniform's product, two logf, the score) is not counted: it only
# raises the bound. `sass_counts` reads the built kernel's own opcodes
# (SHF.L.W counts the cipher's rotates).
DRAW_INT_OPS = 74
INT32_OPS_PER_S = 64 * 132 * 1.98e9
DRAW_LIBRARY_NOTE = ("no single PyTorch call draws threefry Gumbel-max tokens; "
                     "multinomial_ms times torch.multinomial on the same probs, "
                     "another draw, as a yardstick only")
# The memory line `--mode serve` and `--mode client` print.
MEMORY_LINE = r"PEAK_MEMORY_BYTES=(\d+) ALLOCATED_BYTES=(\d+) RESERVED_BYTES=(\d+)"


# Every line of the run is also kept here: the JSON lines outgrow the tail
# of the output that a remote run returns.
LOG_PATH = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke.log"
_log_lines = []


def log(*parts):
    line = " ".join(str(p) for p in parts)
    _log_lines.append(line)
    print(line, flush=True)  # noqa: T201


def save_log() -> None:
    if _log_lines:
        LOG_PATH.parent.mkdir(exist_ok=True)
        LOG_PATH.write_text("\n".join(_log_lines) + "\n")


def ptxas_usage(text: str):
    """(kernel, line) for each register / spill line of ``nvcc -Xptxas -v``,
    the kernel named by its template arguments, e.g.
    ``nf4_dot_kernel<bf16,8>``."""
    kernel = "?"
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d((?:int8|nf4)_(?:dot(?:_mma)?|gemv|f32mma)_kernel)I(.*?)EEv",
                          entry.group(1))
            if m is None:
                kernel = entry.group(1)
                continue
            args = m.group(2)
            dtype = (["float"] if args.startswith("f") else
                     ["bf16"] if args.startswith("13__nv_bfloat16") else [])
            ints = re.findall(r"Li(\d+)E", args)
            kernel = f"{m.group(1)}<{','.join(dtype + ints)}>"
        elif "registers" in line or "spill" in line:
            yield kernel, line.strip()


def card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return line.splitlines()[0]


def peaks_for(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks for {name!r}")


def build_kernels(modules) -> float:
    """Build every kernel at once, one nvcc per source."""
    from importlib import import_module

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        list(pool.map(lambda m: import_module(m).build(), modules))
    return time.monotonic() - t0


def cuda_ms(fn, torch, reps: int = 25, flush=None, spin: bool = False) -> float:
    """Median device time of one call, CUDA events around each call. A
    write of `flush` (1 GiB) before each call evicts the L2 (the main path
    reads each weight cold) and keeps the stream busy while the host
    enqueues the call, so the events bracket device time, not host time.
    `spin` keeps the stream busy with a spin kernel instead, leaving the
    L2 as the last call left it (inputs the main path has just written)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        elif spin:
            torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_bf16(torch, name, site, x, y, ref) -> float:
    """max|kernel - plain|, held to BF16_TOL * max|plain|."""
    m = x.shape[0]
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and tuple(y.shape) == (m, ref.shape[1])
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (err <= BF16_TOL * scale and torch.isfinite(y).all()):
        raise AssertionError(f"{name} {site} M={m}: max|kernel-plain| "
                             f"{err} > {BF16_TOL} * {scale}")
    return err


def check_and_time(torch, name, site, x, kernel_fn, plain_fn, library_fn,
                   nbytes, bw, flops, flush):
    """Hold one kernel call against its plain version (bf16 rule) and time
    the kernel, the plain version and the library yardstick."""
    m, k = x.shape
    ref = plain_fn()
    err = check_bf16(torch, name, site, x, kernel_fn(), ref)
    n = ref.shape[1]
    ops = 2 * m * k * n
    return {"site": site, "M": m, "K": k, "N": n, "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, torch, flush=flush),
            "plain_ms": cuda_ms(plain_fn, torch, flush=flush),
            "library_ms": cuda_ms(library_fn, torch, flush=flush),
            "bytes": nbytes,
            "bound_ms": max(nbytes / bw, ops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / flops else "operations",
            "library": LIBRARY_NOTE}


def check_f32(name, site, y32, ref32):
    err32 = (y32 - ref32).abs().max().item()
    if not err32 <= F32_TOL * ref32.abs().max().item():
        raise AssertionError(f"{name} {site} float32: max err {err32}")
    return err32


def int8_weight(torch, quant, gen, dev, k: int, n: int):
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((1, n), generator=gen, device=dev) * 1e-3 + 1e-4
    return quant.QuantizedTensor(q, s, "bfloat16")


def int8_bytes(m: int, k: int, n: int, xsize: int) -> int:
    """Bytes one int8_dot call must move: x, the int8 weight, its scales, y."""
    return m * k * xsize + k * n + n * 4 + m * n * xsize


def int8_phase(torch, ik, dev, prompt_len: int, prefill_m: int, bw: float,
               flops: float, flush, f32_flops: float):
    """int8_dot at every main-path shape: agreement and times, each row with
    its route (decode M = 1 and 2 on "gemv"); float32 x at M = 1 and 2 on
    "gemv" (F32_TOL) and at M = 16 on "f32mma"; two launches of the decode
    kernel bit-equal (bf16 and float32); at M = 1 the decode kernel, the old
    CUDA-core kernel ("simt"), the plain version and the library at every
    site in both dtypes (`decode` rows); a fused weight's columns bit-equal
    to its parts' alone on the decode route; the decode kernel at every
    cluster size at M = 1 (the plan scan behind `_gemv_plan`); ragged shapes of
    every route and an x view at an offset on the tensor-core and the
    decode routes (and the float32 route); the crossover scan of the three
    kernels at M = 1..8 on wgu and wd; the batched regime, M = SLOTS in
    float32 (the float32 route beside the old CUDA-core kernel) and bf16
    (`batch_rows`), and the float32 prefill at M = prefill_m (`batch_rows`,
    the stages behind TCP, beside the old kernel); the float32 route's own
    checks (`f32mma_checks`; a fused weight's columns bit-equal to its
    parts' at M = SLOTS and prefill_m too) and its crossover scan against
    "simt" at M = 3..64 on wgu and wd. Returns (rows, scan, decode, plans,
    batch, f32mma, f32_scan)."""
    from importlib import import_module

    quant = import_module(PORT + ".models.quant")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, scan, decode, plans, batch, f32mma, f32_scan = [], [], [], [], [], [], []
    ms = tuple(sorted({1, 2, 8, 16, prompt_len, prefill_m, 128, 512}))
    for site, k, n in SITES:
        w = int8_weight(torch, quant, gen, dev, k, n)
        q, s = w.q, w.s
        w_deq = (q.float() * s).to(torch.bfloat16)   # library yardstick only
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            row = check_and_time(
                torch, "int8_dot", site, x, lambda: ik.int8_dot(x, w),
                lambda: ik.int8_dot_reference(x, q, s),
                lambda: torch.matmul(x, w_deq),
                int8_bytes(m, k, n, 2), bw, flops, flush)
            row["route"] = ik._route(m, k, n, x.dtype)
            rows.append(row)
        log(f"int8_dot {site} K={k} N={n}: bf16 ok at M={','.join(map(str, ms))} "
            f"(routes {[r['route'] for r in rows[-len(ms):]]})")
        assert [r["route"] for r in rows[-len(ms):][:2]] == ["gemv", "gemv"]
        q32 = q.float()                              # library yardstick only
        rows_1, point = decode_checks(
            torch, "int8_dot", ik, site, k, n, lambda x: ik.int8_dot(x, w),
            lambda x, route, plan=None: ik._launch(x, q, s, route, plan),
            lambda x: ik.int8_dot_reference(x, q, s),
            {torch.bfloat16: lambda x: torch.matmul(x, w_deq),
             torch.float32: lambda x: torch.matmul(x, q32) * s},
            int8_bytes, -(-k // ik.GEMV_ROWS), gen, dev, bw, flush, "f32mma")
        decode += rows_1
        plans.append(point)
        batch += batch_rows(
            torch, "int8_dot", ik, site, k, n, lambda x: ik.int8_dot(x, w),
            lambda x: ik.int8_dot_reference(x, q, s),
            {torch.bfloat16: lambda x: torch.matmul(x, w_deq),
             torch.float32: lambda x: torch.matmul(x, q32) * s},
            int8_bytes, gen, dev, bw, {torch.float32: f32_flops, torch.bfloat16: flops},
            flush, old=lambda x: ik._launch(x, q, s, "simt"))
        batch += batch_rows(
            torch, "int8_dot", ik, site, k, n, lambda x: ik.int8_dot(x, w),
            lambda x: ik.int8_dot_reference(x, q, s),
            {torch.float32: lambda x: torch.matmul(x, q32) * s}, int8_bytes, gen, dev, bw,
            {torch.float32: f32_flops}, flush, m=prefill_m, dtypes=("float32",),
            old=lambda x: ik._launch(x, q, s, "simt"))
        del q32
        f32mma.append(f32mma_checks(torch, ik, site, k, n, q, s, gen, dev, flush, bw,
                                    f32_flops))
        # The decode kernel's and the float32 route's plans depend on K
        # alone: a fused weight's columns and a part's alone (wq, wk of
        # wq|wk|wv; wg of wg|wu, as a full_forward over the loaded weights
        # runs them) give the same bits.
        if site in ("wqkv", "wgu"):
            cuts = ((0, 4096), (4096, 5120)) if site == "wqkv" else ((0, n // 2),)
            for dtype, m in ((torch.bfloat16, 1), (torch.float32, 1),
                             (torch.float32, SLOTS), (torch.float32, prefill_m)):
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                whole = ik.int8_dot(x, w)
                for a, b in cuts:
                    part = quant.QuantizedTensor(q[:, a:b].contiguous(),
                                                 s[:, a:b].contiguous(), "bfloat16")
                    if not torch.equal(whole[:, a:b], ik.int8_dot(x, part)):
                        raise AssertionError(f"int8_dot {ik._route(m, k, n, dtype)} {site} "
                                             f"{dtype} M={m}: columns {a}:{b} differ alone")
            log(f"int8_dot {site} gemv (bf16 and float32) and f32mma (M={SLOTS}, {prefill_m}): "
                f"columns {cuts} bit-equal alone")
        if site == "wgu":                            # a ragged M, tensor cores
            x = torch.randn((33, k), generator=gen, device=dev).to(torch.bfloat16)
            assert ik._route(33, k, n, x.dtype) == "mma"
            err = check_bf16(torch, "int8_dot", site, x, ik.int8_dot(x, w),
                             ik.int8_dot_reference(x, q, s))
            log(f"int8_dot {site} ragged M=33 (mma): max err {err:.3e}")
            # A result depends on its row of x and its column of q alone: the
            # prompt's rows of a taller x, and the gate half of the fused
            # weight alone (other tiles), give the same bits.
            x = torch.randn((128, k), generator=gen, device=dev).to(torch.bfloat16)
            short = ik.int8_dot(x[:prompt_len], w)
            gate = quant.QuantizedTensor(q[:, : n // 2].contiguous(),
                                         s[:, : n // 2].contiguous(), "bfloat16")
            if not (torch.equal(short, ik.int8_dot(x, w)[:prompt_len])
                    and torch.equal(short[:, : n // 2], ik.int8_dot(x[:prompt_len], gate))):
                raise AssertionError("int8_dot mma: a result depends on M or N")
            log(f"int8_dot {site} mma: M={prompt_len} rows bit-equal at M=128 and "
                f"at N={n // 2}")
        if site in ("wgu", "wd"):
            scan += scan_routes(torch, "int8_dot", site, k, gen, dev,
                                lambda x, route: ik._launch(x, q, s, route),
                                lambda x: ik.int8_dot_reference(x, q, s), flush,
                                routes=("gemv", "simt", "mma"), ms=range(1, 9),
                                takes=lambda route, m: route != "gemv"
                                or m <= ik.GEMV_MAX_M)
            f32_scan += scan_routes(torch, "int8_dot", site, k, gen, dev,
                                    lambda x, route: ik._launch(x, q, s, route),
                                    lambda x: ik.int8_dot_reference(x, q, s), flush,
                                    routes=("simt", "f32mma"), ms=range(3, 65),
                                    dtype=torch.float32)
        del q, s, w, w_deq
    # Ragged shapes: the K tail inside a step or a stage, the last column
    # block part full; N % 16 != 0 takes the CUDA-core route, at decode M
    # too, and so does a K past the decode kernel's x stage.
    for k, n, m, dtype, want in ((100, 97, 16, torch.bfloat16, "simt"),
                                 (328, 48, 33, torch.bfloat16, "mma"),
                                 (100, 97, 1, torch.bfloat16, "simt"),
                                 (4096, 4104, 1, torch.bfloat16, "simt"),
                                 (100, 97, 2, torch.float32, "simt"),
                                 (ik.GEMV_MAX_K + 32, 48, 1, torch.bfloat16, "simt"),
                                 (100, 96, 1, torch.bfloat16, "gemv"),
                                 (130, 48, 2, torch.bfloat16, "gemv"),
                                 (4100, 4112, 1, torch.float32, "gemv"),
                                 (4104, 96, 1, torch.bfloat16, "gemv"),
                                 (130, 48, 2, torch.float32, "gemv"),
                                 (ik.GEMV_MAX_K, 48, 2, torch.float32, "gemv"),
                                 (132, 48, 5, torch.float32, "f32mma"),
                                 (130, 48, 5, torch.float32, "simt"),
                                 (4100, 4112, SLOTS, torch.float32, "f32mma"),
                                 (126 * ik.GEMV_ROWS, 48, 3, torch.float32, "f32mma"),
                                 (ik.GEMV_MAX_K, 48, SLOTS, torch.float32, "f32mma"),
                                 (ik.GEMV_MAX_K + 32, 48, 3, torch.float32, "simt"),
                                 (100, 97, SLOTS, torch.float32, "simt"),
                                 (4100, 4112, 33, torch.float32, "f32mma"),
                                 (132, 48, 17, torch.float32, "f32mma"),
                                 (ik.GEMV_MAX_K, 48, 40, torch.float32, "f32mma"),
                                 (130, 48, 40, torch.float32, "simt"),
                                 (100, 97, 32, torch.float32, "simt"),
                                 (ik.GEMV_MAX_K + 32, 48, 17, torch.float32, "simt")):
        w = int8_weight(torch, quant, gen, dev, k, n)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        assert ik._route(m, k, n, x.dtype) == want
        y, ref = ik.int8_dot(x, w), ik.int8_dot_reference(x, w.q, w.s)
        err = (check_bf16(torch, "int8_dot", f"K={k} N={n}", x, y, ref)
               if dtype == torch.bfloat16 else check_f32("int8_dot", f"K={k} N={n}", y, ref))
        log(f"int8_dot ragged K={k} N={n} M={m} {dtype} ({want}): max err {err:.3e}")
    # x as a view one element into its storage: the tensor-core, the decode
    # and the float32 routes' 16-byte copies take a clone of it.
    k, n = 4096, 4096
    w = int8_weight(torch, quant, gen, dev, k, n)
    for m, dtype, route, counter in ((prompt_len, torch.bfloat16, "mma", "_launches_mma"),
                                     (1, torch.bfloat16, "gemv", "_launches_gemv"),
                                     (SLOTS, torch.float32, "f32mma", "_launches_f32mma"),
                                     (prefill_m, torch.float32, "f32mma", "_launches_f32mma")):
        buf = torch.randn((m * k + 1,), generator=gen, device=dev).to(dtype)
        x = buf[1:].view(m, k)
        assert x.data_ptr() % 16 == buf.element_size() and ik._route(m, k, n, dtype) == route
        before = getattr(ik, counter)
        y, ref = ik.int8_dot(x, w), ik.int8_dot_reference(x, w.q, w.s)
        err = (check_bf16(torch, "int8_dot", "x at an offset", x, y, ref)
               if dtype == torch.bfloat16 else check_f32("int8_dot", "x at an offset", y, ref))
        assert getattr(ik, counter) == before + 1
        log(f"int8_dot x view {buf.element_size()} bytes into its storage K={k} N={n} "
            f"M={m} ({route}, cloned): max err {err:.3e}")
    log(f"int8_dot crossover: mma at least as fast from M={crossover(scan)} "
        f"(MMA_MIN_M = {ik.MMA_MIN_M}); float32 x, f32mma at least as fast as simt from "
        f"M={crossover(f32_scan, 'f32mma')} (F32MMA_MIN_M = {ik.F32MMA_MIN_M})")
    return rows, scan, decode, plans, batch, f32mma, f32_scan


def f32mma_checks(torch, ik, site, k, n, q, s, gen, dev, flush, bw, f32_flops):
    """int8_dot's float32 route at one site: float32 x held at every M of
    F32_CHECKED_M (F32_TOL), and at every M of F32_TIMED_M timed (L2 cold)
    beside the CUDA-core kernel it replaced ("simt", held too), the
    library (``torch.matmul(x32, q.float()) * s``) and the bound; two
    launches bit-equal at M = 32; rows 0-2 at M = 3 (an 8-row tile)
    bit-equal to the same rows at M = 32 (16-row tiles), and again with
    the other rows redrawn; rows 32-34 and 40-42 of M = 64 (both fragments
    of a later M tile) bit-equal to those rows alone. Then the route at M
    = 1 and 2, which its entry point takes but `_route` sends to the decode
    kernel, held (F32_TOL) and timed beside the decode kernel with float32
    x, L2 cold."""
    dot = lambda x: ik._launch(x, q, s, "f32mma")              # noqa: E731
    simt = lambda x: ik._launch(x, q, s, "simt")               # noqa: E731
    plain = lambda x: ik.int8_dot_reference(x, q, s)           # noqa: E731
    q32 = q.float()                                            # library yardstick only
    errs, rel, times = {}, {}, []
    for m in F32_CHECKED_M:
        x = torch.randn((m, k), generator=gen, device=dev)
        assert ik._route(m, k, n, x.dtype) == "f32mma"
        ref, y = plain(x), dot(x)
        errs[m] = check_f32("int8_dot", f"{site} f32mma M={m}", y, ref)
        rel[m] = errs[m] / ref.abs().max().item()
        if m == 64 and not all(torch.equal(y[a:a + 3], dot(x[a:a + 3].contiguous()))
                               for a in (32, 40)):
            raise AssertionError(f"int8_dot f32mma {site}: rows of a later M tile differ "
                                 "alone")
        if m in F32_TIMED_M:
            nb, ops = int8_bytes(m, k, n, 4), 2 * m * k * n
            times.append({
                "M": m, "ms": cuda_ms(lambda: dot(x), torch, flush=flush),
                "simt_max_abs_err": check_f32("int8_dot", f"{site} simt M={m}", simt(x), ref),
                "simt_ms": cuda_ms(lambda: simt(x), torch, flush=flush),
                "library_ms": cuda_ms(lambda: torch.matmul(x, q32) * s, torch, flush=flush),
                "bound_ms": max(nb / bw, ops / f32_flops) * 1e3,
                "bound_by": "bytes" if nb / bw >= ops / f32_flops else "operations"})
        del x, y, ref
    del q32
    x = torch.randn((32, k), generator=gen, device=dev)
    y = dot(x)
    if not torch.equal(y, dot(x)):
        raise AssertionError(f"int8_dot f32mma {site}: two launches differ")
    other = torch.cat([x[:3], torch.randn((29, k), generator=gen, device=dev)])
    if not (torch.equal(dot(x[:3].contiguous()), y[:3]) and torch.equal(dot(other)[:3], y[:3])):
        raise AssertionError(f"int8_dot f32mma {site}: a row's bits depend on M or on "
                             "the other rows")
    point = {"site": site, "K": k, "N": n, "plan": list(ik._gemv_plan(32, k, n)),
             "max_abs_err": errs, "rel_err": rel, "times": times}
    for m in (1, 2):
        x = torch.randn((m, k), generator=gen, device=dev)
        assert ik._route(m, k, n, x.dtype) == "gemv"
        gemv = lambda x=x: ik._launch(x, q, s, "gemv")        # noqa: E731
        check_f32("int8_dot", f"{site} f32mma M={m}", dot(x), plain(x))
        point[f"M{m}_f32mma_ms"] = cuda_ms(lambda x=x: dot(x), torch, flush=flush)
        point[f"M{m}_gemv_ms"] = cuda_ms(gemv, torch, flush=flush)
    log(f"int8_dot {site} f32mma: float32 max err / max|plain| "
        + ", ".join(f"{v:.2e} (M={m})" for m, v in rel.items())
        + "; bit-equal over two launches, for rows 0-2 at M = 3 and 32 and rows 32-34, "
        "40-42 of M = 64; ms (simt, library) "
        + ", ".join(f"M={r['M']} {r['ms']:.4f} ({r['simt_ms']:.4f}, {r['library_ms']:.4f})"
                    for r in times)
        + f"; at M = 1 / 2 {point['M1_f32mma_ms']:.4f} / {point['M2_f32mma_ms']:.4f} ms "
        f"against the decode kernel's {point['M1_gemv_ms']:.4f} / {point['M2_gemv_ms']:.4f}; "
        f"plan {point['plan']}")
    return point


def decode_checks(torch, name, mod, site, k, n, dot, launch, plain, yardsticks,
                  nbytes, units, gen, dev, bw, flush, route16):
    """The decode kernel of `name` (wrapper module `mod`) at one site:
    float32 x held at M = 1 and 2 on "gemv" (F32_TOL) and at M = 16 on
    `route16`, the route `_route` must give it ("simt" for int8_dot,
    "f32mma" for nf4_dot); two launches bit-equal in both dtypes; at M = 1
    in both dtypes (stage 0 and in process bf16, the stages behind TCP
    float32) the decode kernel beside the old CUDA-core kernel, the plain
    version and the library (``yardsticks[dtype](x)``), each held; and the
    decode kernel at every cluster size whose ranks' chunks fit (`units`: K
    in the plan's units), bf16 at M = 1: the scan behind `_gemv_plan`.
    `dot(x)` is the wrapper, ``launch(x, route, plan=None)`` one route,
    `plain(x)` the plain version. Returns (the two decode rows, the plan
    scan's point)."""
    errs32 = {}
    for m in (1, 2, 16):
        x32 = torch.randn((m, k), generator=gen, device=dev)
        assert mod._route(m, k, n, x32.dtype) == ("gemv" if m <= 2 else route16)
        errs32[m] = check_f32(name, f"{site} M={m}", dot(x32), plain(x32))
    # The decode kernel is deterministic: the same bits from two launches.
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((1, k), generator=gen, device=dev).to(dtype)
        if not torch.equal(dot(x), dot(x)):
            raise AssertionError(f"{name} gemv {site} {dtype}: two launches differ")
    rows = []
    for dtype, xsize in ((torch.bfloat16, 2), (torch.float32, 4)):
        x = torch.randn((1, k), generator=gen, device=dev).to(dtype)
        ref = plain(x)
        row = {"site": site, "M": 1, "K": k, "N": n,
               "dtype": str(dtype).replace("torch.", "")}
        for route in ("gemv", "simt"):
            y = launch(x, route)
            row[f"{route}_max_abs_err"] = (
                check_bf16(torch, name, f"{site} {route}", x, y, ref)
                if dtype == torch.bfloat16 else check_f32(name, f"{site} {route}", y, ref))
            row[f"{route}_ms"] = cuda_ms(lambda: launch(x, route), torch, flush=flush)
        row["plain_ms"] = cuda_ms(lambda: plain(x), torch, flush=flush)
        row["library_ms"] = cuda_ms(lambda: yardsticks[dtype](x), torch, flush=flush)
        row["bytes"] = nbytes(1, k, n, xsize)
        row["bound_ms"] = row["bytes"] / bw * 1e3
        row["bound_by"] = "bytes"
        row["plan"] = list(mod._gemv_plan(1, k, n))
        rows.append(row)
    x = torch.randn((1, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = plain(x)
    point = {"site": site, "plan": list(mod._gemv_plan(1, k, n))}
    for split in range(1, mod.GEMV_MAX_SPLIT + 1):
        if -(-units // split) > mod.GEMV_MAX_CHUNK:
            continue
        plan = (mod.GEMV_STRIP, split)
        check_bf16(torch, name, f"{site} gemv split {split}", x, launch(x, "gemv", plan), ref)
        point[f"split{split}_ms"] = cuda_ms(lambda: launch(x, "gemv", plan), torch,
                                            flush=flush)
    log(f"{name} {site} K={k} N={n}: float32 max err {errs32[1]:.3e} (M=1, gemv), "
        f"{errs32[2]:.3e} (M=2, gemv), {errs32[16]:.3e} (M=16, {route16}); gemv bit-equal "
        f"over two launches; M=1 gemv / simt / library ms: bf16 {rows[0]['gemv_ms']:.4f}"
        f" / {rows[0]['simt_ms']:.4f} / {rows[0]['library_ms']:.4f}, float32 "
        f"{rows[1]['gemv_ms']:.4f} / {rows[1]['simt_ms']:.4f} / "
        f"{rows[1]['library_ms']:.4f}; plan {point['plan']}")
    return rows, point


def batch_rows(torch, name, mod, site, k, n, dot, plain, yardsticks, nbytes, gen,
               dev, bw, flops, flush, old=None, m=SLOTS,
               dtypes=("float32", "bfloat16")):
    """One site at M = `m` rows, each dtype of `dtypes`: by default the
    batched engine's regime, M = SLOTS (every slot of a round), float32 x
    (stages 1-3: the route `_route` gives) and bf16 x (the tensor cores);
    with ``m=prefill_m, dtypes=("float32",)`` the float32 prefill of the
    stages behind TCP. Each held to the plain version (F32_TOL / BF16_TOL)
    and timed beside the plain version and the library yardstick
    (``yardsticks[dtype](x)``), and with float32 x beside ``old(x)``, the
    CUDA-core kernel it replaced, where given (``simt_ms``); the bound takes the operations at the rate `flops[dtype]`
    gives x's type (float32: a third of the bf16 rate, F32_TERMS)."""
    rows = []
    for dtype in (getattr(torch, d) for d in dtypes):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        ref, y = plain(x), dot(x)
        err = (check_f32(name, f"{site} M={m}", y, ref) if dtype == torch.float32
               else check_bf16(torch, name, f"{site} M={m}", x, y, ref))
        nb, ops = nbytes(m, k, n, x.element_size()), 2 * m * k * n
        rows.append({"site": site, "M": m, "K": k, "N": n,
                     "dtype": str(dtype).replace("torch.", ""),
                     "route": mod._route(m, k, n, dtype), "max_abs_err": err,
                     "ms": cuda_ms(lambda: dot(x), torch, flush=flush),
                     "plain_ms": cuda_ms(lambda: plain(x), torch, flush=flush),
                     "library_ms": cuda_ms(lambda: yardsticks[dtype](x), torch, flush=flush),
                     "bytes": nb, "bound_ms": max(nb / bw, ops / flops[dtype]) * 1e3,
                     "bound_by": "bytes" if nb / bw >= ops / flops[dtype] else "operations"})
        if old is not None and dtype == torch.float32:
            rows[-1]["simt_max_abs_err"] = check_f32(name, f"{site} simt M={m}",
                                                     old(x), ref)
            rows[-1]["simt_ms"] = cuda_ms(lambda: old(x), torch, flush=flush)
    log(f"{name} {site} M={m}: " + ", ".join(
        f"{r['dtype']} ({r['route']}) {r['ms']:.4f} ms"
        + (f" (simt {r['simt_ms']:.4f})" if "simt_ms" in r else "")
        + f", library {r['library_ms']:.4f}" for r in rows))
    return rows


def scan_routes(torch, name, site, k, gen, dev, launch, plain, flush,
                routes=("simt", "mma"), ms=range(1, 17), takes=lambda route, m: True,
                dtype=None):
    """The kernels of `name` (``launch(x, route)``) at each M of `ms` (each
    route where ``takes(route, m)``), x of `dtype` (bf16 by default), each
    held to the plain version and timed: the crossover scan behind its
    ``MMA_MIN_M`` (with float32 x, behind ``F32MMA_MIN_M``)."""
    dtype = dtype or torch.bfloat16
    points = []
    for m in ms:
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        ref = plain(x)
        point = {"site": site, "M": m, "dtype": str(dtype).replace("torch.", "")}
        for route in routes:
            if not takes(route, m):
                continue
            if dtype == torch.float32:
                check_f32(name, f"{site} {route} M={m}", launch(x, route), ref)
            else:
                check_bf16(torch, name, f"{site} {route}", x, launch(x, route), ref)
            point[f"{route}_ms"] = cuda_ms(lambda: launch(x, route), torch, flush=flush)
        points.append(point)
    return points


def crossover(scan, route="mma"):
    """The least M from which `route` (the tensor-core route by default) is
    at least as fast as every other scanned route at every scanned M of
    every site."""
    faster = [all(p[f"{route}_ms"] <= v for key, v in p.items() if key.endswith("_ms"))
              for p in scan]
    return next((m for m in sorted({p["M"] for p in scan})
                 if all(f for p, f in zip(scan, faster) if p["M"] >= m)), None)


def nf4_weight(torch, quant, gen, dev, k: int, n: int):
    w_bf16 = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    return quant._quantize_leaf_nf4(w_bf16)


def nf4_bytes(m: int, k: int, n: int, xsize: int) -> int:
    """Bytes one nf4_dot call must move: x, the packed weight, its scales, y."""
    return m * k * xsize + k * n // 2 + (k // 64) * n * 2 + m * n * xsize


def nf4_phase(torch, nk, dev, prompt_len: int, prefill_m: int, bw: float,
              flops: float, flush, f32_flops: float):
    """nf4_dot at every main-path shape, on weights quantized by the port's
    own NF4 quantizer: agreement and times, each row with its route
    (decode M = 1 and 2 on "gemv"); float32 x at M = 1 and 2 on "gemv"
    (F32_TOL) and at M = 16 on "f32mma"; two launches of the decode kernel
    bit-equal (bf16 and float32); at M = 1 the decode kernel, the old
    CUDA-core kernel ("simt") and the library at every site in both dtypes
    (`decode` rows); the decode kernel at every cluster size at M = 1 (the
    plan scan behind `_gemv_plan`); ragged shapes of every route; and the
    crossover scan of the three kernels at M = 1..4 on wgu and wd; the
    batched regime, M = SLOTS in float32 and bf16, and the float32 prefill
    at M = prefill_m (`batch_rows`; float32 x on "f32mma" beside the
    CUDA-core kernel it replaced); the float32 prefill route's own checks
    (`nf4_f32mma_checks`; a fused weight's columns bit-equal to its parts'
    at M = prefill_m) and its crossover scan against "simt" at M = 3..16
    on wgu and wd. Returns (rows, scan, decode, plans, batch, f32mma,
    f32_scan)."""
    from importlib import import_module

    quant = import_module(PORT + ".models.quant")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows, scan, decode, plans, batch, f32mma, f32_scan = [], [], [], [], [], [], []
    ms = tuple(sorted({1, 2, 8, 16, prompt_len, prefill_m, 128, 512}))
    for site, k, n in SITES:
        w = nf4_weight(torch, quant, gen, dev, k, n)
        w_deq = w.dequant()                          # library yardstick only
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            row = check_and_time(
                torch, "nf4_dot", site, x, lambda: nk.nf4_dot(x, w),
                lambda: nk.nf4_dot_reference(x, w),
                lambda: torch.matmul(x, w_deq),
                nf4_bytes(m, k, n, 2), bw, flops, flush)
            row["route"] = nk._route(m, k, n, x.dtype)
            rows.append(row)
        log(f"nf4_dot {site} K={k} N={n}: bf16 ok at M={','.join(map(str, ms))} "
            f"(routes {[r['route'] for r in rows[-len(ms):]]})")
        assert [r["route"] for r in rows[-len(ms):][:2]] == ["gemv", "gemv"]
        w_deq32 = w.dequant_f32()                    # library yardstick only
        rows_1, point = decode_checks(
            torch, "nf4_dot", nk, site, k, n, lambda x: nk.nf4_dot(x, w),
            lambda x, route, plan=None: nk._launch(x, w, route, plan),
            lambda x: nk.nf4_dot_reference(x, w),
            {torch.bfloat16: lambda x: torch.matmul(x, w_deq),
             torch.float32: lambda x: torch.matmul(x, w_deq32)},
            nf4_bytes, -(-k // 64), gen, dev, bw, flush, "f32mma")
        decode += rows_1
        plans.append(point)
        simt = lambda x: nk._launch(x, w, "simt")       # noqa: E731
        batch += batch_rows(
            torch, "nf4_dot", nk, site, k, n, lambda x: nk.nf4_dot(x, w),
            lambda x: nk.nf4_dot_reference(x, w),
            {torch.bfloat16: lambda x: torch.matmul(x, w_deq),
             torch.float32: lambda x: torch.matmul(x, w_deq32)},
            nf4_bytes, gen, dev, bw, {torch.float32: f32_flops, torch.bfloat16: flops},
            flush, old=simt)
        batch += batch_rows(
            torch, "nf4_dot", nk, site, k, n, lambda x: nk.nf4_dot(x, w),
            lambda x: nk.nf4_dot_reference(x, w),
            {torch.float32: lambda x: torch.matmul(x, w_deq32)}, nf4_bytes, gen, dev, bw,
            {torch.float32: f32_flops}, flush, m=prefill_m, dtypes=("float32",), old=simt)
        f32mma.append(nf4_f32mma_checks(torch, nk, site, k, n, w, gen, dev))
        # The float32 prefill route's plan depends on K alone: a fused
        # weight's columns and a part's alone (wq, wk of wq|wk|wv; wg of
        # wg|wu, as a full_forward over the loaded weights runs them) give
        # the same bits.
        if site in ("wqkv", "wgu"):
            cuts = ((0, 4096), (4096, 5120)) if site == "wqkv" else ((0, n // 2),)
            x = torch.randn((prefill_m, k), generator=gen, device=dev)
            assert nk._route(prefill_m, k, n, x.dtype) == "f32mma"
            whole = nk.nf4_dot(x, w)
            for a, b in cuts:
                part = quant.NF4Tensor(w.packed[:, a:b].contiguous(),
                                       w.scales[:, a:b].contiguous(), w.in_dim, w.dtype)
                if not torch.equal(whole[:, a:b], nk.nf4_dot(x, part)):
                    raise AssertionError(f"nf4_dot f32mma {site} M={prefill_m}: columns "
                                         f"{a}:{b} differ alone")
            log(f"nf4_dot {site} f32mma (M={prefill_m}): columns {cuts} bit-equal alone")
        if site == "wgu":                            # a ragged M, tensor cores
            x = torch.randn((33, k), generator=gen, device=dev).to(torch.bfloat16)
            assert nk._route(33, k, n, x.dtype) == "mma"
            err = check_bf16(torch, "nf4_dot", site, x, nk.nf4_dot(x, w),
                             nk.nf4_dot_reference(x, w))
            log(f"nf4_dot {site} ragged M=33 (mma): max err {err:.3e}")
        if site in ("wgu", "wd"):
            scan += scan_routes(torch, "nf4_dot", site, k, gen, dev,
                                lambda x, route: nk._launch(x, w, route),
                                lambda x: nk.nf4_dot_reference(x, w), flush,
                                routes=("gemv", "simt", "mma"), ms=range(1, 5),
                                takes=lambda route, m: route != "gemv"
                                or m <= nk.GEMV_MAX_M)
            f32_scan += scan_routes(torch, "nf4_dot", site, k, gen, dev,
                                    lambda x, route: nk._launch(x, w, route),
                                    lambda x: nk.nf4_dot_reference(x, w), flush,
                                    routes=("simt", "f32mma"), ms=range(3, 17),
                                    dtype=torch.float32)
        del w, w_deq, w_deq32
    # Ragged shapes: in_dim not a multiple of 64, the last column block part
    # full; N % 16 != 0 takes the CUDA-core route, at decode M too.
    for k, n, m, dtype, want in ((100, 97, 16, torch.bfloat16, "simt"),
                                 (130, 50, 33, torch.bfloat16, "simt"),
                                 (328, 48, 33, torch.bfloat16, "mma"),
                                 (100, 97, 1, torch.bfloat16, "simt"),
                                 (4096, 4104, 1, torch.bfloat16, "simt"),
                                 (100, 97, 1, torch.float32, "simt"),
                                 (100, 96, 1, torch.bfloat16, "gemv"),
                                 (130, 48, 2, torch.bfloat16, "gemv"),
                                 (4100, 4112, 1, torch.float32, "gemv"),
                                 (4104, 96, 1, torch.bfloat16, "gemv"),
                                 (130, 48, 2, torch.float32, "gemv"),
                                 (4104, 96, 3, torch.float32, "f32mma"),
                                 (328, 48, 33, torch.float32, "f32mma"),
                                 (4096, 4112, 40, torch.float32, "f32mma"),
                                 (64, 16, 5, torch.float32, "f32mma"),
                                 (nk.GEMV_MAX_K, 48, 17, torch.float32, "f32mma"),
                                 (nk.GEMV_MAX_K + 64, 48, 3, torch.float32, "f32mma"),
                                 (100, 96, 5, torch.float32, "simt"),
                                 (130, 50, 8, torch.float32, "simt")):
        w = nf4_weight(torch, quant, gen, dev, k, n)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        assert nk._route(m, k, n, x.dtype) == want
        y, ref = nk.nf4_dot(x, w), nk.nf4_dot_reference(x, w)
        err = (check_bf16(torch, "nf4_dot", f"K={k} N={n}", x, y, ref)
               if dtype == torch.bfloat16 else check_f32("nf4_dot", f"K={k} N={n}", y, ref))
        log(f"nf4_dot ragged K={k} N={n} M={m} {dtype} ({want}): max err {err:.3e}")
    # x as a view one element into its storage: the float32 prefill route's
    # 16-byte copies take a clone of it.
    k, n, m = 4096, 4096, prefill_m
    w = nf4_weight(torch, quant, gen, dev, k, n)
    buf = torch.randn((m * k + 1,), generator=gen, device=dev)
    x = buf[1:].view(m, k)
    assert x.data_ptr() % 16 == 4 and nk._route(m, k, n, x.dtype) == "f32mma"
    before = nk._launches_f32mma
    err = check_f32("nf4_dot", "x at an offset", nk.nf4_dot(x, w), nk.nf4_dot_reference(x, w))
    assert nk._launches_f32mma == before + 1
    log(f"nf4_dot x view 4 bytes into its storage K={k} N={n} M={m} (f32mma, cloned): "
        f"max err {err:.3e}")
    log(f"nf4_dot crossover: mma at least as fast from M={crossover(scan)} "
        f"(MMA_MIN_M = {nk.MMA_MIN_M}); float32 x, f32mma at least as fast as simt from "
        f"M={crossover(f32_scan, 'f32mma')} (F32MMA_MIN_M = {nk.F32MMA_MIN_M})")
    return rows, scan, decode, plans, batch, f32mma, f32_scan


def nf4_f32mma_checks(torch, nk, site, k, n, w, gen, dev):
    """nf4_dot's float32 prefill route at one site: float32 x held at M =
    3, 8, 16, 32, 33, 64 and 512 (F32_TOL); two launches bit-equal at M =
    32; rows 0-2 at M = 3 bit-equal to the same rows at M = 32, and again
    with the other rows redrawn; rows 32-34 at M = 64 (a later M tile)
    bit-equal to those rows alone. The times at M = SLOTS and prefill_m
    beside the CUDA-core kernel are in `batch_rows`."""
    dot = lambda x: nk._launch(x, w, "f32mma")                 # noqa: E731
    plain = lambda x: nk.nf4_dot_reference(x, w)               # noqa: E731
    errs, rel = {}, {}
    for m in (3, SLOTS, 16, 32, 33, 64, 512):
        x = torch.randn((m, k), generator=gen, device=dev)
        assert nk._route(m, k, n, x.dtype) == "f32mma"
        ref = plain(x)
        errs[m] = check_f32("nf4_dot", f"{site} f32mma M={m}", dot(x), ref)
        rel[m] = errs[m] / ref.abs().max().item()
        if m == 64 and not torch.equal(dot(x)[32:35], dot(x[32:35].contiguous())):
            raise AssertionError(f"nf4_dot f32mma {site}: rows of a later M tile "
                                 "differ alone")
    x = torch.randn((32, k), generator=gen, device=dev)
    y = dot(x)
    if not torch.equal(y, dot(x)):
        raise AssertionError(f"nf4_dot f32mma {site}: two launches differ")
    other = torch.cat([x[:3], torch.randn((29, k), generator=gen, device=dev)])
    if not (torch.equal(dot(x[:3].contiguous()), y[:3]) and torch.equal(dot(other)[:3], y[:3])):
        raise AssertionError(f"nf4_dot f32mma {site}: a row's bits depend on M or on the "
                             "other rows")
    point = {"site": site, "K": k, "N": n, "plan": list(nk._f32mma_plan(32, k, n)),
             "max_abs_err": errs, "rel_err": rel}
    log(f"nf4_dot {site} f32mma: float32 max err / max|plain| "
        + ", ".join(f"{v:.2e} (M={m})" for m, v in rel.items())
        + f"; bit-equal over two launches, for rows 0-2 at M = 3 and rows 32-34 of M = 64; "
        f"plan {point['plan']}")
    return point


def host_ms(fn, torch, reps: int = 30) -> float:
    """Median host wall time of one call that ends in a host read."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def replay_kernels(torch, replay, reps: int = 10):
    """Device kernels of `replay` by name under torch.profiler: ms and
    launches a replay, the 8 longest (where a captured sampler's time goes)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            replay()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name[:80], [0.0, 0])
            ms_n[0] += (e.time_range.end - e.time_range.start) / 1e3 / reps
            ms_n[1] += 1 / reps
    return [{"name": k, "ms": v[0], "launches": v[1]}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]]


def sampler_phase(torch, vocab: int):
    """The captured sampler (``runtime/graphs.Sampler``) against the eager
    device sampler (``ops/sampling.sample_token`` with Python knobs and
    keys) at the model's vocabulary: equal tokens for B = 1 and 2 rows
    (row 0 keyed PRNGKey(seed), row 1 fold_in(base, 1)) over greedy and
    every top_k 0 / 1 / 50, top_p 0.9 / 1.0, rp 1.0 / 1.5 at temperature
    0.7, with windows of 0, 2, 3 identical and 60 tokens. One capture per
    (B, V). Then host ms per call (each ends in its one read, of the
    token): the captured sampler, the eager sampler, the eager filters with
    a ``torch.multinomial`` draw (the draw before threefry, a yardstick);
    the draws alone (kernel, plain, multinomial); the device ms of one
    replay and its longest kernels."""
    from importlib import import_module

    samp = import_module(PORT + ".ops.sampling")
    tf3 = import_module(PORT + ".ops.threefry")
    dk = import_module(PORT + ".ops.draw_kernel")
    graphs = import_module(PORT + ".runtime.graphs")
    gen = torch.Generator(device="cuda").manual_seed(0)
    hot = 4242                                   # the repeated token, a top logit
    windows = {"empty": [], "two": [11, hot], "triple": [7, hot, hot, hot],
               "sixty": [(97 * i) % vocab for i in range(60)]}
    grid = [(0.0, 0.9, 50, 1.5)] + [(0.7, p, k, rp) for k in (0, 1, 50)
                                    for p in (0.9, 1.0) for rp in (1.0, 1.5)]
    sampler = graphs.Sampler("cuda")
    checked = 0
    for window in windows.values():
        w = window[-samp.RECENT_WINDOW:]
        recent = torch.zeros(samp.RECENT_WINDOW, dtype=torch.int32, device="cuda")
        if w:
            recent[:len(w)] = torch.tensor(w, dtype=torch.int32, device="cuda")
        for i, knobs in enumerate(grid):
            for batch in (1, 2):
                logits = torch.randn((batch, vocab), generator=gen, device="cuda") * 4.0
                logits[:, hot] = logits[:, hot].abs() + 8.0
                seed = 1000 + i
                got = sampler(logits, window, samp.SamplingParams(*knobs), seed)
                base = tf3.prng_key(seed)
                want = [int(samp.sample_token(base if b == 0 else tf3.fold_in(base, b),
                                              logits[b], recent, len(w), *knobs))
                        for b in range(batch)]
                if got != want:
                    raise AssertionError(f"captured sampler {got} != eager {want} at "
                                         f"knobs {knobs}, window {len(window)}, B={batch}")
                checked += batch
    if sampler.captures != 2:
        raise AssertionError(f"the sampler captured {sampler.captures} graphs, want 2")
    log(f"captured sampler: tokens equal the eager sampler's in {checked} rows "
        f"({len(grid)} knob settings x {len(windows)} windows x B = 1, 2; "
        f"{sampler.captures} captures, {sampler.replays} replays)")

    logits = torch.randn(vocab, generator=gen, device="cuda") * 4.0
    window = windows["sixty"]
    recent = torch.tensor(window[-samp.RECENT_WINDOW:], dtype=torch.int32, device="cuda")
    knobs = (samp.RECENT_WINDOW, 0.7, 0.9, 50, 1.5)
    sp = samp.SamplingParams(0.7, 0.9, 50, 1.5)
    probs = samp.sample_probs(logits, recent, *knobs)
    logp = torch.log(torch.clamp(probs, min=1e-20))
    key = tf3.prng_key(0)
    entry = sampler._graphs[(False, 1, vocab)]
    out = {"vocab": vocab, "rows_checked": checked, "captures": sampler.captures,
           "tokens_equal_eager": True}
    for what, fn in {
            "captured_sampler": lambda: sampler(logits[None], window, sp, 0),
            "eager_sample_token": lambda: int(samp.sample_token(key, logits, recent, *knobs)),
            "eager_filters_multinomial": lambda: int(torch.multinomial(
                samp.sample_probs(logits, recent, *knobs), 1, generator=gen)),
            "draw_kernel": lambda: int(dk.sample_draw(key, logp)),
            "draw_plain": lambda: int(dk.sample_draw_reference(key, logp)),
            "draw_multinomial": lambda: int(torch.multinomial(probs, 1, generator=gen)),
    }.items():
        out[f"{what}_host_ms"] = host_ms(fn, torch)
    out["captured_replay_device_ms"] = cuda_ms(entry.graph.replay, torch, spin=True)
    out["replay_kernels"] = replay_kernels(torch, entry.graph.replay)
    log("captured sampler replay, top kernels (ms, launches a replay): " + ", ".join(
        f"{k['name'][:40]} {k['ms']:.3f} x{k['launches']:g}" for k in out["replay_kernels"][:4]))
    log(f"sampler at V={vocab}: captured {out['captured_sampler_host_ms']:.3f} ms a "
        f"call (replay {out['captured_replay_device_ms']:.3f} ms on the device), eager "
        f"{out['eager_sample_token_host_ms']:.3f} ms; draw kernel "
        f"{out['draw_kernel_host_ms']:.3f} ms, plain {out['draw_plain_host_ms']:.3f} ms "
        "(host ms, each with its read)")
    return out


def draw_bound(rows: int, vocab: int, bw: float):
    """(bound ms, what bounds it) of one draw of `rows` rows of `vocab`:
    the bytes (logp read, keys read, tokens written) over the memory rate,
    and the cipher's integer operations over the CUDA cores' int32 rate."""
    nbytes = rows * vocab * 4 + rows * 16 + rows * 4
    ops = rows * vocab * DRAW_INT_OPS
    t_bytes, t_ops = nbytes / bw, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sass_counts(library: str, kernel: str):
    """Opcode counts of one kernel's SASS in the built library
    ``build/kernels/<library>-*.so`` (``cuobjdump -sass``), the function
    picked by a substring of its mangled name; SHF.L.W apart (the draw's
    rotates), other opcodes by their first word. None, and a log line,
    where cuobjdump is not installed."""
    from importlib import import_module

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log(f"{kernel} sass: no cuobjdump")
        return None
    build_dir = import_module(PORT + ".utils.cuda_build").BUILD_DIR
    lib = max(build_dir.glob(f"{library}-*.so"), key=lambda p: p.stat().st_mtime)
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and op:
            full = op.group(1)
            key = "SHF.L.W" if full.startswith("SHF.L.W") else full.split(".")[0]
            counts[key] = counts.get(key, 0) + 1
    counts = dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    log(f"{kernel} sass ({lib.name}): {sum(counts.values())} instructions; {counts}")
    return counts


def draw_phase(torch, dk, tf3, bw: float):
    """sample_draw against its plain version on the card: for V = 128256
    and 1000 (a row not a multiple of the block), B = 1 and 4, logits at
    temperatures 0.7 and 1.5 and 8 seeds each (64 keys a width), the
    kernel's Gumbel noise must be bit-equal to ``threefry.gumbel`` and its
    tokens equal to ``sample_draw_reference``; planted ties (equal scores
    in far-apart blocks) must go to the first index. Times of the kernel,
    the plain version and ``torch.multinomial`` on the same probs (a
    yardstick: another function), at B = 1 and 4 on the full vocabulary."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws, rows_out = 0, []
    for vocab in (128256, 1000):
        for batch in (1, 4):
            for temp in (0.7, 1.5):
                for seed in range(8):
                    logits = torch.randn((batch, vocab), generator=gen, device="cuda") * 4.0
                    probs = torch.softmax(logits / temp, dim=-1)
                    logp = torch.log(torch.clamp(probs, min=1e-20))
                    keys = tf3.fold_in(tf3.prng_key(seed + 1000 * batch),
                                       torch.arange(batch, device="cuda"))
                    noise = torch.empty_like(logp)
                    got = dk.sample_draw(keys, logp, noise_out=noise)
                    want = dk.sample_draw_reference(keys, logp)
                    torch.cuda.synchronize()
                    plain_noise = tf3.gumbel(keys, (vocab,))
                    if not torch.equal(noise, plain_noise):
                        bad = (noise != plain_noise).sum().item()
                        raise AssertionError(f"sample_draw V={vocab} B={batch}: {bad} noise "
                                             "values differ from the plain version's bits")
                    if not torch.equal(got, want):
                        raise AssertionError(f"sample_draw V={vocab} B={batch} T={temp} "
                                             f"seed {seed}: {got.tolist()} != {want.tolist()}")
                    draws += batch
        # Ties: each row's three planted maxima score exactly 1e30 (the
        # noise is below its ulp); the first of them must win.
        for batch in (1, 4):
            logp = torch.randn((batch, vocab), generator=gen, device="cuda")
            planted = [[vocab // 3 + 7 * r, vocab // 11 + r, vocab - 1 - r] for r in range(batch)]
            for r, idx in enumerate(planted):
                logp[r, idx] = 1e30
            keys = tf3.fold_in(tf3.prng_key(77), torch.arange(batch, device="cuda"))
            got = dk.sample_draw(keys, logp).tolist()
            want = [min(idx) for idx in planted]
            if got != want or dk.sample_draw_reference(keys, logp).tolist() != want:
                raise AssertionError(f"sample_draw ties V={vocab} B={batch}: {got}, want {want}")
    log(f"sample_draw: noise bit-equal and tokens equal to the plain version in {draws} "
        "draws (V = 128256 and 1000, B = 1 and 4, T = 0.7 and 1.5); planted ties go "
        "to the first index")
    for batch in (1, 4):
        vocab = 128256
        logits = torch.randn((batch, vocab), generator=gen, device="cuda") * 4.0
        probs = torch.softmax(logits / 0.7, dim=-1)
        logp = torch.log(torch.clamp(probs, min=1e-20))
        keys = tf3.fold_in(tf3.prng_key(5), torch.arange(batch, device="cuda"))
        # The timed inputs' own output against the plain version's.
        noise = torch.empty_like(logp)
        got = dk.sample_draw(keys, logp, noise_out=noise)
        want = dk.sample_draw_reference(keys, logp)
        err = (noise - tf3.gumbel(keys, (vocab,))).abs().max().item()
        mismatches = int((got != want).sum().item())
        if err != 0 or mismatches:
            raise AssertionError(f"sample_draw timed row B={batch}: noise error {err}, "
                                 f"{mismatches} tokens differ")
        bound_ms, bound_by = draw_bound(batch, vocab, bw)
        rows_out.append({
            "B": batch, "V": vocab, "max_abs_err": err, "token_mismatches": mismatches,
            "ms": cuda_ms(lambda: dk.sample_draw(keys, logp), torch, reps=200, spin=True),
            "plain_ms": cuda_ms(lambda: dk.sample_draw_reference(keys, logp), torch,
                                spin=True),
            "multinomial_ms": cuda_ms(lambda: torch.multinomial(probs, 1, generator=gen),
                                      torch, reps=200, spin=True),
            "bound_ms": bound_ms, "bound_by": bound_by})
    return {"draws_checked": draws, "noise_bit_equal": True, "ties_first_index": True,
            "int_ops_per_element": DRAW_INT_OPS,
            "sass": sass_counts("sample_draw", "draw_partial_kernel"), "times": rows_out}


def first_difference(a, b) -> int:
    return next(j for j in range(min(len(a), len(b)) + 1)
                if j >= min(len(a), len(b)) or a[j] != b[j])


def hold_to_reference(torch, cfg, params, ids, got, want, what: str,
                      cache_dtype=None) -> None:
    """Equal tokens, or a first difference at a near-tie of the reference's
    logits (its KV cache `cache_dtype`, float32 by default; top-2 gap <=
    LOGIT_GAP_TOL * max|logit|)."""
    if got == want:
        log(f"  {what}: tokens equal ({len(want)} tokens)")
        return
    i = first_difference(got, want)
    logits = oracle_logits(torch, cfg, params, ids + want[:i], cache_dtype)
    top2 = torch.topk(logits, 2).values
    gap = (top2[0] - top2[1]).item()
    tol = LOGIT_GAP_TOL * logits.abs().max().item()
    log(f"  {what}:\n    got  {got}\n    want {want}\n  first difference at "
        f"step {i}: reference top-2 logit gap {gap:.4g} (near-tie tolerance {tol:.4g})")
    if not gap <= tol:
        raise AssertionError(f"{what}: tokens differ at a decisive step")


def greedy_reference(torch, cfg, params, ids, max_new_tokens: int, cache_dtype=None):
    """Unsplit greedy loop over ``full_forward`` with a float32 KV cache,
    what the stage executors keep (or `cache_dtype`, what another engine
    keeps), and the pipeline's stop rules."""
    from importlib import import_module

    tf = import_module(PORT + ".models.transformer")
    REPEAT_STOP = import_module(PORT + ".runtime.client").REPEAT_STOP
    dev = params["embed"]["wte"].device
    kc, vc = tf.init_kv_cache(cfg, cfg.num_layers, 1, len(ids) + max_new_tokens + 1,
                              dtype=cache_dtype or torch.float32, device=dev)
    x = torch.tensor([ids], device=dev)
    cur, out = 0, []
    while len(out) < max_new_tokens:
        if len(out) >= REPEAT_STOP and len(set(out[-REPEAT_STOP:])) == 1:
            break
        logits, kc, vc = tf.full_forward(cfg, params, x, kc, vc, cur)
        cur += x.shape[1]
        out.append(int(torch.argmax(logits[0, -1])))
        x = torch.tensor([[out[-1]]], device=dev)
    return out


def sampled_reference(torch, cfg, params, ids, sp, seed: int, max_new_tokens: int,
                      cache_dtype=None):
    """Unsplit sampled loop over ``full_forward`` with a float32 KV cache
    (or `cache_dtype`),
    the plain sampler (eager ``sample_probs`` and the plain draw,
    ``sample_draw_reference``) and the pipeline's key schedule (step i:
    ``PRNGKey(seed + i)``, the window the tokens so far) and stop rules.
    Returns its tokens and, per step, the gap between its two best
    perturbed scores (Gumbel noise plus log-probs) and the near-tie
    tolerance there: LOGIT_GAP_TOL times the scores' scale, max|logit| over
    the temperature; and, for `filter_tie`, the seed and each step's probs
    after and before the top-k and top-p filters."""
    from importlib import import_module

    tf = import_module(PORT + ".models.transformer")
    samp = import_module(PORT + ".ops.sampling")
    tf3 = import_module(PORT + ".ops.threefry")
    dk = import_module(PORT + ".ops.draw_kernel")
    REPEAT_STOP = import_module(PORT + ".runtime.client").REPEAT_STOP
    dev = params["embed"]["wte"].device
    kc, vc = tf.init_kv_cache(cfg, cfg.num_layers, 1, len(ids) + max_new_tokens + 1,
                              dtype=cache_dtype or torch.float32, device=dev)
    x = torch.tensor([ids], device=dev)
    cur, out, gaps, steps = 0, [], [], []
    while len(out) < max_new_tokens:
        if len(out) >= REPEAT_STOP and len(set(out[-REPEAT_STOP:])) == 1:
            break
        logits, kc, vc = tf.full_forward(cfg, params, x, kc, vc, cur)
        logits = logits[0, -1]
        cur += x.shape[1]
        w = out[-samp.RECENT_WINDOW:]
        recent = torch.zeros(samp.RECENT_WINDOW, dtype=torch.int32, device=dev)
        if w:
            recent[:len(w)] = torch.tensor(w, dtype=torch.int32, device=dev)
        probs = samp.sample_probs(logits, recent, len(w), sp.temperature, sp.top_p,
                                  sp.top_k, sp.repetition_penalty)
        logp = torch.log(torch.clamp(probs, min=1e-20))
        unfiltered = samp.sample_probs(logits, recent, len(w), sp.temperature, 1.0, 0,
                                       sp.repetition_penalty)
        steps.append((probs, unfiltered))
        key = tf3.prng_key(seed + len(out))
        top2 = torch.topk(tf3.gumbel(key, logp.shape, dev) + logp, 2).values
        gaps.append(((top2[0] - top2[1]).item(),
                     LOGIT_GAP_TOL * logits.abs().max().item() / max(sp.temperature, 1e-5)))
        out.append(int(dk.sample_draw_reference(key, logp)))
        x = torch.tensor([[out[-1]]], device=dev)
    return {"tokens": out, "gaps": gaps, "steps": steps, "seed": seed}


def filter_tie(ref, i: int, got: int, want: int, tol: float):
    """Whether the run's token at step i is a draw of the reference's with
    its top-k / top-p cut moved across a token whose log-prob before the
    filters lies within `tol` of the cut, as a change of the log-probs
    within the tolerance moves it. The moves: each cut token within `tol`
    of the least one kept joins the kept set; the reference's own draw,
    where it lies within `tol` of the greatest one cut, leaves it (alone or
    with one such token joining). Each moved set is drawn again with the
    step's key, Gumbel-max over its renormalized probs as the reference
    draws (``tf3.gumbel(prng_key(seed + i))``); the run's token must be one
    of the draws. Returns (explained, what was read)."""
    from importlib import import_module

    tf3 = import_module(PORT + ".ops.threefry")
    probs, unfiltered = ref["steps"][i]
    logp = unfiltered.double().clamp(min=1e-300).log()
    kept = probs > 0
    least_kept = logp[kept].min().item()
    most_cut = logp[~kept].max().item() if (~kept).any() else float("-inf")
    near_cut = ((~kept) & (logp >= least_kept - tol)).nonzero().flatten().tolist()
    noise = tf3.gumbel(tf3.prng_key(ref["seed"] + i), probs.shape, probs.device)

    def draw(keep) -> int:
        p = unfiltered.masked_fill(~keep, 0.0)
        p = p / p.sum().clamp(min=1e-20)
        return int((noise + p.clamp(min=1e-20).log()).argmax())

    bases = [kept]
    want_at_cut = logp[want].item() <= most_cut + tol
    if want_at_cut:
        without_want = kept.clone()
        without_want[want] = False
        bases.append(without_want)
    redrawn = set()
    for base in bases:
        redrawn.add(draw(base))
        for c in near_cut:
            moved = base.clone()
            moved[c] = True
            redrawn.add(draw(moved))
    return got in redrawn, {
        "kept": int(kept.sum()), "least_kept_logp": least_kept, "most_cut_logp": most_cut,
        "near_cut": near_cut, "want_at_cut": want_at_cut, "redraw_of_kept": draw(kept),
        "redrawn": sorted(redrawn), "got": got, "got_logp": logp[got].item(),
        "got_cut": not bool(kept[got]), "want": want, "want_logp": logp[want].item()}


def hold_sampled(ref, got, what: str) -> None:
    """Equal tokens, or a first difference at a near-tie: where the
    reference's two best perturbed scores lie within the near-tie
    tolerance, or where the run's token is the reference's draw with the
    top-k / top-p cut moved across a token within the tolerance of it
    (`filter_tie`)."""
    want = ref["tokens"]
    if got == want:
        log(f"  {what}: tokens equal ({len(want)} tokens)")
        return
    i = first_difference(got, want)
    gap, tol = ref["gaps"][i] if i < len(ref["gaps"]) else (float("inf"), 0.0)
    log(f"  {what}:\n    got  {got}\n    want {want}\n  first difference at step {i}: "
        f"reference top-2 perturbed-score gap {gap:.4g} (near-tie tolerance {tol:.4g})")
    if gap <= tol:
        return
    tie, seen = (filter_tie(ref, i, got[i], want[i], tol)
                 if i < min(len(got), len(want)) else (False, {}))
    log(f"  {what}: at the filters' cut: {seen}, explained by a moved cut: {tie}")
    if not tie:
        raise AssertionError(f"{what}: tokens differ at a decisive step")


def serve(torch, kernels, name: str, tmain, sampling_cls, quant: str, dev_name: str,
          extra_argv=()):
    """The port's --mode local cluster serving 3 requests through kernel
    `name` (`kernels` maps each kernel's name to its wrapper module; every
    count is set to 0 just before the requests and read just after), the
    launch counts of both routes, and the greedy tokens held to the float32
    reference. `extra_argv` goes to the CLI parser.
    Returns (summary, state for the telemetry phase and the failover drive)."""
    args = tmain.build_parser().parse_args(
        ["--mode", "local", "--model", MODEL, "--quant", quant,
         "--dtype", "bfloat16", "--device", dev_name, "--seed", "0", *extra_argv])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, params = tmain.load_model(args)
    client = tmain.build_local_client(args, cfg, params)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    log(f"{quant} path: {MODEL} {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{client.plan.num_stages} stages "
        f"{[(s.start, s.end) for s in client.plan.stages]}, set-up {setup_s:.1f}s")
    tok = tmain.load_tokenizer()
    requests = [(PROMPTS[0], sampling_cls(temperature=0.0)),
                (PROMPTS[1], sampling_cls(temperature=0.0)),
                (PROMPTS[2], sampling_cls(temperature=0.7, top_p=0.9, top_k=50,
                                          repetition_penalty=1.5))]
    prompt_ids = [[i % cfg.vocab_size for i in tok.encode(p)] for p, _ in requests]
    executors = path_executors(client)
    reset_counts(kernels, executors)
    results = [client.generate(ids, MAX_NEW_TOKENS, sampling=sp)
               for ids, (_, sp) in zip(prompt_ids, requests)]
    torch.cuda.synchronize()
    launches = kernels[name]._launches
    launches_mma = kernels[name]._launches_mma
    launches_gemv = getattr(kernels[name], "_launches_gemv", None)
    launches_f32mma = getattr(kernels[name], "_launches_f32mma", None)
    draws = draw_gate(f"{quant} path", kernels, executors, results, requests)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held_gb = torch.cuda.memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    tokens = sum(len(r.tokens) for r in results)
    graphs = graph_counts(f"{quant} path", executors, tokens)
    need = 4 * cfg.num_layers * tokens
    log(f"{quant} path: {tokens} tokens over {len(results)} requests, {name} "
        f"launches {launches} (>= 4 x {cfg.num_layers} x {tokens} = {need})")
    if launches < need:
        raise AssertionError(f"{name} launched {launches} times, want >= {need}")
    # One prefill call per site, layer and request, on the tensor cores.
    need_mma = 4 * cfg.num_layers * len(results)
    log(f"{quant} path: {name} tensor-core launches {launches_mma} "
        f"(>= 4 x {cfg.num_layers} x {len(results)} = {need_mma})")
    if launches_mma < need_mma:
        raise AssertionError(f"{name} took the tensor-core route {launches_mma} "
                             f"times, want >= {need_mma}")
    if launches_gemv is not None:
        # Every stage computes in bf16 here: each launch is a prefill on the
        # tensor cores or a decode step on the decode kernel.
        log(f"{quant} path: {name} decode-kernel launches {launches_gemv} (= "
            f"{launches} - {launches_mma} tensor-core)")
        if launches != launches_mma + launches_gemv:
            raise AssertionError(f"{name}: {launches - launches_mma - launches_gemv} "
                                 "launches took neither the tensor cores nor the "
                                 "decode kernel")
    for (p, sp), r in zip(requests, results):
        log(f"  request T={sp.temperature}: {len(r.tokens)} tokens stopped by "
            f"{r.stopped_by}, ttft {r.ttft_s * 1e3:.1f} ms, decode "
            f"{1e3 * sum(r.decode_times_s) / max(len(r.decode_times_s), 1):.2f} "
            f"ms/token: {r.tokens}")

    ref_params = tmain._maybe_quantize(args, params)
    refs = references(torch, cfg, ref_params, prompt_ids, requests, args.seed)
    hold_requests(torch, cfg, ref_params, refs, results, f"{quant} path")
    decode = [t for r in results for t in r.decode_times_s]
    summary = {"model": MODEL, "quant": quant, "layers": cfg.num_layers,
               "stages": client.plan.num_stages, "requests": len(results),
               "tokens": tokens, f"{name}_launches": launches,
               f"{name}_launches_mma": launches_mma,
               **({f"{name}_launches_gemv": launches_gemv}
                  if launches_gemv is not None else {}),
               **({f"{name}_launches_f32mma": launches_f32mma}
                  if launches_f32mma is not None else {}), "graphs": graphs,
               "prefill_ms": [r.ttft_s * 1e3 for r in results],
               "ttft_first_ms": results[0].ttft_s * 1e3,
               "ttft_later_ms": [r.ttft_s * 1e3 for r in results[1:]],
               "prompt_tokens": [len(ids) for ids in prompt_ids],
               "decode_ms_per_token": 1e3 * statistics.median(decode),
               "decode_ms_per_token_mean": 1e3 * sum(decode) / len(decode),
               **greedy_and_sampled_ms(results, requests), "sample_draw": draws,
               "peak_memory_gb": peak_gb, "held_memory_gb": held_gb,
               "reserved_memory_gb": reserved_gb, "setup_s": setup_s}
    state = {"args": args, "cfg": cfg, "params": params, "client": client,
             "ref_params": ref_params, "prompt_ids": prompt_ids,
             "results": results, "requests": requests, "references": refs}
    return summary, state


def reset_counts(kernels, executors) -> None:
    """Every kernel's launch counts and the path's graph and sampler
    counters to 0, just before a path's requests."""
    for mod in kernels.values():
        for counter in ("_launches", "_launches_mma", "_launches_gemv", "_launches_f32mma"):
            if hasattr(mod, counter):
                setattr(mod, counter, 0)
    for ex in executors:
        ex.graphs.captures = ex.graphs.replays = 0
        ex.sampler.captures = ex.sampler.replays = 0


def draw_gate(what: str, kernels, executors, results, requests) -> dict:
    """sample_draw launches on the path (counts reset just before its
    requests) must reach its sampled tokens: one draw a sampled token, on
    the final stage, through the captured sampler (its replays count)."""
    sampled = sum(len(r.tokens) for r, (_, sp) in zip(results, requests) if not sp.greedy)
    launches = kernels["sample_draw"]._launches
    replays = sum(ex.sampler.replays for ex in executors)
    captures = sum(ex.sampler.captures for ex in executors)
    log(f"{what}: sample_draw launches {launches} (>= {sampled} sampled tokens), "
        f"sampler {captures} captures, {replays} replays")
    if launches < sampled or replays < sampled:
        raise AssertionError(f"{what}: {launches} sample_draw launches and {replays} "
                             f"sampler replays for {sampled} sampled tokens")
    return {"launches": launches, "sampled_tokens": sampled,
            "sampler_captures": captures, "sampler_replays": replays}


def greedy_and_sampled_ms(results, requests) -> dict:
    """Median decode ms/token of the greedy requests and of the sampled one."""
    def ms(greedy):
        steps = [t for r, (_, sp) in zip(results, requests) if sp.greedy == greedy
                 for t in r.decode_times_s]
        return 1e3 * statistics.median(steps) if steps else None

    return {"greedy_decode_ms_per_token": ms(True),
            "sampled_decode_ms_per_token": ms(False)}


def references(torch, cfg, params, prompt_ids, requests, seed, cache_dtype=None):
    """The float32-cache (or `cache_dtype`-cache) reference of each
    request: the greedy loop, or the sampled loop with the pipeline's step
    seeds."""
    out = []
    for ids, (_, sp) in zip(prompt_ids, requests):
        if sp.greedy:
            out.append({"ids": ids, "tokens": greedy_reference(
                torch, cfg, params, ids, MAX_NEW_TOKENS, cache_dtype)})
        else:
            out.append({"ids": ids, **sampled_reference(torch, cfg, params, ids, sp, seed,
                                                        MAX_NEW_TOKENS, cache_dtype)})
        out[-1]["cache_dtype"] = cache_dtype
    return out


def hold_requests(torch, cfg, params, refs, results, what: str) -> None:
    """Each request's tokens against its reference (float32-cache unless
    it names another cache dtype): equal, or a first difference at a
    near-tie (greedy: of the logits; sampled: of the perturbed scores)."""
    for ref, r in zip(refs, results):
        if "gaps" in ref:
            hold_sampled(ref, r.tokens, f"{what}: sampled tokens against the "
                         f"{ref.get('cache_dtype') or 'float32'}-cache sampled reference")
        else:
            hold_to_reference(torch, cfg, params, ref["ids"], r.tokens, ref["tokens"],
                              f"{what}: greedy tokens against the "
                              f"{ref.get('cache_dtype') or 'float32'}-cache reference",
                              ref.get("cache_dtype"))


def path_executors(client):
    """Every stage executor of an in-process client: stage 0, then the
    transport's peers."""
    return [client.stage0] + [client.transport.executor(p) for p in client.transport.peers()]


def graph_counts(what: str, executors, tokens: int):
    """Captures and replays of the path's executors (counters set to 0
    before the requests): every token is one step of every stage, each a
    replay, so replays must reach stages x tokens."""
    captures = sum(ex.graphs.captures for ex in executors)
    replays = sum(ex.graphs.replays for ex in executors)
    need = len(executors) * tokens
    log(f"{what}: {captures} graph captures, {replays} replays (>= {len(executors)} "
        f"stages x {tokens} tokens = {need})")
    if replays < need:
        raise AssertionError(f"{what}: {replays} graph replays, want >= {need}")
    return {"captures": captures, "replays": replays,
            "per_stage": {ex.peer_id: [ex.graphs.captures, ex.graphs.replays]
                          for ex in executors}}


def capture_phase(torch, client, quant: str):
    """For every key the served run captured, on every stage: one replay of
    its graph and the eager step, each on its own copy of the same cache
    (the lease buffer as the run left it) and the same static input and
    cache_len. Output and cache writes must be bit-equal."""
    keys = 0
    for ex in path_executors(client):
        for key, st in ex.graphs.entries():
            k0, v0 = st.k.clone(), st.v.clone()
            ek, ev = k0.clone(), v0.clone()
            eager = st.step(st.x, ek, ev, st.cache_len)
            st.graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(st.graph.out, eager) and torch.equal(st.k, ek)
                    and torch.equal(st.v, ev)):
                err = (st.graph.out.float() - eager.float()).abs().max().item()
                raise AssertionError(f"{quant} {ex.peer_id} key {key[:3]}: replay "
                                     f"differs from the eager step (max err {err})")
            st.k.copy_(k0)
            st.v.copy_(v0)
            keys += 1
    log(f"{quant} capture: replay bit-equal to the eager step for all {keys} "
        "captured keys (output and cache writes)")
    return {"keys": keys, "bit_equal": True}


def sync_phase(torch, client, prompt_ids, requests) -> dict:
    """Host syncs of one in-process greedy request and one sampled request
    after their graphs exist: one a token, the read of the token (the
    sampled one through the captured sampler: its scalars go to the device
    in a non-blocking copy from pinned memory)."""
    out = {}
    for ids, (_, sp) in zip(prompt_ids[1:], requests[1:]):
        what = "greedy" if sp.greedy else "sampled"
        box = {}
        syncs = count_syncs(torch, lambda: box.setdefault(
            "r", client.generate(ids, MAX_NEW_TOKENS, sampling=sp)))
        tokens = len(box["r"].tokens)
        log(f"host syncs of one {what} request: {syncs} for {tokens} tokens")
        if syncs != tokens:
            raise AssertionError(f"{what}: {syncs} host syncs for {tokens} tokens, "
                                 "want one a token")
        out[what] = {"syncs": syncs, "tokens": tokens}
    return out


def concurrent_phase(torch, client, ids, greedy) -> dict:
    """Two sessions open at once on the same stages. Session A runs its
    prefill and one decode step and holds its lease; meanwhile session B
    runs a whole greedy request. B's lease is another buffer pair, a new
    slot, and graph keys hold the slot, so every stage captures B's step
    shapes inside B's request (the reference's jit cache is keyed by shape
    alone). Then a request alone, on a reused slot, for comparison: B's
    tokens must equal it. Prints B's TTFT and captures, the alone request's
    TTFT, and the memory the allocator reserves before and after B, each
    read after ``empty_cache()``: what stays reserved then is the live
    tensors and the graphs' pools (a live graph's pool is never released),
    so the difference is what B's graphs and lease added."""
    executors = path_executors(client)

    def captures():
        return sum(ex.graphs.captures for ex in executors)

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    held = client.generate_stepwise(ids, MAX_NEW_TOKENS, sampling=greedy)
    next(held)
    next(held)
    c0, reserved0 = captures(), reserved()
    second = client.generate(ids, MAX_NEW_TOKENS, sampling=greedy)
    c1, reserved1 = captures(), reserved()
    held.close()
    alone = client.generate(ids, MAX_NEW_TOKENS, sampling=greedy)
    if second.tokens != alone.tokens:
        raise AssertionError("a second session's tokens differ from the same "
                             "request's alone")
    out = {"second_session_ttft_ms": 1e3 * second.ttft_s,
           "second_session_captures": c1 - c0,
           "alone_ttft_ms": 1e3 * alone.ttft_s,
           "alone_captures": captures() - c1,
           "graphs_held": sum(len(ex.graphs.entries()) for ex in executors),
           "reserved_gb_before": reserved0 / 1e9, "reserved_gb_after": reserved1 / 1e9}
    log(f"two sessions at once: the second's TTFT {out['second_session_ttft_ms']:.1f} ms "
        f"with {c1 - c0} captures, reserved {reserved0 / 1e9:.3f} -> "
        f"{reserved1 / 1e9:.3f} GB; alone on a reused slot "
        f"{out['alone_ttft_ms']:.1f} ms with {out['alone_captures']} captures")
    return out


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_phase(torch, client, ids, greedy, smi: str, steps: int = 8) -> dict:
    """torch.profiler over `steps` captured decode steps of the in-process
    client: wall ms a step (host clock, each ending in the token read), the
    device's busy ms (union of the traced kernels) and idle share."""
    gen = client.generate_stepwise(ids, steps + 2, sampling=greedy)
    next(gen)                                       # prefill and first token
    next(gen)                                       # one untraced decode step
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            next(gen)
            walls.append(time.perf_counter() - t0)
    gen.close()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    wall_ms = 1e3 * sum(walls) / steps
    out = {"card": smi, "decode_steps_traced": steps, "wall_ms_per_step": wall_ms,
           "kernels_per_step": len(kernels) / steps}
    if kernels:
        busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / steps
        out.update(device_busy_ms_per_step=busy, device_idle_share=1 - busy / wall_ms)
        by_name = {}
        for e in kernels:
            ms_n = by_name.setdefault(e.name[:80], [0.0, 0])
            ms_n[0] += (e.time_range.end - e.time_range.start) / 1e3 / steps
            ms_n[1] += 1 / steps
        out["top_kernels_ms_per_step"] = [
            {"name": k, "ms": v[0], "launches": v[1]}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]]
        log(f"profile: {wall_ms:.2f} ms a captured decode step, device busy {busy:.2f} ms, "
            f"idle {100 * (1 - busy / wall_ms):.1f}%, {len(kernels) / steps:.0f} kernels a step")
    else:
        out["device_busy_ms_per_step"] = "not measured: the profiler saw no device time"
        log("profile: the profiler recorded no device activity")
    return out


def oracle_phase(torch, tmain, sampling_cls, dk, cfg, params, ids, smi: str) -> dict:
    """``--mode oracle --quant int8`` through the fused engines (one
    captured decode step replayed a token) against the eager per-token
    loop of the same oracle, greedy and then sampled (the fused sampled
    engine: the sampler in the captured step, key PRNGKey(seed + i)):
    equal tokens; at least one sample_draw a sampled token in the fused
    calls. Times of both; the first fused call pays the captures."""
    args = tmain.build_parser().parse_args(
        ["--mode", "oracle", "--model", MODEL, "--quant", "int8", "--dtype", "bfloat16",
         "--device", "cuda", "--seed", "0"])
    generate = tmain.make_oracle_generate(args, cfg, params)

    def ms(r):
        return 1e3 * statistics.median(r.decode_times_s) if r.decode_times_s else None

    out = {"card": smi}
    for what, sp in (("greedy", sampling_cls(temperature=0.0)),
                     ("sampled", sampling_cls(temperature=0.7, top_p=0.9, top_k=50,
                                              repetition_penalty=1.5))):
        dk._launches = 0
        fused = [generate(ids, MAX_NEW_TOKENS, sp) for _ in range(2)]
        draws = dk._launches
        eager = generate.per_token(ids, MAX_NEW_TOKENS, sp)
        log(f"oracle int8 {what}: fused {fused[0].tokens}\n  per-token {eager.tokens}")
        if not fused[0].tokens == fused[1].tokens == eager.tokens:
            raise AssertionError(f"oracle {what}: the fused engine's tokens differ from "
                                 "the per-token loop's")
        if not sp.greedy and draws < 2 * len(eager.tokens):
            raise AssertionError(f"oracle sampled: {draws} sample_draw launches for "
                                 f"{2 * len(eager.tokens)} tokens")
        out[what] = {"tokens": len(eager.tokens), "stopped_by": eager.stopped_by,
                     "tokens_equal_per_token": True, "sample_draw_launches_fused": draws,
                     "fused_decode_ms_per_token": [ms(r) for r in fused],
                     "per_token_decode_ms_per_token": ms(eager),
                     "fused_ttft_ms": [1e3 * r.ttft_s for r in fused],
                     "per_token_ttft_ms": 1e3 * eager.ttft_s}
        log(f"oracle int8 {what}: decode {out[what]['fused_decode_ms_per_token']} ms/token "
            f"fused (first call pays the capture), "
            f"{out[what]['per_token_decode_ms_per_token']:.2f} per token eager")
    return out


def failover_drive(torch, tmain, state):
    """Kill the pinned stage-2 peer after its 3rd decode step of a greedy
    request; the client must fail over to a second stage-2 executor, replay
    the journal and produce the fault-free tokens (or differ first at a
    near-tie of the float32 reference)."""
    from importlib import import_module

    executor_mod = import_module(PORT + ".runtime.executor")
    client_mod = import_module(PORT + ".runtime.client")
    args, cfg, client = state["args"], state["cfg"], state["client"]
    transport = client.transport
    spec = client.plan.stages[2]
    replica_id = f"server-stage{spec.index}-replica"
    replica = executor_mod.StageExecutor(
        cfg, spec, tmain._stage_params(args, cfg, state["params"], spec),
        peer_id=replica_id, device=torch.device(args.device),
        act_dtype=tmain._DTYPE_MAP[args.dtype])
    transport.add_peer(replica_id, replica)
    client.registry.register(client_mod.make_server_record(replica_id, spec,
                                                           model=args.model))
    pinned = next(h.peer_id for h in client.route() if h.key == f"stage{spec.index}")
    seen = {"decode": 0}

    def on_call(peer_id, req):
        if peer_id == pinned and not req.is_prefill and not req.is_replay:
            seen["decode"] += 1
            if seen["decode"] == KILL_AFTER_DECODES:
                transport.kill(peer_id)

    transport.on_call = on_call
    before = client.recoveries
    t0 = time.monotonic()
    got = client.generate(state["prompt_ids"][0], MAX_NEW_TOKENS,
                          sampling=state["requests"][0][1])
    wall_s = time.monotonic() - t0
    transport.on_call = None
    recoveries = client.recoveries - before
    log(f"failover: pinned {pinned} killed after {seen['decode']} decode calls, "
        f"{recoveries} recovery, replica served {replica.requests_served} requests, "
        f"{len(got.tokens)} tokens in {wall_s:.2f}s")
    if recoveries < 1 or replica.requests_served <= 0:
        raise AssertionError("failover did not recover onto the replica")
    hold_to_reference(torch, cfg, state["ref_params"], state["prompt_ids"][0],
                      got.tokens, state["results"][0].tokens,
                      "failover tokens against the fault-free run")
    return {"killed": pinned, "replacement": replica_id, "recoveries": recoveries,
            "replica_requests_served": replica.requests_served,
            "tokens": len(got.tokens), "equal_to_fault_free":
            got.tokens == state["results"][0].tokens, "wall_s": wall_s,
            "recovery_step_ms": 1e3 * max(got.decode_times_s),
            "median_step_ms": 1e3 * statistics.median(got.decode_times_s)}


def median_ms(seconds):
    return 1e3 * statistics.median(seconds) if seconds else None


def hist_view(h):
    """count, sum and p50/p90/p99 (interpolated in the buckets) of one
    histogram series, in ms."""
    q = {f"p{int(x * 100)}_ms": (None if h.quantile(x) is None else 1e3 * h.quantile(x))
         for x in (0.5, 0.9, 0.99)}
    return {"count": h.count, "sum_ms": 1e3 * h.sum, **q}


def family_view(reg, name):
    """{labels: value} of one family of the registry: histograms as
    hist_view, counters and gauges as their value."""
    fam = reg.get(name)
    if fam is None:
        return {}
    children = fam.children() if hasattr(fam, "children") else (fam,)
    out = {}
    for child in children:
        key = ",".join(f"{k}={v}" for k, v in child.labels) or "-"
        out[key] = hist_view(child) if hasattr(child, "quantile") else child.value
    return out


def count_syncs(torch, fn) -> int:
    """Host syncs that torch's sync debug mode reports while fn runs."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def hook_cost(torch, tel, on: bool) -> float:
    """Host us a decode step of the port's client and LocalTransport over
    stub stages (3 remote hops, no model, nothing on the card), with
    telemetry on or off: the instrumentation's own cost on this host, in
    the code the served path runs. Median of 5 rounds of HOOK_STEPS
    steps."""
    from importlib import import_module

    client_mod = import_module(PORT + ".runtime.client")
    transport_mod = import_module(PORT + ".runtime.transport")
    messages = import_module(PORT + ".runtime.messages")
    partition = import_module(PORT + ".models.partition")
    registry_mod = import_module(PORT + ".scheduling.registry")
    sampling_cls = import_module(PORT + ".ops.sampling").SamplingParams

    class StubStage:
        """Returns its input (or, last, the next position as the token)."""

        device = torch.device("cpu")

        def __init__(self, peer_id, last):
            self.peer_id, self.last = peer_id, last

        def forward(self, req):
            n = req.cur_len + req.seq_len
            if self.last:
                return messages.StageResponse(req.session_id, token_id=n, cache_len=n)
            return messages.StageResponse(req.session_id, hidden=req.hidden, cache_len=n)

        def drop_session(self, session_id):
            pass

    plan = partition.StagePlan.even(32, 4)
    transport = transport_mod.LocalTransport()
    registry = registry_mod.PlacementRegistry()
    for spec in plan.stages[1:]:
        transport.add_peer(f"stub{spec.index}", StubStage(f"stub{spec.index}", spec.is_last))
        registry.register(client_mod.make_server_record(f"stub{spec.index}", spec))
    stage0 = StubStage("stub0", False)
    stage0.forward = lambda req: messages.StageResponse(
        req.session_id, hidden=torch.zeros(1, req.seq_len, 8), cache_len=req.seq_len)
    client = client_mod.PipelineClient(None, plan, stage0, transport, registry,
                                       settle_seconds=0.0,
                                       metrics=tel.get_registry())
    (tel.enable if on else tel.disable)()
    try:
        rounds = []
        for _ in range(5):
            r = client.generate([1, 2, 3], HOOK_STEPS + 1,
                                sampling=sampling_cls(temperature=0.0))
            rounds.append(1e6 * statistics.median(r.decode_times_s))
    finally:
        tel.disable()
        tel.get_tracer().clear()
        tel.get_recorder().clear()
    return statistics.median(rounds)


def telemetry_phase(torch, tmain, nk, state, smi: str):
    """Telemetry on the NF4 path, on the serve phase's client (whose metrics
    go to the process-global registry).

    1. One greedy request, telemetry off and on in turn, TELEMETRY_PAIRS
       pairs in ABBA order (off on, on off, ...): equal tokens and equal
       nf4_dot launch counts of both routes in every run (counts set to 0
       before each run, read after). The median decode ms/token and TTFT of
       each side are reported, not gated. One more pair runs under
       torch's sync debug mode: the host syncs it reports must be as many
       with telemetry on as off. And the hooks alone are priced on this
       host: the client and transport over stub stages (hook_cost).
    2. The failover drive with telemetry on and the recorder cleared just
       before it: the recorder must hold the session's story, and the
       doctor, over the dump of it, must name one failure chain with the
       tokens the client replayed (the prompt and the decode steps the
       killed peer served) and split each request's wall time into parts
       that sum to it.
    3. The registry's summary and the per-layer families.
    Telemetry is off and cleared at the end, whatever happens."""
    from importlib import import_module

    tel = import_module(PORT + ".telemetry")
    doctor = import_module(PORT + ".telemetry.doctor")
    client, ids = state["client"], state["prompt_ids"][0]
    greedy = state["requests"][0][1]
    runs = {"off": [], "on": []}
    try:
        for i in range(TELEMETRY_PAIRS):
            for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
                (tel.enable if side == "on" else tel.disable)()
                nk._launches = nk._launches_mma = nk._launches_gemv = 0
                r = client.generate(ids, MAX_NEW_TOKENS, sampling=greedy)
                torch.cuda.synchronize()
                runs[side].append({"tokens": r.tokens, "ttft_s": r.ttft_s,
                                   "decode_s": median_ms(r.decode_times_s) / 1e3,
                                   "launches": (nk._launches, nk._launches_mma,
                                                nk._launches_gemv)})
        syncs = {}
        for side in ("off", "on"):
            (tel.enable if side == "on" else tel.disable)()
            syncs[side] = count_syncs(torch, lambda: client.generate(
                ids, MAX_NEW_TOKENS, sampling=greedy))
        if syncs["on"] != syncs["off"]:
            raise AssertionError(f"telemetry adds host syncs: {syncs}")
        every = runs["off"] + runs["on"]
        if any(r["tokens"] != every[0]["tokens"] for r in every):
            raise AssertionError("telemetry on/off: the tokens differ between runs")
        if any(r["launches"] != every[0]["launches"] for r in every):
            raise AssertionError("telemetry on/off: nf4_dot launch counts differ: "
                                 f"{[r['launches'] for r in every]}")
        overhead = {"card": smi, "pairs": TELEMETRY_PAIRS, "order": "ABBA",
                    "syncs_per_request": syncs,
                    "tokens": len(every[0]["tokens"]),
                    "nf4_dot_launches": every[0]["launches"][0],
                    "nf4_dot_launches_mma": every[0]["launches"][1],
                    "nf4_dot_launches_gemv": every[0]["launches"][2]}
        for side, rs in runs.items():
            overhead[f"decode_ms_per_token_{side}"] = median_ms([r["decode_s"] for r in rs])
            overhead[f"ttft_ms_{side}"] = median_ms([r["ttft_s"] for r in rs])
            overhead[f"decode_ms_per_token_{side}_runs"] = [1e3 * r["decode_s"] for r in rs]
        log(f"telemetry off/on ({smi}): decode "
            f"{overhead['decode_ms_per_token_off']:.3f} / "
            f"{overhead['decode_ms_per_token_on']:.3f} ms/token, ttft "
            f"{overhead['ttft_ms_off']:.1f} / {overhead['ttft_ms_on']:.1f} ms "
            f"(medians of {TELEMETRY_PAIRS} runs each); tokens and nf4_dot "
            f"launches {every[0]['launches']} equal in all {len(every)} runs; "
            f"host syncs a request {syncs}")

        tel.enable()
        tel.get_recorder().clear()
        tel.get_tracer().clear()
        failover = failover_drive(torch, tmain, state)
        evs = tel.get_recorder().events()
        starts = [e for e in evs if e.name == "session_start"]
        if len(starts) != 1:
            raise AssertionError(f"want one session_start, got {len(starts)}")
        sid = starts[0].session_id
        names = {e.name for e in evs if e.session_id == sid}
        want = {"session_start", "failover", "replay_start", "replay_done", "session_end"}
        if not want <= names or not names & {"transport_error", "peer_failed"}:
            raise AssertionError(f"recorder lacks the failover story: {sorted(names)}")
        replayed = len(ids) + KILL_AFTER_DECODES
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "events.jsonl")
            tel.get_recorder().dump(path, registry=tel.get_registry())
            streams = doctor.load_dumps([path])
        report = doctor.diagnose_streams(streams)
        chains = doctor.failure_chains(doctor.merge_timeline(streams))
        if len(chains) != 1 or sid not in chains[0]["sessions"] or \
                f"replay of {replayed} tokens" not in chains[0]["chain"] or \
                f"{sid}: {replayed} tokens" not in report:
            raise AssertionError(f"doctor: want one chain replaying {replayed} tokens "
                                 f"of {sid}, got:\n{report}")
        log("doctor over the failover dump:\n" + report.rstrip())
        reports = doctor.critical_path_reports(streams)
        if len(reports) != failover["tokens"]:
            raise AssertionError(f"critical path: {len(reports)} requests, want one "
                                 f"per step ({failover['tokens']})")
        for rep in reports:
            total = sum(rep["parts"].values())
            if not abs(total - rep["wall_s"]) <= 1e-9 * rep["wall_s"] + 1e-12:
                raise AssertionError(f"critical path parts {rep['parts']} sum to "
                                     f"{total}, wall {rep['wall_s']}")
        log(doctor.render_critical_path(reports).rstrip())

        reg = tel.get_registry()
        per_stage = {}
        for sp in tel.get_tracer().spans():
            if sp.name == "server_forward" and sp.end_s is not None:
                key = f"{sp.attrs.get('peer')},{sp.attrs.get('phase')}"
                per_stage.setdefault(key, []).append(sp.end_s - sp.start_s)
        families = {
            "card": smi,
            "covers": (f"the {TELEMETRY_PAIRS + 1} telemetry-on runs of the "
                       "request and the failover run"),
            "summary": tel.summary(reg),
            **{name: family_view(reg, name) for name in (
                "client_ttft_seconds", "client_step_seconds",
                "client_stage_time_seconds", "server_step_latency_seconds",
                "server_kv_used_bytes", "transport_bytes_sent_total")},
            "server_forward_span_ms_by_stage": {
                k: {"count": len(v), "p50_ms": median_ms(v)} for k, v in sorted(per_stage.items())},
            "critical_path_parts_ms": {
                part: 1e3 * sum(r["parts"][part] for r in reports)
                for part in reports[0]["parts"]},
        }
        log(json.dumps({"telemetry_families": families}))
        # Last: the stub pipeline's series land in the same registry.
        overhead["hook_us_per_decode_step_stub_stages"] = hooks_us = {
            side: hook_cost(torch, tel, side == "on") for side in ("off", "on")}
        log(f"telemetry hooks alone, client and transport over stub stages "
            f"({smi}): {hooks_us['off']:.1f} / {hooks_us['on']:.1f} us a decode "
            f"step, off / on")
        return {"overhead": overhead, "failover": failover,
                "doctor": {"chains": len(chains), "replayed_tokens": replayed,
                           "critical_path_requests": len(reports)}}
    finally:
        tel.disable()
        tel.get_tracer().clear()
        tel.get_recorder().clear()
        tel.get_registry().reset()


def f32_chain(torch, state) -> dict:
    """The path's requests in process with every executor after stage 0
    given ``act_dtype=torch.float32``: the float32 activations that a TCP
    hop hands a stage that casts nothing, as ``--mode serve`` builds it.
    Its tokens are what the TCP drive at wire f32 and the CLI drive must
    give; each request is held to its float32-cache reference. The
    executors' act_dtype is set back after. Returns the results and the
    run's times."""
    local, cfg = state["client"], state["cfg"]
    remote = [local.transport.executor(p) for p in local.transport.peers()]
    saved = [ex.act_dtype for ex in remote]
    for ex in remote:
        ex.act_dtype = torch.float32
    try:
        results = [local.generate(ids, MAX_NEW_TOKENS, sampling=sp)
                   for ids, (_, sp) in zip(state["prompt_ids"], state["requests"])]
    finally:
        for ex, dtype in zip(remote, saved):
            ex.act_dtype = dtype
    hold_requests(torch, cfg, state["ref_params"], state["references"], results,
                  f"{state['args'].quant} float32-after-stage-0 chain")
    return {"results": results,
            "ttft_ms": [r.ttft_s * 1e3 for r in results],
            **greedy_and_sampled_ms(results, state["requests"])}


def gemv_gate(what: str, name: str, cfg, local, graphs, tokens: int, requests: int,
              by_route: dict, prefill_route: str) -> None:
    """Over TCP every decode step of every layer takes the decode kernel
    (stage 0 with bf16 x, stages 1-3 with the float32 the wire decodes to),
    and the float32 prefill of stages 1-3 takes `prefill_route` (the route
    `_route` gives float32 x at the prompt's bucket: "f32mma" for both
    kernels): exactly 4 launches a layer of those stages for
    each request, and for each eager warm-up run of a capture (at most one
    a capture); besides stage 0's prefill on the tensor cores, no launch
    takes any other route. `by_route` maps each route to its launches."""
    later = cfg.num_layers - local.plan.stages[0].num_layers
    need_gemv = 4 * cfg.num_layers * (tokens - requests)
    captures = sum(c for peer, (c, _) in graphs["per_stage"].items()
                   if peer != local.stage0.peer_id)
    passes, rest = divmod(by_route[prefill_route], 4 * later)
    others = {route: n for route, n in by_route.items()
              if route not in ("mma", "gemv", prefill_route) and n}
    log(f"{what}: {name} decode-kernel launches {by_route['gemv']} (>= 4 x "
        f"{cfg.num_layers} x {tokens - requests} decode steps = {need_gemv}), "
        f"{prefill_route} {by_route[prefill_route]} (float32 prefill: 4 x {later} layers x "
        f"{passes} passes, {requests} requests + <= {captures} warm-ups), other routes "
        f"{others or 0}")
    if (by_route["gemv"] < need_gemv or rest or not requests <= passes <= requests + captures
            or others):
        raise AssertionError(f"{what}: {name} launches by route {by_route}: a decode step "
                             f"left the decode kernel, or the float32 prefill left "
                             f"{prefill_route}, or another route ran")


def tcp_drive(torch, kernels, name: str, tmain, state, smi: str, failover: bool,
              wire: str):
    """The serve() run's executors behind TCP servers and a registry
    service, each with no act_dtype (as ``--mode serve`` builds it: an
    arrival computes in the float32 the wire decodes to), the same
    requests through a TCP client at wire dtype `wire`. At ``f32`` the
    tokens must equal the float32-after-stage-0 chain's (`f32_chain`); at
    ``bf16``, ``--wire_dtype``'s default, each hop rounds the activation
    to bfloat16, and each request is held to its float32-cache reference
    (`hold_requests`: equal, or a first difference at a near-tie). Both:
    the launch gates of serve() (tensor-core launches: stage 0's prefill
    sites, the only ones that still get bf16 x), one sample_draw a sampled
    token, the native codec; with `failover`, a stage-2 replica and the
    pinned server stopped after its 3rd decode step. Returns the tcp_path
    summary."""
    from importlib import import_module

    net = import_module(PORT + ".runtime.net")
    native = import_module(PORT + ".native")
    task_pool = import_module(PORT + ".runtime.task_pool")
    client_mod = import_module(PORT + ".runtime.client")
    executor_mod = import_module(PORT + ".runtime.executor")
    profiling = import_module(PORT + ".telemetry.profiling")
    args, cfg, local = state["args"], state["cfg"], state["client"]
    chain = f32_chain(torch, state) if wire == "f32" else None
    registry_srv = net.RegistryServer()
    registry_srv.start()
    servers = {}
    transport = None
    remote = [local.transport.executor(p) for p in local.transport.peers()]
    saved = [ex.act_dtype for ex in remote]

    def serve_over_tcp(peer, ex):
        ex.act_dtype = None
        srv = net.TcpStageServer(ex, task_pool.StageRuntime(), wire_dtype=wire,
                                 model=MODEL)
        srv.start()
        servers[peer] = srv
        rec = client_mod.make_server_record(peer, ex.spec, model=MODEL)
        rec.address = srv.address
        registry_srv.registry.register(rec)

    prof = profiling.get_profiler()
    try:
        for peer in local.transport.peers():
            serve_over_tcp(peer, local.transport.executor(peer))
        registry = net.RemoteRegistry(registry_srv.address)
        transport = net.TcpTransport(registry, wire_dtype=wire, model=MODEL)
        client = client_mod.PipelineClient(cfg, local.plan, local.stage0, transport,
                                           registry, seed=args.seed, model=MODEL)
        torch.cuda.reset_peak_memory_stats()
        profiling.enable_phase_profiling()
        prof.reset()
        executors = path_executors(local)
        reset_counts(kernels, executors)
        results = [client.generate(ids, MAX_NEW_TOKENS, sampling=sp)
                   for ids, (_, sp) in zip(state["prompt_ids"], state["requests"])]
        torch.cuda.synchronize()
        mod = kernels[name]
        launches, launches_mma = mod._launches, mod._launches_mma
        launches_gemv, launches_f32mma = mod._launches_gemv, mod._launches_f32mma
        by_route = {"mma": launches_mma, "gemv": launches_gemv, "f32mma": launches_f32mma,
                    "simt": launches - launches_mma - launches_gemv - launches_f32mma}
        draws = draw_gate(f"tcp {args.quant}", kernels, executors, results,
                          state["requests"])
        socket_phase = prof.snapshot().get("socket")
        profiling.disable_phase_profiling()
        if not native.have_native():
            raise AssertionError("the native wire codec is not loaded")
        tokens = sum(len(r.tokens) for r in results)
        graphs = graph_counts(f"tcp {args.quant}", executors, tokens)
        # Stage 0 (in the client) is the one span whose prefill x is still
        # bf16: the stages behind TCP get float32 x at the prompt's bucket,
        # which takes the route `_route` gives it at every site.
        prefill_m = import_module(PORT + ".runtime.kv_cache").round_to_bucket(
            len(state["prompt_ids"][0]), executor_mod.SEQ_BUCKETS)
        prefill_route = {mod._route(prefill_m, k, n, torch.float32) for _, k, n in SITES}
        assert len(prefill_route) == 1, prefill_route
        prefill_route = prefill_route.pop()
        stage0_layers = local.plan.stages[0].num_layers
        need, need_mma = 4 * cfg.num_layers * tokens, 4 * stage0_layers * len(results)
        log(f"tcp {args.quant}: {tokens} tokens over {len(results)} requests, {name} "
            f"launches {launches} (>= {need}), tensor-core {launches_mma} (>= 4 x "
            f"{stage0_layers} stage-0 layers x {len(results)} = {need_mma})")
        if launches < need or launches_mma < need_mma:
            raise AssertionError(f"tcp {args.quant}: {name} launches {launches} / "
                                 f"{launches_mma}, want >= {need} / {need_mma}")
        gemv_gate(f"tcp {args.quant}", name, cfg, local, graphs, tokens, len(results),
                  by_route, prefill_route)
        if chain is not None:
            for r, want in zip(results, chain["results"]):
                if r.tokens != want.tokens:
                    raise AssertionError(f"tcp {args.quant}: tokens differ from the "
                                         f"in-process float32-after-stage-0 chain's:\n  "
                                         f"{r.tokens}\n  {want.tokens}")
            log(f"  tcp {args.quant}: tokens of all {len(results)} requests equal the "
                "in-process float32-after-stage-0 chain's")
        else:
            hold_requests(torch, cfg, state["ref_params"], state["references"], results,
                          f"tcp {args.quant} wire {wire}")
        decode = [t for r in results for t in r.decode_times_s]
        local_decode = [t for r in state["results"] for t in r.decode_times_s]
        summary = {
            "model": MODEL, "quant": args.quant, "wire_dtype": wire,
            "act_dtype_after_hop": "float32",
            "stages": local.plan.num_stages, "requests": len(results),
            "tokens": tokens,
            "held_to": ("equal to the float32-after-stage-0 chain" if chain is not None
                        else "float32-cache references, near-tie rule"),
            f"{name}_launches": launches, f"{name}_launches_mma": launches_mma,
            f"{name}_launches_gemv": launches_gemv,
            f"{name}_launches_f32mma": launches_f32mma,
            f"{name}_launches_by_route": by_route, "float32_prefill_route": prefill_route,
            "sample_draw": draws,
            "graphs": graphs, "native_codec": native.have_native(),
            "ttft_ms": [r.ttft_s * 1e3 for r in results],
            "ttft_ms_local": [r.ttft_s * 1e3 for r in state["results"]],
            "decode_ms_per_token": 1e3 * statistics.median(decode),
            "decode_ms_per_token_local": 1e3 * statistics.median(local_decode),
            **greedy_and_sampled_ms(results, state["requests"]),
            "client_stage_time_seconds": family_view(client.metrics,
                                                     "client_stage_time_seconds"),
            "socket_phase": socket_phase,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}
        if chain is not None:
            summary["ttft_ms_f32_chain"] = chain["ttft_ms"]
            summary["f32_chain_in_process"] = {k: v for k, v in chain.items()
                                               if k != "results"}
            state["f32_chain_results"] = chain["results"]
        summary["wire"] = wire_costs(torch, net, transport, cfg.hidden_size,
                                     len(state["prompt_ids"][0]), list(servers))
        log(f"  tcp {args.quant}: decode {summary['decode_ms_per_token']:.2f} ms/token "
            f"(in-process {summary['decode_ms_per_token_local']:.2f}), ttft "
            f"{[round(t, 1) for t in summary['ttft_ms']]} ms; wire {summary['wire']}")
        if failover:
            spec = local.plan.stages[2]
            replica_id = f"tcp-stage{spec.index}-replica"
            replica = executor_mod.StageExecutor(
                cfg, spec, tmain._stage_params(args, cfg, state["params"], spec),
                peer_id=replica_id, device=torch.device(args.device))
            serve_over_tcp(replica_id, replica)
            pinned = next(h.peer_id for h in client.route() if h.key == f"stage{spec.index}")
            seen = {"decode": 0}
            call = transport.call

            def stop_after_decodes(peer_id, req, timeout=None):
                resp = call(peer_id, req, timeout)
                if peer_id == pinned and not req.is_prefill and not req.is_replay:
                    seen["decode"] += 1
                    if seen["decode"] == KILL_AFTER_DECODES:
                        servers[pinned].stop()
                return resp

            transport.call = stop_after_decodes
            before = client.recoveries
            got = client.generate(state["prompt_ids"][0], MAX_NEW_TOKENS,
                                  sampling=state["requests"][0][1])
            transport.call = call
            recoveries = client.recoveries - before
            log(f"  tcp failover: {pinned} stopped after {seen['decode']} decode steps, "
                f"{recoveries} recovery, replica served {replica.requests_served} requests")
            if recoveries < 1 or replica.requests_served <= 0:
                raise AssertionError("tcp failover did not recover onto the replica")
            if got.tokens != results[0].tokens:
                raise AssertionError(f"tcp failover tokens differ:\n  {got.tokens}\n  "
                                     f"{results[0].tokens}")
            summary["failover"] = {
                "stopped": pinned, "replacement": replica_id, "recoveries": recoveries,
                "replica_requests_served": replica.requests_served,
                "tokens": len(got.tokens), "equal_to_fault_free": True,
                "recovery_step_ms": 1e3 * max(got.decode_times_s),
                "median_step_ms": 1e3 * statistics.median(got.decode_times_s)}
        return summary
    finally:
        profiling.disable_phase_profiling()
        prof.reset()
        if transport is not None:
            transport.close()
        for srv in servers.values():
            srv.stop()
        registry_srv.stop()
        for ex, dtype in zip(remote, saved):
            ex.act_dtype = dtype


def wire_costs(torch, net, transport, hidden: int, prompt_len: int, peers,
               reps: int = 200):
    """Host cost of the wire alone, on this host: one hop's activation
    (a decode step's [1, 1, hidden] and a prefill's [1, prompt_len,
    hidden]: bfloat16 on the card out of stage 0, float32 out of a stage
    that computes in float32) copied to the host, encoded to the wire
    dtype (bf16, and f32, the TCP drive's) with its CRC-32C, checked and
    decoded again (medians in us); and the median loopback round trip of
    an `info` frame to each server (ms)."""
    out = {}
    for wire, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for what, t in (("decode_hop", 1), ("prefill_hop", prompt_len)):
            x = torch.randn((1, t, hidden), device="cuda").to(dtype)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                meta, body = net._encode_tensor(net._host_array(x), wire)
                net.native.crc32c(body)
                net.native.crc32c(body)
                net._to_tensor(net._decode_tensor(meta, body))
                times.append(time.perf_counter() - t0)
            out[f"{what}_{wire}_codec_us"] = 1e6 * statistics.median(times)
            out[f"{what}_{wire}_bytes"] = len(body)
    rtts = [transport.ping(p) for p in peers for _ in range(20)]
    out["info_round_trip_ms"] = 1e3 * statistics.median(r for r in rtts if r is not None)
    return out


def _wait_line(proc, path: pathlib.Path, prefix: str, what: str) -> str:
    """The first line of the child's stdout file that starts with
    `prefix`; raises if the child exits or CLI_STEP_TIMEOUT_S passes first."""
    deadline = time.monotonic() + CLI_STEP_TIMEOUT_S
    while time.monotonic() < deadline:
        for line in path.read_text(errors="replace").splitlines():
            if line.startswith(prefix):
                return line
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited ({proc.returncode}) before "
                                 f"printing {prefix!r}")
        time.sleep(0.2)
    raise AssertionError(f"{what}: no {prefix!r} line in {CLI_STEP_TIMEOUT_S}s")


def _stderr_tail(path: pathlib.Path, n: int = 30) -> str:
    return "\n".join(path.read_text(errors="replace").splitlines()[-n:])


def cli_drive(torch, tok, wants, smi: str, serve_argv=(), stages=(1, 2, 3), client_argv=()):
    """The port's swarm as processes on the card: a registry, a server a
    stage of `stages` (int8, bfloat16, seed 0, wire f32, and `serve_argv`)
    and one client a `wants` entry (prompt, the in-process result its
    tokens must equal, its sampling; and `client_argv`), the clients run at
    once. Each server computes what arrives in float32 (``serve`` casts
    nothing), so each client's printed generation and its ``TOKENS=`` ids
    must equal its in-process run's over float32 hops (with ``stages=(0,)``
    the one full-span server: the in-process full-span run's). Returns the
    summary."""
    main = [sys.executable, "-m", PORT + ".main"]
    model_args = ["--model", MODEL, "--quant", "int8", "--dtype", "bfloat16",
                  "--seed", "0", "--device", "cuda", "--wire_dtype", "f32"]
    env = dict(os.environ, PYTHONIOENCODING="utf-8", PYTHONUNBUFFERED="1")
    procs = []
    peaks, held, reserved = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        def spawn(what, argv):
            out, err = tmp / f"{what}.out", tmp / f"{what}.err"
            with open(out, "wb") as fo, open(err, "wb") as fe:
                proc = subprocess.Popen(main + argv, stdout=fo, stderr=fe, env=env,
                                        cwd=str(LOG_PATH.parents[1]))
            procs.append((what, proc, err))
            return proc, out

        try:
            t0 = time.monotonic()
            proc, out = spawn("registry", ["--mode", "registry", "--registry_port", "0"])
            addr = _wait_line(proc, out, "REGISTRY_ADDR=", "registry").split("=", 1)[1]
            start_s = {"registry": time.monotonic() - t0}
            for k in stages:
                t0 = time.monotonic()
                proc, out = spawn(f"stage{k}", ["--mode", "serve", "--stage", str(k),
                                                "--registry_addr", addr, "--rpc_port", "0",
                                                *model_args, *serve_argv])
                line = _wait_line(proc, out, "SERVING ", f"stage {k} server")
                # Printed before the SERVING line.
                peak = re.search(r"PEAK_MEMORY_BYTES=(\d+)", out.read_text())
                peaks[f"stage{k}_at_start"] = peak and int(peak.group(1))
                start_s[f"stage{k}"] = time.monotonic() - t0
                log(f"cli: {line} ({start_s[f'stage{k}']:.1f}s)")
            t0 = time.monotonic()
            clients = []
            for i, (prompt, _, sp) in enumerate(wants):
                proc, out = spawn(f"client{i}", [
                    "--mode", "client", "--registry_addr", addr, *model_args,
                    "--prompt", prompt, "--max_new_tokens", str(MAX_NEW_TOKENS),
                    "--temperature", str(sp.temperature), "--top_p", str(sp.top_p),
                    "--top_k", str(sp.top_k),
                    "--repetition_penalty", str(sp.repetition_penalty), *client_argv])
                clients.append((proc, out))
            ttft, tps = [], []
            for i, ((proc, out), (prompt, want, _)) in enumerate(zip(clients, wants)):
                code = proc.wait(timeout=CLI_STEP_TIMEOUT_S)
                # Bytes decoded as they are: a generation may hold a "\r",
                # which a text read would turn into a newline.
                stdout = out.read_bytes().decode("utf-8", errors="replace")
                if code != 0:
                    raise AssertionError(f"client {i} exited {code}:\n"
                                         + _stderr_tail(procs[1 + len(stages) + i][2], 60))
                expect = (f"=== Generation ({len(want.tokens)} tokens, stopped by "
                          f"{want.stopped_by}) ===\n{tok.decode(want.tokens)}\n")
                if expect not in stdout:
                    raise AssertionError(f"cli client {i} text differs from its in-process "
                                         f"run's:\n{stdout}\nwant:\n{expect}")
                ids = re.search(r"^TOKENS=(\[[0-9, ]*\])$", stdout, re.M)
                if ids is None or json.loads(ids.group(1)) != want.tokens:
                    raise AssertionError(f"cli client {i} token ids differ from its "
                                         f"in-process run's:\n{ids and ids.group(1)}\n"
                                         f"want:\n{want.tokens}")
                ttft.append(float(re.search(r"TTFT: ([0-9.]+)s", stdout).group(1)))
                tps.append(float(re.search(r"Decode: [0-9.]+s total, ([0-9.]+) tokens/s",
                                           stdout).group(1)))
                peak = re.search(MEMORY_LINE, stdout)
                peaks[f"client{i}"] = peak and int(peak.group(1))
                held[f"client{i}"] = peak and int(peak.group(2))
                reserved[f"client{i}"] = peak and int(peak.group(3))
            client_s = time.monotonic() - t0
            log(f"cli: every client's text and token ids equal its in-process run's "
                f"({len(wants)} clients at once, {client_s:.1f}s with set-up)")
            # A server prints its peak again when SIGINT stops it.
            servers = procs[1:1 + len(stages)]
            for what, proc, _ in servers:
                proc.send_signal(signal.SIGINT)
            for what, proc, _ in servers:
                proc.wait(timeout=CLI_STEP_TIMEOUT_S)
                last = re.findall(MEMORY_LINE, (tmp / f"{what}.out").read_text())
                peaks[f"{what}_after_request"] = (int(last[-1][0]) if len(last) == 2
                                                  else None)
                held[what] = int(last[-1][1]) if len(last) == 2 else None
                reserved[what] = int(last[-1][2]) if len(last) == 2 else None
            missing = [k for k, v in peaks.items() if v is None]
            if missing:
                raise AssertionError(f"cli: no peak device memory from {missing}")
            summary = {"model": MODEL, "quant": "int8", "wire_dtype": "f32",
                       "serve_argv": list(serve_argv), "stages": list(stages),
                       "client_argv": list(client_argv),
                       "processes": 1 + len(stages) + len(wants),
                       "prompts": [w[0] for w in wants],
                       "tokens": [len(w[1].tokens) for w in wants],
                       "text_equal_in_process": True,
                       "ttft_ms_printed": [t * 1e3 for t in ttft],
                       "decode_ms_per_token_mean_printed": [1e3 / t if t else None
                                                            for t in tps],
                       "peak_memory_gb": {k: v / 1e9 for k, v in peaks.items()},
                       "held_memory_gb": {k: v and v / 1e9 for k, v in held.items()},
                       "reserved_memory_gb": {k: v and v / 1e9
                                              for k, v in reserved.items()},
                       "start_s": start_s, "client_run_s": client_s, "card": smi}
            log(f"cli: ttft {[round(t * 1e3) for t in ttft]} ms, decode "
                f"{[round(v, 2) for v in summary['decode_ms_per_token_mean_printed']]} "
                f"ms/token (mean, printed); peaks GB {summary['peak_memory_gb']}; held GB "
                f"{summary['held_memory_gb']}; reserved GB "
                f"{summary['reserved_memory_gb']}")
            return summary
        except BaseException:
            for what, _, err in procs:
                log(f"--- {what} stderr tail:\n{_stderr_tail(err)}")
            raise
        finally:
            for _, proc, _ in procs:
                proc.kill()
            for _, proc, _ in procs:
                proc.wait(timeout=60)


class Observed:
    """Stands in for one of an adapter's histogram handles (round fills,
    round seconds, queue waits): keeps what it observes."""

    def __init__(self):
        self.values = []

    def observe(self, value):
        self.values.append(value)


def float32_hops():
    """A LocalTransport that hands each hop its activation in float32, as
    a TCP hop at wire f32 does."""
    from importlib import import_module

    transport_mod = import_module(PORT + ".runtime.transport")

    class Float32Hops(transport_mod.LocalTransport):
        def call(self, peer_id, request, timeout=None):
            if request.hidden is not None and request.hidden.is_floating_point():
                request = dataclasses.replace(request, hidden=request.hidden.float())
            return super().call(peer_id, request, timeout)

    return Float32Hops()


def observe_fills(adapters) -> None:
    """From now on, each adapter's round fills, and the monotonic instants
    at which each decode request reaches it and leaves it, with its
    session (`arrivals`)."""
    for a in adapters:
        a._m_fill = Observed()
        a._arrived, a._left = [], []
        decode = type(a)._decode

        def timed(req, a=a, decode=decode):
            a._arrived.append((time.monotonic(), req.session_id))
            try:
                return decode(a, req)
            finally:
                a._left.append((time.monotonic(), req.session_id))

        a._decode = timed


def arrivals(adapters) -> dict:
    """Per stage, since `observe_fills`: the spread of each decode step's
    arrivals (ms from a step's first session to its last, a session's n-th
    decode request being its step n), which one round window must cover for
    one round to take the step; the steps whose spread passed the window;
    and from stage 2 on, each hop (ms from a request leaving the stage
    before to the same session's next request reaching this one)."""
    def by_step(events):
        seen, out = {}, {}
        for t, sid in events:
            seen[sid] = seen.get(sid, -1) + 1
            out[(sid, seen[sid])] = t
        return out

    def quantiles(values):
        v = sorted(values)
        return ({"median": v[len(v) // 2], "p90": v[(9 * (len(v) - 1)) // 10], "max": v[-1]}
                if v else {})

    out, left = {}, None
    for a in adapters:
        came = by_step(a._arrived)
        steps = {}
        for (_, n), t in came.items():
            steps.setdefault(n, []).append(t)
        spreads = [1e3 * (max(v) - min(v)) for v in steps.values()]
        entry = {"window_ms": 1e3 * a.window_s, "steps": len(spreads),
                 "spread_ms": quantiles(spreads),
                 "steps_over_window": sum(x > 1e3 * a.window_s for x in spreads)}
        if left is not None:
            entry["hop_ms"] = quantiles([1e3 * (t - left[key]) for key, t in came.items()
                                         if key in left])
        out[a.peer_id] = entry
        left = by_step(a._left)
    return out


def round_windows(adapters, sessions: int, default: float, tcp: bool = False) -> None:
    """Stage 1's round window for `sessions` clients on this card (see
    STAGE0_STEP_S); stages 2 and 3 keep the `default` in process and take
    TCP_HOP_S a session over TCP."""
    adapters[0].window_s = max(default, sessions * STAGE0_STEP_S)
    for a in adapters[1:]:
        a.window_s = max(default, sessions * TCP_HOP_S) if tcp else default


def batched_requests(tok, sampling_cls, cfg):
    """The batched path's 8 requests: (prompt ids, sampling) each."""
    greedy = sampling_cls(temperature=0.0)
    sampled = sampling_cls(temperature=0.7, top_p=0.9, top_k=50, repetition_penalty=1.5)
    return [([i % cfg.vocab_size for i in tok.encode(p)],
             sampled if j in BATCH_SAMPLED else greedy)
            for j, p in enumerate(BATCH_PROMPTS)]


def batched_engines(torch, tmain, state):
    """Stages 1-3 of the int8 path as `--mode serve --batched` builds them:
    batched engines (bfloat16 slot caches, SLOTS slots of MAX_SESSION_LEN
    rows) behind adapters with the default round window, each warmed up.
    Returns (adapters, warm-up seconds a stage)."""
    from importlib import import_module

    batching = import_module(PORT + ".runtime.batching")
    args, cfg, params = state["args"], state["cfg"], state["params"]
    adapters, warm_s = [], {}
    for spec in state["client"].plan.stages[1:]:
        engine = batching.BatchedStageExecutor(
            cfg, spec, tmain._stage_params(args, cfg, params, spec), device="cuda",
            slots=SLOTS, max_len=MAX_SESSION_LEN, dtype=torch.bfloat16)
        adapter = batching.BatchingStageAdapter(engine, peer_id=f"batched-stage{spec.index}")
        t0 = time.monotonic()
        adapter.warmup()
        torch.cuda.synchronize()
        warm_s[adapter.peer_id] = time.monotonic() - t0
        adapters.append(adapter)
    log(f"batched: stages 1-3 engines, {SLOTS} slots x {MAX_SESSION_LEN} rows, warm-up "
        f"{ {k: round(v, 2) for k, v in warm_s.items()} } s, "
        f"{[a.inner.graphs.captures for a in adapters]} step captures")
    return adapters, warm_s


def stage0_executors(torch, tmain, state, n: int):
    """`n` stage-0 executors, one a client (each `--mode client` process has
    its own), on one fused copy of stage 0's weights, each warmed up with a
    prefill and a step of the batched prompts' shape: their captures happen
    before the clients run at once."""
    from importlib import import_module

    executor_mod = import_module(PORT + ".runtime.executor")
    messages = import_module(PORT + ".runtime.messages")
    transformer = import_module(PORT + ".models.transformer")
    args, cfg = state["args"], state["cfg"]
    spec = state["client"].plan.stages[0]
    shard = transformer.fuse_qkv_params(tmain._stage_params(args, cfg, state["params"], spec))
    out = []
    for i in range(n):
        ex = executor_mod.StageExecutor(cfg, spec, shard, peer_id=f"batched-client{i}",
                                        device="cuda", act_dtype=torch.bfloat16)
        for t, cur in ((32, 0), (1, 32)):
            ex.forward(messages.StageRequest(
                session_id="__warmup__", hidden=torch.zeros((1, t), dtype=torch.int64),
                seq_len=t, cur_len=cur, is_prefill=cur == 0, max_length=32 + MAX_NEW_TOKENS))
        ex.drop_session("__warmup__")
        out.append(ex)
    return out


def run_clients(jobs, burst: int = 0):
    """Each (client, ids, sampling) job on a thread of its own, released
    together; the sessions start decoding together, once every one has its
    first token (requests admitted as one batch: sessions whose prefills
    end apart would decode a step or more apart, and two groups of them
    can then alternate rounds for the whole run); with `burst`, each asks
    for bursts of that many ticks. Returns (results, wall seconds from the
    release to the last end)."""
    barrier = threading.Barrier(len(jobs) + 1)
    prefilled = threading.Barrier(len(jobs))
    results, errors = [None] * len(jobs), []

    def run(i):
        client, ids, sp = jobs[i]
        barrier.wait(timeout=60)
        try:
            steps = client.generate_stepwise(ids, MAX_NEW_TOKENS, sampling=sp,
                                             **({"burst": burst} if burst else {}))
            next(steps)                                 # prefill, first token
            prefilled.wait(timeout=CLI_STEP_TIMEOUT_S)
            for step in steps:          # to its end, which ends the session
                if step.done:
                    results[i] = step.result
        except BaseException as exc:  # raised below, in the caller's thread
            errors.append(exc)
            prefilled.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    t0 = time.monotonic()
    for t in threads:
        t.join(timeout=CLI_STEP_TIMEOUT_S)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a batched client did not finish")
    return results, wall


def batched_counts(kernels, adapters, stage0s) -> None:
    """Every kernel count and every graph and sampler counter of the
    batched path to 0."""
    reset_counts(kernels, stage0s)
    for a in adapters:
        a.inner.graphs.captures = a.inner.graphs.replays = 0
        a.inner.sampler.captures = a.inner.sampler.replays = 0


def batched_gates(what: str, kernels, cfg, adapters, stage0s, results, requests,
                  rounds_before) -> dict:
    """Gates of one batched run (counts set to 0 just before it): no
    capture anywhere (every shape was warmed up); each stage's rounds at
    most MAX_NEW_TOKENS - 1 + ROUND_SLACK; int8_dot launches by route
    (stage 0's prefill on the tensor cores and its decode on the decode
    kernel, one each a site, layer and token at least; on stages 1-3
    exactly one float32-route launch a site and layer for each round and
    for each float32 prefill, and no CUDA-core launch); one sample_draw a
    sampled token at least."""
    ik = kernels["int8_dot"]
    rounds = {a.peer_id: a.inner.decode_steps - rounds_before[a.peer_id] for a in adapters}
    captures = (sum(a.inner.graphs.captures + a.inner.sampler.captures for a in adapters)
                + sum(ex.graphs.captures + ex.sampler.captures for ex in stage0s))
    tokens = sum(len(r.tokens) for r in results)
    decode_tokens = tokens - len(results)
    simt = ik._launches - ik._launches_mma - ik._launches_gemv - ik._launches_f32mma
    layers0 = stage0s[0].spec.num_layers
    need = {"mma": 4 * layers0 * len(results), "gemv": 4 * layers0 * decode_tokens,
            "f32mma": sum(4 * a.spec.num_layers * (rounds[a.peer_id] + len(results))
                          for a in adapters),
            "simt": 0}
    got = {"mma": ik._launches_mma, "gemv": ik._launches_gemv,
           "f32mma": ik._launches_f32mma, "simt": simt}
    sampled = sum(len(r.tokens) for r, (_, sp) in zip(results, requests) if not sp.greedy)
    draws = kernels["sample_draw"]._launches
    limit = MAX_NEW_TOKENS - 1 + ROUND_SLACK
    spread = arrivals(adapters)
    log(f"{what}: {tokens} tokens over {len(results)} sessions; rounds a stage {rounds} "
        f"(<= {limit}; one session a round would take {decode_tokens}); int8_dot "
        f"launches by route {got} (want mma, gemv >= and f32mma, simt == {need}); "
        f"captures {captures}; sample_draw {draws} (>= {sampled} sampled tokens)")
    log(f"{what}: arrivals a stage {json.dumps(spread)}")
    if captures:
        raise AssertionError(f"{what}: {captures} captures after warm-up")
    if any(r > limit for r in rounds.values()):
        raise AssertionError(f"{what}: rounds {rounds}, want <= {limit} a stage")
    if any(got[k] < need[k] for k in ("mma", "gemv")):
        raise AssertionError(f"{what}: int8_dot launches {got}, want >= {need}")
    if got["f32mma"] != need["f32mma"]:
        raise AssertionError(f"{what}: {got['f32mma']} float32-route launches, want one "
                             f"a site and layer for each round and each prefill of stages "
                             f"1-3: {need['f32mma']}")
    if got["simt"] != need["simt"]:
        raise AssertionError(f"{what}: {got['simt']} CUDA-core launches, want none")
    if draws < sampled:
        raise AssertionError(f"{what}: {draws} sample_draw launches for {sampled} "
                             "sampled tokens")
    return {"rounds": rounds, "round_limit": limit,
            "fills": {a.peer_id: list(a._m_fill.values) for a in adapters},
            "arrivals": spread,
            "int8_dot_launches": ik._launches,
            "int8_dot_launches_by_route": got, "sample_draw_launches": draws,
            "captures_after_warmup": captures}


def batched_capture_check(torch, adapters) -> dict:
    """For every key each batched engine captured: one replay of its graph
    and its step run eagerly on the same static inputs, each from a copy
    of the same caches. Outputs (and the head's logits on the last stage)
    and cache writes must be bit-equal."""
    keys = 0
    for a in adapters:
        eng = a.inner
        for key, entry in eng.graphs.entries():
            step = eng._decode_step if key[0] == "decode" else eng._prefill_step
            k0, v0 = eng.k.clone(), eng.v.clone()
            entry.graph.replay()
            out = entry.graph.out
            got = [t.clone() for t in (out if isinstance(out, tuple) else (out,))]
            kr, vr = eng.k.clone(), eng.v.clone()
            eng.k.copy_(k0)
            eng.v.copy_(v0)
            eager = step(entry.x, entry.scalars.tensor)
            eager = eager if isinstance(eager, tuple) else (eager,)
            torch.cuda.synchronize()
            ok = (all(torch.equal(g, e) for g, e in zip(got, eager))
                  and torch.equal(eng.k, kr) and torch.equal(eng.v, vr))
            eng.k.copy_(k0)
            eng.v.copy_(v0)
            if not ok:
                err = max((g.float() - e.float()).abs().max().item()
                          for g, e in zip(got, eager))
                raise AssertionError(f"batched {a.peer_id} key {key}: replay differs "
                                     f"from the eager step (max err {err})")
            keys += 1
    log(f"batched capture: replay bit-equal to the eager step for all {keys} keys "
        "(outputs, head logits and cache writes)")
    return {"keys": keys, "bit_equal": True}


def round_phase(torch, adapters, smi: str, reps: int = 10) -> dict:
    """Each batched stage's decode round alone, SLOTS sessions of a 32-row
    prompt in its slots: the device ms of one round (CUDA events, the
    stream kept busy while the round is enqueued) at fills 1, 2, 4 and 8;
    on the last stage the host ms of a round as its leader runs it (the
    step and the argmax read of every row) at fill 8; the host syncs of
    that round; and the top kernels of a round at fill 8 under
    torch.profiler."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    out = {"card": smi}
    for a in adapters:
        eng = a.inner
        d = eng.cfg.hidden_size
        sids = [f"round{i}" for i in range(SLOTS)]
        for sid in sids:
            eng.prefill(sid, torch.randn((1, 32, d), generator=gen, device="cuda"))
        rows = {sid: torch.randn((1, 1, d), generator=gen, device="cuda") for sid in sids}
        stage = {}
        for fill in (1, 2, 4, 8):
            inputs = {sid: rows[sid] for sid in sids[:fill]}
            stage[f"fill{fill}_device_ms"] = cuda_ms(lambda: eng.decode_batch(inputs),
                                                     torch, reps=reps, spin=True)
        full = {sid: rows[sid] for sid in sids}
        if eng.spec.is_last:
            greedy = {sid: _greedy_request() for sid in sids}

            def leader_round():
                eng.decode_batch(full)
                return eng.sample_round(greedy)

            stage["fill8_leader_host_ms"] = host_ms(leader_round, torch, reps=reps)
            stage["fill8_host_syncs"] = count_syncs(torch, leader_round)
        stage["fill8_top_kernels"] = replay_kernels(torch, lambda: eng.decode_batch(full),
                                                    reps=3)
        for sid in sids:
            eng.end_session(sid)
        out[a.peer_id] = stage
        log(f"batched round {a.peer_id}: device ms at fills 1/2/4/8 "
            f"{[round(stage[f'fill{f}_device_ms'], 3) for f in (1, 2, 4, 8)]}"
            + (f", leader's round {stage['fill8_leader_host_ms']:.2f} ms host with "
               f"{stage['fill8_host_syncs']} sync" if eng.spec.is_last else "")
            + "; top kernels " + ", ".join(f"{k['name'][:40]} {k['ms']:.3f}"
                                           for k in stage["fill8_top_kernels"][:4]))
    return out


def _greedy_request():
    from importlib import import_module

    messages = import_module(PORT + ".runtime.messages")
    sampling = import_module(PORT + ".ops.sampling")
    return messages.StageRequest(session_id="", hidden=None, seq_len=1, cur_len=0,
                                 is_prefill=False, max_length=MAX_SESSION_LEN,
                                 sampling=sampling.SamplingParams(temperature=0.0))


def batched_run_view(results, wall: float, requests) -> dict:
    tokens = sum(len(r.tokens) for r in results)
    decode = [t for r in results for t in r.decode_times_s]
    return {"sessions": len(results), "tokens": tokens, "wall_s": wall,
            "aggregate_tokens_per_s": tokens / wall,
            "per_session_ms_per_token": 1e3 * statistics.median(decode),
            **greedy_and_sampled_ms(results, requests),
            "ttft_ms": [r.ttft_s * 1e3 for r in results]}


def batched_path(torch, kernels, tmain, sampling_cls, state, smi: str):
    """Steps 10-11: the int8 path's stages 1-3 on batched engines. In
    process over float32 hops: 8 concurrent clients, each request held to
    its float32-cache reference, with the rounds, launch, capture and sync
    gates; the fill scan (1, 2, 4, 8 sessions at once); the same 8
    requests one after another on the session engines; every captured
    key's replay against its eager step; the rounds alone. Then the same
    engines behind TcpStageServers with no runtime, the 8 clients over
    TcpTransport at wire f32: tokens equal to the in-process run's.
    Returns (summary, the in-process results for the CLI drive)."""
    from importlib import import_module

    client_mod = import_module(PORT + ".runtime.client")
    registry_mod = import_module(PORT + ".scheduling.registry")
    net = import_module(PORT + ".runtime.net")
    args, cfg, local = state["args"], state["cfg"], state["client"]
    requests = batched_requests(tmain.load_tokenizer(), sampling_cls, cfg)
    reqs = [(None, sp) for _, sp in requests]
    refs = state["references"] + references(
        torch, cfg, state["ref_params"], [ids for ids, _ in requests[3:]], reqs[3:], args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adapters, warm_s = batched_engines(torch, tmain, state)
    window = adapters[-1].window_s                  # the adapters' default
    stage0s = stage0_executors(torch, tmain, state, SLOTS)
    transport = float32_hops()
    registry = registry_mod.PlacementRegistry()
    for a in adapters:
        transport.add_peer(a.peer_id, a)
        registry.register(client_mod.make_server_record(a.peer_id, a.spec, model=MODEL,
                                                        engine="batched"))
    clients = [client_mod.PipelineClient(cfg, local.plan, ex, transport, registry,
                                         seed=args.seed, model=MODEL) for ex in stage0s]
    jobs = [(c, ids, sp) for c, (ids, sp) in zip(clients, requests)]
    summary = {"model": MODEL, "quant": "int8", "slots": SLOTS,
               "max_session_len": MAX_SESSION_LEN, "warmup_s": warm_s,
               "window_ms": 1e3 * window,
               "stage1_window_ms_at_8": 1e3 * SLOTS * STAGE0_STEP_S,
               "tcp_later_window_ms_at_8": 1e3 * max(window, SLOTS * TCP_HOP_S), "card": smi}

    batched_counts(kernels, adapters, stage0s)
    observe_fills(adapters)
    round_windows(adapters, len(jobs), window)
    before = {a.peer_id: a.inner.decode_steps for a in adapters}
    box = {}
    syncs = count_syncs(torch, lambda: box.setdefault("run", run_clients(jobs)))
    results, wall = box["run"]
    torch.cuda.synchronize()
    summary["in_process"] = {
        **batched_run_view(results, wall, reqs),
        **batched_gates("batched in process", kernels, cfg, adapters, stage0s, results,
                        reqs, before),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
        "reserved_memory_gb": torch.cuda.memory_reserved() / 1e9}
    last_rounds = summary["in_process"]["rounds"][adapters[-1].peer_id]
    summary["in_process"]["host_syncs"] = syncs
    summary["in_process"]["host_syncs_per_round"] = (syncs - len(results)) / last_rounds
    log(f"batched in process: {syncs} host syncs for {len(results)} prefills and "
        f"{last_rounds} rounds of the last stage")
    if syncs > len(results) + last_rounds:
        raise AssertionError(f"batched: {syncs} host syncs, want <= one a prefill and "
                             "one a round")
    hold_requests(torch, cfg, state["ref_params"], refs, results, "batched in process")
    v = summary["in_process"]
    log(f"batched in process: {v['tokens']} tokens in {wall:.2f}s, "
        f"{v['aggregate_tokens_per_s']:.1f} tokens/s, {v['per_session_ms_per_token']:.2f} "
        f"ms/token a session; peak / held / reserved GB {v['peak_memory_gb']:.2f} / "
        f"{v['held_memory_gb']:.2f} / {v['reserved_memory_gb']:.2f}")

    scan = {}
    for fill in (1, 2, 4, 8):
        round_windows(adapters, fill, window)
        before = {a.peer_id: a.inner.decode_steps for a in adapters}
        got, wall_f = run_clients(jobs[:fill])
        scan[fill] = {**batched_run_view(got, wall_f, reqs[:fill]),
                      "stage1_window_ms": 1e3 * adapters[0].window_s,
                      "rounds": {a.peer_id: a.inner.decode_steps - before[a.peer_id]
                                 for a in adapters}}
        for r, want in zip(got, results):
            if r.tokens != want.tokens:
                raise AssertionError(f"batched fill {fill}: tokens differ from the fill-8 "
                                     f"run's:\n  {r.tokens}\n  {want.tokens}")
        log(f"batched fill {fill}: {scan[fill]['per_session_ms_per_token']:.2f} ms a round "
            f"(client decode ms/token), {scan[fill]['aggregate_tokens_per_s']:.1f} tokens/s "
            f"in all, rounds {scan[fill]['rounds']}")
    summary["fill_scan"] = scan

    t0 = time.monotonic()
    session = [local.generate(ids, MAX_NEW_TOKENS, sampling=sp) for ids, sp in requests]
    summary["session_engine_one_after_another"] = batched_run_view(
        session, time.monotonic() - t0, reqs)
    log(f"session engine, the 8 requests one after another: "
        f"{summary['session_engine_one_after_another']['aggregate_tokens_per_s']:.1f} "
        f"tokens/s, {summary['session_engine_one_after_another']['per_session_ms_per_token']:.2f}"
        " ms/token")
    summary["capture"] = batched_capture_check(torch, adapters)

    registry_srv = net.RegistryServer()
    registry_srv.start()
    servers, transports = [], []
    try:
        for a in adapters:
            srv = net.TcpStageServer(a, None, wire_dtype="f32", model=MODEL)
            srv.start()
            servers.append(srv)
            rec = client_mod.make_server_record(a.peer_id, a.spec, model=MODEL,
                                                engine="batched")
            rec.address = srv.address
            registry_srv.registry.register(rec)
        tcp_jobs = []
        for ex, (ids, sp) in zip(stage0s, requests):
            remote = net.RemoteRegistry(registry_srv.address)
            tx = net.TcpTransport(remote, wire_dtype="f32", model=MODEL)
            transports.append(tx)
            tcp_jobs.append((client_mod.PipelineClient(cfg, local.plan, ex, tx, remote,
                                                       seed=args.seed, model=MODEL), ids, sp))
        batched_counts(kernels, adapters, stage0s)
        observe_fills(adapters)
        round_windows(adapters, len(tcp_jobs), window, tcp=True)
        before = {a.peer_id: a.inner.decode_steps for a in adapters}
        got, wall = run_clients(tcp_jobs)
        torch.cuda.synchronize()
        summary["tcp"] = {**batched_run_view(got, wall, reqs),
                          **batched_gates("batched tcp", kernels, cfg, adapters, stage0s,
                                          got, reqs, before)}
        for r, want in zip(got, results):
            if r.tokens != want.tokens:
                raise AssertionError(f"batched tcp: tokens differ from the in-process "
                                     f"batched run's:\n  {r.tokens}\n  {want.tokens}")
        log(f"batched tcp: tokens of all {len(got)} sessions equal the in-process run's; "
            f"{summary['tcp']['aggregate_tokens_per_s']:.1f} tokens/s, "
            f"{summary['tcp']['per_session_ms_per_token']:.2f} ms/token a session")
    finally:
        for tx in transports:
            tx.close()
        for srv in servers:
            srv.stop()
        registry_srv.stop()
    summary["rounds_alone"] = round_phase(torch, adapters, smi)
    return summary, results, refs


class Tokens:
    """A run's tokens where `hold_requests` wants a GenerationResult."""

    def __init__(self, tokens):
        self.tokens = tokens


def full_span_adapter(torch, state, peer_id: str, params=None):
    """The full-span batched engine `--mode serve --stage 0 --batched`
    builds (every layer, the embedding and the head; bfloat16 slot caches
    of SLOTS x MAX_SESSION_LEN rows) on the int8 path's quantized weights,
    behind an adapter with the default round window. `params`: another
    engine's fused tree, shared (a second peer holds no second copy)."""
    from importlib import import_module

    batching = import_module(PORT + ".runtime.batching")
    partition = import_module(PORT + ".models.partition")
    cfg = state["cfg"]
    spec = partition.StagePlan.even(cfg.num_layers, 1).stages[0]
    engine = batching.BatchedStageExecutor(
        cfg, spec, state["ref_params"] if params is None else params, device="cuda",
        slots=SLOTS, max_len=MAX_SESSION_LEN, dtype=torch.bfloat16)
    return batching.BatchingStageAdapter(engine, peer_id=peer_id)


def _burst_done(gen) -> bool:
    """The host's stop rules (the byte tokenizer has no eos)."""
    return len(gen) >= MAX_NEW_TOKENS or (len(gen) >= 5 and len(set(gen[-5:])) == 1)


def burst_engine_runs(torch, eng, requests, seed: int):
    """The 8 requests on one full-span engine three ways, each after its
    own prefills (each session's first token as the adapter samples it):
    per step (`decode_batch` + `sample_round`, the host's stop rules),
    through `decode_burst` (BURST_TICKS a burst, the per-burst spec the
    wire ships), and through `burst_stream`. Yields (what, tokens by
    request, the callable that ran the decode), the decode run inside the
    caller's counts."""
    from importlib import import_module

    executor_mod = import_module(PORT + ".runtime.executor")
    messages = import_module(PORT + ".runtime.messages")

    def request(sid, sp, gen):
        return messages.StageRequest(session_id=sid, hidden=None, seq_len=1, cur_len=0,
                                     is_prefill=False, max_length=MAX_SESSION_LEN,
                                     sampling=sp, generated_tokens=tuple(gen[-50:]),
                                     step_seed=seed + len(gen))

    def prefill():
        gen, sps = {}, {}
        for i, (ids, sp) in enumerate(requests):
            sid = f"burst{i}"
            h = eng.prefill(sid, torch.tensor([ids]))
            gen[sid] = executor_mod._sample_rows(eng.logits(h[:, -1:]), 1,
                                                 request(sid, sp, []), eng.sampler)
            sps[sid] = sp
        return gen, sps

    def entry(gen, sp):
        return {"token": gen[-1], "seed": seed + len(gen),
                "budget": MAX_NEW_TOKENS - len(gen), "eos": None,
                "generated": tuple(gen[-50:]), "temperature": sp.temperature,
                "top_p": sp.top_p, "top_k": sp.top_k,
                "repetition_penalty": sp.repetition_penalty}

    def per_step(gen, sps):
        while True:
            live = [sid for sid in gen if not _burst_done(gen[sid])]
            if not live:
                return
            eng.decode_batch({sid: torch.tensor([[gen[sid][-1]]]) for sid in live})
            toks = eng.sample_round({sid: request(sid, sps[sid], gen[sid]) for sid in live})
            for sid in live:
                gen[sid].append(toks[sid])

    def bursts(gen, sps):
        live = set(gen)
        while live:
            entries = {sid: entry(gen[sid], sps[sid]) for sid in sorted(live)
                       if not _burst_done(gen[sid])}
            live = set(entries)
            if not entries:
                return
            for sid, r in eng.decode_burst(entries, BURST_TICKS).items():
                gen[sid].extend(r["tokens"])
                if r["stop"] is not None:
                    live.discard(sid)

    def stream(gen, sps):
        entries = {sid: entry(g, sps[sid]) for sid, g in gen.items()}
        for block in eng.burst_stream(entries, BURST_TICKS):
            for sid, r in block.items():
                gen[sid].extend(r["tokens"])

    for what, run in (("per_step", per_step), ("decode_burst", bursts),
                      ("burst_stream", stream)):
        gen, sps = prefill()
        yield what, gen, (lambda run=run, gen=gen, sps=sps: run(gen, sps))
        for sid in gen:
            eng.end_session(sid)


def burst_scan(torch, eng, smi: str) -> dict:
    """Device ms of one burst replay (CUDA events, the stream kept busy)
    at fills 1/2/4/8 with BURST_TICKS ticks, and a tick's at fill 8 with
    N = BURST_TICK_SCAN ticks (each N's graph captured at its first call:
    its capture seconds and the reserved memory after it), and the top
    kernels of a burst at fill 8 under torch.profiler; SLOTS sessions of a
    32-token prompt in the slots, every slot's budget N."""
    from importlib import import_module

    batching = import_module(PORT + ".runtime.batching")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    for sid in list(eng._slot_of):     # a session the stopped peer never ended
        eng.end_session(sid)
    sids = [f"scan{i}" for i in range(SLOTS)]
    for sid in sids:
        eng.prefill(sid, torch.randint(0, eng.cfg.vocab_size, (1, 32), generator=gen))

    def carry(fill, n):
        entries = {sid: {"token": 7, "seed": i, "budget": n, "eos": None, "generated": (7,),
                         "temperature": 0.7 if i % 2 else 0.0, "top_p": 0.9, "top_k": 50,
                         "repetition_penalty": 1.5}
                   for i, sid in enumerate(sids[:fill])}
        return torch.tensor(eng._burst_prep(entries, n)[1], device="cuda")

    def replay(n, c):
        return lambda: eng.graphs.run_carry(("burst", n), lambda x: eng._burst_step(x, n), c,
                                            (SLOTS, batching.BURST_COLS))

    out = {"card": smi, "fill_device_ms": {}, "tick_device_ms": {}, "capture_s": {},
           "reserved_gb_after_capture": {}}
    for fill in (1, 2, 4, 8):
        out["fill_device_ms"][fill] = cuda_ms(replay(BURST_TICKS, carry(fill, BURST_TICKS)),
                                              torch, reps=5, spin=True)
    for n in BURST_TICK_SCAN:
        c = carry(SLOTS, n)
        if n != BURST_TICKS:
            t0 = time.monotonic()
            replay(n, c)()
            torch.cuda.synchronize()
            out["capture_s"][n] = time.monotonic() - t0
            out["reserved_gb_after_capture"][n] = torch.cuda.memory_reserved() / 1e9
        out["tick_device_ms"][n] = cuda_ms(replay(n, c), torch, reps=5, spin=True) / n
    # Where a burst's device time goes, by kernel (ms and launches a burst).
    out["top_kernels"] = replay_kernels(torch, replay(BURST_TICKS, carry(SLOTS, BURST_TICKS)),
                                        reps=2)
    for sid in sids:
        eng.end_session(sid)
    log(f"burst scan: device ms a burst of {BURST_TICKS} at fills 1/2/4/8 "
        f"{[round(out['fill_device_ms'][f], 2) for f in (1, 2, 4, 8)]}; a tick at N = "
        f"{list(BURST_TICK_SCAN)}: {[round(out['tick_device_ms'][n], 3) for n in BURST_TICK_SCAN]}"
        f"; captures {out['capture_s']} s, reserved GB {out['reserved_gb_after_capture']}; "
        f"top kernels a burst " + ", ".join(f"{k['name'][:40]} {k['ms']:.2f} ms x "
                                            f"{k['launches']:.0f}" for k in out["top_kernels"]))
    return out


def burst_view(results, wall: float) -> dict:
    """A burst run's numbers: tokens/s over the wall from the release to
    the last end, each session's decode ms/token (its bursts' wall over the
    tokens they brought) and ms a burst, TTFT."""
    ms_token = [1e3 * sum(r.decode_times_s) / max(len(r.tokens) - 1, 1) for r in results]
    return {"sessions": len(results), "tokens": sum(len(r.tokens) for r in results),
            "wall_s": wall,
            "aggregate_tokens_per_s": sum(len(r.tokens) for r in results) / wall,
            "per_session_ms_per_token": statistics.median(ms_token),
            "ms_per_burst": 1e3 * statistics.median(
                [t for r in results for t in r.decode_times_s]),
            "bursts_per_session": [len(r.decode_times_s) for r in results],
            "ttft_ms": [r.ttft_s * 1e3 for r in results]}


def burst_path(torch, kernels, tmain, sampling_cls, state, refs, batched, smi: str):
    """Step 10b: burst decode on one full-span engine (the int8 path's
    weights, all 32 layers, bf16, SLOTS slots of MAX_SESSION_LEN rows,
    BURST_TICKS ticks a burst), warmed up as `--mode serve --stage 0
    --batched --burst 8` warms it. The batched path's 8 requests per step,
    through `decode_burst` and through `burst_stream` on that engine: the
    bursts' tokens equal the per-step tokens and are held to the
    float32-cache references; one host sync, one replay and no capture a
    burst; int8_dot launches 4 x layers x N a burst, by route; sample_draw
    one a slot row a tick. Then 8 client threads with burst = 8 through the
    adapter over LocalTransport (no burst_fallback event, a dispatch a
    round, the engine's tokens), the same over in-process TCP with a
    second full-span peer, the pinned one stopped after its first burst
    of one more request (the fault-free tokens), and the device scan.
    Returns (summary, the in-process client results for the CLI drive)."""
    from importlib import import_module

    client_mod = import_module(PORT + ".runtime.client")
    registry_mod = import_module(PORT + ".scheduling.registry")
    transport_mod = import_module(PORT + ".runtime.transport")
    net = import_module(PORT + ".runtime.net")
    events = import_module(PORT + ".telemetry.events")
    args, cfg, local = state["args"], state["cfg"], state["client"]
    requests = batched_requests(tmain.load_tokenizer(), sampling_cls, cfg)
    reqs = [(None, sp) for _, sp in requests]
    ik, dk = kernels["int8_dot"], kernels["sample_draw"]
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    adapter = full_span_adapter(torch, state, "burst-full")
    eng = adapter.inner
    t0 = time.monotonic()
    adapter.warmup()
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    reserved_before = torch.cuda.memory_reserved() / 1e9
    t0 = time.monotonic()
    adapter.warmup(burst=BURST_TICKS)
    torch.cuda.synchronize()
    warm_burst_s = time.monotonic() - t0
    reserved_after = torch.cuda.memory_reserved() / 1e9
    head_f32_gb = cfg.vocab_size * cfg.hidden_size * 4 / 1e9
    summary = {"model": MODEL, "quant": "int8", "layers": layers, "slots": SLOTS,
               "max_session_len": MAX_SESSION_LEN, "ticks": BURST_TICKS, "card": smi,
               "warmup_s_without_burst": warm_s, "warmup_s_with_burst": warm_burst_s,
               "captures": eng.graphs.captures,
               "reserved_gb_without_burst_graph": reserved_before,
               "reserved_gb_with_burst_graph": reserved_after,
               "head_float32_copy_gb": head_f32_gb}
    log(f"burst: full-span engine, {layers} layers, {SLOTS} slots x {MAX_SESSION_LEN} rows; "
        f"warm-up {warm_s:.1f}s, then with the {BURST_TICKS}-tick burst {warm_burst_s:.1f}s; "
        f"reserved GB {reserved_before:.2f} -> {reserved_after:.2f} with the burst graph "
        f"(a float32 head copy {head_f32_gb:.2f} GB, {BURST_TICKS} made in the graph)")

    runs, engine = {}, None
    for what, gen, decode in burst_engine_runs(torch, eng, requests, args.seed):
        eng.graphs.captures = eng.graphs.replays = 0
        eng.sampler.captures = eng.sampler.replays = 0
        reset_counts(kernels, [])
        before = eng.burst_dispatches
        t0 = time.monotonic()
        syncs = count_syncs(torch, decode)
        wall = time.monotonic() - t0
        tokens = [gen[f"burst{i}"] for i in range(len(requests))]
        runs[what] = tokens
        if what == "per_step":
            continue
        bursts = eng.burst_dispatches - before
        by_route = {"mma": ik._launches_mma, "gemv": ik._launches_gemv,
                    "f32mma": ik._launches_f32mma,
                    "simt": ik._launches - ik._launches_mma - ik._launches_gemv
                    - ik._launches_f32mma}
        need = 4 * layers * BURST_TICKS * bursts
        draws_need = SLOTS * BURST_TICKS * bursts
        decoded = sum(len(t) - 1 for t in tokens)
        view = {"bursts": bursts, "host_syncs": syncs, "replays": eng.graphs.replays,
                "captures": eng.graphs.captures + eng.sampler.captures,
                "int8_dot_launches": ik._launches, "int8_dot_launches_by_route": by_route,
                "sample_draw_launches": dk._launches, "decode_wall_s": wall,
                "decode_tokens_per_s": decoded / wall,
                "ms_per_burst": 1e3 * wall / bursts}
        log(f"burst {what}: {bursts} bursts for {decoded} decoded tokens, {syncs} host syncs, "
            f"{view['replays']} replays, {view['captures']} captures; int8_dot {ik._launches} "
            f"launches (want 4 x {layers} x {BURST_TICKS} x {bursts} = {need}) by route "
            f"{by_route}; sample_draw {dk._launches} (want {draws_need}); "
            f"{view['decode_tokens_per_s']:.1f} tokens/s, {view['ms_per_burst']:.1f} ms a burst")
        if tokens != runs["per_step"]:
            for t, want in zip(tokens, runs["per_step"]):
                log(f"  {t}\n  {want}")
            raise AssertionError(f"burst {what}: tokens differ from the per-step rounds of "
                                 "the same engine")
        if syncs > bursts or view["replays"] != bursts or view["captures"]:
            raise AssertionError(f"burst {what}: {syncs} host syncs, {view['replays']} "
                                 f"replays and {view['captures']} captures for {bursts} "
                                 "bursts: want one sync and one replay a burst, no capture")
        if ik._launches != need or by_route["simt"]:
            raise AssertionError(f"burst {what}: int8_dot launches {ik._launches} by route "
                                 f"{by_route}, want {need} and no CUDA-core launch")
        if dk._launches != draws_need:
            raise AssertionError(f"burst {what}: {dk._launches} sample_draw launches, want "
                                 f"{draws_need} (one a slot row a tick)")
        summary[what] = view
        if what == "decode_burst":
            engine = view
    # The engine keeps bf16 slot caches and computes in bf16 from the
    # embedding on (rms_norm, rope and slot_attention keep x's dtype), so
    # its reference keeps a bf16 cache: the rule of the session paths'
    # float32-cache references (the cache the engine keeps), applied here.
    # Against those float32-cache references the first differences are
    # logged, not gated.
    bf16_refs = references(torch, cfg, state["ref_params"], [ids for ids, _ in requests],
                           reqs, args.seed, torch.bfloat16)
    hold_requests(torch, cfg, state["ref_params"], bf16_refs,
                  [Tokens(t) for t in runs["per_step"]], "burst engine per step")
    summary["float32_cache_reference_first_difference"] = [
        first_difference(t, ref["tokens"]) for t, ref in zip(runs["per_step"], refs)]
    log(f"burst engine: decode_burst and burst_stream tokens equal the per-step rounds' "
        f"for all {len(requests)} requests, held to the bf16-cache references; against "
        f"the float32-cache references the first differences are at steps "
        f"{summary['float32_cache_reference_first_difference']} (not gated)")
    summary["engine"] = engine
    summary["tokens_equal_per_step"] = True

    # The adapter and 8 clients in process.
    transport = transport_mod.LocalTransport()
    registry = registry_mod.PlacementRegistry()
    transport.add_peer(adapter.peer_id, adapter)
    registry.register(client_mod.make_server_record(adapter.peer_id, eng.spec, model=MODEL,
                                                    engine="batched"))
    clients = [client_mod.PipelineClient(cfg, local.plan, local.stage0, transport, registry,
                                         seed=args.seed, model=MODEL)
               for _ in range(len(requests))]
    jobs = [(c, ids, sp) for c, (ids, sp) in zip(clients, requests)]
    adapter._m_fill = Observed()
    eng.graphs.captures = eng.sampler.captures = 0
    reset_counts(kernels, [])
    before = eng.burst_dispatches
    recorder = events.get_recorder()
    recorder.enable()
    recorder.clear()
    try:
        box = {}
        syncs = count_syncs(torch, lambda: box.setdefault("run", run_clients(
            jobs, burst=BURST_TICKS)))
        fallbacks = [e for e in recorder.events() if e.name == "burst_fallback"]
    finally:
        recorder.disable()
        recorder.clear()
    results, wall = box["run"]
    rounds = len(adapter._m_fill.values)
    dispatches = eng.burst_dispatches - before
    sampled = sum(1 for _, sp in requests if not sp.greedy)
    need = 4 * layers * (len(requests) + BURST_TICKS * rounds)
    draws_need = SLOTS * BURST_TICKS * rounds + sampled
    captures = eng.graphs.captures + eng.sampler.captures
    summary["in_process"] = {**burst_view(results, wall), "rounds": rounds,
                             "fills": adapter._m_fill.values, "burst_dispatches": dispatches,
                             "host_syncs": syncs, "burst_fallback_events": len(fallbacks),
                             "captures_after_warmup": captures,
                             "int8_dot_launches": ik._launches,
                             "sample_draw_launches": dk._launches,
                             "batched_path_in_process": {
                                 k: batched["in_process"][k] for k in (
                                     "aggregate_tokens_per_s", "per_session_ms_per_token")},
                             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
                             "reserved_memory_gb": torch.cuda.memory_reserved() / 1e9}
    v = summary["in_process"]
    log(f"burst in process: {v['tokens']} tokens in {wall:.2f}s, "
        f"{v['aggregate_tokens_per_s']:.1f} tokens/s, {v['per_session_ms_per_token']:.2f} "
        f"ms/token a session, {v['ms_per_burst']:.1f} ms a burst (the batched path: "
        f"{batched['in_process']['aggregate_tokens_per_s']:.1f} tokens/s, "
        f"{batched['in_process']['per_session_ms_per_token']:.2f} ms/token); {rounds} rounds "
        f"(fills {v['fills']}), {dispatches} dispatches, {syncs} host syncs, {captures} "
        f"captures, {len(fallbacks)} burst_fallback events; int8_dot {ik._launches} (want "
        f"{need}), sample_draw {dk._launches} (want {draws_need}); peak / held / reserved GB "
        f"{v['peak_memory_gb']:.2f} / {v['held_memory_gb']:.2f} / {v['reserved_memory_gb']:.2f}")
    if fallbacks or dispatches != rounds or dispatches == 0:
        raise AssertionError(f"burst in process: {len(fallbacks)} burst_fallback events, "
                             f"{dispatches} dispatches for {rounds} rounds")
    if [r.tokens for r in results] != runs["per_step"]:
        raise AssertionError("burst in process: client tokens differ from the engine's")
    if syncs > len(requests) + rounds or captures:
        raise AssertionError(f"burst in process: {syncs} host syncs, {captures} captures: "
                             "want <= one a prefill and one a round, none")
    if ik._launches != need or dk._launches != draws_need:
        raise AssertionError(f"burst in process: int8_dot {ik._launches} (want {need}), "
                             f"sample_draw {dk._launches} (want {draws_need})")

    # Over in-process TCP, with a second full-span peer for the failover.
    second = full_span_adapter(torch, state, "burst-full-2", params=eng.params)
    second.warmup(burst=BURST_TICKS)
    registry_srv = net.RegistryServer()
    registry_srv.start()
    servers, transports = {}, []
    try:
        for a in (adapter, second):
            srv = net.TcpStageServer(a, None, wire_dtype="f32", model=MODEL)
            srv.start()
            servers[a.peer_id] = srv
            rec = client_mod.make_server_record(a.peer_id, a.spec, model=MODEL,
                                                engine="batched")
            rec.address = srv.address
            registry_srv.registry.register(rec)

        def tcp_client():
            remote = net.RemoteRegistry(registry_srv.address)
            tx = net.TcpTransport(remote, wire_dtype="f32", model=MODEL)
            transports.append(tx)
            return client_mod.PipelineClient(cfg, local.plan, local.stage0, tx, remote,
                                             seed=args.seed, model=MODEL)

        tcp_jobs = [(tcp_client(), ids, sp) for ids, sp in requests]
        # Over TCP a round's arrivals spread with the handler threads' and
        # clients' Python work on one interpreter: the window the batched
        # TCP drive gives stages 2-3, TCP_HOP_S a session.
        for a in (adapter, second):
            a._m_fill = Observed()
            a.window_s = max(a.window_s, len(tcp_jobs) * TCP_HOP_S)
        got, wall = run_clients(tcp_jobs, burst=BURST_TICKS)
        if [r.tokens for r in got] != runs["per_step"]:
            raise AssertionError("burst tcp: tokens differ from the in-process run's")
        summary["tcp"] = {**burst_view(got, wall), "window_ms": 1e3 * adapter.window_s,
                          "fills": {a.peer_id: a._m_fill.values for a in (adapter, second)}}
        log(f"burst tcp: tokens of all {len(got)} sessions equal the in-process run's; "
            f"{summary['tcp']['aggregate_tokens_per_s']:.1f} tokens/s, "
            f"{summary['tcp']['per_session_ms_per_token']:.2f} ms/token a session, "
            f"{summary['tcp']['ms_per_burst']:.1f} ms a burst, round fills at a "
            f"{summary['tcp']['window_ms']:.0f} ms window {summary['tcp']['fills']}")

        client = tcp_client()
        pinned = client._discover_burst_peer()
        spare = next(p for p in servers if p != pinned)
        call = client.transport.call
        seen = {"bursts": 0}

        def stop_after_first_burst(peer_id, req, timeout=None):
            resp = call(peer_id, req, timeout)
            if peer_id == pinned and req.burst_len:
                seen["bursts"] += 1
                if seen["bursts"] == 1:
                    servers[pinned].stop()
            return resp

        client.transport.call = stop_after_first_burst
        spare_adapter = adapter if spare == adapter.peer_id else second
        served0 = spare_adapter.requests_served
        fo = client.generate(requests[0][0], MAX_NEW_TOKENS, sampling=requests[0][1],
                             burst=BURST_TICKS)
        if client.recoveries < 1 or spare_adapter.requests_served <= served0:
            raise AssertionError("burst failover did not recover onto the other peer")
        if fo.tokens != runs["per_step"][0]:
            raise AssertionError(f"burst failover tokens differ:\n  {fo.tokens}\n  "
                                 f"{runs['per_step'][0]}")
        summary["failover"] = {
            "stopped": pinned, "replacement": spare, "recoveries": client.recoveries,
            "replacement_requests": spare_adapter.requests_served - served0,
            "equal_to_fault_free": True,
            "recovery_step_ms": 1e3 * max(fo.decode_times_s),
            "median_step_ms": 1e3 * statistics.median(fo.decode_times_s)}
        log(f"burst failover: {pinned} stopped after its first burst; recovered onto {spare} "
            f"({summary['failover']['replacement_requests']} requests: the replay and the "
            f"bursts), tokens equal the fault-free run's; recovery step "
            f"{summary['failover']['recovery_step_ms']:.1f} ms, median burst "
            f"{summary['failover']['median_step_ms']:.1f} ms")
    finally:
        for tx in transports:
            tx.close()
        for srv in servers.values():
            srv.stop()
        registry_srv.stop()
    summary["scan"] = burst_scan(torch, eng, smi)
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return summary, results


def oracle_logits(torch, cfg, params, ids, cache_dtype=None):
    """The float32-cache (or `cache_dtype`-cache) reference's next-token
    logits after `ids` (one prefill)."""
    from importlib import import_module

    tf = import_module(PORT + ".models.transformer")
    dev = params["embed"]["wte"].device
    kc, vc = tf.init_kv_cache(cfg, cfg.num_layers, 1, len(ids),
                              dtype=cache_dtype or torch.float32, device=dev)
    logits, _, _ = tf.full_forward(cfg, params, torch.tensor([ids], device=dev), kc, vc, 0)
    if not (torch.isfinite(logits).all() and tuple(logits.shape) == (1, len(ids), cfg.vocab_size)):
        raise AssertionError("reference logits are not finite or have the wrong shape")
    return logits[0, -1]


def layer_sum(rows):
    """The four sites' rows of one M summed: one layer (and the old
    CUDA-core kernel's ms where every row has it)."""
    old = ({"simt_ms": sum(r["simt_ms"] for r in rows)}
           if rows and all("simt_ms" in r for r in rows) else {})
    return {"ms": sum(r["ms"] for r in rows), **old,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def decode_layer(rows):
    """The four sites' `decode` rows of one dtype summed: one layer at M = 1."""
    keys = ("gemv_ms", "simt_ms", "plain_ms", "library_ms", "bound_ms")
    return {key: sum(r[key] for r in rows) for key in keys}


def kernel_entry(name: str, rows, summary, prefill_m: int, decode, batch, batched, tcp,
                 burst):
    """One kernel of the ``kernels`` line: one decode layer's four sites at
    M = 1 summed, and one prefill layer (M = prefill_m, the prompt padded to
    its sequence bucket, as the executors run it) under ``prefill``; the
    decode layer with float32 x (the stages behind TCP) under
    ``decode_float32``, from the `decode` rows; the path's launches, and
    under ``launches_by_route`` each route's share; the same path over
    in-process TCP (`tcp`, its summary) under ``launches_tcp_by_route``
    (stages 1-3's float32 prefill: both on "f32mma"); the batched regime
    (M = SLOTS) and the float32 prefill (M = prefill_m) under
    ``batched_<dtype>`` and ``prefill_float32`` with their route (float32
    with the old CUDA-core kernel's ms beside it where the phase timed
    it); the burst path's bursts (`burst`, the engine drive's summary)
    under ``launches_burst_path`` and ``launches_burst_path_by_route``."""
    decode_rows = [r for r in rows if r["M"] == 1]
    launches = summary[f"{name}_launches"]
    by_route = {"mma": summary[f"{name}_launches_mma"]}
    for route in ("gemv", "f32mma"):
        if f"{name}_launches_{route}" in summary:
            by_route[route] = summary[f"{name}_launches_{route}"]
    by_route["simt"] = launches - sum(by_route.values())
    entry = {"name": name, "route": "cuda",
             "source": f"{PORT}/csrc/{name}.cu",
             "replaces": "global_capstone_design_distributed_inference_of_llms_over_"
                         "the_internet_tpu/" + REPLACES[name],
             "launches": launches, "launches_by_route": by_route,
             "launches_tcp": tcp[f"{name}_launches"],
             "launches_tcp_by_route": tcp[f"{name}_launches_by_route"],
             "at": "one decode layer: wqkv+wo+wgu+wd at M=1, bf16, L2 cold",
             "decode_route": "+".join(sorted({r["route"] for r in decode_rows})),
             **layer_sum(decode_rows), "library": LIBRARY_NOTE}
    pre = [r for r in rows if r["M"] == prefill_m]
    entry["prefill"] = {
        "at": f"one prefill layer: wqkv+wo+wgu+wd at M={prefill_m}, bf16, L2 cold",
        "route": "+".join(sorted({r["route"] for r in pre})), **layer_sum(pre)}
    entry["decode_float32"] = {
        "at": "one decode layer: wqkv+wo+wgu+wd at M=1, float32 x, L2 cold",
        **decode_layer([r for r in decode if r["dtype"] == "float32"])}
    # The batched regime: every slot of a round, M = SLOTS; and the float32
    # prefill of the stages behind TCP.
    for key, dtype, m, what in (("batched_float32", "float32", SLOTS, "one batched round's"),
                                ("batched_bfloat16", "bfloat16", SLOTS, "one batched round's"),
                                ("prefill_float32", "float32", prefill_m, "one prefill")):
        rows_b = [r for r in batch if r["dtype"] == dtype and r["M"] == m]
        entry[key] = {
            "at": f"{what} layer: wqkv+wo+wgu+wd at M={m}, {dtype} x, L2 cold",
            "route": "+".join(sorted({r["route"] for r in rows_b})), **layer_sum(rows_b)}
    if batched is not None:
        # The batched path's own run (counts set to 0 just before it).
        entry["launches_batched_path"] = batched["int8_dot_launches"]
        entry["launches_batched_path_by_route"] = batched["int8_dot_launches_by_route"]
    if burst is not None:
        entry["launches_burst_path"] = burst["int8_dot_launches"]
        entry["launches_burst_path_by_route"] = burst["int8_dot_launches_by_route"]
    return entry


def draw_entry(draw, launches: int, launches_batched: int, launches_burst: int):
    """sample_draw in the ``kernels`` line: one draw of one row at the 128k
    vocabulary, as the final stage runs it for each sampled token (B = 4
    under ``batch4``). ``max_abs_err`` is the measured max |noise - plain
    noise| of the timed row's own inputs (its tokens are compared too)."""
    row = next(r for r in draw["times"] if r["B"] == 1)
    return {"name": "sample_draw", "route": "cuda",
            "source": f"{PORT}/csrc/sample_draw.cu",
            "replaces": "global_capstone_design_distributed_inference_of_llms_over_the_"
                        "internet_tpu/" + REPLACES["sample_draw"],
            "launches": launches, "launches_batched_path": launches_batched,
            "launches_burst_path": launches_burst,
            "at": "one draw, B=1, V=128256, float32 logp in L2",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "multinomial_ms": row["multinomial_ms"], "library": DRAW_LIBRARY_NOTE,
            "batch4": next(r for r in draw["times"] if r["B"] == 4)}


def main(argv) -> int:
    import torch

    kernels_only = "--kernels-only" in argv
    if set(argv) - {"--kernels-only"}:
        print(f"usage: chip_smoke.py [--kernels-only], got {argv}",  # noqa: T201
              file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)  # noqa: T201
        return 2
    try:
        from importlib import import_module

        ik = import_module(PORT + ".ops.int8_kernel")
        nk = import_module(PORT + ".ops.nf4_kernel")
        dk = import_module(PORT + ".ops.draw_kernel")
        tf3 = import_module(PORT + ".ops.threefry")
        tmain = import_module(PORT + ".main")
        sampling_cls = import_module(PORT + ".ops.sampling").SamplingParams
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repo ({exc})",  # noqa: T201
              file=sys.stderr)
        return 2
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The NF4 path keeps per-layer NF4 leaves packed for nf4_dot.
    os.environ["NF4_KERNEL"] = "1"
    smi = card()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
        f"{torch.cuda.device_count()} visible")
    bw, flops = peaks_for(name)

    build_s = build_kernels([PORT + ".ops.int8_kernel", PORT + ".ops.nf4_kernel",
                             PORT + ".ops.draw_kernel"])
    log(f"build: {build_s:.1f}s")
    for src, text in import_module(PORT + ".utils.cuda_build").build_logs.items():
        for kernel, line in ptxas_usage(text):
            log(f"  {src} {kernel}: {line}")

    kernel_mods = {"int8_dot": ik, "nf4_dot": nk, "sample_draw": dk}
    prompt_len = len(PROMPTS[0].encode())
    # The executors pad a prompt to its sequence bucket: the M its prefill
    # projections run at.
    prefill_m = import_module(PORT + ".runtime.kv_cache").round_to_bucket(
        prompt_len, import_module(PORT + ".runtime.executor").SEQ_BUCKETS)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    f32_flops = flops / F32_TERMS
    (int8_rows, int8_scan, int8_decode, int8_plans, int8_batch, int8_f32mma,
     int8_f32_scan) = int8_phase(torch, ik, "cuda", prompt_len, prefill_m, bw, flops, flush,
                                 f32_flops)
    per_layer = {f"M={m}": {route: sum(p[f"M{m}_{route}_ms"] for p in int8_f32mma)
                            for route in ("f32mma", "gemv")} for m in (1, 2)}
    for m in F32_TIMED_M:
        rows_m = [r for p in int8_f32mma for r in p["times"] if r["M"] == m]
        per_layer[f"M={m}"] = {key: sum(r[key] for r in rows_m)
                               for key in ("ms", "simt_ms", "library_ms", "bound_ms")}
    log(json.dumps({"int8_dot_f32mma": int8_f32mma, "int8_dot_f32mma_per_layer": per_layer,
                    "int8_dot_f32mma_crossover": int8_f32_scan, "card": smi}))
    nf4_rows, nf4_scan, nf4_decode, nf4_plans, nf4_batch, nf4_f32mma, nf4_f32_scan = nf4_phase(
        torch, nk, "cuda", prompt_len, prefill_m, bw, flops, flush, f32_flops)
    log(json.dumps({"nf4_dot_f32mma": nf4_f32mma, "nf4_dot_f32mma_crossover": nf4_f32_scan,
                    "card": smi}))
    for kname, batch in (("int8_dot", int8_batch), ("nf4_dot", nf4_batch)):
        log(json.dumps({f"{kname}_batched": batch, f"{kname}_batched_per_layer": {
            f"{dtype} M={m}": layer_sum([r for r in batch
                                         if r["dtype"] == dtype and r["M"] == m])
            for dtype, m in (("float32", SLOTS), ("bfloat16", SLOTS),
                             ("float32", prefill_m))}, "card": smi}))
    for kname, rows, scan in (("int8_dot", int8_rows, int8_scan),
                              ("nf4_dot", nf4_rows, nf4_scan)):
        log(json.dumps({f"{kname}_shapes": rows, "card": smi}))
        log(json.dumps({f"{kname}_crossover": scan, "card": smi}))
        log(json.dumps({f"{kname}_per_layer": {
            m: layer_sum([r for r in rows if r["M"] == m])
            for m in sorted({r["M"] for r in rows})}, "card": smi}))
    for kname, dec, plans in (("int8_dot", int8_decode, int8_plans),
                              ("nf4_dot", nf4_decode, nf4_plans)):
        log(json.dumps({f"{kname}_decode": dec, f"{kname}_decode_per_layer": {
            dtype: decode_layer([r for r in dec if r["dtype"] == dtype])
            for dtype in ("bfloat16", "float32")}, "card": smi}))
        log(json.dumps({f"{kname}_gemv_plans": plans, "card": smi}))
    # The decode kernels' instructions (bf16 and float32 x at M = 1): the
    # whole function, its loop over a scale block or a stage most of it;
    # int8_dot's old CUDA-core kernel beside its new one.
    dtypes = (("bfloat16", "13__nv_bfloat16"), ("float32", "f"))
    log(json.dumps({"nf4_gemv_sass": {
        dtype: sass_counts("nf4_dot", f"nf4_gemv_kernelI{mangled}Li1E")
        for dtype, mangled in dtypes}}))
    # int8_dot's float32 route at each M tile beside the old kernel it
    # replaced; no int-to-float instruction anywhere in it.
    int8_sass = {f"{kernel} {dtype}": sass_counts("int8_dot", f"{kernel}I{mangled}Li1E")
                 for kernel in ("int8_gemv_kernel", "int8_dot_kernel")
                 for dtype, mangled in dtypes}
    int8_sass["int8_dot_kernel float32 M=8"] = sass_counts("int8_dot",
                                                           "int8_dot_kernelIfLi8E")
    f32mma_sass = {f"int8_f32mma_kernel<{frags}>": sass_counts("int8_dot",
                                                               f"int8_f32mma_kernelILi{frags}E")
                   for frags in (1, ik.F32MMA_MAX_FRAGS)}
    int8_sass.update(f32mma_sass)
    log(json.dumps({"int8_gemv_sass": int8_sass}))
    for kernel, counts in f32mma_sass.items():
        if counts and counts.get("I2F", 0):
            raise AssertionError(f"{kernel}: {counts['I2F']} I2F in its SASS")
    # Both float32 routes at each M tile (8 and 16 rows of x): on the tensor
    # cores (HMMA; no cuobjdump, or no function of that name in the library,
    # fails it), with no local memory (a spill would show as STL / LDL, and
    # in ptxas's spill lines).
    nf4_sass = {f"nf4_f32mma_kernel<{frags}>": sass_counts("nf4_dot",
                                                           f"nf4_f32mma_kernelILi{frags}E")
                for frags in (1, nk.F32MMA_MAX_FRAGS)}
    spills = [line for src, text in import_module(PORT + ".utils.cuda_build")
              .build_logs.items() for kernel, line in ptxas_usage(text)
              if kernel.startswith(("nf4_f32mma_kernel", "int8_f32mma_kernel"))
              and "spill" in line
              and not re.fullmatch(r"0 bytes stack frame, 0 bytes spill stores, "
                                   r"0 bytes spill loads", line)]
    log(json.dumps({"nf4_f32mma_sass": nf4_sass, "f32mma_spills": spills}))
    for kernel, counts in {**f32mma_sass, **nf4_sass}.items():
        if not counts or not counts.get("HMMA"):
            raise AssertionError(f"{kernel}: no SASS read or no HMMA (cuobjdump missing, or "
                                 "no such function in the library)")
        if counts.get("STL") or counts.get("LDL") or spills:
            raise AssertionError(f"{kernel}: local memory in its SASS ({counts.get('STL', 0)} "
                                 f"STL, {counts.get('LDL', 0)} LDL) or spills {spills}")
    del flush
    draw = draw_phase(torch, dk, tf3, bw)
    log(json.dumps({"sample_draw": draw, "card": smi}))
    if kernels_only:
        log(f"total {time.monotonic() - t_start:.1f}s")
        log("kernels-only: not a smoke pass")
        return 0
    sampler = sampler_phase(torch, 128256)
    log(json.dumps({"sampler": sampler, "card": smi}))

    int8_summary, state = serve(torch, kernel_mods, "int8_dot", tmain, sampling_cls,
                                "int8", "cuda")
    greedy = state["requests"][0][1]
    int8_summary["capture"] = capture_phase(torch, state["client"], "int8")
    int8_summary["syncs_per_request"] = sync_phase(torch, state["client"],
                                                   state["prompt_ids"], state["requests"])
    int8_summary["profile"] = profile_phase(torch, state["client"],
                                            state["prompt_ids"][0], greedy, smi)
    int8_summary["two_sessions"] = concurrent_phase(torch, state["client"],
                                                    state["prompt_ids"][0], greedy)
    log(json.dumps({"main_path": int8_summary, "card": smi}))
    # int8 at wire f32, held to the in-process chain exactly; NF4 at the
    # CLI's default wire bf16, held to the float32-cache references.
    tcp = {"int8": tcp_drive(torch, kernel_mods, "int8_dot", tmain, state, smi,
                             failover=True, wire="f32")}
    oracle = oracle_phase(torch, tmain, sampling_cls, dk, state["cfg"], state["params"],
                          state["prompt_ids"][0], smi)
    log(json.dumps({"oracle": oracle}))
    batched, batched_results, batched_refs = batched_path(torch, kernel_mods, tmain,
                                                          sampling_cls, state, smi)
    log(json.dumps({"batched_path": batched}))
    # The batched engines are gone with batched_path's frame.
    gc.collect()
    torch.cuda.empty_cache()
    burst, burst_results = burst_path(torch, kernel_mods, tmain, sampling_cls, state,
                                      batched_refs, batched, smi)
    log(json.dumps({"burst_path": burst}))
    # What the CLI drives compare with; the weights go.
    int8_state = {k: state[k] for k in ("f32_chain_results", "requests")}
    del state
    # As under --telemetry: the client's metrics go to the global registry,
    # which stays disabled until the telemetry phase.
    nf4_summary, state = serve(torch, kernel_mods, "nf4_dot", tmain, sampling_cls,
                               "nf4", "cuda", extra_argv=("--telemetry",))
    nf4_summary["capture"] = capture_phase(torch, state["client"], "nf4")
    tcp["nf4"] = tcp_drive(torch, kernel_mods, "nf4_dot", tmain, state, smi,
                           failover=False, wire="bf16")
    tele = telemetry_phase(torch, tmain, nk, state, smi)
    nf4_summary["failover"] = tele.pop("failover")
    log(json.dumps({"nf4_path": nf4_summary, "card": smi}))
    log(json.dumps({"telemetry": tele, "card": smi}))
    del state
    log(json.dumps({"tcp_path": tcp}))
    gc.collect()
    torch.cuda.empty_cache()
    tok = tmain.load_tokenizer()
    cli = cli_drive(torch, tok, [(PROMPTS[0], int8_state["f32_chain_results"][0],
                                  int8_state["requests"][0][1])], smi)
    log(json.dumps({"cli_path": cli}))
    gc.collect()
    torch.cuda.empty_cache()
    greedy = sampling_cls(temperature=0.0)
    batched["cli"] = cli_drive(torch, tok, [(PROMPTS[0], batched_results[0], greedy),
                                            (PROMPTS[1], batched_results[1], greedy)],
                               smi, serve_argv=("--batched",))
    log(json.dumps({"batched_cli_path": batched["cli"]}))
    gc.collect()
    torch.cuda.empty_cache()
    burst["cli"] = cli_drive(torch, tok, [(PROMPTS[0], burst_results[0], greedy),
                                          (PROMPTS[1], burst_results[1], greedy)],
                             smi, serve_argv=("--batched", "--burst", str(BURST_TICKS)),
                             stages=(0,), client_argv=("--burst", str(BURST_TICKS)))
    log(json.dumps({"burst_cli_path": burst["cli"]}))

    kernels = [kernel_entry("int8_dot", int8_rows, int8_summary, prefill_m, int8_decode,
                            int8_batch, batched["in_process"], tcp["int8"], burst["engine"]),
               kernel_entry("nf4_dot", nf4_rows, nf4_summary, prefill_m, nf4_decode,
                            nf4_batch, None, tcp["nf4"], None),
               draw_entry(draw, int8_summary["sample_draw"]["launches"],
                          batched["in_process"]["sample_draw_launches"],
                          burst["engine"]["sample_draw_launches"])]
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.monotonic() - t_start:.1f}s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    finally:
        save_log()
