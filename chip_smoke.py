#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py
(``--kernels-only``: steps 1-3 and stop, a development aid for iterating on
the kernels; it never prints the last line of a smoke pass.)

1. Card: prints ``nvidia-smi``'s name and power limit, torch and CUDA versions.
2. Build: compiles every CUDA kernel of the port from ``csrc/``, one nvcc per
   source, all at once.
3. Kernels: calls each kernel's wrapper (``int8_dot``, ``nf4_dot``) at the
   shapes the main paths give it (llama-3.1-8b projections at M = 1, 8, 16,
   the prompt length, 128 and 512, each row with the route it took), holds
   it against its plain PyTorch version on the same card, and times the
   kernel, the plain version and one PyTorch library call computing the
   same function. Each is also held at ragged shapes of both its routes
   (``int8_dot`` also at an x view 2 bytes into its storage), and both
   kernels of each are timed at M = 1..16 on wgu and wd (the crossover scan
   behind its ``MMA_MIN_M``). Prints JSON lines of shapes, crossover scan
   and per-layer sums per kernel.
4. Sampling: times one sampled draw at llama-3.1-8b's vocabulary, the
   port's threefry ``sample_token`` beside a ``torch.multinomial`` draw.
5. int8 path: builds the port's in-process ``--mode local`` cluster through
   ``main.py``'s own functions (llama-3.1-8b at full width and depth, random
   weights from a seed, ``--quant int8``, bfloat16, 4 even stages), serves 3
   requests (two greedy, one sampled), checks that every projection went
   through ``int8_dot`` (launch counts reset just before, read just after),
   whose every prefill projection must take the tensor-core route
   (``_launches_mma``), and holds the greedy tokens to an unsplit greedy
   loop over ``full_forward`` with the executors' float32 cache.
6. NF4 path: the same with ``--quant nf4`` and ``NF4_KERNEL=1``, through
   ``nf4_dot``, with the same gates. Both serve phases run with telemetry
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
   telemetry phase on the NF4 one): that path's stage executors behind
   ``TcpStageServer``s (each with its own ``StageRuntime``) registered at a
   ``RegistryServer``, and the same 3 requests through a ``TcpTransport``
   client (``RemoteRegistry`` discovery, wire bf16). The tokens must equal
   the in-process run's exactly (the hidden state is bfloat16, so the bf16
   wire round trip is the identity), with the launch gates of steps 5-6
   (counts set to 0 just before the requests, read just after) and the
   native wire codec loaded. On the int8 path a stage-2 replica joins and
   the pinned stage-2 server is ``stop()``ped after its 3rd decode step
   of a greedy request: the client must recover onto the replica with the
   fault-free tokens.
9. CLI drive: ``--mode registry``, then ``--mode serve --stage 1..3 --quant
   int8 --dtype bfloat16 --seed 0`` and ``--mode client`` with the first
   greedy prompt, each a process of its own on the card, started one after
   another (handshake lines scraped, port 0 everywhere). The client's
   printed generation must equal the in-process int8 run's for that
   prompt, and the token ids on its ``TOKENS=`` line must equal that run's.
   Each process's peak device memory is read from its ``PEAK_MEMORY_BYTES``
   lines (a server prints one when it starts serving and one when it stops
   on SIGINT, after the request); every child is killed at the end,
   whatever happens.
   ``tcp_path`` and ``cli_path`` JSON lines carry TTFT, decode ms/token,
   the per-hop ``client_stage_time_seconds``, the client's ``socket``
   phase and the peaks.
10. Prints the ``kernels`` JSON line and ``{"ok": true, "device": {...}}``
   as its last line.

Any failure raises and the script exits non-zero without the last line. It
refuses to run without a CUDA device, and outside a checkout of the repo.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import pathlib
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

PORT = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch"
MODEL = "llama-3.1-8b"
PROMPTS = ("The quick brown fox jumps over", "Pipeline stages pass activations",
           "Sampling with a seed: once upon")
MAX_NEW_TOKENS = 32
# (site, K, N) of llama-3.1-8b's four projection launches per layer after the
# executor's fusion: wqkv = wq|wk|wv, wgu = wg|wu.
SITES = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("wgu", 4096, 28672),
         ("wd", 14336, 4096))
# Published dense peaks (data sheets): bytes/s of device memory, and bf16
# tensor-core FLOP/s, the rate of the kernel's input type.
PEAKS = (("H200", 4.8e12, 989e12), ("H100 NVL", 3.9e12, 835e12),
         ("H100 PCIe", 2.0e12, 756e12), ("H100", 3.35e12, 989e12))
BF16_TOL = 2.0 ** -7   # max|kernel - plain| <= BF16_TOL * max|plain|: one
#                        bf16 ulp at the output's scale (sums in other orders)
F32_TOL = 1e-5         # float32 activations, relative to max|plain|
LOGIT_GAP_TOL = 2.0 ** -6  # a near-tie: top-2 gap <= this * max|logit|
KILL_AFTER_DECODES = 3  # the failover drives kill the pinned peer after this
#                         many decode steps it served
CLI_STEP_TIMEOUT_S = 300  # each CLI process: its handshake line, or the client's run
TELEMETRY_PAIRS = 4     # telemetry off / on runs of one request, in ABBA order
HOOK_STEPS = 2000       # decode steps of the stub pipeline that prices the hooks
LIBRARY_NOTE = ("torch.matmul(x, dequantized bf16 weight): a yardstick that "
                "reads the weight as bf16; the port never calls it")
REPLACES = {"int8_dot": "ops/int8_kernel.py:98", "nf4_dot": "ops/nf4_kernel.py:132"}


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
            m = re.search(r"\d((?:int8|nf4)_dot(?:_mma)?_kernel)I(.*?)EEv",
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


def cuda_ms(fn, torch, reps: int = 25, flush=None) -> float:
    """Median device time of one call, CUDA events around each call. A
    write of `flush` (1 GiB) before each call evicts the L2 (the main path
    reads each weight cold) and keeps the stream busy while the host
    enqueues the call, so the events bracket device time, not host time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
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


def int8_phase(torch, ik, dev, prompt_len: int, bw: float, flops: float, flush):
    """int8_dot at every main-path shape: agreement and times, each row with
    its route; ragged shapes of both routes and an x view at an offset; and
    the crossover scan of the two kernels at M = 1..16 on wgu and wd.
    Returns (rows, scan)."""
    from importlib import import_module

    quant = import_module(PORT + ".models.quant")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, scan = [], []
    ms = (1, 8, 16, prompt_len, 128, 512)
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
                m * k * 2 + k * n + n * 4 + m * n * 2, bw, flops, flush)
            row["route"] = ik._route(m, k, n, x.dtype)
            rows.append(row)
        x32 = torch.randn((16, k), generator=gen, device=dev)
        err32 = check_f32("int8_dot", site, ik.int8_dot(x32, w),
                          ik.int8_dot_reference(x32, q, s))
        log(f"int8_dot {site} K={k} N={n}: bf16 ok at M={','.join(map(str, ms))} "
            f"(routes {[r['route'] for r in rows[-len(ms):]]}); "
            f"float32 M=16 max err {err32:.3e}")
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
                                lambda x: ik.int8_dot_reference(x, q, s), flush)
        del q, s, w, w_deq
    # Ragged shapes: the K tail inside a step, the last column block part
    # full; N % 16 != 0 takes the CUDA-core route.
    for k, n, m, want in ((100, 97, 16, "simt"), (328, 48, 33, "mma")):
        w = int8_weight(torch, quant, gen, dev, k, n)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        assert ik._route(m, k, n, x.dtype) == want
        err = check_bf16(torch, "int8_dot", f"K={k} N={n}", x, ik.int8_dot(x, w),
                         ik.int8_dot_reference(x, w.q, w.s))
        log(f"int8_dot ragged K={k} N={n} M={m} ({want}): max err {err:.3e}")
    # x as a view 2 bytes into its storage: the tensor-core route's 16-byte
    # copies take a clone of it.
    k, n, m = 4096, 4096, prompt_len
    w = int8_weight(torch, quant, gen, dev, k, n)
    buf = torch.randn((m * k + 1,), generator=gen, device=dev).to(torch.bfloat16)
    x = buf[1:].view(m, k)
    assert x.data_ptr() % 16 == 2 and ik._route(m, k, n, x.dtype) == "mma"
    before = ik._launches_mma
    err = check_bf16(torch, "int8_dot", "x at a 2-byte offset", x, ik.int8_dot(x, w),
                     ik.int8_dot_reference(x, w.q, w.s))
    assert ik._launches_mma == before + 1
    log(f"int8_dot x view at a 2-byte offset K={k} N={n} M={m} (mma, cloned): "
        f"max err {err:.3e}")
    log(f"int8_dot crossover: mma at least as fast from M={crossover(scan)} "
        f"(MMA_MIN_M = {ik.MMA_MIN_M})")
    return rows, scan


def scan_routes(torch, name, site, k, gen, dev, launch, plain, flush):
    """Both kernels of `name` (``launch(x, route)``) at M = 1..16, each held
    to the plain version and timed: the crossover scan behind its
    ``MMA_MIN_M``."""
    points = []
    for m in range(1, 17):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        ref = plain(x)
        point = {"site": site, "M": m}
        for route in ("simt", "mma"):
            check_bf16(torch, name, f"{site} {route}", x, launch(x, route), ref)
            point[f"{route}_ms"] = cuda_ms(lambda: launch(x, route), torch, flush=flush)
        points.append(point)
    return points


def crossover(scan):
    """The least M from which the tensor-core route is at least as fast at
    every scanned M of every site."""
    faster = [p["mma_ms"] <= p["simt_ms"] for p in scan]
    return next((m for m in range(1, 17)
                 if all(f for p, f in zip(scan, faster) if p["M"] >= m)), None)


def nf4_weight(torch, quant, gen, dev, k: int, n: int):
    w_bf16 = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    return quant._quantize_leaf_nf4(w_bf16)


def nf4_phase(torch, nk, dev, prompt_len: int, bw: float, flops: float, flush):
    """nf4_dot at every main-path shape, on weights quantized by the port's
    own NF4 quantizer: agreement and times, each row with its route; ragged
    shapes of both routes; and the crossover scan of the two kernels at
    M = 1..16 on wgu and wd. Returns (rows, scan)."""
    from importlib import import_module

    quant = import_module(PORT + ".models.quant")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows, scan = [], []
    ms = (1, 8, 16, prompt_len, 128, 512)
    for site, k, n in SITES:
        w = nf4_weight(torch, quant, gen, dev, k, n)
        w_deq = w.dequant()                          # library yardstick only
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            row = check_and_time(
                torch, "nf4_dot", site, x, lambda: nk.nf4_dot(x, w),
                lambda: nk.nf4_dot_reference(x, w),
                lambda: torch.matmul(x, w_deq),
                m * k * 2 + k * n // 2 + (k // 64) * n * 2 + m * n * 2,
                bw, flops, flush)
            row["route"] = nk._route(m, k, n, x.dtype)
            rows.append(row)
        x32 = torch.randn((16, k), generator=gen, device=dev)
        err32 = check_f32("nf4_dot", site, nk.nf4_dot(x32, w),
                          nk.nf4_dot_reference(x32, w))
        log(f"nf4_dot {site} K={k} N={n}: bf16 ok at M={','.join(map(str, ms))} "
            f"(routes {[r['route'] for r in rows[-len(ms):]]}); "
            f"float32 M=16 max err {err32:.3e}")
        if site == "wgu":                            # a ragged M, tensor cores
            x = torch.randn((33, k), generator=gen, device=dev).to(torch.bfloat16)
            assert nk._route(33, k, n, x.dtype) == "mma"
            err = check_bf16(torch, "nf4_dot", site, x, nk.nf4_dot(x, w),
                             nk.nf4_dot_reference(x, w))
            log(f"nf4_dot {site} ragged M=33 (mma): max err {err:.3e}")
        if site in ("wgu", "wd"):
            scan += scan_routes(torch, "nf4_dot", site, k, gen, dev,
                                lambda x, route: nk._launch(x, w, route),
                                lambda x: nk.nf4_dot_reference(x, w), flush)
        del w, w_deq
    # Ragged shapes: in_dim not a multiple of 64, the last column block part
    # full; N % 16 != 0 takes the CUDA-core route.
    for k, n, m, want in ((100, 97, 16, "simt"), (130, 50, 33, "simt"),
                          (328, 48, 33, "mma")):
        w = nf4_weight(torch, quant, gen, dev, k, n)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        assert nk._route(m, k, n, x.dtype) == want
        err = check_bf16(torch, "nf4_dot", f"K={k} N={n}", x, nk.nf4_dot(x, w),
                         nk.nf4_dot_reference(x, w))
        log(f"nf4_dot ragged K={k} N={n} M={m} ({want}): max err {err:.3e}")
    log(f"nf4_dot crossover: mma at least as fast from M={crossover(scan)} "
        f"(MMA_MIN_M = {nk.MMA_MIN_M})")
    return rows, scan


def sampling_phase(torch, vocab: int, reps: int = 30):
    """Host wall time of one sampled draw at the model's vocabulary, as the
    final stage pays it per sampled token (each call ends in a host read of
    the token): the port's ``sample_token`` (threefry Gumbel-max draw), and
    the same filters followed by one ``torch.multinomial`` draw, the port's
    draw before threefry. The draws alone beside them. The multinomial
    rows are a yardstick the port never calls."""
    from importlib import import_module

    samp = import_module(PORT + ".ops.sampling")
    tf3 = import_module(PORT + ".ops.threefry")
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(vocab, generator=gen, device="cuda") * 4.0
    recent = torch.randint(0, vocab, (samp.RECENT_WINDOW,), generator=gen,
                           device="cuda", dtype=torch.int32)
    knobs = (samp.RECENT_WINDOW, 0.7, 0.9, 50, 1.5)
    probs = samp.sample_probs(logits, recent, *knobs)
    logp = torch.log(torch.clamp(probs, min=1e-20))
    key = tf3.prng_key(0)
    fns = {
        "sample_token_threefry": lambda: samp.sample_token(key, logits, recent, *knobs),
        "sample_token_multinomial": lambda: int(torch.multinomial(
            samp.sample_probs(logits, recent, *knobs), 1, generator=gen)),
        "draw_threefry": lambda: int(tf3.categorical(key, logp)),
        "draw_multinomial": lambda: int(torch.multinomial(probs, 1, generator=gen)),
    }
    out = {"vocab": vocab, "reps": reps}
    for what, fn in fns.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out[f"{what}_ms"] = 1e3 * statistics.median(times)
    return out


def first_difference(a, b) -> int:
    return next(j for j in range(min(len(a), len(b)) + 1)
                if j >= min(len(a), len(b)) or a[j] != b[j])


def hold_to_reference(torch, cfg, params, ids, got, want, what: str) -> None:
    """Equal tokens, or a first difference at a near-tie of the float32
    reference's logits (top-2 gap <= LOGIT_GAP_TOL * max|logit|)."""
    if got == want:
        log(f"  {what}: tokens equal ({len(want)} tokens)")
        return
    i = first_difference(got, want)
    logits = oracle_logits(torch, cfg, params, ids + want[:i])
    top2 = torch.topk(logits, 2).values
    gap = (top2[0] - top2[1]).item()
    tol = LOGIT_GAP_TOL * logits.abs().max().item()
    log(f"  {what}:\n    got  {got}\n    want {want}\n  first difference at "
        f"step {i}: reference top-2 logit gap {gap:.4g} (near-tie tolerance {tol:.4g})")
    if not gap <= tol:
        raise AssertionError(f"{what}: tokens differ at a decisive step")


def greedy_reference(torch, cfg, params, ids, max_new_tokens: int):
    """Unsplit greedy loop over ``full_forward`` with a float32 KV cache,
    what the stage executors keep, and the pipeline's stop rules."""
    from importlib import import_module

    tf = import_module(PORT + ".models.transformer")
    REPEAT_STOP = import_module(PORT + ".runtime.client").REPEAT_STOP
    dev = params["embed"]["wte"].device
    kc, vc = tf.init_kv_cache(cfg, cfg.num_layers, 1, len(ids) + max_new_tokens + 1,
                              dtype=torch.float32, device=dev)
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
    for mod in kernels.values():
        mod._launches = 0
        mod._launches_mma = 0
    results = [client.generate(ids, MAX_NEW_TOKENS, sampling=sp)
               for ids, (_, sp) in zip(prompt_ids, requests)]
    torch.cuda.synchronize()
    launches = kernels[name]._launches
    launches_mma = kernels[name]._launches_mma
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = sum(len(r.tokens) for r in results)
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
    for (p, sp), r in zip(requests, results):
        log(f"  request T={sp.temperature}: {len(r.tokens)} tokens stopped by "
            f"{r.stopped_by}, ttft {r.ttft_s * 1e3:.1f} ms, decode "
            f"{1e3 * sum(r.decode_times_s) / max(len(r.decode_times_s), 1):.2f} "
            f"ms/token: {r.tokens}")

    ref_params = tmain._maybe_quantize(args, params)
    for ids, r in zip(prompt_ids[:2], results[:2]):
        want = greedy_reference(torch, cfg, ref_params, ids, MAX_NEW_TOKENS)
        hold_to_reference(torch, cfg, ref_params, ids, r.tokens, want,
                          "greedy tokens against the float32-cache reference")
    decode = [t for r in results for t in r.decode_times_s]
    summary = {"model": MODEL, "quant": quant, "layers": cfg.num_layers,
               "stages": client.plan.num_stages, "requests": len(results),
               "tokens": tokens, f"{name}_launches": launches,
               f"{name}_launches_mma": launches_mma,
               "prefill_ms": [r.ttft_s * 1e3 for r in results],
               "prompt_tokens": [len(ids) for ids in prompt_ids],
               "decode_ms_per_token": 1e3 * statistics.median(decode),
               "decode_ms_per_token_mean": 1e3 * sum(decode) / len(decode),
               "peak_memory_gb": peak_gb, "setup_s": setup_s}
    state = {"args": args, "cfg": cfg, "params": params, "client": client,
             "ref_params": ref_params, "prompt_ids": prompt_ids,
             "results": results, "requests": requests}
    return summary, state


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
                nk._launches = 0
                nk._launches_mma = 0
                r = client.generate(ids, MAX_NEW_TOKENS, sampling=greedy)
                torch.cuda.synchronize()
                runs[side].append({"tokens": r.tokens, "ttft_s": r.ttft_s,
                                   "decode_s": median_ms(r.decode_times_s) / 1e3,
                                   "launches": (nk._launches, nk._launches_mma)})
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
                    "nf4_dot_launches_mma": every[0]["launches"][1]}
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


def tcp_drive(torch, kernels, name: str, tmain, state, smi: str, failover: bool):
    """The serve() run's executors behind TCP servers and a registry
    service, the same requests through a TCP client at wire bf16: tokens
    equal to the in-process run's, the launch gates of serve(), the native
    codec; with `failover`, a stage-2 replica and the pinned server stopped
    after its 3rd decode step. Returns the tcp_path summary."""
    from importlib import import_module

    net = import_module(PORT + ".runtime.net")
    native = import_module(PORT + ".native")
    task_pool = import_module(PORT + ".runtime.task_pool")
    client_mod = import_module(PORT + ".runtime.client")
    executor_mod = import_module(PORT + ".runtime.executor")
    profiling = import_module(PORT + ".telemetry.profiling")
    args, cfg, local = state["args"], state["cfg"], state["client"]
    registry_srv = net.RegistryServer()
    registry_srv.start()
    servers = {}
    transport = None

    def serve_over_tcp(peer, ex):
        srv = net.TcpStageServer(ex, task_pool.StageRuntime(), wire_dtype="bf16",
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
        transport = net.TcpTransport(registry, wire_dtype="bf16", model=MODEL)
        client = client_mod.PipelineClient(cfg, local.plan, local.stage0, transport,
                                           registry, seed=args.seed, model=MODEL)
        torch.cuda.reset_peak_memory_stats()
        profiling.enable_phase_profiling()
        prof.reset()
        for mod in kernels.values():
            mod._launches = 0
            mod._launches_mma = 0
        results = [client.generate(ids, MAX_NEW_TOKENS, sampling=sp)
                   for ids, (_, sp) in zip(state["prompt_ids"], state["requests"])]
        torch.cuda.synchronize()
        launches = kernels[name]._launches
        launches_mma = kernels[name]._launches_mma
        socket_phase = prof.snapshot().get("socket")
        profiling.disable_phase_profiling()
        if not native.have_native():
            raise AssertionError("the native wire codec is not loaded")
        tokens = sum(len(r.tokens) for r in results)
        need, need_mma = 4 * cfg.num_layers * tokens, 4 * cfg.num_layers * len(results)
        log(f"tcp {args.quant}: {tokens} tokens over {len(results)} requests, {name} "
            f"launches {launches} (>= {need}), tensor-core {launches_mma} (>= {need_mma})")
        if launches < need or launches_mma < need_mma:
            raise AssertionError(f"tcp {args.quant}: {name} launches {launches} / "
                                 f"{launches_mma}, want >= {need} / {need_mma}")
        for r, want in zip(results, state["results"]):
            if r.tokens != want.tokens:
                raise AssertionError(f"tcp {args.quant}: tokens differ from the "
                                     f"in-process run:\n  {r.tokens}\n  {want.tokens}")
        log(f"  tcp {args.quant}: tokens of all {len(results)} requests equal the "
            "in-process run's")
        decode = [t for r in results for t in r.decode_times_s]
        local_decode = [t for r in state["results"] for t in r.decode_times_s]
        summary = {
            "model": MODEL, "quant": args.quant, "wire_dtype": "bf16",
            "stages": local.plan.num_stages, "requests": len(results),
            "tokens": tokens, "tokens_equal_local": True,
            f"{name}_launches": launches, f"{name}_launches_mma": launches_mma,
            "native_codec": native.have_native(),
            "ttft_ms": [r.ttft_s * 1e3 for r in results],
            "ttft_ms_local": [r.ttft_s * 1e3 for r in state["results"]],
            "decode_ms_per_token": 1e3 * statistics.median(decode),
            "decode_ms_per_token_local": 1e3 * statistics.median(local_decode),
            "client_stage_time_seconds": family_view(client.metrics,
                                                     "client_stage_time_seconds"),
            "socket_phase": socket_phase,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}
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
                peer_id=replica_id, device=torch.device(args.device),
                act_dtype=tmain._DTYPE_MAP[args.dtype])
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


def wire_costs(torch, net, transport, hidden: int, prompt_len: int, peers,
               reps: int = 200):
    """Host cost of the wire alone, on this host: one hop's activation
    (a decode step's [1, 1, hidden] and a prefill's [1, prompt_len,
    hidden], bfloat16 on the card) copied to the host, encoded to wire bf16
    with its CRC-32C, checked and decoded again (medians in us); and the
    median loopback round trip of an `info` frame to each server (ms)."""
    out = {}
    for what, t in (("decode_hop", 1), ("prefill_hop", prompt_len)):
        x = torch.randn((1, t, hidden), device="cuda").to(torch.bfloat16)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            meta, body = net._encode_tensor(net._host_array(x), "bf16")
            net.native.crc32c(body)
            net.native.crc32c(body)
            net._to_tensor(net._decode_tensor(meta, body))
            times.append(time.perf_counter() - t0)
        out[f"{what}_codec_us"] = 1e6 * statistics.median(times)
        out[f"{what}_bytes"] = len(body)
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


def cli_drive(torch, tok, int8_state, smi: str):
    """The port's swarm as processes on the card: a registry, three stage
    servers (int8, bfloat16, seed 0) and a client with the first greedy
    prompt, started one after another. The client's printed generation
    and its ``TOKENS=`` ids must equal the in-process int8 run's. Returns
    the cli_path summary."""
    want = int8_state["results"][0]
    sp = int8_state["requests"][0][1]
    expect = (f"=== Generation ({len(want.tokens)} tokens, stopped by "
              f"{want.stopped_by}) ===\n{tok.decode(want.tokens)}\n")
    main = [sys.executable, "-m", PORT + ".main"]
    model_args = ["--model", MODEL, "--quant", "int8", "--dtype", "bfloat16",
                  "--seed", "0", "--device", "cuda"]
    env = dict(os.environ, PYTHONIOENCODING="utf-8", PYTHONUNBUFFERED="1")
    procs = []
    peaks, held = {}, {}
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
            for k in (1, 2, 3):
                t0 = time.monotonic()
                proc, out = spawn(f"stage{k}", ["--mode", "serve", "--stage", str(k),
                                                "--registry_addr", addr, "--rpc_port", "0",
                                                *model_args])
                line = _wait_line(proc, out, "SERVING ", f"stage {k} server")
                # Printed before the SERVING line.
                peak = re.search(r"PEAK_MEMORY_BYTES=(\d+)", out.read_text())
                peaks[f"stage{k}_at_start"] = peak and int(peak.group(1))
                start_s[f"stage{k}"] = time.monotonic() - t0
                log(f"cli: {line} ({start_s[f'stage{k}']:.1f}s)")
            t0 = time.monotonic()
            client = subprocess.run(
                main + ["--mode", "client", "--registry_addr", addr, *model_args,
                        "--prompt", PROMPTS[0], "--max_new_tokens", str(MAX_NEW_TOKENS),
                        "--temperature", str(sp.temperature), "--top_p", str(sp.top_p),
                        "--top_k", str(sp.top_k),
                        "--repetition_penalty", str(sp.repetition_penalty)],
                capture_output=True, env=env, timeout=CLI_STEP_TIMEOUT_S,
                cwd=str(LOG_PATH.parents[1]))
            client_s = time.monotonic() - t0
            stdout = client.stdout.decode("utf-8", errors="replace")
            if client.returncode != 0:
                raise AssertionError(f"client exited {client.returncode}:\n"
                                     + client.stderr.decode(errors="replace")[-3000:])
            if expect not in stdout:
                raise AssertionError(f"cli client text differs from the in-process "
                                     f"run's:\n{stdout}\nwant:\n{expect}")
            ids = re.search(r"^TOKENS=(\[[0-9, ]*\])$", stdout, re.M)
            if ids is None or json.loads(ids.group(1)) != want.tokens:
                raise AssertionError(f"cli client token ids differ from the in-process "
                                     f"run's:\n{ids and ids.group(1)}\nwant:\n{want.tokens}")
            log(f"cli: client text and token ids equal the in-process int8 run's "
                f"({len(want.tokens)} tokens, {client_s:.1f}s with set-up)")
            ttft = float(re.search(r"TTFT: ([0-9.]+)s", stdout).group(1))
            tps = float(re.search(r"Decode: [0-9.]+s total, ([0-9.]+) tokens/s",
                                  stdout).group(1))
            peak = re.search(r"PEAK_MEMORY_BYTES=(\d+) ALLOCATED_BYTES=(\d+)", stdout)
            peaks["client"] = peak and int(peak.group(1))
            held["client"] = peak and int(peak.group(2))
            # A server prints its peak again when SIGINT stops it.
            for what, proc, _ in procs[1:]:
                proc.send_signal(signal.SIGINT)
            for what, proc, _ in procs[1:]:
                proc.wait(timeout=CLI_STEP_TIMEOUT_S)
                last = re.findall(r"PEAK_MEMORY_BYTES=(\d+) ALLOCATED_BYTES=(\d+)",
                                  (tmp / f"{what}.out").read_text())
                peaks[f"{what}_after_request"] = (int(last[-1][0]) if len(last) == 2
                                                  else None)
                held[what] = int(last[-1][1]) if len(last) == 2 else None
            missing = [k for k, v in peaks.items() if v is None]
            if missing:
                raise AssertionError(f"cli: no peak device memory from {missing}")
            summary = {"model": MODEL, "quant": "int8", "wire_dtype": "bf16",
                       "processes": 5, "prompt": PROMPTS[0],
                       "tokens": len(want.tokens), "text_equal_in_process": True,
                       "ttft_ms_printed": ttft * 1e3,
                       "decode_ms_per_token_mean_printed": 1e3 / tps if tps else None,
                       "peak_memory_gb": {k: v / 1e9 for k, v in peaks.items()},
                       "held_memory_gb": {k: v and v / 1e9 for k, v in held.items()},
                       "start_s": start_s, "client_run_s": client_s, "card": smi}
            log(f"cli: ttft {ttft * 1e3:.0f} ms, decode "
                f"{summary['decode_ms_per_token_mean_printed']:.2f} ms/token (mean, "
                f"printed); peaks GB {summary['peak_memory_gb']}; held GB "
                f"{summary['held_memory_gb']}")
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


def oracle_logits(torch, cfg, params, ids):
    """The float32-cache reference's next-token logits after `ids` (one
    prefill)."""
    from importlib import import_module

    tf = import_module(PORT + ".models.transformer")
    dev = params["embed"]["wte"].device
    kc, vc = tf.init_kv_cache(cfg, cfg.num_layers, 1, len(ids), dtype=torch.float32,
                              device=dev)
    logits, _, _ = tf.full_forward(cfg, params, torch.tensor([ids], device=dev), kc, vc, 0)
    if not (torch.isfinite(logits).all() and tuple(logits.shape) == (1, len(ids), cfg.vocab_size)):
        raise AssertionError("reference logits are not finite or have the wrong shape")
    return logits[0, -1]


def layer_sum(rows):
    """The four sites' rows of one M summed: one layer."""
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def kernel_entry(name: str, rows, launches: int, prompt_len: int):
    """One kernel of the ``kernels`` line: one decode layer's four sites at
    M = 1 summed, and one prefill layer (M = prompt_len) under
    ``prefill``."""
    decode_rows = [r for r in rows if r["M"] == 1]
    entry = {"name": name, "route": "cuda",
             "source": f"{PORT}/csrc/{name}.cu",
             "replaces": "global_capstone_design_distributed_inference_of_llms_over_"
                         "the_internet_tpu/" + REPLACES[name],
             "launches": launches,
             "at": "one decode layer: wqkv+wo+wgu+wd at M=1, bf16, L2 cold",
             **layer_sum(decode_rows), "library": LIBRARY_NOTE}
    pre = [r for r in rows if r["M"] == prompt_len]
    entry["prefill"] = {
        "at": f"one prefill layer: wqkv+wo+wgu+wd at M={prompt_len}, bf16, L2 cold",
        "route": "+".join(sorted({r["route"] for r in pre})), **layer_sum(pre)}
    return entry


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

    build_s = build_kernels([PORT + ".ops.int8_kernel", PORT + ".ops.nf4_kernel"])
    log(f"build: {build_s:.1f}s")
    for src, text in import_module(PORT + ".utils.cuda_build").build_logs.items():
        for kernel, line in ptxas_usage(text):
            log(f"  {src} {kernel}: {line}")

    kernel_mods = {"int8_dot": ik, "nf4_dot": nk}
    prompt_len = len(PROMPTS[0].encode())
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    int8_rows, int8_scan = int8_phase(torch, ik, "cuda", prompt_len, bw, flops, flush)
    nf4_rows, nf4_scan = nf4_phase(torch, nk, "cuda", prompt_len, bw, flops, flush)
    for kname, rows, scan in (("int8_dot", int8_rows, int8_scan),
                              ("nf4_dot", nf4_rows, nf4_scan)):
        log(json.dumps({f"{kname}_shapes": rows, "card": smi}))
        log(json.dumps({f"{kname}_crossover": scan, "card": smi}))
        log(json.dumps({f"{kname}_per_layer": {
            m: layer_sum([r for r in rows if r["M"] == m])
            for m in sorted({r["M"] for r in rows})}, "card": smi}))
    del flush
    if kernels_only:
        log(f"total {time.monotonic() - t_start:.1f}s")
        log("kernels-only: not a smoke pass")
        return 0
    sampling = sampling_phase(torch, 128256)
    log(json.dumps({"sampling_draw": sampling, "card": smi}))

    int8_summary, state = serve(torch, kernel_mods, "int8_dot", tmain, sampling_cls,
                                "int8", "cuda")
    log(json.dumps({"main_path": int8_summary, "card": smi}))
    tcp = {"int8": tcp_drive(torch, kernel_mods, "int8_dot", tmain, state, smi,
                             failover=True)}
    # What the CLI drive compares with; the weights go.
    int8_state = {k: state[k] for k in ("results", "requests")}
    del state
    # As under --telemetry: the client's metrics go to the global registry,
    # which stays disabled until the telemetry phase.
    nf4_summary, state = serve(torch, kernel_mods, "nf4_dot", tmain, sampling_cls,
                               "nf4", "cuda", extra_argv=("--telemetry",))
    tcp["nf4"] = tcp_drive(torch, kernel_mods, "nf4_dot", tmain, state, smi,
                           failover=False)
    tele = telemetry_phase(torch, tmain, nk, state, smi)
    nf4_summary["failover"] = tele.pop("failover")
    log(json.dumps({"nf4_path": nf4_summary, "card": smi}))
    log(json.dumps({"telemetry": tele, "card": smi}))
    del state
    log(json.dumps({"tcp_path": tcp}))
    gc.collect()
    torch.cuda.empty_cache()
    cli = cli_drive(torch, tmain.load_tokenizer(), int8_state, smi)
    log(json.dumps({"cli_path": cli}))

    kernels = [kernel_entry("int8_dot", int8_rows, int8_summary["int8_dot_launches"],
                            prompt_len),
               kernel_entry("nf4_dot", nf4_rows, nf4_summary["nf4_dot_launches"],
                            prompt_len)]
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
