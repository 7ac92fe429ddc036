#!/usr/bin/env python3
"""Where the time of a decode step goes in the PyTorch port, on the GPU.

Builds the port's in-process ``--mode local`` cluster through its
``main.py`` (default: llama-3.1-8b, full width and depth, random weights
from seed 0, ``--quant int8``, bfloat16, 4 even stages), generates a prompt
and a few tokens to warm up, then traces decode steps with
``torch.profiler`` and prints one JSON object:

  * wall ms per decode step (host clock; each step ends in a host sync on
    the sampled token);
  * device-busy ms per step (the union of the traced kernels' intervals),
    the device's idle share, and kernel launches per step;
  * the kernels with the most device time, and the host ops with the most
    self CPU time;
  * the int8_dot wrapper's host cost per call against its device time (one
    wo-shaped weight, M = 1, 2000 back-to-back calls).

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_profile_decode.py [--model llama-3.1-8b] [--steps 8]

The JSON also goes to ``chiprun_out/profile_decode.json``. Needs a GPU: it
exits with an error without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
PORT = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch"


def _busy_us(intervals):
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def wrapper_cost(torch, ik, QuantizedTensor, calls: int = 2000) -> dict:
    """Host time per int8_dot call vs its device time, wo shape at M = 1."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q = torch.randint(-127, 128, (4096, 4096), generator=g, device="cuda",
                      dtype=torch.int8)
    w = QuantizedTensor(q, torch.rand((1, 4096), generator=g, device="cuda"), "bfloat16")
    x = torch.randn((1, 4096), generator=g, device="cuda").to(torch.bfloat16)
    for _ in range(20):
        ik.int8_dot(x, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ik.int8_dot(x, w)
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / calls * 1e6
    # Device time alone: the same calls queued behind a long memset.
    fill = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fill.zero_()
    a.record()
    for _ in range(50):
        ik.int8_dot(x, w)
    b.record()
    b.synchronize()
    return {"shape": "wo 4096x4096, M=1, bf16, L2 warm", "calls": calls,
            "host_us_per_call": host_us, "wall_us_per_call": wall_us,
            "device_us_per_call_queued": a.elapsed_time(b) / 50 * 1e3}


def main() -> int:
    import torch
    from importlib import import_module

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama-3.1-8b")
    p.add_argument("--steps", type=int, default=8)
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_decode: needs a CUDA GPU")
    tmain = import_module(PORT + ".main")
    ik = import_module(PORT + ".ops.int8_kernel")
    QuantizedTensor = import_module(PORT + ".models.quant").QuantizedTensor
    SamplingParams = import_module(PORT + ".ops.sampling").SamplingParams
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    args = tmain.build_parser().parse_args(
        ["--mode", "local", "--model", opts.model, "--quant", "int8",
         "--dtype", "bfloat16", "--device", "cuda", "--seed", "0"])
    cfg, params = tmain.load_model(args)
    client = tmain.build_local_client(args, cfg, params)
    prompt = [i % cfg.vocab_size for i in
              tmain.load_tokenizer().encode("The quick brown fox jumps over")]
    greedy = SamplingParams(temperature=0.0)
    client.generate(prompt, 4, sampling=greedy)          # warm-up

    steps = client.generate_stepwise(prompt, opts.steps + 2, sampling=greedy)
    next(steps)                                           # prefill + first token
    next(steps)                                           # one untraced decode
    launches0 = ik._launches
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(opts.steps):
            t0 = time.perf_counter()
            next(steps)
            walls.append(time.perf_counter() - t0)
    steps.close()
    int8_launches = (ik._launches - launches0) / opts.steps

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    top_kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host_ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)[:15]
    n = opts.steps
    wall_ms = 1e3 * sum(walls) / n
    out = {
        "card": card, "model": opts.model, "layers": cfg.num_layers,
        "stages": client.plan.num_stages, "decode_steps_traced": n,
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_each": [1e3 * w for w in walls],
        "device_busy_ms_per_step": busy_ms / n if kernels else None,
        "device_idle_share": (1 - (busy_ms / n) / wall_ms) if kernels else None,
        "kernel_launches_per_step": len(kernels) / n if kernels else None,
        "int8_dot_launches_per_step": int8_launches,
        "top_kernels_ms_per_step": [
            {"name": k[:90], "ms": v[0] / n, "launches": v[1] / n} for k, v in top_kernels],
        "top_host_ops_self_cpu_ms_per_step": [
            {"name": e.key, "ms": e.self_cpu_time_total / 1e3 / n, "calls": e.count / n}
            for e in host_ops],
        "int8_dot_wrapper": wrapper_cost(torch, ik, QuantizedTensor),
    }
    if not kernels:
        out["note"] = "the profiler recorded no device activity; device numbers not measured"
    text = json.dumps(out)
    print(text)  # noqa: T201
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profile_decode.json").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
