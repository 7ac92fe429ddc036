#!/usr/bin/env python3
"""How the batched engine's rounds coalesce on the GPU.

Builds the int8 llama-3.1-8b pipeline of ``chip_smoke.py`` (4 even
stages, random weights from seed 0, bfloat16), puts stages 1-3 on batched
engines behind adapters (``runtime/batching.py``; 8 slots of 2048 rows,
each warmed up) and runs chip_smoke's 8 requests at once, one client
thread each (each with its own warmed-up stage 0), over float32 hops, at
each round window of ``--windows``. For each window it prints one JSON
object: the rounds each stage ran, the sessions each round carried (its
fill), each stage's median host ms a round as the leader runs it (the
step, and on the last stage the sampling and its read), the sessions'
queue waits, and the median decode ms/token; then the host ms of one
stage-0 decode step with the device idle. ``--stage1-windows`` gives
stage 1 a window of its own for each run (stages 2-3 keep ``--windows``).

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_batched_rounds.py [--windows 0.003,0.01] \
        [--stage1-windows 0.003,0.024]

The objects also go to ``chiprun_out/batched_rounds.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))



def main() -> int:
    import torch

    import chip_smoke as cs

    p = argparse.ArgumentParser()
    p.add_argument("--windows", default="0.003,0.01")
    p.add_argument("--stage1-windows", dest="stage1_windows", default=None)
    args_ = p.parse_args()
    windows = [float(w) for w in args_.windows.split(",")]
    firsts = ([float(w) for w in args_.stage1_windows.split(",")]
              if args_.stage1_windows else windows)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from importlib import import_module

    port = cs.PORT
    tmain = import_module(port + ".main")
    sampling_cls = import_module(port + ".ops.sampling").SamplingParams
    client_mod = import_module(port + ".runtime.client")
    registry_mod = import_module(port + ".scheduling.registry")
    messages = import_module(port + ".runtime.messages")
    cs.build_kernels([port + ".ops.int8_kernel", port + ".ops.nf4_kernel",
                      port + ".ops.draw_kernel"])
    args = tmain.build_parser().parse_args(
        ["--mode", "local", "--model", cs.MODEL, "--quant", "int8", "--dtype", "bfloat16",
         "--device", "cuda", "--seed", "0"])
    cfg, params = tmain.load_model(args)
    local = tmain.build_local_client(args, cfg, params)
    state = {"args": args, "cfg": cfg, "params": params, "client": local}
    requests = cs.batched_requests(tmain.load_tokenizer(), sampling_cls, cfg)
    adapters, _ = cs.batched_engines(torch, tmain, state)
    stage0s = cs.stage0_executors(torch, tmain, state, cs.SLOTS)
    transport, registry = cs.float32_hops(), registry_mod.PlacementRegistry()
    for a in adapters:
        transport.add_peer(a.peer_id, a)
        registry.register(client_mod.make_server_record(a.peer_id, a.spec, model=cs.MODEL,
                                                        engine="batched"))
    jobs = [(client_mod.PipelineClient(cfg, local.plan, ex, transport, registry, seed=0,
                                       model=cs.MODEL), ids, sp)
            for ex, (ids, sp) in zip(stage0s, requests)]
    out = []
    card = cs.card()
    for window, first in zip(windows, firsts):
        stages = {}
        for i, a in enumerate(adapters):
            a.window_s = first if i == 0 else window
            a._m_fill, a._m_round, a._m_queue_wait = cs.Observed(), cs.Observed(), cs.Observed()
        before = {a.peer_id: a.inner.decode_steps for a in adapters}
        results, wall = cs.run_clients(jobs)
        for a in adapters:
            waits = sorted(a._m_queue_wait.values)
            stages[a.peer_id] = {
                "rounds": a.inner.decode_steps - before[a.peer_id],
                "fills": a._m_fill.values,
                "round_host_ms_median": 1e3 * statistics.median(a._m_round.values),
                "queue_wait_ms_p50": 1e3 * waits[len(waits) // 2],
                "queue_wait_ms_p90": 1e3 * waits[int(len(waits) * 0.9)]}
        decode = [t for r in results for t in r.decode_times_s]
        row = {"window_s": window, "stage1_window_s": first, "wall_s": wall, "stages": stages,
               "decode_ms_per_token": 1e3 * statistics.median(decode), "card": card}
        out.append(row)
        print(json.dumps(row), flush=True)  # noqa: T201
    ex = stage0s[0]
    ex.forward(messages.StageRequest(session_id="t", hidden=torch.zeros((1, 32), dtype=torch.int64),
                                     seq_len=32, cur_len=0, is_prefill=True, max_length=64))
    times = []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.forward(messages.StageRequest(session_id="t", hidden=torch.zeros((1, 1), dtype=torch.int64),
                                         seq_len=1, cur_len=32 + i, is_prefill=False,
                                         max_length=64))
        times.append(time.perf_counter() - t0)
    row = {"stage0_decode_host_ms_median": 1e3 * statistics.median(times), "card": card}
    out.append(row)
    print(json.dumps(row), flush=True)  # noqa: T201
    dest = REPO / "chiprun_out" / "batched_rounds.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
