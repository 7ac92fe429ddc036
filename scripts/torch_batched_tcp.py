#!/usr/bin/env python3
"""How the round window of stages 2 and 3 over TCP splits the batched rounds.

Builds ``chip_smoke.py``'s int8 llama-3.1-8b path (its ``serve`` phase),
then runs chip_smoke's batched path (``batched_path``: 8 sessions in
process and over in-process TCP, the fill scan, the rounds alone) with
each value of ``--hop`` as chip_smoke's ``TCP_HOP_S`` in turn (0: stages
2 and 3 keep the adapters' 3 ms window over TCP too; else that many
seconds a session), ``--repeats`` times over. For each run it prints one
JSON object: the value, the rounds each stage ran and each round's fill,
each stage's arrivals (the spread of a step's arrivals against the round
window, and the hops from the stage before: chip_smoke's ``arrivals``),
tokens/s and decode ms/token a session in process and over TCP, each
stage's round alone at fill 8 (device ms), or the gate that failed (its
arrivals are then in chip_smoke's log line before it).

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_batched_tcp.py [--hop 0,0.001] [--repeats 3]

The objects also go to ``chiprun_out/batched_tcp.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch
    from importlib import import_module

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--hop", default="0,0.001")
    ap.add_argument("--repeats", type=int, default=3)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_batched_tcp: no CUDA device", file=sys.stderr)  # noqa: T201
        return 2
    port = cs.PORT
    kernels = {"int8_dot": import_module(port + ".ops.int8_kernel"),
               "nf4_dot": import_module(port + ".ops.nf4_kernel"),
               "sample_draw": import_module(port + ".ops.draw_kernel")}
    tmain = import_module(port + ".main")
    sampling_cls = import_module(port + ".ops.sampling").SamplingParams
    cs.build_kernels([mod.__name__ for mod in kernels.values()])
    smi = cs.card()
    _, state = cs.serve(torch, kernels, "int8_dot", tmain, sampling_cls, "int8", "cuda")
    runs = []
    for _ in range(opts.repeats):
        for hop in (float(v) for v in opts.hop.split(",")):
            cs.TCP_HOP_S = hop
            run = {"tcp_hop_s": hop, "card": smi}
            try:
                b, _ = cs.batched_path(torch, kernels, tmain, sampling_cls, state, smi)
                for key in ("in_process", "tcp"):
                    run[key] = {"rounds": b[key]["rounds"], "fills": b[key]["fills"],
                            "arrivals": b[key]["arrivals"],
                                "tokens_per_s": b[key]["aggregate_tokens_per_s"],
                                "ms_per_token": b[key]["per_session_ms_per_token"]}
                run["round_alone_fill8_ms"] = {peer: v["fill8_device_ms"]
                                               for peer, v in b["rounds_alone"].items()
                                               if peer != "card"}
            except AssertionError as exc:
                run["failed"] = str(exc)
            torch.cuda.empty_cache()
            runs.append(run)
            print(json.dumps(run), flush=True)  # noqa: T201
    out = REPO / "chiprun_out" / "batched_tcp.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(runs, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
