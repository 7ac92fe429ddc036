#!/usr/bin/env python3
"""int8_dot's batched route ("f32mma") in several builds of the port.

Each argument is a directory holding a copy of the port's package (for
example a checkout whose ``csrc/int8_dot.cu`` has another
``kF32MmaStages``). For each, in turn and again in reverse order, a
process of its own builds that copy's kernels and times the route at
llama-3.1-8b's four sites at M = 8 with float32 x (median of 40 launches,
CUDA events, the L2 flushed by a 1 GiB write before each), held to the
plain version first (1e-5 of max|plain|; max|kernel - plain| over
max|plain| is kept as ``<site>_rel_err``). One JSON object a run, also
appended to ``chiprun_out/f32mma_variants.jsonl``.

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_f32mma_variants.py DIR_A DIR_B
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

OUT = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out" / "f32mma_variants.jsonl"

SITES = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("wgu", 4096, 28672),
         ("wd", 14336, 4096))


def time_one(directory: str) -> dict:
    sys.path.insert(0, directory)
    import torch
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
        int8_kernel as ik,
    )

    ik.build()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ms(fn, reps=40):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    out = {"variant": directory}
    for site, k, n in SITES:
        q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 + 1e-4
        x = torch.randn((8, k), generator=gen, device="cuda")
        ref = ik.int8_dot_reference(x, q, s)
        err = ((ik._launch(x, q, s, "f32mma") - ref).abs().max() / ref.abs().max()).item()
        if not err <= 1e-5:
            raise AssertionError(f"{directory} {site}: {err} of max|plain|")
        out[site + "_rel_err"] = err
        out[site] = ms(lambda: ik._launch(x, q, s, "f32mma"))
    out["layer"] = sum(out[site] for site, _, _ in SITES)
    out["max_rel_err"] = max(out[site + "_rel_err"] for site, _, _ in SITES)
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        line = json.dumps(time_one(argv[1]))
        print(line, flush=True)  # noqa: T201
        OUT.parent.mkdir(exist_ok=True)
        with OUT.open("a") as f:
            f.write(line + "\n")
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: T201
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)
    for directory in list(argv) + list(reversed(argv)):
        rc = subprocess.run([sys.executable, __file__, "--one", directory]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
