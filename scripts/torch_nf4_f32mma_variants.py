#!/usr/bin/env python3
"""nf4_dot's float32 prefill route ("f32mma") in several builds of the port.

Each argument is NAME, one of VARIANTS below (``base`` changes nothing):
a copy of this checkout's package with that change to
``csrc/nf4_dot.cu``, made in a new temporary directory under $TMPDIR and
removed at the end; or ``NAME=DIR``, the same copy made in DIR, which
must not hold the package yet, and kept; or a directory that already
holds a copy of the port's package. For each, in turn and again in reverse order, a process
of its own builds that copy's kernels and times the route at
llama-3.1-8b's four sites at M = 8 and 32 with float32 x (median of 25
launches, CUDA events, the L2 flushed by a 1 GiB write before each), held
to the plain version first (1e-5 of max|plain|; max|kernel - plain| over
max|plain| is kept as ``<site>_rel_err``). One JSON object a run, also
appended to ``chiprun_out/nf4_f32mma_variants.jsonl``.

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_nf4_f32mma_variants.py base products3
"""

from __future__ import annotations

import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch"
OUT = ROOT / "chiprun_out" / "nf4_f32mma_variants.jsonl"
SITES = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("wgu", 4096, 28672),
         ("wd", 14336, 4096))
# Each variant: (old, new) replacements in csrc/nf4_dot.cu.
VARIANTS = {
    "base": (),
    # Three products a block, (0,0), (1,0), (0,1), instead of five.
    "products3": (("constexpr int kF32MmaProducts = 5;", "constexpr int kF32MmaProducts = 3;"),),
    # M tiles of 32 rows (three CTAs an SM) instead of 16 (four).
    "rows32": (("constexpr int kF32MmaMaxFrags = 2;", "constexpr int kF32MmaMaxFrags = 4;"),
               ("static_assert(4 * (F32MmaTile", "static_assert(3 * (F32MmaTile")),
    # 16 copies of the pair table (conflict-free lookups, 32 KB) instead of 8.
    "copies16": (("constexpr int kF32MmaCopies = 8;", "constexpr int kF32MmaCopies = 16;"),
                 ("static_assert(4 * (F32MmaTile", "static_assert(3 * (F32MmaTile")),
    # A ring of 4 scale blocks instead of 3.
    "stages4": (("constexpr int kF32MmaStages = 3;", "constexpr int kF32MmaStages = 4;"),
                ("static_assert(4 * (F32MmaTile", "static_assert(3 * (F32MmaTile")),
}


def make_copy(name: str, directory: pathlib.Path) -> pathlib.Path:
    if name not in VARIANTS:
        raise SystemExit(f"unknown variant {name!r}: one of {sorted(VARIANTS)}")
    if (directory / PORT).exists():
        raise SystemExit(f"{directory / PORT} exists: pass a new directory")
    shutil.copytree(ROOT / PORT, directory / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    source = directory / PORT / "csrc" / "nf4_dot.cu"
    text = source.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} not found once")
        text = text.replace(old, new)
    source.write_text(text)
    return directory


def time_one(label: str, directory: str) -> dict:
    sys.path.insert(0, directory)
    import torch
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
        quant,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
        nf4_kernel as nk,
    )

    nk.build()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ms(fn, reps=25):
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

    out = {"variant": label}
    for site, k, n in SITES:
        w = quant._quantize_leaf_nf4(
            (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16))
        errs = []
        for m in (8, 32):
            x = torch.randn((m, k), generator=gen, device="cuda")
            ref = nk.nf4_dot_reference(x, w)
            err = ((nk._launch(x, w, "f32mma") - ref).abs().max() / ref.abs().max()).item()
            if not err <= 1e-5:
                raise AssertionError(f"{directory} {site} M={m}: {err} of max|plain|")
            errs.append(err)
            out[f"{site}_M{m}"] = ms(lambda: nk._launch(x, w, "f32mma"))
        out[site + "_rel_err"] = max(errs)
    for m in (8, 32):
        out[f"layer_M{m}"] = sum(out[f"{site}_M{m}"] for site, _, _ in SITES)
    out["max_rel_err"] = max(out[site + "_rel_err"] for site, _, _ in SITES)
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        line = json.dumps(time_one(argv[1], argv[2]))
        print(line, flush=True)  # noqa: T201
        OUT.parent.mkdir(exist_ok=True)
        with OUT.open("a") as f:
            f.write(line + "\n")
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)  # noqa: T201
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)  # noqa: T201
    runs, made = [], []
    try:
        for arg in argv:
            name, _, directory = arg.rpartition("=")
            if arg in VARIANTS:
                made.append(pathlib.Path(tempfile.mkdtemp(prefix=f"nf4_f32mma_{arg}_")))
                runs.append((arg, str(make_copy(arg, made[-1]))))
            elif name:
                runs.append((name, str(make_copy(name, pathlib.Path(directory)))))
            else:
                runs.append((arg, arg))
        for label, directory in runs + runs[::-1]:
            subprocess.run([sys.executable, __file__, "--one", label, directory], check=True)
    finally:
        for directory in made:
            shutil.rmtree(directory)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
