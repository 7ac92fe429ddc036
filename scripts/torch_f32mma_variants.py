#!/usr/bin/env python3
"""A kernel's float32 route ("f32mma") in several builds of the port.

KERNEL is ``int8_dot`` or ``nf4_dot``. Each further argument is NAME, one
of VARIANTS[KERNEL] below (``base`` changes nothing): a copy of this
checkout's package with that change to the kernel's source, made in a new
temporary directory under $TMPDIR and removed at the end; or
``NAME=DIR``, the same copy made in DIR, which must not hold the package
yet, and kept; or a directory that already holds a copy of the port's
package. For each, in turn and again in reverse order, a process of its
own builds that copy's kernels and times the route at llama-3.1-8b's four
sites at M = 8 and 32 with float32 x (median of 25 launches, CUDA events,
the L2 flushed by a 1 GiB write before each), held to the plain version
first (1e-5 of max|plain|; max|kernel - plain| over max|plain| is kept as
``<site>_rel_err``) unless the variant is a timing bound whose sums are
wrong by design (TIMING_ONLY: its error is reported, not held). One JSON
object a run, also appended to ``chiprun_out/f32mma_variants.jsonl``.

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_f32mma_variants.py int8_dot base nosplit
    python3 scripts/torch_f32mma_variants.py nf4_dot base products3
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
OUT = ROOT / "chiprun_out" / "f32mma_variants.jsonl"
SITES = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("wgu", 4096, 28672),
         ("wd", 14336, 4096))
SOURCES = {"int8_dot": "int8_dot.cu", "nf4_dot": "nf4_dot.cu"}
# int8_dot's push of a rank's sums into the owner's slots: 16 bytes a store
# (the kernel's), and a column a thread (the push1 variant).
PUSH_16_BYTES = """  const int c4 = 4 * (threadIdx.x & 31);
  for (int j = 0; j < per; ++j) {
    for (int o = warp; o < split && j * split + o < rows; o += kGemvWarps) {
      const int m = j * split + o;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) {
        const float* src = wsum + w * T::kRows * kF32MmaSumRow + f32mma_sum_at(m, c4);
        v.x += src[0];
        v.y += src[1];
        v.z += src[2];
        v.w += src[3];
      }
      *reinterpret_cast<float4*>(cluster.map_shared_rank(slots, o) +
                                 (rank * per + j) * kGemvStrip + c4) = v;
    }
  }
"""
PUSH_4_BYTES = """  for (int j = 0; j < per; ++j) {
    for (int o = 0; o < split && j * split + o < rows; ++o) {
      const int at = f32mma_sum_at(j * split + o, col);
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) v += wsum[w * T::kRows * kF32MmaSumRow + at];
      cluster.map_shared_rank(slots, o)[(rank * per + j) * kGemvStrip + col] = v;
    }
  }
"""
# Each kernel's variants: (old, new) replacements in its source.
VARIANTS = {
    "int8_dot": {
        "base": (),
        # Two bf16 terms of x instead of three.
        "terms2": (("constexpr int kF32MmaTerms = 3;", "constexpr int kF32MmaTerms = 2;"),),
        # A ring of 4 stages instead of 3 (two CTAs an SM at 16 rows).
        "stages4": (("constexpr int kF32MmaStages = 3;", "constexpr int kF32MmaStages = 4;"),
                    ("static_assert(3 * (F32MmaTile", "static_assert(2 * (F32MmaTile")),
        # M tiles of 8 rows at every M instead of 16 past M = 8.
        "rows8": (("constexpr int kF32MmaMaxFrags = 2;", "constexpr int kF32MmaMaxFrags = 1;"),),
        # Each thread pushes one column of a row at a time into the owner's
        # slots (a 4-byte store, every row) instead of four (16 bytes).
        "push1": ((PUSH_16_BYTES, PUSH_4_BYTES),),
        # The bound on what a split pre-pass could save: x's float32 bits taken
        # as the B registers, no split instruction (the sums are wrong).
        "nosplit": (("    const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);\n"
                     "    b[u] = *reinterpret_cast<const uint32_t*>(&p);\n"
                     "    v.x -= __low2float(p);\n"
                     "    v.y -= __high2float(p);\n",
                     "    b[u] = __float_as_uint(u & 1 ? v.y : v.x);\n"),),
    },
    "nf4_dot": {
        "base": (),
        # Three products a block, (0,0), (1,0), (0,1), instead of five.
        "products3": (("constexpr int kF32MmaProducts = 5;",
                       "constexpr int kF32MmaProducts = 3;"),),
        # M tiles of 32 rows (three CTAs an SM) instead of 16 (four).
        "rows32": (("constexpr int kF32MmaMaxFrags = 2;", "constexpr int kF32MmaMaxFrags = 4;"),
                   ("static_assert(4 * (F32MmaTile", "static_assert(3 * (F32MmaTile")),
        # 16 copies of the pair table (conflict-free lookups, 32 KB) instead of 8.
        "copies16": (("constexpr int kF32MmaCopies = 8;", "constexpr int kF32MmaCopies = 16;"),
                     ("static_assert(4 * (F32MmaTile", "static_assert(3 * (F32MmaTile")),
        # A ring of 4 scale blocks instead of 3.
        "stages4": (("constexpr int kF32MmaStages = 3;", "constexpr int kF32MmaStages = 4;"),
                    ("static_assert(4 * (F32MmaTile", "static_assert(3 * (F32MmaTile")),
    },
}
TIMING_ONLY = {("int8_dot", "nosplit")}


def make_copy(kernel: str, name: str, directory: pathlib.Path) -> pathlib.Path:
    if name not in VARIANTS[kernel]:
        raise SystemExit(f"unknown variant {name!r}: one of {sorted(VARIANTS[kernel])}")
    if (directory / PORT).exists():
        raise SystemExit(f"{directory / PORT} exists: pass a new directory")
    shutil.copytree(ROOT / PORT, directory / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    source = directory / PORT / "csrc" / SOURCES[kernel]
    text = source.read_text()
    for old, new in VARIANTS[kernel][name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} not found once")
        text = text.replace(old, new)
    source.write_text(text)
    return directory


def time_one(kernel: str, label: str, directory: str) -> dict:
    sys.path.insert(0, directory)
    from importlib import import_module

    import torch

    mod = import_module(f"{PORT}.ops.{kernel.replace('_dot', '')}_kernel")
    quant = import_module(f"{PORT}.models.quant")
    mod.build()
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

    out = {"kernel": kernel, "variant": label}
    for site, k, n in SITES:
        if kernel == "int8_dot":
            q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
            s = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 + 1e-4
            dot = lambda x: mod._launch(x, q, s, "f32mma")        # noqa: E731
            plain = lambda x: mod.int8_dot_reference(x, q, s)     # noqa: E731
        else:
            w = quant._quantize_leaf_nf4(
                (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16))
            dot = lambda x: mod._launch(x, w, "f32mma")           # noqa: E731
            plain = lambda x: mod.nf4_dot_reference(x, w)         # noqa: E731
        errs = []
        for m in (8, 32):
            x = torch.randn((m, k), generator=gen, device="cuda")
            ref = plain(x)
            err = ((dot(x) - ref).abs().max() / ref.abs().max()).item()
            if not err <= 1e-5 and (kernel, label) not in TIMING_ONLY:
                raise AssertionError(f"{directory} {site} M={m}: {err} of max|plain|")
            errs.append(err)
            out[f"{site}_M{m}"] = ms(lambda: dot(x))
        out[site + "_rel_err"] = max(errs)
    for m in (8, 32):
        out[f"layer_M{m}"] = sum(out[f"{site}_M{m}"] for site, _, _ in SITES)
    out["max_rel_err"] = max(out[site + "_rel_err"] for site, _, _ in SITES)
    return out


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--one":
        line = json.dumps(time_one(*argv[1:]))
        print(line, flush=True)  # noqa: T201
        OUT.parent.mkdir(exist_ok=True)
        with OUT.open("a") as f:
            f.write(line + "\n")
        return 0
    if len(argv) < 2 or argv[0] not in VARIANTS:
        print(__doc__, file=sys.stderr)  # noqa: T201
        return 2
    kernel = argv[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)  # noqa: T201
    runs, made = [], []
    try:
        for arg in argv[1:]:
            name, _, directory = arg.rpartition("=")
            if arg in VARIANTS[kernel]:
                made.append(pathlib.Path(tempfile.mkdtemp(prefix=f"{kernel}_f32mma_{arg}_")))
                runs.append((arg, str(make_copy(kernel, arg, made[-1]))))
            elif name:
                runs.append((name, str(make_copy(kernel, name, pathlib.Path(directory)))))
            else:
                runs.append((arg, arg))
        for label, directory in runs + runs[::-1]:
            subprocess.run([sys.executable, __file__, "--one", kernel, label, directory],
                           check=True)
    finally:
        for directory in made:
            shutil.rmtree(directory)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
