#!/usr/bin/env python3
"""Where a CTA of a kernel's float32 route ("f32mma") spends its time.

KERNEL is ``int8_dot`` (``int8_f32mma_kernel``) or ``nf4_dot``
(``nf4_f32mma_kernel``). Copies this checkout's port into DIR (a new
directory; by default a temporary one under $TMPDIR, removed at the end),
adds timers to the kernel in the copy (``%globaltimer`` at the CTA's
start, before its loop, after its loop, after the first cluster barrier
and at its end; ``clock64`` cycles of each step's wait at the barrier and
of its products, a step being a 128-row stage of int8 weights or a
64-row NF4 scale block), builds it, runs each llama-3.1-8b site at M = 8
and 32 with float32 x once, L2 cold, and prints one JSON object a run: the
CTAs and SMs used, the span from the first CTA's start to the last one's
end, the spread of the CTAs' starts (the cluster scheduling), and the
10th / 50th / 90th percentiles over CTAs of each phase (microseconds;
kilocycles a step for the loop's parts). The timers cost a few percent;
the kernel's own time is in ``chip_smoke.py``.

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_f32mma_profile.py int8_dot [DIR]
    python3 scripts/torch_f32mma_profile.py nf4_dot [DIR]
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch"
SITES = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("wgu", 4096, 28672),
         ("wd", 14336, 4096))
MARKS = 10  # words a CTA: 5 times, its SM, cycles waiting, cycles computing
HEADER = ("namespace {\n\nconstexpr int kThreads",
          "__device__ unsigned long long g_prof[1 << 22];\n"
          "__device__ __forceinline__ unsigned long long gtime() {\n"
          "  unsigned long long t;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n"
          "}\n"
          "namespace {\n\nconstexpr int kThreads")
LOOP_TOP = ("  const unsigned long long t1 = gtime();\n"
            "  unsigned long long waited = 0, worked = 0;\n"
            "  for (int i = 0; i < count; ++i) {\n"
            "    const unsigned long long ta = clock64();\n")
RECORD = ("  __syncthreads();\n"
          "  if (threadIdx.x == 0) {\n"
          "    unsigned sm;\n"
          "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
          "    unsigned long long* o = g_prof + 10ull * (blockIdx.x + gridDim.x * (blockIdx.y + "
          "gridDim.y * blockIdx.z));\n"
          "    o[0] = t0; o[1] = t1; o[2] = t2; o[3] = t3; o[4] = gtime(); o[5] = sm;\n"
          "    o[6] = waited; o[7] = worked;\n"
          "  }\n}\n")
BARRIER = ("  cluster.sync();\n  const int col = threadIdx.x;\n",
           "  cluster.sync();\n  const unsigned long long t3 = gtime();\n"
           "  const int col = threadIdx.x;\n")


def _timed(call: str, acc: str) -> tuple:
    """The loop's products `call` timed after the step's wait; `acc` is a
    sum the products write, read so the clock follows them."""
    return (call + "\n  }\n",
            "    const unsigned long long tb = clock64();\n" + call + "\n"
            f"    if ({acc} == 12345.f) ++waited;  // orders the clock after the products\n"
            "    waited += tb - ta;\n"
            "    worked += clock64() - tb;\n"
            "  }\n"
            "  const unsigned long long t2 = gtime();\n")


# Each kernel: its source and the (old, new) insertions of its timers.
KERNELS = {
    "int8_dot": ("int8_dot.cu", (
        HEADER,
        ("  const int m0 = blockIdx.y * T::kRows;\n",
         "  const unsigned long long t0 = gtime();\n  const int m0 = blockIdx.y * T::kRows;\n"),
        ("  for (int i = 0; i < count; ++i) {\n    // As int8_gemv_kernel's loop:",
         LOOP_TOP + "    // As int8_gemv_kernel's loop:"),
        _timed("    f32mma_rows<NF>(d, w, reinterpret_cast<const float*>(slot + kGemvStageBytes)"
               " + 32 * warp,\n                    g, c);", "d[0][0][0]"),
        BARRIER,
        ("      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v * "
         "s[strip0 + col];\n    }\n  }\n}\n",
         "      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v * "
         "s[strip0 + col];\n    }\n  }\n" + RECORD))),
    "nf4_dot": ("nf4_dot.cu", (
        HEADER,
        ("  unsigned char* ring = gsmem + kF32MmaTableBytes;\n",
         "  const unsigned long long t0 = gtime();\n"
         "  unsigned char* ring = gsmem + kF32MmaTableBytes;\n"),
        ("  for (int i = 0; i < count; ++i) {\n    // Block i has landed;",
         LOOP_TOP + "    // Block i has landed;"),
        _timed("    f32mma_block<NF>(acc, ring + (i % kF32MmaStages) * T::kSlotBytes, tab, "
               "warp, g, c);", "acc[0][0][0]"),
        BARRIER,
        ("      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v;\n"
         "    }\n  }\n}\n",
         "      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v;\n"
         "    }\n  }\n" + RECORD))),
}


def patched_copy(kernel: str, directory: pathlib.Path) -> pathlib.Path:
    if (directory / PORT).exists():
        raise SystemExit(f"{directory / PORT} exists: pass a new directory")
    source_name, timers = KERNELS[kernel]
    shutil.copytree(ROOT / PORT, directory / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    source = directory / PORT / "csrc" / source_name
    text = source.read_text()
    for old, new in timers:
        if text.count(old) != 1:
            raise SystemExit(f"timer anchor not found once: {old[:60]!r}")
        text = text.replace(old, new)
    text += ('\nextern "C" int f32mma_prof_read(void* dst, int n) {\n'
             '  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_prof, '
             f'static_cast<size_t>(n) * {MARKS} * 8));\n}}\n')
    source.write_text(text)
    return directory


def quantiles(values, scale=1.0):
    if len(values) < 3:
        return [round(v / scale, 2) for v in values]
    q = statistics.quantiles(values, n=10)
    return [round(q[i] / scale, 2) for i in (0, 4, 8)]


def main(argv) -> int:
    if not argv or argv[0] not in KERNELS or len(argv) > 2:
        print(__doc__, file=sys.stderr)  # noqa: T201
        return 2
    kernel = argv[0]
    if len(argv) == 2:
        return profile(kernel, patched_copy(kernel, pathlib.Path(argv[1])))
    directory = pathlib.Path(tempfile.mkdtemp(prefix=f"{kernel}_f32mma_profile_"))
    try:
        return profile(kernel, patched_copy(kernel, directory))
    finally:
        shutil.rmtree(directory)


def _site(kernel: str, mod, quant, torch, gen, k: int, n: int):
    """(launch(x), rows of an M tile at M = m, plan(m), rows of a loop
    step) of the float32 route at one site, on random weights."""
    if kernel == "int8_dot":
        q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 + 1e-4
        return (lambda x: mod._launch(x, q, s, "f32mma"),
                lambda m: mod.F32MMA_ROWS * (1 if m <= mod.F32MMA_ROWS else mod.F32MMA_MAX_FRAGS),
                lambda m: mod._gemv_plan(m, k, n), mod.GEMV_ROWS)
    w = quant._quantize_leaf_nf4(
        (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16))
    return (lambda x: mod._launch(x, w, "f32mma"),
            lambda m: 8 if m <= 8 else 8 * mod.F32MMA_MAX_FRAGS,
            lambda m: mod._f32mma_plan(m, k, n), 64)


def profile(kernel: str, directory: pathlib.Path) -> int:
    sys.path.insert(0, str(directory))
    from importlib import import_module

    import torch

    mod = import_module(f"{PORT}.ops.{kernel.replace('_dot', '')}_kernel")
    quant = import_module(f"{PORT}.models.quant")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)  # noqa: T201
    lib = mod._library()
    lib.f32mma_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, k, n in SITES:
        launch, tile_rows, plan, step_rows = _site(kernel, mod, quant, torch, gen, k, n)
        for m in (8, 32):
            x = torch.randn((m, k), generator=gen, device="cuda")
            _, split = plan(m)
            ctas = split * -(-m // tile_rows(m)) * -(-n // mod.GEMV_STRIP)
            launch(x)                                  # warm
            flush.zero_()
            torch.cuda.synchronize()
            launch(x)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (ctas * MARKS))()
            if lib.f32mma_prof_read(buf, ctas) != 0:
                raise RuntimeError("cudaMemcpyFromSymbol failed")
            marks = [buf[i * MARKS:(i + 1) * MARKS] for i in range(ctas)]
            start = min(r[0] for r in marks)
            steps = -(-(k // step_rows) // split)
            print(json.dumps({  # noqa: T201
                "kernel": kernel, "site": site, "M": m, "K": k, "N": n, "split": split,
                "ctas": ctas, "sms": len({r[5] for r in marks}),
                "ctas_per_sm_max": max(collections.Counter(r[5] for r in marks).values()),
                "span_us": (max(r[4] for r in marks) - start) / 1e3,
                "start_us": quantiles([r[0] - start for r in marks], 1e3),
                "setup_us": quantiles([r[1] - r[0] for r in marks], 1e3),
                "loop_us": quantiles([r[2] - r[1] for r in marks], 1e3),
                "wait_kcycles_a_step": quantiles([r[6] / steps for r in marks], 1e3),
                "products_kcycles_a_step": quantiles([r[7] / steps for r in marks], 1e3),
                "sums_and_barrier_us": quantiles([r[3] - r[2] for r in marks], 1e3),
                "push_and_rows_us": quantiles([r[4] - r[3] for r in marks], 1e3)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
