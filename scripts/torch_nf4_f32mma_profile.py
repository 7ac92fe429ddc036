#!/usr/bin/env python3
"""Where a CTA of nf4_dot's float32 prefill kernel spends its time.

Copies this checkout's port into DIR (a new directory; by default a
temporary one under $TMPDIR, removed at the end), adds timers to ``nf4_f32mma_kernel`` in the copy (``%globaltimer`` at the
CTA's start, after its set-up, after its loop, after the first cluster
barrier and at its end; ``clock64`` cycles of each scale block's wait at
the barrier and of its products), builds it, runs each llama-3.1-8b site
at M = 8 and 32 with float32 x once, and prints one JSON object a run:
the CTAs and SMs used, the span from the first CTA's start to the last
one's end, the spread of the CTAs' starts (the cluster scheduling), and
the 10th / 50th / 90th percentiles over CTAs of each phase (microseconds;
kilocycles a block for the loop's parts). The timers cost a few percent;
the kernel's own time is in ``chip_smoke.py``.

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_nf4_f32mma_profile.py [DIR]
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
TIMERS = (
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ unsigned long long g_prof[1 << 22];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"
     "namespace {\n\nconstexpr int kThreads"),
    ("  unsigned char* ring = gsmem + kF32MmaTableBytes;\n",
     "  const unsigned long long t0 = gtime();\n"
     "  unsigned char* ring = gsmem + kF32MmaTableBytes;\n"),
    ("  for (int i = 0; i < count; ++i) {\n    // Block i has landed;",
     "  const unsigned long long t1 = gtime();\n"
     "  unsigned long long waited = 0, worked = 0;\n"
     "  for (int i = 0; i < count; ++i) {\n"
     "    const unsigned long long ta = clock64();\n"
     "    // Block i has landed;"),
    ("    cp_async_commit();\n    f32mma_block<NF>(acc, ring + (i % kF32MmaStages) * T::kSlotBytes, "
     "tab, warp, g, c);\n  }\n",
     "    cp_async_commit();\n"
     "    const unsigned long long tb = clock64();\n"
     "    f32mma_block<NF>(acc, ring + (i % kF32MmaStages) * T::kSlotBytes, tab, warp, g, c);\n"
     "    if (acc[0][0][0] == 12345.f) ++waited;  // orders the clock after the products\n"
     "    waited += tb - ta;\n"
     "    worked += clock64() - tb;\n"
     "  }\n"
     "  const unsigned long long t2 = gtime();\n"),
    ("  cluster.sync();\n  const int col = threadIdx.x;\n",
     "  cluster.sync();\n  const unsigned long long t3 = gtime();\n"
     "  const int col = threadIdx.x;\n"),
    ("      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v;\n    }\n  }\n}\n",
     "      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v;\n    }\n  }\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    unsigned long long* o = g_prof + 10ull * (blockIdx.x + gridDim.x * (blockIdx.y + "
     "gridDim.y * blockIdx.z));\n"
     "    o[0] = t0; o[1] = t1; o[2] = t2; o[3] = t3; o[4] = gtime(); o[5] = sm;\n"
     "    o[6] = waited; o[7] = worked;\n"
     "  }\n}\n"),
)


def patched_copy(directory: pathlib.Path) -> pathlib.Path:
    if (directory / PORT).exists():
        raise SystemExit(f"{directory / PORT} exists: pass a new directory")
    shutil.copytree(ROOT / PORT, directory / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    source = directory / PORT / "csrc" / "nf4_dot.cu"
    text = source.read_text()
    for old, new in TIMERS:
        if text.count(old) != 1:
            raise SystemExit(f"timer anchor not found once: {old[:60]!r}")
        text = text.replace(old, new)
    text += ('\nextern "C" int nf4_prof_read(void* dst, int n) {\n'
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
    if argv:
        return profile(patched_copy(pathlib.Path(argv[0])))
    directory = pathlib.Path(tempfile.mkdtemp(prefix="nf4_f32mma_profile_"))
    try:
        return profile(patched_copy(directory))
    finally:
        shutil.rmtree(directory)


def profile(directory: pathlib.Path) -> int:
    sys.path.insert(0, str(directory))
    import torch
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
        quant,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
        nf4_kernel as nk,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)  # noqa: T201
    lib = nk._library()
    lib.nf4_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, k, n in SITES:
        w = quant._quantize_leaf_nf4(
            (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16))
        for m in (8, 32):
            x = torch.randn((m, k), generator=gen, device="cuda")
            rows = 8 if m <= 8 else 8 * nk.F32MMA_MAX_FRAGS
            _, split = nk._f32mma_plan(m, k, n)
            ctas = split * -(-m // rows) * -(-n // nk.GEMV_STRIP)
            nk._launch(x, w, "f32mma")                 # warm
            flush.zero_()
            torch.cuda.synchronize()
            nk._launch(x, w, "f32mma")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (ctas * MARKS))()
            if lib.nf4_prof_read(buf, ctas) != 0:
                raise RuntimeError("cudaMemcpyFromSymbol failed")
            marks = [buf[i * MARKS:(i + 1) * MARKS] for i in range(ctas)]
            start = min(r[0] for r in marks)
            blocks = -(-(k // 64) // split)
            print(json.dumps({  # noqa: T201
                "site": site, "M": m, "K": k, "N": n, "split": split, "ctas": ctas,
                "sms": len({r[5] for r in marks}),
                "ctas_per_sm_max": max(collections.Counter(r[5] for r in marks).values()),
                "span_us": (max(r[4] for r in marks) - start) / 1e3,
                "start_us": quantiles([r[0] - start for r in marks], 1e3),
                "setup_us": quantiles([r[1] - r[0] for r in marks], 1e3),
                "loop_us": quantiles([r[2] - r[1] for r in marks], 1e3),
                "wait_kcycles_a_block": quantiles([r[6] / blocks for r in marks], 1e3),
                "products_kcycles_a_block": quantiles([r[7] / blocks for r in marks], 1e3),
                "sums_and_barrier_us": quantiles([r[3] - r[2] for r in marks], 1e3),
                "push_and_rows_us": quantiles([r[4] - r[3] for r in marks], 1e3)}),
                flush=True)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
