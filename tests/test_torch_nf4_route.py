"""``nf4_dot``'s four kernels: `_route` picks the decode kernel ("gemv"),
the float32 prefill kernel ("f32mma"), the tensor-core kernel ("mma") or
the CUDA-core kernel ("simt") from M, K, N and x's dtype alone; `_gemv_plan` cuts K into whole scale blocks for a
cluster of at most 8 CTAs and puts a CTA on every SM of the H100 at every
llama-3.1-8b site;
CPU tensors take the plain version at any M and launch nothing; and the
level table and the decode kernel's geometry compiled into
``csrc/nf4_dot.cu`` are the port's ``NF4_LEVELS`` bit for bit as float32 and
the wrapper's constants (read from the source text, nothing CUDA imported).
The plain version itself is held to the reference's Pallas kernel by
``test_torch_nf4.py``."""

import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    nf4_kernel as tnk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.utils.cuda_build import (
    CSRC,
)

LLAMA_8B_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
                  "wd": (14336, 4096)}
MIN = tnk.MMA_MIN_M

ROUTES = [
    # (case, m, k, n, dtype, route)
    ("bf16 below MMA_MIN_M", MIN - 1, 4096, 4096, torch.bfloat16, "gemv"),
    ("bf16 at M 2", 2, 4096, 4096, torch.bfloat16, "gemv"),
    ("bf16 at MMA_MIN_M", MIN, 4096, 4096, torch.bfloat16, "mma"),
    ("bf16 prefill chunk", 2048, 4096, 4096, torch.bfloat16, "mma"),
    ("float32 at M 1", 1, 4096, 4096, torch.float32, "gemv"),
    ("float32 at M 2", 2, 4096, 4096, torch.float32, "gemv"),
    ("float32 at M 3", 3, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 8", 8, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 32", 32, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 33", 33, 4096, 4096, torch.float32, "f32mma"),
    ("float32 prefill chunk", 2048, 4096, 4096, torch.float32, "f32mma"),
    ("float32 M 3 N 97", 3, 4096, 97, torch.float32, "simt"),
    ("float32 M 3 K 4100", 3, 4100, 4096, torch.float32, "simt"),
    ("float32 M 3 past GEMV_MAX_K", 3, tnk.GEMV_MAX_K + 8, 4096, torch.float32, "f32mma"),
    ("bf16 M 1 N 4104", 1, 4096, 4104, torch.bfloat16, "simt"),
    ("bf16 M 1 N 97", 1, 128, 97, torch.bfloat16, "simt"),
    ("float32 M 1 N 97", 1, 128, 97, torch.float32, "simt"),
    ("bf16 M 1 K 100 N 96 (ragged in_dim)", 1, 100, 96, torch.bfloat16, "gemv"),
    ("bf16 M 1 at GEMV_MAX_K", 1, tnk.GEMV_MAX_K, 4096, torch.bfloat16, "gemv"),
    ("bf16 M 1 past GEMV_MAX_K", 1, tnk.GEMV_MAX_K + 1, 4096, torch.bfloat16, "simt"),
    ("float32 at MMA_MIN_M", MIN, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 512", 512, 4096, 4096, torch.float32, "f32mma"),
    ("bf16 N not a multiple of 16", 30, 4096, 4104, torch.bfloat16, "simt"),
    ("bf16 N 97", 30, 128, 97, torch.bfloat16, "simt"),
    ("bf16 K not a multiple of 8", 30, 4100, 4096, torch.bfloat16, "simt"),
    ("bf16 K 100", 30, 100, 96, torch.bfloat16, "simt"),
    ("bf16 K 328 N 48 (ragged in_dim, aligned)", 33, 328, 48, torch.bfloat16, "mma"),
] + [(f"llama-3.1-8b {site} M {m}", m, k, n, torch.bfloat16, "gemv" if m == 1 else "mma")
     for site, (k, n) in LLAMA_8B_SITES.items() for m in (1, 30)] + [
    (f"llama-3.1-8b {site} float32 M 1", 1, k, n, torch.float32, "gemv")
    for site, (k, n) in LLAMA_8B_SITES.items()] + [
    (f"llama-3.1-8b {site} float32 M 32", 32, k, n, torch.float32, "f32mma")
    for site, (k, n) in LLAMA_8B_SITES.items()]


@pytest.mark.parametrize("case,m,k,n,dtype,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_table(case, m, k, n, dtype, route):
    assert tnk._route(m, k, n, dtype) == route


@pytest.mark.parametrize("m", [1, 64])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(m):
    gen = torch.Generator().manual_seed(m)
    w = tquant._quantize_leaf_nf4(
        (torch.randn(256, 128, generator=gen) * 0.02).to(torch.bfloat16))
    x = torch.randn(m, 256, generator=gen).to(torch.bfloat16)
    assert tnk._route(m, 256, 128, x.dtype) == ("gemv" if m < tnk.MMA_MIN_M else "mma")
    before = (tnk._launches, tnk._launches_mma, tnk._launches_gemv, tnk._launches_f32mma)
    got = tnk.nf4_dot(x, w)
    assert (tnk._launches, tnk._launches_mma, tnk._launches_gemv,
            tnk._launches_f32mma) == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, 128)
    assert torch.equal(got, tnk.nf4_dot_reference(x, w))


def _source() -> str:
    return (CSRC / tnk.SOURCE).read_text()


def _nearest_float32(literal: str) -> np.float32:
    """The float32 a C compiler makes of `literal` (round to nearest),
    exactly: the candidate around the double nearest the decimal value."""
    exact = Fraction(literal)
    f = np.float32(float(literal))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: abs(Fraction(float(c)) - exact))


def test_cuda_level_table_is_nf4_levels_bit_for_bit():
    src = re.sub(r"//[^\n]*", "", _source())
    match = re.search(r"kLevels\s*\[\s*16\s*\]\s*=\s*\{([^}]*)\}", src)
    assert match, "kLevels[16] = {...} not found in the kernel source"
    tokens = [t.strip() for t in match.group(1).split(",") if t.strip()]
    assert len(tokens) == 16
    for tok in tokens:
        assert re.fullmatch(r"-?\d+\.\d*(e-?\d+)?f", tok), tok
    got = np.array([_nearest_float32(t[:-1]) for t in tokens], np.float32)
    want = np.asarray(tquant.NF4_LEVELS, np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _signature(src: str, name: str):
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert match, f"{name} not found in the kernel source"
    return [" ".join(p.split()) for p in match.group(1).split(",")]


def test_both_entry_points_take_the_same_arguments():
    """The four C entry points take the same 11 arguments; the two split-K
    routes' then take their plan, as `_gemv_plan` and `_f32mma_plan`
    return it, and the float32 prefill route's the scratch for x's terms."""
    src = _source()
    simt = _signature(src, "nf4_dot_launch")
    assert len(simt) == 11
    assert _signature(src, "nf4_dot_mma_launch") == simt
    assert _signature(src, "nf4_dot_gemv_launch") == simt + ["int strip_cols", "int split"]
    assert _signature(src, "nf4_dot_f32mma_launch") == simt + ["int strip_cols", "int split",
                                                               "void* terms"]


def _constant(src: str, name: str) -> int:
    match = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert match, f"{name} not found in the kernel source"
    return int(match.group(1))


def test_gemv_geometry_matches_the_kernel_source():
    src = _source()
    assert _constant(src, "kGemvStrip") == tnk.GEMV_STRIP
    assert _constant(src, "kGemvWarps") == tnk.GEMV_WARPS
    assert _constant(src, "kGemvMaxSplit") == tnk.GEMV_MAX_SPLIT
    assert _constant(src, "kGemvMaxChunk") == tnk.GEMV_MAX_CHUNK
    assert _constant(src, "kRowsPerScale") * 2 == tquant.NF4_BLOCK


PLAN_SHAPES = [(f"llama-3.1-8b {site}", k, n) for site, (k, n) in LLAMA_8B_SITES.items()] + [
    ("ragged K 100", 100, 96), ("ragged K 4100", 4100, 4096), ("K 640 N 16", 640, 16),
    ("K 64", 64, 16), ("GEMV_MAX_K", tnk.GEMV_MAX_K, 28672), ("ragged K 14300", 14300, 6144)]


@pytest.mark.parametrize("case,k,n", PLAN_SHAPES, ids=[c for c, _, _ in PLAN_SHAPES])
@pytest.mark.parametrize("m", [1, 2])
def test_gemv_plan_cuts_k_into_whole_scale_blocks(case, k, n, m):
    """Each rank of the cluster takes ceil(blocks / split) whole 64-row
    scale blocks (the kernel's own cut), at most GEMV_MAX_CHUNK; every rank
    gets one; together they cover in_pad; the split is at most the portable
    cluster size 8; and the plan is a pure function of (m, k, n)."""
    strip, split = tnk._gemv_plan(m, k, n)
    assert strip == tnk.GEMV_STRIP and 1 <= split <= 8
    blocks = -(-k // tquant.NF4_BLOCK)
    chunk = -(-blocks // split)
    ranks = [(r * chunk, min((r + 1) * chunk, blocks)) for r in range(split)]
    assert all(b0 < b1 for b0, b1 in ranks)
    assert ranks[0][0] == 0 and ranks[-1][1] == blocks
    assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
    assert chunk <= tnk.GEMV_MAX_CHUNK
    assert tnk._gemv_plan(m, k, n) == (strip, split) == tnk._gemv_plan(3 - m, k, n)


@pytest.mark.parametrize("site", sorted(LLAMA_8B_SITES))
def test_gemv_plan_fills_the_card_at_every_llama_site(site):
    """At every llama-3.1-8b site the plan launches at least GEMV_FILL_CTAS
    (192) CTAs on the H100's 132 SMs, so every SM has one and most two (4 an
    SM at N = 4096 would need a 17-way split of 128-column strips, past the
    portable cluster size 8), keeps >= 32 KB of weight loads in flight an
    SM (a warp issues the next scale block's 4 KB before it works on this
    one), and gives every warp of a CTA the same number of scale blocks."""
    k, n = LLAMA_8B_SITES[site]
    strip, split = tnk._gemv_plan(1, k, n)
    ctas = -(-n // strip) * split
    assert ctas >= tnk.GEMV_FILL_CTAS >= 132
    blocks = k // tquant.NF4_BLOCK
    per_warp = blocks // (split * tnk.GEMV_WARPS)
    assert blocks == per_warp * split * tnk.GEMV_WARPS
    block_bytes = 32 * strip                         # 32 packed rows x 128 bytes
    in_flight = ctas * tnk.GEMV_WARPS * min(per_warp, 2) * block_bytes
    assert in_flight / 132 >= 32 * 1024
