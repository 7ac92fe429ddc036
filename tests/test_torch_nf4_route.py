"""``nf4_dot``'s two kernels: `_route` picks the tensor-core kernel ("mma")
or the CUDA-core kernel ("simt") from M, K, N and x's dtype alone; CPU
tensors take the plain version at any M and launch nothing; and the level
table compiled into ``csrc/nf4_dot.cu`` is the port's ``NF4_LEVELS`` bit for
bit as float32 (read from the source text, nothing CUDA imported). The
plain version itself is held to the reference's Pallas kernel by
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
    ("bf16 below MMA_MIN_M", MIN - 1, 4096, 4096, torch.bfloat16, "simt"),
    ("bf16 at MMA_MIN_M", MIN, 4096, 4096, torch.bfloat16, "mma"),
    ("bf16 prefill chunk", 2048, 4096, 4096, torch.bfloat16, "mma"),
    ("float32 at M 1", 1, 4096, 4096, torch.float32, "simt"),
    ("float32 at MMA_MIN_M", MIN, 4096, 4096, torch.float32, "simt"),
    ("float32 at M 512", 512, 4096, 4096, torch.float32, "simt"),
    ("bf16 N not a multiple of 16", 30, 4096, 4104, torch.bfloat16, "simt"),
    ("bf16 N 97", 30, 128, 97, torch.bfloat16, "simt"),
    ("bf16 K not a multiple of 8", 30, 4100, 4096, torch.bfloat16, "simt"),
    ("bf16 K 100", 30, 100, 96, torch.bfloat16, "simt"),
    ("bf16 K 328 N 48 (ragged in_dim, aligned)", 33, 328, 48, torch.bfloat16, "mma"),
] + [(f"llama-3.1-8b {site} M {m}", m, k, n, torch.bfloat16, "simt" if m == 1 else "mma")
     for site, (k, n) in LLAMA_8B_SITES.items() for m in (1, 30)]


@pytest.mark.parametrize("case,m,k,n,dtype,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_table(case, m, k, n, dtype, route):
    assert tnk._route(m, k, n, dtype) == route


@pytest.mark.parametrize("m", [1, 64])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(m):
    gen = torch.Generator().manual_seed(m)
    w = tquant._quantize_leaf_nf4(
        (torch.randn(256, 128, generator=gen) * 0.02).to(torch.bfloat16))
    x = torch.randn(m, 256, generator=gen).to(torch.bfloat16)
    assert tnk._route(m, 256, 128, x.dtype) == ("simt" if m < tnk.MMA_MIN_M else "mma")
    before = (tnk._launches, tnk._launches_mma)
    got = tnk.nf4_dot(x, w)
    assert (tnk._launches, tnk._launches_mma) == before
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
    src = _source()
    simt = _signature(src, "nf4_dot_launch")
    assert len(simt) == 11
    assert _signature(src, "nf4_dot_mma_launch") == simt
