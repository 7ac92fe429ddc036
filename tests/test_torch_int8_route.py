"""``int8_dot``'s four kernels: `_route` picks the decode kernel ("gemv"),
the float32 kernel ("f32mma"), the tensor-core kernel ("mma") or
the CUDA-core kernel ("simt") from M, K, N and x's dtype alone; CPU
tensors take the plain version at any M and launch nothing; the C entry
points of ``csrc/int8_dot.cu`` take the same
arguments (read from the source text, nothing CUDA imported); and the
plain version agrees with the reference's Pallas kernel, run interpreted,
at prefill M with bf16 x. The decode kernel's plan and its decode-M
agreement are in ``test_torch_int8_gemv.py``, the float32 route's in
``test_torch_int8_f32mma.py``."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    one_torch_thread,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    quant as jquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    int8_kernel as jk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    array_to_torch,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    int8_kernel as tk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.utils.cuda_build import (
    CSRC,
)

LLAMA_8B_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
                  "wd": (14336, 4096)}
MIN = tk.MMA_MIN_M
# bf16 outputs of two float32 sums in different orders, each rounded once:
# max|a - b| <= 2^-7 * max|b| (one bf16 ulp at the output's scale), the
# tolerance chip_smoke.py holds the kernels to on the card.
BF16_TOL = 2.0 ** -7

ROUTES = [
    # (case, m, k, n, dtype, route)
    ("bf16 below MMA_MIN_M", MIN - 1, 4096, 4096, torch.bfloat16, "simt"),
    ("bf16 at MMA_MIN_M", MIN, 4096, 4096, torch.bfloat16, "mma"),
    ("bf16 prefill chunk", 2048, 4096, 4096, torch.bfloat16, "mma"),
    ("float32 at M 1", 1, 4096, 4096, torch.float32, "gemv"),
    ("float32 at MMA_MIN_M", MIN, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 512", 512, 4096, 4096, torch.float32, "f32mma"),
    ("float32 prefill chunk", 2048, 14336, 4096, torch.float32, "f32mma"),
    ("bf16 N not a multiple of 16", 30, 4096, 4104, torch.bfloat16, "simt"),
    ("bf16 N 97", 30, 128, 97, torch.bfloat16, "simt"),
    ("bf16 K not a multiple of 8", 30, 4100, 4096, torch.bfloat16, "simt"),
    ("bf16 K 100", 30, 100, 96, torch.bfloat16, "simt"),
    ("bf16 K 328 N 48 (K tail inside a step)", 33, 328, 48, torch.bfloat16, "mma"),
    ("bf16 at M 1", 1, 4096, 4096, torch.bfloat16, "gemv"),
    ("bf16 at GEMV_MAX_M", tk.GEMV_MAX_M, 4096, 4096, torch.bfloat16, "gemv"),
    ("bf16 past GEMV_MAX_M", tk.GEMV_MAX_M + 1, 4096, 4096, torch.bfloat16, "simt"),
    ("float32 at GEMV_MAX_M", tk.GEMV_MAX_M, 4096, 4096, torch.float32, "gemv"),
    ("float32 past GEMV_MAX_M", tk.GEMV_MAX_M + 1, 4096, 4096, torch.float32, "f32mma"),
    ("bf16 M 1 ragged K 100", 1, 100, 96, torch.bfloat16, "gemv"),
    ("float32 M 2 ragged K 4100", 2, 4100, 4112, torch.float32, "gemv"),
    ("bf16 M 1 N not a multiple of 16", 1, 4096, 4104, torch.bfloat16, "simt"),
    ("float32 M 2 N 97", 2, 128, 97, torch.float32, "simt"),
    ("bf16 M 1 K at GEMV_MAX_K", 1, tk.GEMV_MAX_K, 4096, torch.bfloat16, "gemv"),
    ("bf16 M 1 K past the x stage", 1, tk.GEMV_MAX_K + 1, 4096, torch.bfloat16, "simt"),
    ("float32 M 1 K past the x stage", 1, tk.GEMV_MAX_K + 32, 48, torch.float32, "simt"),
    ("float32 at M 3", 3, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 5", 5, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 8 (the batched round)", 8, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at F32MMA_ROWS (one 8-row tile)", tk.F32MMA_ROWS, 14336, 4096, torch.float32,
     "f32mma"),
    ("float32 at M 9", 9, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 16", 16, 4096, 4096, torch.float32, "f32mma"),
    ("float32 at M 33 (a failover replay)", 33, 4096, 28672, torch.float32, "f32mma"),
    ("float32 M 32 K past the plan", 32, tk.GEMV_MAX_K + 4, 48, torch.float32, "simt"),
    ("float32 M 32 K not a multiple of 4", 32, 4098, 4096, torch.float32, "simt"),
    ("float32 M 512 N not a multiple of 16", 512, 4096, 4104, torch.float32, "simt"),
    ("float32 M 8 K at GEMV_MAX_K", 8, tk.GEMV_MAX_K, 48, torch.float32, "f32mma"),
    ("float32 M 8 K past the plan", 8, tk.GEMV_MAX_K + 4, 48, torch.float32, "simt"),
    ("float32 M 3 K past the plan", 3, tk.GEMV_MAX_K + 128, 4096, torch.float32, "simt"),
    ("float32 M 8 ragged K 4100", 8, 4100, 4112, torch.float32, "f32mma"),
    ("float32 M 8 K not a multiple of 4", 8, 4098, 4096, torch.float32, "simt"),
    ("float32 M 5 K 130", 5, 130, 48, torch.float32, "simt"),
    ("float32 M 8 N not a multiple of 16", 8, 4096, 4104, torch.float32, "simt"),
    ("float32 M 5 N 97", 5, 128, 97, torch.float32, "simt"),
    ("bf16 at M 8 keeps mma", 8, 4096, 4096, torch.bfloat16, "mma"),
    ("bf16 at M 3 keeps simt", 3, 4096, 4096, torch.bfloat16, "simt"),
] + [(f"llama-3.1-8b {site} M {m}", m, k, n, torch.bfloat16, "gemv" if m == 1 else "mma")
     for site, (k, n) in LLAMA_8B_SITES.items() for m in (1, 30)] + [
    (f"llama-3.1-8b {site} M {m} float32", m, k, n, torch.float32, "gemv")
    for site, (k, n) in LLAMA_8B_SITES.items() for m in (1, 2)] + [
    (f"llama-3.1-8b {site} M {m} float32 (batched)", m, k, n, torch.float32, "f32mma")
    for site, (k, n) in LLAMA_8B_SITES.items() for m in (3, 8, 32)]


@pytest.mark.parametrize("case,m,k,n,dtype,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_table(case, m, k, n, dtype, route):
    assert tk._route(m, k, n, dtype) == route


@pytest.mark.parametrize("m", [1, 64])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(m):
    gen = torch.Generator().manual_seed(m)
    w = tquant._quantize_leaf((torch.randn(256, 128, generator=gen) * 0.02).to(torch.bfloat16))
    x = torch.randn(m, 256, generator=gen).to(torch.bfloat16)
    assert tk._route(m, 256, 128, x.dtype) == ("gemv" if m <= tk.GEMV_MAX_M else "mma")
    before = (tk._launches, tk._launches_mma, tk._launches_gemv, tk._launches_f32mma)
    got = tk.int8_dot(x, w)
    assert (tk._launches, tk._launches_mma, tk._launches_gemv,
            tk._launches_f32mma) == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, 128)
    assert torch.equal(got, tk.int8_dot_reference(x, w.q, w.s))


def _signature(src: str, name: str):
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert match, f"{name} not found in the kernel source"
    return [" ".join(p.split()) for p in match.group(1).split(",")]


def test_both_entry_points_take_the_same_arguments():
    src = (CSRC / tk.SOURCE).read_text()
    simt = _signature(src, "int8_dot_launch")
    assert len(simt) == 10
    assert _signature(src, "int8_dot_mma_launch") == simt


@pytest.mark.parametrize("m", [30, 64])
def test_plain_version_matches_pallas_interpret_at_prefill_bf16(m, monkeypatch):
    r = np.random.default_rng(m)
    k, n = 256, 384
    w = (0.02 * r.standard_normal((k, n))).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero output channel (s = 1)
    jw = jquant._quantize_leaf(jnp.asarray(w))
    tw = tquant.QuantizedTensor(array_to_torch(np.asarray(jw.q)),
                                array_to_torch(np.asarray(jw.s)), jw.dtype)
    x = jnp.asarray(r.standard_normal((m, k)), jnp.bfloat16)
    tx = array_to_torch(np.asarray(x))
    assert tk._route(m, k, n, tx.dtype) == "mma"
    got = tk.int8_dot(tx, tw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    monkeypatch.setattr(jk, "_INTERPRET", True)
    before = jk._launches
    pallas = jk.int8_dot(x, jw)
    assert jk._launches == before + 1      # really took the Pallas kernel
    want = np.asarray(pallas.astype(jnp.float32))
    assert_close(got.float(), want, rtol=BF16_TOL, atol=0.0)
