"""``int8_dot``'s decode kernel ("gemv", ``int8_gemv_kernel`` in
``csrc/int8_dot.cu``) from the CPU: its C entry point's arguments and its
geometry constants read from the source text (nothing CUDA imported), the
host plan `_gemv_plan` (whole 128-row stages a rank, a portable cluster,
the card filled at every llama-3.1-8b site), its launch counter among the
ones a captured graph adds per replay, CPU tensors at decode M taking the
plain version, and the plain version against the reference's Pallas
kernel, run interpreted, at decode M with bf16 and float32 x."""

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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.utils.cuda_build import (
    CSRC,
)

LLAMA_8B_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
                  "wd": (14336, 4096)}
# The plans at these sites (PERF.md has the scan on the H100 beside them):
# the least split that gives every rank as many stages, at most 8 of them.
LLAMA_8B_PLANS = {"wqkv": 4, "wo": 4, "wgu": 4, "wd": 8}
# The executors' fused weights and the parts a full_forward over the loaded
# weights runs instead (wq|wk|wv with 8 KV heads of 128, wg|wu).
LLAMA_8B_PARTS = {"wqkv": (4096, 1024, 1024), "wgu": (14336, 14336)}
# bf16 outputs of two float32 sums in different orders, each rounded once:
# max|a - b| <= 2^-7 * max|b| (one bf16 ulp at the output's scale), the
# tolerance chip_smoke.py holds the kernels to on the card.
BF16_TOL = 2.0 ** -7
STAGE_BYTES = tk.GEMV_ROWS * tk.GEMV_STRIP         # a CTA's 128 rows x 128 columns


def _source() -> str:
    return (CSRC / tk.SOURCE).read_text()


def _signature(src: str, name: str):
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert match, f"{name} not found in the kernel source"
    return [" ".join(p.split()) for p in match.group(1).split(",")]


def _constant(src: str, name: str) -> int:
    match = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert match, f"{name} not found in the kernel source"
    return int(match.group(1))


def test_gemv_entry_point_takes_the_others_arguments_and_its_plan():
    """The decode route's C entry point takes the other two's 10 arguments,
    then the plan as `_gemv_plan` returns it."""
    src = _source()
    simt = _signature(src, "int8_dot_launch")
    assert _signature(src, "int8_dot_gemv_launch") == simt + ["int strip_cols", "int split"]


@pytest.mark.parametrize("name,value", [
    ("kGemvStrip", tk.GEMV_STRIP), ("kGemvWarps", tk.GEMV_WARPS),
    ("kGemvRows", tk.GEMV_ROWS), ("kGemvStages", tk.GEMV_STAGES),
    ("kGemvMaxSplit", tk.GEMV_MAX_SPLIT), ("kGemvMaxChunk", tk.GEMV_MAX_CHUNK)])
def test_gemv_geometry_matches_the_kernel_source(name, value):
    assert _constant(_source(), name) == value


def test_gemv_max_k_is_what_one_cluster_stages():
    assert tk.GEMV_MAX_K == tk.GEMV_MAX_SPLIT * tk.GEMV_MAX_CHUNK * tk.GEMV_ROWS == 32768
    assert tk._route(1, tk.GEMV_MAX_K, 16, torch.bfloat16) == "gemv"
    assert tk._route(1, tk.GEMV_MAX_K + 1, 16, torch.bfloat16) == "simt"


PLAN_SHAPES = [(f"llama-3.1-8b {site}", k, n) for site, (k, n) in LLAMA_8B_SITES.items()] + [
    ("ragged K 100", 100, 96), ("ragged K 4100", 4100, 4096), ("K 640 N 16", 640, 16),
    ("K 128", 128, 16), ("K 1", 1, 48), ("GEMV_MAX_K", tk.GEMV_MAX_K, 28672),
    ("ragged K 14300", 14300, 6144), ("K 4096 N 1024", 4096, 1024)]


@pytest.mark.parametrize("case,k,n", PLAN_SHAPES, ids=[c for c, _, _ in PLAN_SHAPES])
@pytest.mark.parametrize("m", [1, 2])
def test_gemv_plan_cuts_k_into_whole_stages(case, k, n, m):
    """Each rank of the cluster takes ceil(stages / split) whole 128-row
    stages (the kernel's own cut), at most GEMV_MAX_CHUNK; every rank gets
    one; together they cover K; the split is at most the portable cluster
    size 8; and the plan is a pure function of (k, n)."""
    strip, split = tk._gemv_plan(m, k, n)
    assert strip == tk.GEMV_STRIP and 1 <= split <= tk.GEMV_MAX_SPLIT == 8
    stages = -(-k // tk.GEMV_ROWS)
    chunk = -(-stages // split)
    ranks = [(r * chunk, min((r + 1) * chunk, stages)) for r in range(split)]
    assert all(g0 < g1 for g0, g1 in ranks)
    assert ranks[0][0] == 0 and ranks[-1][1] * tk.GEMV_ROWS >= k
    assert (ranks[-1][1] - 1) * tk.GEMV_ROWS < k
    assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
    assert chunk <= tk.GEMV_MAX_CHUNK
    assert tk._gemv_plan(m, k, n) == (strip, split) == tk._gemv_plan(3 - m, k, n)
    assert all(tk._gemv_plan(m, k, other) == (strip, split) for other in (16, 4096, 28672))


@pytest.mark.parametrize("site", sorted(LLAMA_8B_PARTS))
def test_gemv_plan_of_a_fused_weight_is_its_parts_plan(site):
    """The split depends on K alone, so a fused projection and each of its
    parts sum every column in the same order: the executors (fused) and a
    full_forward over the loaded weights (parts) give the same bits, as
    the decode kernel is held to on the card."""
    k, n = LLAMA_8B_SITES[site]
    assert sum(LLAMA_8B_PARTS[site]) == n
    assert {tk._gemv_plan(1, k, part) for part in LLAMA_8B_PARTS[site]} == \
        {tk._gemv_plan(1, k, n)}


@pytest.mark.parametrize("site", sorted(LLAMA_8B_SITES))
def test_gemv_plan_fills_the_card_at_every_llama_site(site):
    """At every llama-3.1-8b site the plan launches a CTA for nearly every
    one of the H100's 132 SMs (at least 128), gives every CTA the same
    number of stages (and every warp of a CTA 32 rows of each), and keeps
    >= 32 KB of weight copies in flight an SM (a CTA asks for
    GEMV_STAGES - 1 stages of 16 KB ahead of its work)."""
    k, n = LLAMA_8B_SITES[site]
    strip, split = tk._gemv_plan(1, k, n)
    assert split == LLAMA_8B_PLANS[site]
    ctas = -(-n // strip) * split
    assert ctas >= 128
    stages = k // tk.GEMV_ROWS
    per_cta = stages // split
    assert stages == per_cta * split and tk.GEMV_ROWS == 32 * tk.GEMV_WARPS
    in_flight = ctas * min(per_cta, tk.GEMV_STAGES - 1) * STAGE_BYTES
    assert in_flight / 132 >= 32 * 1024


@pytest.mark.parametrize("counter", ["_launches", "_launches_mma", "_launches_gemv",
                                     "_launches_f32mma"])
def test_graph_counters_hold_every_int8_route(counter):
    """A replay adds the launches of each of int8_dot's routes, and a launch
    of a route counts on its own counter and on ``_launches``."""
    assert hasattr(tk, counter) and (tk, counter) in tgraphs._COUNTERS
    routes = [r for r, names in tk._COUNTED.items() if counter in names]
    assert routes == (list(tk._COUNTED) if counter == "_launches" else [counter[10:]])


def _quantized(r, k, n):
    w = (0.02 * r.standard_normal((k, n))).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero output channel (s = 1)
    jw = jquant._quantize_leaf(jnp.asarray(w))
    tw = tquant.QuantizedTensor(array_to_torch(np.asarray(jw.q)),
                                array_to_torch(np.asarray(jw.s)), jw.dtype)
    return jw, tw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 2])
def test_cpu_tensors_at_decode_m_take_the_plain_version(m, dtype):
    r = np.random.default_rng(10 + m)
    _, tw = _quantized(r, 320, 96)
    x = torch.from_numpy(r.standard_normal((m, 320)).astype(np.float32)).to(dtype)
    assert tk._route(m, 320, 96, dtype) == "gemv"
    before = (tk._launches, tk._launches_mma, tk._launches_gemv, tk._launches_f32mma)
    got = tk.int8_dot(x, tw)
    assert (tk._launches, tk._launches_mma, tk._launches_gemv,
            tk._launches_f32mma) == before
    assert got.dtype == dtype and tuple(got.shape) == (m, 96)
    assert torch.equal(got, tk.int8_dot_reference(x, tw.q, tw.s))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 2])
def test_plain_version_matches_pallas_interpret_at_decode(m, dtype, monkeypatch):
    """The plain version (what the card's decode kernel is held to) against
    the reference's Pallas kernel, interpreted, at the decode route's M:
    float32 x within the float32 parity tolerance of the port's tests
    (sums in another order), bf16 x within one bf16 ulp at the output's
    scale (both sum in float32 and round once)."""
    r = np.random.default_rng(20 + m)
    k, n = 256, 384
    jw, tw = _quantized(r, k, n)
    x = jnp.asarray(r.standard_normal((m, k)), dtype)
    tx = array_to_torch(np.asarray(x))
    assert tk._route(m, k, n, tx.dtype) == "gemv"
    got = tk.int8_dot(tx, tw)
    assert tuple(got.shape) == (m, n)
    monkeypatch.setattr(jk, "_INTERPRET", True)
    before = jk._launches
    pallas = jk.int8_dot(x, jw)
    assert jk._launches == before + 1      # really took the Pallas kernel
    want = np.asarray(pallas.astype(jnp.float32))
    if dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        assert_close(got.float(), want, rtol=BF16_TOL, atol=0.0)
    else:
        assert got.dtype == torch.float32
        assert_close(got, want)
