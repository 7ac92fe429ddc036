"""``nf4_dot``'s float32 prefill route ("f32mma", ``nf4_f32mma_kernel`` in
``csrc/nf4_dot.cu``: float32 x at M >= 3, the prefill of the stages behind
TCP) from the CPU: its C entry point's arguments and its geometry
constants read from the source text (nothing CUDA imported), the shared
memory a CTA takes, its host plan (`_f32mma_plan`, a function of K alone),
CPU tensors at its M taking the plain version, and the kernel's arithmetic
emulated in plain PyTorch (x split into three bf16 terms, each NF4 level
into two, five products a scale block summed in float32, each block's sums
times its scale, the ranks of the plan in order) against the plain version
at the llama-3.1-8b sites and against the reference's Pallas kernel, run
interpreted."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.nf4_kernel as jnk
from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    one_torch_thread,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    quant as jquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    array_to_torch,
    from_jax_tree,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    nf4_kernel as tnk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.utils.cuda_build import (
    CSRC,
)

LLAMA_8B_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
                  "wd": (14336, 4096)}
# The executors' fused weights and the parts a full_forward over the loaded
# weights runs instead (wq|wk|wv with 8 KV heads of 128, wg|wu).
LLAMA_8B_PARTS = {"wqkv": (4096, 1024, 1024), "wgu": (14336, 14336)}
# chip_smoke.py's tolerance for float32 x: max|kernel - plain| <= F32_TOL *
# max|plain|. Not loosened for the route.
F32_TOL = 1e-5
# Shared memory an SM of the H100 has (228 KB), a block may take (227 KB),
# and what the card reserves for each block besides its dynamic shared memory.
SM_SMEM = 233472
BLOCK_SMEM = 232448
RESERVED = 1024
# The products of a scale block's sums, (x term, level term), in the
# kernel's order (f32mma_x, f32mma_l): every pair with t + u <= 2.
PRODUCTS = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1))
# bf16 terms of an NF4 level in the emulation below.
LEVEL_TERMS = 2


def _source() -> str:
    return (CSRC / tnk.SOURCE).read_text()


def _signature(src: str, name: str):
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert match, f"{name} not found in the kernel source"
    return [" ".join(p.split()) for p in match.group(1).split(",")]


def _constant(src: str, name: str) -> int:
    match = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert match, f"{name} not found in the kernel source"
    return int(match.group(1))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class _FakeFunction:
    pass


class _FakeLibrary:
    """What ``load_kernel_library`` returns, with no CUDA: every entry point
    an object that takes the ctypes attributes the wrapper sets."""

    def __getattr__(self, name):
        fn = _FakeFunction()
        object.__setattr__(self, name, fn)
        return fn


def test_f32mma_entry_point_takes_the_gemv_arguments_and_the_term_buffer(monkeypatch):
    """The route's C entry point takes the decode route's arguments (the
    other two's 11 and the plan's strip and split), then the scratch buffer
    of x's terms that the wrapper allocates; the wrapper binds it with the
    same ctypes types, a pointer-sized type for each pointer."""
    src = _source()
    gemv = _signature(src, "nf4_dot_gemv_launch")
    f32mma = _signature(src, "nf4_dot_f32mma_launch")
    assert f32mma == gemv + ["void* terms"]
    monkeypatch.setattr(tnk, "_lib", None)
    monkeypatch.setattr(tnk, "load_kernel_library", lambda source: _FakeLibrary())
    lib = tnk._library()
    types = lib.nf4_dot_f32mma_launch.argtypes
    assert types[:-1] == lib.nf4_dot_gemv_launch.argtypes and len(types) == len(f32mma)
    for arg, typ in zip(f32mma, types):
        want = ctypes.c_void_p if "*" in arg else ctypes.c_int
        assert typ is want, (arg, typ)
    assert lib.nf4_dot_f32mma_launch.restype is ctypes.c_int


@pytest.mark.parametrize("name,value", [
    ("kF32MmaTerms", tnk.F32MMA_TERMS), ("kF32MmaLevelTerms", LEVEL_TERMS),
    ("kF32MmaMaxFrags", tnk.F32MMA_MAX_FRAGS), ("kRowsPerScale", tquant.NF4_BLOCK // 2),
    ("kF32MmaProducts", len(PRODUCTS)), ("kGemvStrip", tnk.GEMV_STRIP),
    ("kGemvWarps", tnk.GEMV_WARPS), ("kGemvMaxSplit", tnk.GEMV_MAX_SPLIT)])
def test_f32mma_geometry_matches_the_kernel_source(name, value):
    assert _constant(_source(), name) == value


def test_f32mma_product_order_is_the_kernels():
    """f32mma_x / f32mma_l in the source give PRODUCTS, the order the
    emulation below sums in: every pair of terms with t + u <= 2."""
    src = _source()
    x = re.search(r"int f32mma_x\(int p\) \{\s*return p == 1 \|\| p == 4 \? 1 : p == 3 \? 2 : 0;",
                  src)
    lv = re.search(r"int f32mma_l\(int p\) \{ return p == 2 \|\| p == 4 \? 1 : 0; \}", src)
    assert x and lv
    got = tuple((1 if p in (1, 4) else 2 if p == 3 else 0, 1 if p in (2, 4) else 0)
                for p in range(len(PRODUCTS)))
    assert got == PRODUCTS
    assert sorted(PRODUCTS) == sorted((t, u) for t in range(tnk.F32MMA_TERMS)
                                      for u in range(LEVEL_TERMS) if t + u <= 2)


def _smem(frags: int) -> int:
    """``F32MmaTile<frags>::kSmem``: the pair table and a ring of
    scale-block slots (the strip's 32 packed rows of 128 bytes, its 128 bf16
    scales, 32 words of each term of each row of x); none of it depends on
    K. After the loop the drained ring holds the CTA's sums and the slots
    the cluster's ranks push to it."""
    src = _source()
    rows = 8 * frags
    stages = _constant(src, "kF32MmaStages")
    table = 256 * _constant(src, "kF32MmaCopies") * 8
    slot = 32 * tnk.GEMV_STRIP + 2 * tnk.GEMV_STRIP + tnk.F32MMA_TERMS * rows * 32 * 4
    sums = tnk.GEMV_STRIP * (rows + 2) * 4
    pushed = (rows + tnk.GEMV_MAX_SPLIT - 1) * tnk.GEMV_STRIP * 4
    assert sums + pushed <= stages * slot
    return table + stages * slot


@pytest.mark.parametrize("frags", [1, tnk.F32MMA_MAX_FRAGS])
def test_f32mma_shared_memory_fits_at_every_k_it_takes(frags):
    """A CTA's shared memory does not depend on K (no rank stages its chunk
    of x ahead of the loop), so at every K the route takes (no bound: here
    up to twice GEMV_MAX_K, the decode route's bound) it fits a block four
    times an SM, at 8 and 16 rows. The plan's ranks cover every K's scale
    blocks."""
    per_sm = 4
    need = _smem(frags) + RESERVED
    assert need <= BLOCK_SMEM and per_sm * need <= SM_SMEM
    for blocks in range(1, 2 * tnk.GEMV_MAX_K // tquant.NF4_BLOCK + 1):
        _, split = tnk._f32mma_plan(32, blocks * tquant.NF4_BLOCK, 4096)
        assert _ceil(blocks, _ceil(blocks, split)) == split


PLAN_SHAPES = [(f"llama-3.1-8b {site}", k, n) for site, (k, n) in LLAMA_8B_SITES.items()] + [
    ("ragged K 4104", 4104, 96), ("K 640 N 16", 640, 16), ("K 64", 64, 16),
    ("GEMV_MAX_K", tnk.GEMV_MAX_K, 28672), ("ragged K 14336 + 8", 14344, 6144),
    ("K past GEMV_MAX_K", tnk.GEMV_MAX_K + 64, 48)]


@pytest.mark.parametrize("case,k,n", PLAN_SHAPES, ids=[c for c, _, _ in PLAN_SHAPES])
def test_f32mma_plan_cuts_k_into_whole_blocks_by_k_alone(case, k, n):
    """Each rank takes ceil(blocks / split) whole 64-row scale blocks,
    at least F32MMA_RANK_BLOCKS where K has them; every rank gets one;
    together they cover in_pad; the split is at most 8; and the plan is the
    same at every M and every N, so a row gives the same bits at any M."""
    strip, split = tnk._f32mma_plan(32, k, n)
    assert strip == tnk.GEMV_STRIP and 1 <= split <= tnk.GEMV_MAX_SPLIT
    blocks = _ceil(k, tquant.NF4_BLOCK)
    chunk = _ceil(blocks, split)
    ranks = [(r * chunk, min((r + 1) * chunk, blocks)) for r in range(split)]
    assert all(b0 < b1 for b0, b1 in ranks)
    assert ranks[0][0] == 0 and ranks[-1][1] == blocks
    assert split == 1 or chunk >= tnk.F32MMA_RANK_BLOCKS
    assert {tnk._f32mma_plan(m, k, other) for m in (3, 8, 32, 33, 512, 2048)
            for other in (16, n, 28672)} == {(strip, split)}


@pytest.mark.parametrize("site", sorted(LLAMA_8B_SITES))
def test_f32mma_plan_fills_the_card_at_every_llama_site(site):
    """At every llama-3.1-8b site one M tile of the plan launches at least
    256 CTAs, about two for each of the H100's 132 SMs (four fit an SM),
    every rank takes the same number of blocks, and the strip is the
    decode kernel's."""
    k, n = LLAMA_8B_SITES[site]
    strip, split = tnk._f32mma_plan(32, k, n)
    assert strip == tnk.GEMV_STRIP
    assert _ceil(n, strip) * split >= 256
    blocks = k // tquant.NF4_BLOCK
    assert blocks % split == 0


@pytest.mark.parametrize("site", sorted(LLAMA_8B_PARTS))
def test_f32mma_plan_of_a_fused_weight_is_its_parts_plan(site):
    """A fused projection and each of its parts take one plan, so they sum
    every column in the same order: the stage executors (fused) and a
    full_forward over the loaded weights (parts) give the same bits. (The
    decode kernel's `_gemv_plan` follows N, and does not.)"""
    k, n = LLAMA_8B_SITES[site]
    assert sum(LLAMA_8B_PARTS[site]) == n
    assert {tnk._f32mma_plan(32, k, part) for part in LLAMA_8B_PARTS[site]} == \
        {tnk._f32mma_plan(32, k, n)}


def _nf4(r, k, n):
    w = (0.02 * r.standard_normal((k, n))).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero column
    jw = jquant._quantize_leaf_nf4(jnp.asarray(w))
    tw = from_jax_tree(jax.tree.map(np.asarray, {"w": jw}))["w"]
    assert isinstance(tw, tquant.NF4Tensor)
    return jw, tw


@pytest.mark.parametrize("m", [3, 8, 32])
def test_cpu_tensors_at_prefill_m_take_the_plain_version(m):
    r = np.random.default_rng(30 + m)
    _, tw = _nf4(r, 320, 96)
    x = torch.from_numpy(r.standard_normal((m, 320)).astype(np.float32))
    assert tnk._route(m, 320, 96, x.dtype) == "f32mma"
    before = (tnk._launches, tnk._launches_mma, tnk._launches_gemv, tnk._launches_f32mma)
    got = tnk.nf4_dot(x, tw)
    assert (tnk._launches, tnk._launches_mma, tnk._launches_gemv,
            tnk._launches_f32mma) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 96)
    assert torch.equal(got, tnk.nf4_dot_reference(x, tw))


def _terms(v: torch.Tensor, terms: int):
    """``f32mma_split_x`` / ``f32mma_entry``: term t is bf16 of what the
    earlier terms leave of v (round to nearest even), each subtraction exact
    in float32. Returns the terms (float32) and what they leave."""
    out, rest = [], v.float()
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out, rest


def test_three_bf16_terms_hold_a_float32_and_two_an_nf4_weight():
    """x: three terms are every float32 of normal range exactly. A level:
    two terms hold each NF4 level, and so a weight level * bf16 scale, to
    2^-16 of its magnitude (the kernel drops the rest)."""
    r = np.random.default_rng(40)
    x = torch.from_numpy((r.standard_normal((8, 4096))
                          * np.exp2(r.integers(-30, 30, (8, 4096)))).astype(np.float32))
    _, rest3 = _terms(x, tnk.F32MMA_TERMS)
    assert torch.equal(rest3, torch.zeros_like(x))
    levels = torch.tensor(tquant.NF4_LEVELS, dtype=torch.float32)
    parts, rest = _terms(levels, LEVEL_TERMS)
    assert (rest.abs() <= levels.abs() * 2.0 ** -16).all() and rest.abs().max() > 0
    scales = torch.from_numpy(r.random(4096).astype(np.float32) * 0.05).to(torch.bfloat16)
    codes = torch.from_numpy(r.integers(0, 16, 4096))
    w = levels[codes] * scales.float()
    two = (parts[0][codes] + parts[1][codes]) * scales.float()
    assert ((two - w).abs() <= w.abs() * 2.0 ** -16).all()


def _emulate(x: torch.Tensor, w: tquant.NF4Tensor) -> torch.Tensor:
    """The route's arithmetic in plain PyTorch: x split into F32MMA_TERMS
    bf16 terms and each NF4 level into LEVEL_TERMS; each 64-row
    scale block's products (PRODUCTS; each exact in float32) summed in
    float32, times the block's scales into the rank's sums in block order;
    the ranks of `_f32mma_plan` in rank order."""
    m, k = x.shape
    pairs, n = w.packed.shape
    in_pad = 2 * pairs
    codes = torch.stack([w.packed >> 4, w.packed & 0xF], dim=1).reshape(in_pad, n).long()
    lt, _ = _terms(torch.tensor(tquant.NF4_LEVELS, dtype=torch.float32),
                   LEVEL_TERMS)
    lvl = [t[codes] for t in lt]
    xt, _ = _terms(torch.nn.functional.pad(x, (0, in_pad - k)), tnk.F32MMA_TERMS)
    s = w.scales.float()
    blocks = in_pad // tquant.NF4_BLOCK
    _, split = tnk._f32mma_plan(m, k, n)
    chunk = _ceil(blocks, split)
    total = torch.zeros((m, n), dtype=torch.float32)
    for r0 in range(0, blocks, chunk):
        rank = torch.zeros_like(total)
        for b in range(r0, min(r0 + chunk, blocks)):
            rows = slice(b * tquant.NF4_BLOCK, (b + 1) * tquant.NF4_BLOCK)
            blk = torch.zeros_like(total)
            for t, u in PRODUCTS:
                blk += xt[t][:, rows] @ lvl[u][rows]
            rank += blk * s[b]
        total += rank
    return total


@pytest.mark.parametrize("m", [3, 8, 32])
@pytest.mark.parametrize("site", sorted(LLAMA_8B_SITES))
def test_term_split_meets_the_float32_tolerance_at_llama_sites(site, m):
    """The emulated route at a llama-3.1-8b site (full K, 128 of its
    columns; weights quantized by the port's NF4 quantizer as chip_smoke.py
    quantizes them, x standard normal) against the plain version: within
    F32_TOL of max|plain|."""
    k, n = LLAMA_8B_SITES[site]
    assert tnk._route(m, k, n, torch.float32) == "f32mma"
    r = np.random.default_rng(10 * sorted(LLAMA_8B_SITES).index(site) + m)
    gen = torch.Generator().manual_seed(int(r.integers(1 << 30)))
    w = tquant._quantize_leaf_nf4(
        (torch.randn((k, 128), generator=gen) * 0.02).to(torch.bfloat16))
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32))
    want = tnk.nf4_dot_reference(x, w)
    err = (_emulate(x, w) - want).abs().max().item()
    assert err <= F32_TOL * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.parametrize("m", [8, 32])
def test_term_split_matches_pallas_interpret_at_prefill_m(m, monkeypatch):
    """The emulated route against the reference's Pallas kernel,
    interpreted, with float32 x at the route's M, within the float32 parity
    tolerance of the port's tests; the wrapper on a CPU tensor routes there
    and gives the plain version."""
    r = np.random.default_rng(50 + m)
    k, n = 256, 384
    jw, tw = _nf4(r, k, n)
    x = jnp.asarray(r.standard_normal((m, k)), jnp.float32)
    tx = array_to_torch(np.asarray(x))
    assert tnk._route(m, k, n, tx.dtype) == "f32mma"
    got = _emulate(tx, tw)
    monkeypatch.setattr(jnk, "_INTERPRET", True)
    before = jnk._launches
    pallas = jnk.nf4_dot(x, jw)
    assert jnk._launches == before + 1     # really took the Pallas kernel
    want = np.asarray(pallas)
    assert_close(got, want)
    assert_close(tnk.nf4_dot(tx, tw), want)
