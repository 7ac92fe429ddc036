"""``int8_dot``'s float32 route ("f32mma", ``int8_f32mma_kernel<NF>`` in
``csrc/int8_dot.cu``: float32 x at every M >= 3, the prefill of stages 1-3
and the batched engine's rounds) from the CPU: its C entry point's
arguments and its geometry constants read from the source text (nothing
CUDA imported), the shared memory a CTA takes at 8- and 16-row M tiles and
the slots its ranks push their sums to, the host plan it shares with the
decode route (`_gemv_plan`, a function of K alone), CPU tensors at its M
taking the plain version, and the kernel's arithmetic emulated in plain
PyTorch (x split into bf16 terms, float32 sums a rank of the plan, ranks
in order) against the plain version at the llama-3.1-8b sites and against
the reference's Pallas kernel, run interpreted; and the kernel's order of
sums, emulated row by row, giving a row the same bits at every M."""

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
# The executors' fused weights and the parts a full_forward over the loaded
# weights runs instead (wq|wk|wv with 8 KV heads of 128, wg|wu).
LLAMA_8B_PARTS = {"wqkv": (4096, 1024, 1024), "wgu": (14336, 14336)}
# chip_smoke.py's tolerance for float32 x: max|kernel - plain| <= F32_TOL *
# max|plain|. Not loosened for the route.
F32_TOL = 1e-5
# Shared memory a block may take on an H100 (227 KB), an SM's (228 KB), and
# what the card reserves for each block besides its dynamic shared memory.
BLOCK_SMEM = 232448
SM_SMEM = 233472
RESERVED = 1024
STAGE_COUNTS = range(1, tk.GEMV_MAX_K // tk.GEMV_ROWS + 1)


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


def _rows(frags: int) -> int:
    return tk.F32MMA_ROWS * frags


def _smem(frags: int) -> int:
    """``F32MmaTile<NF>::kSmem``: a ring of F32MMA_STAGES slots, each a
    stage's weights (GEMV_ROWS x GEMV_STRIP int8) and its rows of the M
    tile's x (8 NF rows of GEMV_ROWS float32 and a pad of 8); the sums go
    into the drained ring. It does not depend on K: no rank stages its
    chunk of x ahead of the loop."""
    src = _source()
    assert re.search(r"constexpr int kF32MmaXRow = kGemvRows \+ 8;", src)
    x_rows = 4 * _rows(frags) * (tk.GEMV_ROWS + 8)
    return tk.F32MMA_STAGES * (tk.GEMV_ROWS * tk.GEMV_STRIP + x_rows)


def _tile_frags(m: int) -> int:
    """Fragments of x a CTA takes at M = m: one up to F32MMA_ROWS rows,
    F32MMA_MAX_FRAGS past it (``launch_f32mma``)."""
    return 1 if m <= tk.F32MMA_ROWS else tk.F32MMA_MAX_FRAGS


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _chunk(k: int) -> int:
    """Stages a rank of the plan takes, as the kernel's launch cuts them."""
    _, split = tk._gemv_plan(32, k, 4096)
    return _ceil(_ceil(k, tk.GEMV_ROWS), split)


def test_f32mma_entry_point_takes_the_gemv_arguments_and_the_terms():
    """The float32 route's C entry point takes the decode route's arguments
    (the other two's 10 and the plan's strip and split, as `_gemv_plan`
    returns them) and nothing more: the number of bf16 terms is the
    kernel's constant, three, not an argument, and the M tile follows M
    (no argument, and no bound on M past the grid's)."""
    src = _source()
    gemv = _signature(src, "int8_dot_gemv_launch")
    assert gemv[:10] == _signature(src, "int8_dot_launch")
    assert _signature(src, "int8_dot_f32mma_launch") == gemv
    assert _constant(src, "kF32MmaTerms") == tk.F32MMA_TERMS == 3
    assert "template <int Terms>" not in src
    entry = src[src.index('extern "C" int int8_dot_f32mma_launch'):]
    entry = entry[:entry.index("\n}\n")]
    assert "M <= 0" in entry and "M >" not in entry
    assert re.search(r"M <= kF32MmaRows\s*\?\s*launch_f32mma_tiles<1>", src)
    assert re.search(r":\s*launch_f32mma_tiles<kF32MmaMaxFrags>", src)


@pytest.mark.parametrize("name,value", [
    ("kF32MmaRows", tk.F32MMA_ROWS), ("kF32MmaTerms", tk.F32MMA_TERMS),
    ("kF32MmaMaxFrags", tk.F32MMA_MAX_FRAGS),
    ("kF32MmaStages", tk.F32MMA_STAGES),
    ("kGemvStrip", tk.GEMV_STRIP),
    ("kGemvRows", tk.GEMV_ROWS), ("kGemvStages", tk.GEMV_STAGES),
    ("kGemvMaxSplit", tk.GEMV_MAX_SPLIT)])
def test_f32mma_geometry_matches_the_kernel_source(name, value):
    assert _constant(_source(), name) == value


def test_f32mma_takes_the_gemv_plans_k_and_whole_x_copies():
    """The route takes the K the decode kernel's plan covers (every
    llama-3.1-8b site), and K % 4 == 0 (x's 16-byte copies are all inside K
    or all past it), at every M from F32MMA_MIN_M (the batched rounds, the
    prompt's bucket, a 2048-row prefill chunk); any other K goes to the
    CUDA-core route by shape."""
    assert max(k for k, _ in LLAMA_8B_SITES.values()) <= tk.GEMV_MAX_K
    for m in (8, 9, 32, 2048):
        assert tk._route(m, tk.GEMV_MAX_K, 16, torch.float32) == "f32mma"
        assert tk._route(m, tk.GEMV_MAX_K + 4, 16, torch.float32) == "simt"
        assert tk._route(m, 4098, 16, torch.float32) == "simt"
    assert tk.F32MMA_MIN_M == tk.GEMV_MAX_M + 1 == 3


def test_f32mma_shared_memory_fits_a_block_at_every_k_it_takes():
    """At every stage count the route takes (1..256) the plan's ranks cover
    K, and a CTA's shared memory at either M tile (62208 bytes at 8 rows,
    75264 at 16, whatever K), with what the card reserves, fits the 227 KB a
    block may take, three times an SM; the warps' sums and the largest
    cluster's pushed slots fit the drained ring."""
    for stages in STAGE_COUNTS:
        k = stages * tk.GEMV_ROWS
        assert _chunk(k) * tk._gemv_plan(8, k, 16)[1] >= stages
    src = _source()
    assert re.search(r"constexpr int kF32MmaSumRow = kGemvStrip \+ kGemvStrip / 16 \+ 12;",
                     src)
    for frags in (1, tk.F32MMA_MAX_FRAGS):
        smem = _smem(frags)
        assert smem + RESERVED <= BLOCK_SMEM and 3 * (smem + RESERVED) <= SM_SMEM
        sums = 4 * tk.GEMV_WARPS * _rows(frags) * (tk.GEMV_STRIP + tk.GEMV_STRIP // 16 + 12)
        slots = 4 * (_rows(frags) + tk.GEMV_MAX_SPLIT - 1) * tk.GEMV_STRIP
        assert sums % 16 == 0 and sums + slots <= smem
    assert [_smem(1), _smem(2)] == [62208, 75264]


@pytest.mark.parametrize("frags", [1, tk.F32MMA_MAX_FRAGS])
def test_f32mma_pushed_sums_fill_their_owners_slots_once(frags):
    """After the loop rank r of a cluster of `split` owns the tile's rows r,
    r + split, ...; every rank pushes its sum of row m = j * split + o into
    rank o's slot rank * per + j, per = ceil(8 NF / split) from the host
    (the kernel divides nothing). At every row count a tile of 8 NF rows
    holds (the last tile may be short) and every split: each owner's slots
    are written once by each rank for each of its rows and lie inside its
    (rows + GEMV_MAX_SPLIT - 1) x GEMV_STRIP slots; a rank owns at most per
    rows, two at 16 rows and split 8."""
    src = _source()
    assert "const int per = (T::kRows + split - 1) / split;" in src
    for split in range(1, tk.GEMV_MAX_SPLIT + 1):
        per = _ceil(_rows(frags), split)
        assert split * per <= _rows(frags) + tk.GEMV_MAX_SPLIT - 1
        for rows in range(1, _rows(frags) + 1):
            written = {}
            for rank in range(split):
                for j in range(per):
                    for o in range(split):
                        if j * split + o < rows:
                            key = (o, rank * per + j)
                            assert key not in written and key[1] < split * per
                            written[key] = (rank, j * split + o)
            assert sorted(m for _, m in written.values()) == sorted(
                m for m in range(rows) for _ in range(split))
            for owner in range(split):
                mine = [owner + j * split for j in range(per) if owner + j * split < rows]
                assert mine == [m for m in range(rows) if m % split == owner]
                assert all(written[(owner, rank * per + m // split)] == (rank, m)
                           for rank in range(split) for m in mine)
    assert _ceil(_rows(tk.F32MMA_MAX_FRAGS), tk.GEMV_MAX_SPLIT) == 2


@pytest.mark.parametrize("site", sorted(LLAMA_8B_SITES))
def test_f32mma_fills_the_card_at_every_llama_site(site):
    """At every llama-3.1-8b site the plan launches a CTA for nearly every
    one of the H100's 132 SMs (at least 128) at M = 8, one M tile, and
    twice as many at the prompt's bucket (M = 32, two 16-row tiles); every
    rank takes the same number of whole stages."""
    k, n = LLAMA_8B_SITES[site]
    strip, split = tk._gemv_plan(8, k, n)
    assert strip == tk.GEMV_STRIP and tk._gemv_plan(32, k, n) == (strip, split)
    assert _ceil(n, strip) * split >= 128
    assert _ceil(32, _rows(_tile_frags(32))) * _ceil(n, strip) * split >= 256
    assert k % tk.GEMV_ROWS == 0 and (k // tk.GEMV_ROWS) % split == 0


PLAN_SHAPES = [(f"llama-3.1-8b {site}", k, n) for site, (k, n) in LLAMA_8B_SITES.items()] + [
    ("ragged K 100", 100, 96), ("ragged K 4100", 4100, 4096), ("K 640 N 16", 640, 16),
    ("K 4", 4, 48), ("GEMV_MAX_K", tk.GEMV_MAX_K, 4096),
    ("126 stages", 126 * 128, 4096), ("ragged K 14300", 14300, 6144)]


@pytest.mark.parametrize("case,k,n", PLAN_SHAPES, ids=[c for c, _, _ in PLAN_SHAPES])
def test_f32mma_plan_cuts_k_into_whole_stages_by_k_alone(case, k, n):
    """Each rank takes ceil(stages / split) whole 128-row stages; every
    rank gets one; together they cover K; the split is at most 8; and the
    plan is the same at every M of the route and every N, so a row gives
    the same bits at M = 3, 8, 32 and 2048."""
    strip, split = tk._gemv_plan(8, k, n)
    assert strip == tk.GEMV_STRIP and 1 <= split <= tk.GEMV_MAX_SPLIT
    stages = _ceil(k, tk.GEMV_ROWS)
    chunk = _ceil(stages, split)
    ranks = [(r * chunk, min((r + 1) * chunk, stages)) for r in range(split)]
    assert all(g0 < g1 for g0, g1 in ranks)
    assert ranks[0][0] == 0 and ranks[-1][1] == stages
    assert {tk._gemv_plan(m, k, other) for m in [*range(tk.F32MMA_MIN_M, 65), 512, 2048]
            for other in (16, n, 28672)} == {(strip, split)}


@pytest.mark.parametrize("site", sorted(LLAMA_8B_PARTS))
def test_f32mma_plan_of_a_fused_weight_is_its_parts_plan(site):
    """At M = 8 and at the prompt's bucket (M = 32) a fused projection and
    each of its parts take one plan, so they sum every column in the same
    order: the executors (fused) and a full_forward over the loaded
    weights (parts) give the same bits. It is the plan the decode kernel
    takes at M = 1."""
    k, n = LLAMA_8B_SITES[site]
    assert sum(LLAMA_8B_PARTS[site]) == n
    for m in (8, 32):
        assert {tk._gemv_plan(m, k, part) for part in LLAMA_8B_PARTS[site]} == \
            {tk._gemv_plan(m, k, n)} == {tk._gemv_plan(1, k, n)}


@pytest.mark.parametrize("m", [3, 5, 8, 16, 33])
def test_cpu_tensors_at_batched_m_take_the_plain_version(m):
    r = np.random.default_rng(30 + m)
    _, tw = _quantized(r, 320, 96)
    x = torch.from_numpy(r.standard_normal((m, 320)).astype(np.float32))
    assert tk._route(m, 320, 96, x.dtype) == "f32mma"
    before = (tk._launches, tk._launches_mma, tk._launches_gemv, tk._launches_f32mma)
    got = tk.int8_dot(x, tw)
    assert (tk._launches, tk._launches_mma, tk._launches_gemv,
            tk._launches_f32mma) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 96)
    assert torch.equal(got, tk.int8_dot_reference(x, tw.q, tw.s))


def _terms(x: torch.Tensor, terms: int):
    """``f32mma_split``: term t is bf16 of what the earlier terms leave of
    x (round to nearest even), each subtraction exact in float32."""
    out, rest = [], x
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out, rest


def _emulate(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, terms: int) -> torch.Tensor:
    """The float32 route's arithmetic in plain PyTorch: x split into bf16
    terms; each rank of the plan sums its chunk of K over the terms'
    products with int8 q (each exact in float32) in float32; the ranks'
    sums in rank order; then each column's scale."""
    m, k = x.shape
    rows = _chunk(k) * tk.GEMV_ROWS
    parts, _ = _terms(x, terms)
    acc = torch.zeros((m, q.shape[1]), dtype=torch.float32)
    for r0 in range(0, k, rows):
        qf = q[r0:r0 + rows].float()
        rank = torch.zeros_like(acc)
        for p in parts:
            rank += p[:, r0:r0 + rows].float() @ qf
        acc += rank
    return acc * s


def _quantized(r, k, n):
    w = (0.02 * r.standard_normal((k, n))).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero output channel (s = 1)
    jw = jquant._quantize_leaf(jnp.asarray(w))
    tw = tquant.QuantizedTensor(array_to_torch(np.asarray(jw.q)),
                                array_to_torch(np.asarray(jw.s)), jw.dtype)
    return jw, tw


def test_three_bf16_terms_hold_a_float32_exactly():
    """hi + mid + lo is every float32 of normal range exactly (the kernel
    drops nothing of x with three terms); two terms leave a residual of at
    most 2^-16 of |x|."""
    r = np.random.default_rng(40)
    x = torch.from_numpy((r.standard_normal((8, 4096))
                          * np.exp2(r.integers(-30, 30, (8, 4096)))).astype(np.float32))
    _, rest3 = _terms(x, 3)
    assert torch.equal(rest3, torch.zeros_like(x))
    _, rest2 = _terms(x, 2)
    assert (rest2.abs() <= x.abs() * 2.0 ** -16).all() and rest2.abs().max() > 0


@pytest.mark.parametrize("m", [3, 8, 16, 32, 33])
@pytest.mark.parametrize("site", sorted(LLAMA_8B_SITES))
def test_term_split_meets_the_float32_tolerance_at_llama_sites(site, m):
    """The emulated route at a llama-3.1-8b site (int8 weights and scales
    as chip_smoke.py draws them, x standard normal) against the plain
    version: within F32_TOL of max|plain| over every column (taken 4096
    columns at a time to bound the memory)."""
    k, n = LLAMA_8B_SITES[site]
    assert tk._route(m, k, n, torch.float32) == "f32mma"
    r = np.random.default_rng(10 * sorted(LLAMA_8B_SITES).index(site) + m)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32))
    err = scale = 0.0
    for n0 in range(0, n, 4096):
        cols = min(4096, n - n0)
        q = torch.from_numpy(r.integers(-127, 128, (k, cols), dtype=np.int8))
        s = torch.from_numpy((r.random((1, cols)) * 1e-3 + 1e-4).astype(np.float32))
        want = tk.int8_dot_reference(x, q, s)
        err = max(err, (_emulate(x, q, s, tk.F32MMA_TERMS) - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    assert err <= F32_TOL * scale, (err, scale)


@pytest.mark.parametrize("m", [3, 8, 16, 32])
def test_term_split_matches_pallas_interpret_at_batched_m(m, monkeypatch):
    """The emulated route against the reference's Pallas kernel,
    interpreted (it pads M to a multiple of 8), with float32 x at the
    route's M, within the float32 parity tolerance of the port's tests;
    the wrapper on a CPU tensor routes there and gives the plain
    version."""
    r = np.random.default_rng(50 + m)
    k, n = 256, 384
    jw, tw = _quantized(r, k, n)
    x = jnp.asarray(r.standard_normal((m, k)), jnp.float32)
    tx = array_to_torch(np.asarray(x))
    assert tk._route(m, k, n, tx.dtype) == "f32mma"
    got = _emulate(tx, tw.q, tw.s, tk.F32MMA_TERMS)
    monkeypatch.setattr(jk, "_INTERPRET", True)
    before = jk._launches
    pallas = jk.int8_dot(x, jw)
    assert jk._launches == before + 1      # really took the Pallas kernel
    want = np.asarray(pallas)
    assert_close(got, want)
    assert_close(tk.int8_dot(tx, tw), want)


def _emulate_order(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The float32 route's order of sums for every row, in plain PyTorch: x
    split into its three bf16 terms; for each rank of the plan, each warp w
    (rows 32 w .. 32 w + 31 of every 128-row stage) sums, stage by stage in
    order, each 16-row slice's exact products term by term (hi, mid, lo)
    into its float32 sums, the slice's 16 products added in k order (the
    mma's own order inside a slice is the card's); the warps' sums are
    added in warp order, the ranks' in rank order, then each column's scale.
    Every step is elementwise over [M, N]: a row's sums never touch
    another row's."""
    m, k = x.shape
    n = q.shape[1]
    stages = _ceil(k, tk.GEMV_ROWS)
    _, split = tk._gemv_plan(m, k, n)
    chunk = _ceil(stages, split)
    pad = stages * tk.GEMV_ROWS - k
    parts = [torch.nn.functional.pad(p.float(), (0, pad)) for p in _terms(x, tk.F32MMA_TERMS)[0]]
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, pad))
    total = torch.zeros((m, n), dtype=torch.float32)
    for r in range(split):
        rank = torch.zeros_like(total)
        for w in range(tk.GEMV_WARPS):
            acc = torch.zeros_like(total)
            for st in range(r * chunk, min((r + 1) * chunk, stages)):
                for t in range(2):
                    k0 = st * tk.GEMV_ROWS + 32 * w + 16 * t
                    for p in parts:
                        part = torch.zeros_like(total)
                        for kk in range(k0, k0 + 16):
                            part = part + p[:, kk:kk + 1] * qf[kk]
                        acc = acc + part
            rank = rank + acc
        total = total + rank
    return total * s


def test_emulated_row_bits_do_not_depend_on_m():
    """In the route's order of sums a row's float32 bits do not depend on M
    or on the other rows: rows 0-2 at M = 3 equal rows 0-2 at M = 32 (8- and
    16-row tiles), also with the other rows redrawn, and rows 32-34 of M =
    64 (a later M tile) equal those rows alone; the emulation is within
    F32_TOL of the plain version. K = 2048 takes a split of 2 and N = 32
    one ragged strip."""
    r = np.random.default_rng(60)
    k, n = 2048, 32
    assert tk._gemv_plan(3, k, n) == (tk.GEMV_STRIP, 2)
    q = torch.from_numpy(r.integers(-127, 128, (k, n), dtype=np.int8))
    s = torch.from_numpy((r.random((1, n)) * 1e-3 + 1e-4).astype(np.float32))
    x = torch.from_numpy(r.standard_normal((64, k)).astype(np.float32))
    assert {_tile_frags(m) for m in (3, 32, 64)} == {1, tk.F32MMA_MAX_FRAGS}
    y64 = _emulate_order(x, q, s)
    y32 = _emulate_order(x[:32], q, s)
    other = torch.cat([x[:3], torch.from_numpy(r.standard_normal((29, k)).astype(np.float32))])
    assert torch.equal(_emulate_order(x[:3], q, s), y32[:3])
    assert torch.equal(_emulate_order(other, q, s)[:3], y32[:3])
    assert torch.equal(y64[:32], y32)
    assert torch.equal(_emulate_order(x[32:35], q, s), y64[32:35])
    want = tk.int8_dot_reference(x, q, s)
    assert (y64 - want).abs().max() <= F32_TOL * want.abs().max()
