"""NF4 matmul with the dequantization fused into the kernel.

    y = x @ deq(w),   deq(code) = round_to(x.dtype, NF4_LEVELS[code] * scale)

x [M, K] in float32 or bfloat16; w an `NF4Tensor` of one layer: packed
uint8 [in_pad/2, N] (high nibble row 2r, low nibble row 2r+1) and bf16
scales [in_pad/64, N]; y [M, N] in x's dtype, accumulated in float32.
Port of the JAX package's ``ops/nf4_kernel.py``: as there, the level times
the scale is formed in float32 and rounded to the activation's dtype
before the product (``nf4_kernel.py:122-124``).

Two versions of one function:

  * the CUDA kernels of ``csrc/nf4_dot.cu`` (Hopper, ``sm_90a``), launched
    for a tensor on the card. `_route` picks one from M, K, N and x's dtype
    alone: "gemv", the decode kernel (M <= `GEMV_MAX_M`: bf16 x below
    `MMA_MIN_M`, float32 x; N % 16 == 0, K <= `GEMV_MAX_K`), split-K over a
    thread-block cluster whose size `_gemv_plan` picks; "f32mma", float32 x
    at prefill M (M >= `F32MMA_MIN_M`, N % 16 == 0, K % 8 == 0, any K: the
    prefill of the stages behind TCP), the decode kernel's strips and
    cluster split-K on the tensor cores, with x split into `F32MMA_TERMS`
    bf16 terms and each NF4 level into two, and a plan of K alone
    (`_f32mma_plan`); "mma", the tensor-core kernel for bf16 x
    (M >= `MMA_MIN_M`, the alignment its 16-byte copies need: N % 16 == 0,
    K % 8 == 0), which dequantizes each weight once per block into shared
    memory; else "simt", the CUDA-core kernel, which reads the packed
    nibbles and the bf16 scales straight from device memory (0.5 B per
    weight plus 2 B per 64) and takes any M, K and N (ragged N or K);
  * `nf4_dot_reference`, the plain PyTorch version, taken for a tensor on
    the CPU (the CPU tests) and used by ``chip_smoke.py`` to check the
    kernels on the card.

`nf4_dot` launches the routed kernel or raises; it never falls back from
one kernel to the other, or from the card to the plain version.

On the card an x that needs a gradient goes through `_NF4Dot`, whose
backward is the gradient of the plain version with respect to x
(`nf4_dot_grad_x`: ``g @ deq.T``, the reference's fallback ``x @
w.dequant()`` transposed), a plain PyTorch product over blocks of columns
dequantized one at a time, as ``ops/int8_kernel.py`` does for int8.
``_launches`` counts kernel launches of every route (not calls of the plain
version), ``_launches_mma`` those of the tensor-core route,
``_launches_gemv`` those of the decode route and ``_launches_f32mma`` those
of the float32 prefill route, so a run can show that its main path went
through the kernels (``ops/launch_counts.py``: a launch recorded into a
CUDA graph counts on each replay).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..models.quant import NF4_BLOCK, NF4Tensor
from ..utils.cuda_build import load_kernel_library
from . import launch_counts
from .int8_kernel import grad_column_blocks

SOURCE = "nf4_dot.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The least M that takes the tensor-core route: from the crossover scan of
# ``chip_smoke.py`` (both kernels at M = 1..16 on wgu and wd, PERF.md): on
# the H100 the tensor-core kernel is the faster at both sites from M = 3.
MMA_MIN_M = 3

# The decode route's geometry, as ``csrc/nf4_dot.cu`` has it (kGemv*): a CTA
# of 4 warps owns 128 columns; a cluster of at most 8 CTAs (the portable
# size) splits K, each rank at most 64 scale blocks (its x stage in shared
# memory). A plan asks for 192 CTAs (~1.5 an SM of the H100's 132; three
# fit an SM): in ``chip_smoke.py``'s plan scan the least split that reached
# about that many was the fastest at every llama-3.1-8b site (PERF.md).
GEMV_MAX_M = 2
GEMV_STRIP = 128
GEMV_WARPS = 4
GEMV_MAX_SPLIT = 8
GEMV_MAX_CHUNK = 64
GEMV_MAX_K = GEMV_MAX_SPLIT * GEMV_MAX_CHUNK * NF4_BLOCK
GEMV_FILL_CTAS = 192

# The float32 prefill route's geometry, as ``csrc/nf4_dot.cu`` has it
# (kF32Mma*): the decode kernel's 128-column strips and cluster split-K, x
# in n8 fragments of the mma (up to F32MMA_MAX_FRAGS, 16 rows, a CTA; more
# rows take further M tiles), each float32 x value as F32MMA_TERMS bf16
# terms (the scratch the wrapper allocates). A CTA stages its chunk of K
# through a ring of scale-block slots, so its shared memory does not depend
# on K and the route takes any K. The plan (`_f32mma_plan`) depends on K
# alone and gives each rank at least F32MMA_RANK_BLOCKS scale blocks.
F32MMA_MIN_M = GEMV_MAX_M + 1
F32MMA_MAX_FRAGS = 2
F32MMA_TERMS = 3
F32MMA_RANK_BLOCKS = 8

_launches = 0
_launches_mma = 0
_launches_gemv = 0
_launches_f32mma = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library(SOURCE)
        lib.nf4_dot_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
        lib.nf4_dot_launch.restype = ctypes.c_int
        lib.nf4_dot_mma_launch.argtypes = lib.nf4_dot_launch.argtypes
        lib.nf4_dot_mma_launch.restype = ctypes.c_int
        lib.nf4_dot_gemv_launch.argtypes = (lib.nf4_dot_launch.argtypes
                                            + [ctypes.c_int] * 2)
        lib.nf4_dot_gemv_launch.restype = ctypes.c_int
        lib.nf4_dot_f32mma_launch.argtypes = (lib.nf4_dot_gemv_launch.argtypes
                                              + [ctypes.c_void_p])
        lib.nf4_dot_f32mma_launch.restype = ctypes.c_int
        lib.nf4_dot_error_string.argtypes = [ctypes.c_int]
        lib.nf4_dot_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _library()


def nf4_dot_reference(x: torch.Tensor, w: NF4Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [M, K] @ the dequantized weight rounded to
    x.dtype, float32 accumulate, cast to x.dtype."""
    deq = w.dequant_f32().to(x.dtype)
    return (x.float() @ deq.float()).to(x.dtype)


# Bytes a weight of the gradient's dequantized block holds at its widest:
# the codes as int64 indices, the levels and the scaled values in float32.
GRAD_ITEMSIZE = 16


def nf4_dot_grad_x(g: torch.Tensor, w: NF4Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gradient of `nf4_dot_reference` with respect to x for the
    output's gradient g [M, N]: ``g @ deq.T`` in float32, deq the weight
    dequantized and rounded to x's `dtype` as the plain version rounds it,
    cast to `dtype`, a block of columns at a time (`grad_column_blocks`)."""
    g32 = g.float()
    out = None
    for n0, n1 in grad_column_blocks(w.in_dim, w.packed.shape[1], GRAD_ITEMSIZE):
        part_w = NF4Tensor(w.packed[:, n0:n1], w.scales[:, n0:n1], w.in_dim, w.dtype)
        part = g32[:, n0:n1] @ part_w.dequant_f32().to(dtype).float().T
        out = part if out is None else out.add_(part)
    return out.to(dtype)


class _NF4Dot(torch.autograd.Function):
    """The routed launch, differentiable in x (the weight is frozen)."""

    @staticmethod
    def forward(ctx, x, packed, scales, w):
        ctx.w = w
        ctx.x_dtype = x.dtype
        return _launch(x, w)

    @staticmethod
    def backward(ctx, g):
        return nf4_dot_grad_x(g, ctx.w, ctx.x_dtype), None, None, None


def _route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel for x [m, k] of `dtype` times an NF4 weight [k, n]:
    "gemv" (decode) for M <= GEMV_MAX_M, bf16 x below MMA_MIN_M or float32
    x, with N % 16 == 0 and K <= GEMV_MAX_K; "f32mma" (tensor cores, x and
    the levels as bf16 terms) for float32 x at M >= F32MMA_MIN_M with N % 16
    == 0 and K % 8 == 0; "mma" (tensor cores) for bf16 x
    at M >= MMA_MIN_M with N % 16 == 0 and K % 8 == 0; else "simt" (CUDA
    cores: ragged N or K)."""
    decode = m <= GEMV_MAX_M and (dtype == torch.float32 or
                                  (dtype == torch.bfloat16 and m < MMA_MIN_M))
    if decode and n % 16 == 0 and k <= GEMV_MAX_K:
        return "gemv"
    if dtype == torch.float32 and m >= F32MMA_MIN_M and n % 16 == 0 and k % 8 == 0:
        return "f32mma"
    if dtype == torch.bfloat16 and m >= MMA_MIN_M and n % 16 == 0 and k % 8 == 0:
        return "mma"
    return "simt"


def _gemv_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(strip_cols, split) of the decode kernel for x [m, k] times a weight
    [k, n]: strips of GEMV_STRIP columns, and the cluster size `split` that
    cuts K into whole 64-row scale blocks, ceil(blocks / split) a rank. The
    least split (at most GEMV_MAX_SPLIT, each rank at most GEMV_MAX_CHUNK
    blocks) that gives GEMV_FILL_CTAS CTAs and the same number of blocks to
    every warp; else the least that gives GEMV_FILL_CTAS; else the most.
    The split is then cut to the ranks that get a block. M does not change
    the plan: a CTA's sums for both rows share its loads."""
    del m
    blocks = -(-k // NF4_BLOCK)
    strips = -(-n // GEMV_STRIP)
    least = -(-blocks // GEMV_MAX_CHUNK)
    splits = range(least, min(GEMV_MAX_SPLIT, blocks) + 1)
    filled = [s for s in splits if strips * s >= GEMV_FILL_CTAS]
    even = [s for s in filled if blocks % (s * GEMV_WARPS) == 0]
    split = (even or filled or [max(splits, default=least)])[0]
    return GEMV_STRIP, -(-blocks // -(-blocks // split))


def _f32mma_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(strip_cols, split) of the float32 prefill kernel for x [m, k] times
    a weight [k, n]: strips of GEMV_STRIP columns, and the most ranks up to
    GEMV_MAX_SPLIT that each take at least F32MMA_RANK_BLOCKS whole 64-row
    scale blocks, ceil(blocks / split) a rank; the split is then cut to the
    ranks that get a block.

    The plan depends on K alone, not on N or M (`_gemv_plan` follows N):
    the order of a column's float32 sums follows the split, so a fused
    weight (wq|wk|wv, wg|wu, as the stage executors hold them) and its
    parts (as a full_forward over the loaded weights runs them) give the
    same bits, and so does a row at any M."""
    del m, n
    blocks = -(-k // NF4_BLOCK)
    split = max(1, min(GEMV_MAX_SPLIT, blocks // F32MMA_RANK_BLOCKS))
    return GEMV_STRIP, -(-blocks // -(-blocks // split))


def _launch(x: torch.Tensor, w: NF4Tensor, route: str | None = None,
            plan: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch the kernel that `_route` names (`route` overrides it, and
    `plan` the split-K kernels' plan, only for ``chip_smoke.py``'s
    scans)."""
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"nf4_dot kernel takes float32 or bfloat16 x, got {x.dtype}")
    packed, scales = w.packed, w.scales
    if packed.dtype != torch.uint8 or packed.ndim != 2:
        raise TypeError(f"nf4_dot kernel takes a 2-D uint8 packed weight, got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    m, k = x.shape
    pairs, n = packed.shape
    if k != w.in_dim or not 0 <= 2 * pairs - k < NF4_BLOCK or pairs % (NF4_BLOCK // 2):
        raise ValueError(f"x [{m}, {k}] does not match NF4 weight with in_dim "
                         f"{w.in_dim} and packed {tuple(packed.shape)}")
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (2 * pairs // NF4_BLOCK, n):
        raise TypeError(f"nf4_dot kernel takes bf16 scales of shape "
                        f"{(2 * pairs // NF4_BLOCK, n)}, got {scales.dtype} "
                        f"{tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("nf4_dot kernel takes contiguous packed and scales")
    dev = x.device
    if packed.device != dev or scales.device != dev:
        raise ValueError(f"x on {dev}, packed on {packed.device}, scales on {scales.device}")
    if max(m, k, n) >= 2 ** 31 or pairs * n >= 2 ** 40:
        raise ValueError(f"nf4_dot kernel shape [{m}, {k}] x [{k}, {n}] too large")
    route = route or _route(m, k, n, x.dtype)
    x = x.contiguous()
    if route in ("mma", "f32mma") and x.data_ptr() % 16:
        x = x.clone()               # a view's offset: the copies need 16 B
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    lib = _library()
    entry = {"mma": lib.nf4_dot_mma_launch, "simt": lib.nf4_dot_launch,
             "gemv": lib.nf4_dot_gemv_launch, "f32mma": lib.nf4_dot_f32mma_launch}[route]
    plans = {"gemv": _gemv_plan, "f32mma": _f32mma_plan}
    extra = tuple(plan or plans[route](m, k, n)) if route in plans else ()
    if route == "f32mma":
        # Scratch for x's bf16 terms, [F32MMA_TERMS, M, P] words: the
        # kernel's first pass splits x into it once, every CTA reads it.
        terms = torch.empty((F32MMA_TERMS, m, pairs), dtype=torch.int32, device=dev)
        extra += (terms.data_ptr(),)
    # The raw current-stream handle: the cheap form of
    # torch.cuda.current_stream(dev).cuda_stream, on the decode hot path.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = entry(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
               y.data_ptr(), m, k, pairs, n, code, dev.index, stream, *extra)
    if rc != 0:
        raise RuntimeError(f"nf4_dot {route} kernel launch failed: "
                           + lib.nf4_dot_error_string(rc).decode())
    launch_counts.count(sys.modules[__name__], *_COUNTED[route])
    return y


# The counters a launch of each route adds one to.
_COUNTED = {"simt": ("_launches",), "mma": ("_launches", "_launches_mma"),
            "gemv": ("_launches", "_launches_gemv"),
            "f32mma": ("_launches", "_launches_f32mma")}


def nf4_dot(x: torch.Tensor, w: NF4Tensor) -> torch.Tensor:
    """x [..., K] @ NF4 weight [K, N] -> [..., N] in x.dtype. CPU tensors
    take the plain version; CUDA tensors launch the routed kernel (or
    raise), through `_NF4Dot` where x needs a gradient, so that no such
    output leaves without one."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = nf4_dot_reference(x2, w)
    elif x2.device.type == "cuda":
        y = (_NF4Dot.apply(x2, w.packed, w.scales, w)
             if x2.requires_grad and torch.is_grad_enabled() else _launch(x2, w))
    else:
        raise ValueError(f"nf4_dot has no version for device {x2.device}")
    return y.reshape(*lead, -1)
