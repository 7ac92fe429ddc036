"""int8 matmul with the per-channel scale folded into the epilogue.

    y = (x @ q) * s        # q int8 [K, N], s float32 [1, N], y in x.dtype

Port of the JAX package's ``ops/int8_kernel.py``. Scaling a column after
the K reduction is exactly scaling the column's weights before it, so the
fold differs from dequantize-then-matmul only in accumulation order.

Two versions of one function:

  * the CUDA kernels of ``csrc/int8_dot.cu`` (Hopper, ``sm_90a``), launched
    for a tensor on the card. `_route` picks one from M, K, N and x's dtype
    alone: "gemv", the decode kernel (M <= `GEMV_MAX_M`: bf16 x below
    `MMA_MIN_M`, float32 x; N % 16 == 0, K <= `GEMV_MAX_K`), split-K over a
    thread-block cluster whose size `_gemv_plan` picks; "f32mma", float32
    x at M >= `F32MMA_MIN_M` (the prefill of the stages behind TCP and the
    batched rounds; N % 16 == 0, K % 4 == 0, K <= `GEMV_MAX_K`): the
    decode kernel's structure and plan (`_gemv_plan`) on the tensor cores
    with x split into `F32MMA_TERMS` bf16 terms, in M tiles of up to
    `F32MMA_MAX_FRAGS` n8 fragments; "mma", the
    tensor-core kernel (bf16 x, M >= `MMA_MIN_M`, the alignment its 16-byte
    copies need: N % 16 == 0, K % 8 == 0), which widens each int8 weight
    once per block into a bf16 tile in shared memory; else "simt", the
    CUDA-core kernel (bf16 x at M 3-4, ragged shapes), which reads the
    int8 bytes straight from device memory and takes any M, K and N. None
    ever materializes a scaled weight: each scales the float32 sums;
  * `int8_dot_reference`, the plain PyTorch version, taken for a tensor on
    the CPU (the CPU tests) and used by ``chip_smoke.py`` to check the
    kernels on the card.

`int8_dot` launches the routed kernel or raises; it never falls back from
one kernel to the other, or from the card to the plain version.

A launch returns a tensor with no autograd history, so on the card an x
that needs a gradient goes through `_Int8Dot`, whose backward is the
gradient of the plain version with respect to x (`int8_dot_grad_x`, the
transpose of the reference's ``dot_general`` fallback: the weights are
frozen, as in the reference's training path). That product is plain
PyTorch, as it is XLA's in the reference, over the weight widened to
float32 a block of columns at a time. On the CPU the plain version is
differentiable as it stands.
``_launches`` counts kernel launches of every route (not calls of the plain
version), ``_launches_mma`` those of the tensor-core route and
``_launches_gemv`` those of the decode route and ``_launches_f32mma``
those of the float32 route, so a run can show that its main path went
through the kernels (``ops/launch_counts.py``: a launch recorded into a
CUDA graph counts on each replay).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..models.quant import QuantizedTensor
from ..utils.cuda_build import load_kernel_library
from . import launch_counts

SOURCE = "int8_dot.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The least M that takes the tensor-core route: from the crossover scan of
# ``chip_smoke.py`` (both kernels at M = 1..16 on wgu and wd, PERF.md): on
# the H100 the tensor-core kernel is the faster at both sites from M = 5.
MMA_MIN_M = 5

# The decode route's geometry, as ``csrc/int8_dot.cu`` has it (kGemv*): a
# CTA of 4 warps owns 128 columns and walks K in stages of 128 rows (32 a
# warp), each copied into a ring of 4 in shared memory 3 stages ahead of
# the work; a cluster of at most 8 CTAs (the portable size) splits K, each
# rank at most 32 stages (its x stage in shared memory). A plan gives each
# rank at most GEMV_RANK_STAGES stages (1024 rows): in ``chip_smoke.py``'s
# plan scan every llama-3.1-8b site ran within a few percent of its
# fastest split at that cut (PERF.md).
GEMV_MAX_M = 2
GEMV_STRIP = 128
GEMV_WARPS = 4
GEMV_ROWS = 128
GEMV_STAGES = 4
GEMV_MAX_SPLIT = 8
GEMV_MAX_CHUNK = 32
GEMV_MAX_K = GEMV_MAX_SPLIT * GEMV_MAX_CHUNK * GEMV_ROWS
GEMV_RANK_STAGES = 8

# The float32 route's geometry, as ``csrc/int8_dot.cu`` has it (kF32Mma*):
# the decode kernel's strips, stages, cluster and plan; x in n8 B fragments
# of the mma (F32MMA_ROWS rows each), M tiles of one fragment up to M = 8
# (the batched engine's M = --slots, 8 by default) and of F32MMA_MAX_FRAGS
# past it, next to each other in the grid; each float32 value as
# F32MMA_TERMS bf16 terms; a ring of F32MMA_STAGES slots, each a stage's
# weights and its rows of the tile's x.
F32MMA_MIN_M = GEMV_MAX_M + 1
F32MMA_ROWS = 8
F32MMA_MAX_FRAGS = 2
F32MMA_TERMS = 3
F32MMA_STAGES = 3

# The gradient's product widens the weight to float32 a block of columns at
# a time, at most this many bytes of it at once: wgu of llama-3.1-8b
# (4096 x 28672) is 470 MB widened whole.
GRAD_CHUNK_BYTES = 256 << 20

_launches = 0
_launches_mma = 0
_launches_gemv = 0
_launches_f32mma = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library(SOURCE)
        lib.int8_dot_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.int8_dot_launch.restype = ctypes.c_int
        lib.int8_dot_mma_launch.argtypes = lib.int8_dot_launch.argtypes
        lib.int8_dot_mma_launch.restype = ctypes.c_int
        lib.int8_dot_gemv_launch.argtypes = (lib.int8_dot_launch.argtypes
                                             + [ctypes.c_int] * 2)
        lib.int8_dot_gemv_launch.restype = ctypes.c_int
        lib.int8_dot_f32mma_launch.argtypes = lib.int8_dot_gemv_launch.argtypes
        lib.int8_dot_f32mma_launch.restype = ctypes.c_int
        lib.int8_dot_error_string.argtypes = [ctypes.c_int]
        lib.int8_dot_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _library()


def int8_dot_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [M, K] @ int8 q [K, N], float32 accumulate,
    times s [1, N], cast to x.dtype."""
    return ((x.float() @ q.float()) * s).to(x.dtype)


def grad_column_blocks(k: int, n: int, itemsize: int = 4) -> list:
    """Column ranges [n0, n1) of a [k, n] weight whose widened copy, at
    `itemsize` bytes a weight, fits GRAD_CHUNK_BYTES (one column at least)."""
    cols = max(1, GRAD_CHUNK_BYTES // (itemsize * max(k, 1)))
    return [(n0, min(n, n0 + cols)) for n0 in range(0, n, cols)]


def int8_dot_grad_x(g: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The gradient of `int8_dot_reference` with respect to x for the
    output's gradient g [M, N]: ``(g * s) @ q.T`` in float32, cast to x's
    `dtype`, summed over blocks of columns (`grad_column_blocks`)."""
    gs = g.float() * s.reshape(1, -1)
    out = None
    for n0, n1 in grad_column_blocks(q.shape[0], q.shape[1]):
        part = gs[:, n0:n1] @ q[:, n0:n1].float().T
        out = part if out is None else out.add_(part)
    return out.to(dtype)


class _Int8Dot(torch.autograd.Function):
    """The routed launch, differentiable in x (q and s are frozen)."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.save_for_backward(q, s)
        ctx.x_dtype = x.dtype
        return _launch(x, q, s)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        return int8_dot_grad_x(g, q, s, ctx.x_dtype), None, None


def _route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel for x [m, k] of `dtype` times an int8 weight [k, n]:
    "gemv" (decode) for M <= GEMV_MAX_M, bf16 x below MMA_MIN_M or float32
    x, with N % 16 == 0 and K <= GEMV_MAX_K; "f32mma" (tensor cores, x as
    bf16 terms) for float32 x at M >= F32MMA_MIN_M with N % 16 == 0, K % 4
    == 0 and K <= GEMV_MAX_K; "mma" (tensor cores) for bf16 x at M >=
    MMA_MIN_M with N % 16 == 0 and K % 8 == 0; else "simt" (CUDA cores)."""
    decode = m <= GEMV_MAX_M and (dtype == torch.float32 or
                                  (dtype == torch.bfloat16 and m < MMA_MIN_M))
    if decode and n % 16 == 0 and k <= GEMV_MAX_K:
        return "gemv"
    if (dtype == torch.float32 and m >= F32MMA_MIN_M
            and n % 16 == 0 and k % 4 == 0 and k <= GEMV_MAX_K):
        return "f32mma"
    if dtype == torch.bfloat16 and m >= MMA_MIN_M and n % 16 == 0 and k % 8 == 0:
        return "mma"
    return "simt"


def _gemv_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(strip_cols, split) of the decode kernel for x [m, k] times a weight
    [k, n]: strips of GEMV_STRIP columns, and the cluster size `split` that
    cuts K into whole GEMV_ROWS-row stages, ceil(stages / split) a rank.
    Of the splits up to GEMV_MAX_SPLIT that leave each rank at most
    GEMV_MAX_CHUNK stages, the least that gives every rank the same number
    of stages, at most GEMV_RANK_STAGES; else the most that gives every
    rank the same number; else the most. The split is then cut to the
    ranks that get a stage.

    The plan depends on K alone, not on N or M: the order of a column's
    float32 sums follows the split, so a fused weight (wq|wk|wv, wg|wu, as
    the stage executors hold them) and its parts (as a full_forward over
    the loaded weights runs them) give the same bits, a CTA's sums for
    both rows of x at decode share its loads, and a row gives the same
    bits at every M of the float32 route."""
    del m, n
    stages = -(-k // GEMV_ROWS)
    least = -(-stages // GEMV_MAX_CHUNK)
    splits = range(least, min(GEMV_MAX_SPLIT, stages) + 1)
    even = [s for s in splits if stages % s == 0]
    short = [s for s in even if stages // s <= GEMV_RANK_STAGES]
    split = short[0] if short else max(even or splits, default=least)
    return GEMV_STRIP, -(-stages // -(-stages // split))


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            route: str | None = None,
            plan: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch the kernel that `_route` names (`route` overrides it, and
    `plan` the split-K kernels' `_gemv_plan`, only for ``chip_smoke.py``'s
    scans)."""
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"int8_dot kernel takes float32 or bfloat16 x, got {x.dtype}")
    if q.dtype != torch.int8 or q.ndim != 2:
        raise TypeError(f"int8_dot kernel takes a 2-D int8 q, got {q.dtype} {tuple(q.shape)}")
    m, k = x.shape
    n = q.shape[1]
    if q.shape[0] != k:
        raise ValueError(f"x [{m}, {k}] does not match q {tuple(q.shape)}")
    if s.dtype != torch.float32 or s.numel() != n:
        raise TypeError(f"int8_dot kernel takes a float32 scale of {n} columns, "
                        f"got {s.dtype} {tuple(s.shape)}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_dot kernel takes contiguous q and s")
    dev = x.device
    if q.device != dev or s.device != dev:
        raise ValueError(f"x on {dev}, q on {q.device}, s on {s.device}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"int8_dot kernel shape [{m}, {k}] x [{k}, {n}] too large")
    route = route or _route(m, k, n, x.dtype)
    x = x.contiguous()
    if route in ("mma", "gemv", "f32mma") and x.data_ptr() % 16:
        x = x.clone()               # a view's offset: the copies need 16 B
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    lib = _library()
    entry = {"mma": lib.int8_dot_mma_launch, "simt": lib.int8_dot_launch,
             "gemv": lib.int8_dot_gemv_launch,
             "f32mma": lib.int8_dot_f32mma_launch}[route]
    # Both split-K routes take `_gemv_plan`: a function of K alone, so a
    # fused weight and its parts, and a row at any M, give the same bits.
    extra = (plan or _gemv_plan(m, k, n)) if route in ("gemv", "f32mma") else ()
    # The raw current-stream handle: the cheap form of
    # torch.cuda.current_stream(dev).cuda_stream, on the decode hot path.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = entry(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
               m, k, n, code, dev.index, stream, *extra)
    if rc != 0:
        raise RuntimeError(f"int8_dot {route} kernel launch failed: "
                           + lib.int8_dot_error_string(rc).decode())
    launch_counts.count(sys.modules[__name__], *_COUNTED[route])
    return y


# The counters a launch of each route adds one to.
_COUNTED = {"simt": ("_launches",), "mma": ("_launches", "_launches_mma"),
            "gemv": ("_launches", "_launches_gemv"),
            "f32mma": ("_launches", "_launches_f32mma")}


def int8_dot(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x [..., K] @ int8 weight [K, N] with the scale folded into the
    epilogue -> [..., N] in x.dtype. CPU tensors take the plain version;
    CUDA tensors launch the routed kernel (or raise), through `_Int8Dot`
    where x needs a gradient, so that no such output leaves without one."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = int8_dot_reference(x2, w.q, w.s)
    elif x2.device.type == "cuda":
        y = (_Int8Dot.apply(x2, w.q, w.s) if x2.requires_grad and torch.is_grad_enabled()
             else _launch(x2, w.q, w.s))
    else:
        raise ValueError(f"int8_dot has no version for device {x2.device}")
    return y.reshape(*lead, -1)
