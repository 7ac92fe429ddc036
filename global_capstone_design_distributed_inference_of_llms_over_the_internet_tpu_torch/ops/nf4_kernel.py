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
    alone: "mma", the tensor-core kernel (bf16 x, M >= `MMA_MIN_M`, the
    alignment its 16-byte copies need: N % 16 == 0, K % 8 == 0), which
    dequantizes each weight once per block into shared memory; else
    "simt", the CUDA-core kernel, which reads the packed nibbles and the
    bf16 scales straight from device memory (0.5 B per weight plus 2 B
    per 64) and takes any M, K and N;
  * `nf4_dot_reference`, the plain PyTorch version, taken for a tensor on
    the CPU (the CPU tests) and used by ``chip_smoke.py`` to check the
    kernels on the card.

`nf4_dot` launches the routed kernel or raises; it never falls back from
one kernel to the other, or from the card to the plain version.
``_launches`` counts kernel launches of both routes (not calls of the plain
version) and ``_launches_mma`` those of the tensor-core route, so a run can
show that its main path went through the kernels (``ops/launch_counts.py``:
a launch recorded into a CUDA graph counts on each replay).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..models.quant import NF4_BLOCK, NF4Tensor
from ..utils.cuda_build import load_kernel_library
from . import launch_counts

SOURCE = "nf4_dot.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The least M that takes the tensor-core route: from the crossover scan of
# ``chip_smoke.py`` (both kernels at M = 1..16 on wgu and wd, PERF.md): on
# the H100 the tensor-core kernel is the faster at both sites from M = 3.
MMA_MIN_M = 3

_launches = 0
_launches_mma = 0
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


def _route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel for x [m, k] of `dtype` times an NF4 weight [k, n]: "mma"
    (tensor cores) for bf16 x at M >= MMA_MIN_M with N % 16 == 0 and
    K % 8 == 0, else "simt" (CUDA cores)."""
    if dtype == torch.bfloat16 and m >= MMA_MIN_M and n % 16 == 0 and k % 8 == 0:
        return "mma"
    return "simt"


def _launch(x: torch.Tensor, w: NF4Tensor, route: str | None = None) -> torch.Tensor:
    """Launch the kernel that `_route` names (`route` overrides it only for
    ``chip_smoke.py``'s crossover scan)."""
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
    if route == "mma" and x.data_ptr() % 16:
        x = x.clone()               # a view's offset: the copies need 16 B
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    lib = _library()
    entry = {"mma": lib.nf4_dot_mma_launch, "simt": lib.nf4_dot_launch}[route]
    # The raw current-stream handle: the cheap form of
    # torch.cuda.current_stream(dev).cuda_stream, on the decode hot path.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = entry(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
               y.data_ptr(), m, k, pairs, n, code, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"nf4_dot {route} kernel launch failed: "
                           + lib.nf4_dot_error_string(rc).decode())
    names = ("_launches", "_launches_mma") if route == "mma" else ("_launches",)
    launch_counts.count(sys.modules[__name__], *names)
    return y


def nf4_dot(x: torch.Tensor, w: NF4Tensor) -> torch.Tensor:
    """x [..., K] @ NF4 weight [K, N] -> [..., N] in x.dtype. CPU tensors
    take the plain version; CUDA tensors launch the routed kernel (or
    raise)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = nf4_dot_reference(x2, w)
    elif x2.device.type == "cuda":
        y = _launch(x2, w)
    else:
        raise ValueError(f"nf4_dot has no version for device {x2.device}")
    return y.reshape(*lead, -1)
