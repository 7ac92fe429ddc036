"""int8 matmul with the per-channel scale folded into the epilogue.

    y = (x @ q) * s        # q int8 [K, N], s float32 [1, N], y in x.dtype

Port of the JAX package's ``ops/int8_kernel.py``. Scaling a column after
the K reduction is exactly scaling the column's weights before it, so the
fold differs from dequantize-then-matmul only in accumulation order.

Two versions of one function:

  * the CUDA kernels of ``csrc/int8_dot.cu`` (Hopper, ``sm_90a``), launched
    for a tensor on the card. `_route` picks one from M, K, N and x's dtype
    alone: "mma", the tensor-core kernel (bf16 x, M >= `MMA_MIN_M`, the
    alignment its 16-byte copies need: N % 16 == 0, K % 8 == 0), which
    widens each int8 weight once per block into a bf16 tile in shared
    memory; else "simt", the CUDA-core kernel, which reads the int8 bytes
    straight from device memory and takes any M, K and N. Neither ever
    materializes a scaled weight: both scale the float32 sums;
  * `int8_dot_reference`, the plain PyTorch version, taken for a tensor on
    the CPU (the CPU tests) and used by ``chip_smoke.py`` to check the
    kernels on the card.

`int8_dot` launches the routed kernel or raises; it never falls back from
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

from ..models.quant import QuantizedTensor
from ..utils.cuda_build import load_kernel_library
from . import launch_counts

SOURCE = "int8_dot.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The least M that takes the tensor-core route: from the crossover scan of
# ``chip_smoke.py`` (both kernels at M = 1..16 on wgu and wd, PERF.md): on
# the H100 the tensor-core kernel is the faster at both sites from M = 5.
MMA_MIN_M = 5

_launches = 0
_launches_mma = 0
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


def _route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel for x [m, k] of `dtype` times an int8 weight [k, n]: "mma"
    (tensor cores) for bf16 x at M >= MMA_MIN_M with N % 16 == 0 and
    K % 8 == 0, else "simt" (CUDA cores)."""
    if dtype == torch.bfloat16 and m >= MMA_MIN_M and n % 16 == 0 and k % 8 == 0:
        return "mma"
    return "simt"


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            route: str | None = None) -> torch.Tensor:
    """Launch the kernel that `_route` names (`route` overrides it only for
    ``chip_smoke.py``'s crossover scan)."""
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
    if route == "mma" and x.data_ptr() % 16:
        x = x.clone()               # a view's offset: the copies need 16 B
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    lib = _library()
    entry = {"mma": lib.int8_dot_mma_launch, "simt": lib.int8_dot_launch}[route]
    # The raw current-stream handle: the cheap form of
    # torch.cuda.current_stream(dev).cuda_stream, on the decode hot path.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = entry(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
               m, k, n, code, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"int8_dot {route} kernel launch failed: "
                           + lib.int8_dot_error_string(rc).decode())
    names = ("_launches", "_launches_mma") if route == "mma" else ("_launches",)
    launch_counts.count(sys.modules[__name__], *names)
    return y


def int8_dot(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x [..., K] @ int8 weight [K, N] with the scale folded into the
    epilogue -> [..., N] in x.dtype. CPU tensors take the plain version;
    CUDA tensors launch the routed kernel (or raise)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = int8_dot_reference(x2, w.q, w.s)
    elif x2.device.type == "cuda":
        y = _launch(x2, w.q, w.s)
    else:
        raise ValueError(f"int8_dot has no version for device {x2.device}")
    return y.reshape(*lead, -1)
