"""int8 matmul with the per-channel scale folded into the epilogue.

    y = (x @ q) * s        # q int8 [K, N], s float32 [1, N], y in x.dtype

Port of the JAX package's ``ops/int8_kernel.py``. Scaling a column after
the K reduction is exactly scaling the column's weights before it, so the
fold differs from dequantize-then-matmul only in accumulation order.

Two versions of one function:

  * the CUDA kernel ``csrc/int8_dot.cu`` (Hopper, ``sm_90a``), launched for
    a tensor on the card — it reads the int8 bytes straight from device
    memory and never materializes a scaled weight;
  * `int8_dot_reference`, the plain PyTorch version, taken for a tensor on
    the CPU (the CPU tests) and used by ``chip_smoke.py`` to check the
    kernel on the card.

`int8_dot` launches the kernel or raises; it never falls back from the card
to the plain version. ``_launches`` counts kernel launches (not calls of the
plain version), so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.quant import QuantizedTensor
from ..utils.cuda_build import load_kernel_library

SOURCE = "int8_dot.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_launches = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library(SOURCE)
        lib.int8_dot_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.int8_dot_launch.restype = ctypes.c_int
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


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    global _launches
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
    x = x.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    lib = _library()
    # The raw current-stream handle: the cheap form of
    # torch.cuda.current_stream(dev).cuda_stream, on the decode hot path.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = lib.int8_dot_launch(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                             m, k, n, code, dev.index, stream)
    if rc != 0:
        raise RuntimeError("int8_dot kernel launch failed: "
                           + lib.int8_dot_error_string(rc).decode())
    _launches += 1
    return y


def int8_dot(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x [..., K] @ int8 weight [K, N] with the scale folded into the
    epilogue -> [..., N] in x.dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = int8_dot_reference(x2, w.q, w.s)
    elif x2.device.type == "cuda":
        y = _launch(x2, w.q, w.s)
    else:
        raise ValueError(f"int8_dot has no version for device {x2.device}")
    return y.reshape(*lead, -1)
