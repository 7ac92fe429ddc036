"""The wire codec: RNE fp32 <-> bf16 and CRC-32C, native, with plain versions.

Port of the JAX package's ``native/``: ``csrc/codec.cpp`` is a byte-equal
copy of its ``native/codec.cpp``, built at first use with ``g++ -O3
-shared -fPIC`` into ``build/kernels/codec-<digest>.so``
(``utils/cuda_build.load_host_library``) and bound with ctypes. Where the
reference falls back to numpy quietly when the build fails, the port
raises: the plain CRC below runs a Python loop over every byte (a quarter
of a second for one 30-token prefill hop at hidden 4096), which would make
every TCP number meaningless. The plain versions are the reference's numpy
code and serve the tests, which hold the native ones to them bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..utils.cuda_build import load_host_library

SOURCE = "codec.cpp"
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = load_host_library(SOURCE)
            lib.fp32_to_bf16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.fp32_to_bf16.restype = None
            lib.bf16_to_fp32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.bf16_to_fp32.restype = None
            lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.crc32c.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def build() -> None:
    """Build and load the native codec now (raises if it cannot)."""
    _load()


def have_native() -> bool:
    """Whether the native codec is loaded in this process."""
    return _lib is not None


def fp32_to_bf16_bytes(arr: np.ndarray) -> bytes:
    """fp32 array -> bf16 wire bytes (round-to-nearest-even)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    out = np.empty(arr.size, np.uint16)
    _load().fp32_to_bf16(arr.ctypes.data, out.ctypes.data, arr.size)
    return out.tobytes()


def bf16_bytes_to_fp32(data: bytes, shape) -> np.ndarray:
    """bf16 wire bytes -> fp32 array of `shape`."""
    src = np.ascontiguousarray(np.frombuffer(data, np.uint16))
    out = np.empty(src.size, np.float32)
    _load().bf16_to_fp32(src.ctypes.data, out.ctypes.data, src.size)
    return out.reshape(shape)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object."""
    buf = np.frombuffer(data, np.uint8)
    if not buf.size:
        return int(_load().crc32c(None, 0))
    return int(_load().crc32c(buf.ctypes.data, buf.size))


# ---------------------------------------------------------------------------
# Plain versions (the reference's numpy fallbacks, native/__init__.py:56-113)
# ---------------------------------------------------------------------------

def fp32_to_bf16_bytes_reference(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    bits = arr.view(np.uint32).reshape(-1)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    bias = 0x7FFF + ((bits >> 16) & 1)
    rounded = ((bits + bias) >> 16).astype(np.uint16)
    qnan = ((bits >> 16) | 0x0040).astype(np.uint16)
    return np.where(nan, qnan, rounded).tobytes()


def bf16_bytes_to_fp32_reference(data: bytes, shape) -> np.ndarray:
    raw = np.frombuffer(data, np.uint16)
    return (raw.astype(np.uint32) << 16).view(np.float32).reshape(shape)


def crc32c_reference(data: bytes) -> int:
    table = _py_table()
    crc = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, np.uint8)
    for b in arr:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


_TABLE = None


def _py_table():
    global _TABLE
    if _TABLE is None:
        poly = np.uint32(0x82F63B78)
        t = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = (poly ^ (c >> np.uint32(1))) if (c & np.uint32(1)) else (c >> np.uint32(1))
            t[i] = c
        _TABLE = t
    return _TABLE
