"""Paged decode attention, one kernel pair on the card.

    out[b, 0, h] = softmax_{j <= cache_len}(q[b, 0, h] . k[b, j, h // G] / sqrt(Dh))
                   @ v[b, j, h // G]

for q ``[B, 1, H, Dh]`` and caches ``[B, S, Hkv, Dh]`` (float32 or bf16
each; the new key already written at cache_len), a page of the cache at a
time: the reference's ``paged_decode_attention`` (``ops/attention.py:58``
of the JAX package), which the layer takes at decode when
``ModelConfig.decode_kv_page`` is set.

Two versions of one function:

  * the CUDA kernels of ``csrc/paged_decode_attention.cu`` (Hopper,
    ``sm_90a``), launched for a tensor on the card: a pass over chunks of
    pages that skips the chunks past cache_len, reading cache_len from
    device memory (a 0-d int64 tensor, as a captured step holds it) or
    taking a Python int by value, then a pass that merges the chunks'
    partials. The grid follows the shapes alone, so one captured launch
    replays at every length;
  * ``ops.attention.paged_decode_attention``, the plain PyTorch version,
    taken for a tensor on the CPU (the CPU tests) and used by
    ``chip_smoke.py`` to check the kernel on the card; it reads cache_len
    to the host.

`paged_decode_attention` launches the kernel or raises; it never falls back
from the card to the plain version. ``_launches`` counts launches (one a
call: the kernel pair), through ``ops/launch_counts.py`` (a launch recorded
into a graph counts on each replay). Nothing is built when this module is
imported: the library builds at the first launch, or at `build()`.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Union

import torch

from ..utils.cuda_build import load_kernel_library
from . import launch_counts
from .attention import paged_decode_attention as paged_decode_attention_reference

SOURCE = "paged_decode_attention.cu"
# What csrc/paged_decode_attention.cu takes: query heads a KV head, head
# width, rows a page.
MAX_GROUPS = 8
MAX_HEAD_DIM = 256
MAX_PAGE = 128
# Rows a block of the first pass covers (whole pages): a chunk of
# CHUNK_ROWS // page pages, at least one.
CHUNK_ROWS = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_launches = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library(SOURCE)
        lib.paged_decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.paged_decode_attention_launch.restype = ctypes.c_int
        lib.paged_decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _library()


def chunk_plan(s: int, page: int):
    """(pages a chunk, chunks) of a cache bucket of `s` rows: whole pages,
    about CHUNK_ROWS rows a chunk."""
    chunk_pages = max(1, CHUNK_ROWS // page)
    pages = s // page
    return chunk_pages, -(-pages // chunk_pages)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cache_len: Union[int, torch.Tensor], page: int) -> torch.Tensor:
    dev = q.device
    if q.dtype not in _DTYPE_CODE or k_cache.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention kernel takes float32 or bfloat16 q and "
                        f"caches, got {q.dtype} and {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError("paged_decode_attention kernel takes k and v caches of one "
                         "dtype and shape")
    if q.ndim != 4 or k_cache.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention kernel takes q [B, 1, H, Dh] and caches "
                         f"[B, S, Hkv, Dh], got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, _, h, dh = q.shape
    _, s, hkv, dhk = k_cache.shape
    if k_cache.shape[0] != b or dhk != dh or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match caches {tuple(k_cache.shape)}")
    groups = h // hkv
    if not (groups <= MAX_GROUPS and dh <= MAX_HEAD_DIM and 0 < page <= MAX_PAGE):
        raise ValueError(f"paged_decode_attention kernel takes G <= {MAX_GROUPS}, "
                         f"Dh <= {MAX_HEAD_DIM}, page <= {MAX_PAGE}; got G {groups}, "
                         f"Dh {dh}, page {page}")
    if s % page:
        raise ValueError(f"cache bucket {s} not divisible by page {page}")
    if b > 65535 or hkv > 65535 or b * s * hkv * dh >= 2 ** 62:
        raise ValueError(f"paged_decode_attention kernel shape {tuple(k_cache.shape)} "
                         "too large")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("paged_decode_attention kernel takes contiguous caches")
    q = q.contiguous()              # a projection's view: one row a head
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"q on {dev}, caches on {k_cache.device} and {v_cache.device}")
    if isinstance(cache_len, torch.Tensor):
        if (cache_len.dtype != torch.int64 or cache_len.numel() != 1
                or cache_len.device != dev):
            raise ValueError("paged_decode_attention kernel takes cache_len as an int or "
                             "a one-element int64 tensor on the caches' device")
        len_ptr, len_value = cache_len.data_ptr(), 0
    else:
        len_ptr, len_value = None, int(cache_len)
        if not 0 <= len_value < s:
            raise ValueError(f"cache_len {len_value} outside a cache of {s} rows")
    chunk_pages, chunks = chunk_plan(s, page)
    m_part = torch.empty((b, hkv, chunks, groups), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, hkv, chunks, groups, dh), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _library()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = lib.paged_decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), len_ptr, len_value,
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(),
        b, s, hkv, groups, dh, page, chunk_pages, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_cache.dtype], dh ** -0.5, dev.index, stream)
    if rc != 0:
        raise RuntimeError("paged_decode_attention kernel launch failed: "
                           + lib.paged_decode_attention_error_string(rc).decode())
    launch_counts.count(sys.modules[__name__], "_launches")
    return out


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_len: Union[int, torch.Tensor], page: int) -> torch.Tensor:
    """Decode attention of q [B, 1, H, Dh] over rows 0..cache_len of the
    caches [B, S, Hkv, Dh], `page` rows at a time -> [B, 1, H, Dh] in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_cache, v_cache, cache_len, page)
    if q.device.type == "cuda":
        return _launch(q, k_cache, v_cache, cache_len, page)
    raise ValueError(f"paged_decode_attention has no version for device {q.device}")
