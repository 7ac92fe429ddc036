"""The threefry Gumbel-max draw of a sampled token, one kernel on the card.

    token[r] = argmax_i( gumbel(key_r)[i] + logp[r, i] )   (first index on ties)

for float32 ``logp [B, V]`` (or ``[V]``) and int64 keys ``[B, 2]`` (or
``[2]``, or a pair of ints) of uint32 words: ``jax.random.categorical``
row by row, as the reference's sampler draws (``ops/sampling.py:309`` of
the JAX package, under ``vmap`` for a batch of rows).

Two versions of one function:

  * the CUDA kernels of ``csrc/sample_draw.cu`` (Hopper, ``sm_90a``),
    launched for a tensor on the card: one pass that hashes, scores and
    reduces each block's chunk of a row, then one block a row that reduces
    the blocks' bests, both under one total order (ties to the first
    index), so the token never depends on which block finishes first;
  * `sample_draw_reference`, the plain PyTorch version
    (``ops/threefry.categorical_reference``), taken for a tensor on the CPU
    (the CPU tests) and used by ``chip_smoke.py`` to check the kernel on
    the card, noise and tokens.

`sample_draw` launches the kernel or raises; it never falls back from the
card to the plain version. It reads nothing back to the host: the tokens
stay on the device, so a CUDA graph can hold the draw
(``runtime/graphs.py``). ``_launches`` counts launches (one a call: the
kernel pair), through ``ops/launch_counts.py`` (a launch recorded into a
graph counts on each replay). Nothing is built when this module is
imported: the library builds at the first launch, or at `build()`.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import Optional, Tuple

import torch

from ..utils.cuda_build import load_kernel_library
from . import launch_counts
from .threefry import Key, categorical_reference, gumbel, key_tensor

SOURCE = "sample_draw.cu"
# Launch shape, as csrc/sample_draw.cu takes it: 256 threads a block, each
# block a chunk of one row of THREADS * PER_THREAD elements.
THREADS = 256
PER_THREAD = 4

_launches = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library(SOURCE)
        lib.sample_draw_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
        lib.sample_draw_launch.restype = ctypes.c_int
        lib.sample_draw_error_string.argtypes = [ctypes.c_int]
        lib.sample_draw_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _library()


def _grid(vocab: int) -> Tuple[int, int]:
    """(blocks a row, elements a block) for a row of `vocab` elements:
    blocks * chunk >= vocab > (blocks - 1) * chunk."""
    chunk = THREADS * PER_THREAD
    return -(-vocab // chunk), chunk


def sample_draw_reference(key: Key, logp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the int32 tokens ``[...]`` of float32 logp
    ``[..., V]`` (``threefry.categorical_reference``)."""
    return categorical_reference(key, logp).to(torch.int32)


def _launch(keys: torch.Tensor, logp: torch.Tensor,
            noise_out: Optional[torch.Tensor]) -> torch.Tensor:
    if logp.dtype != torch.float32:
        raise TypeError(f"sample_draw kernel takes float32 logp, got {logp.dtype}")
    if logp.ndim not in (1, 2) or logp.shape[-1] == 0:
        raise ValueError(f"sample_draw kernel takes logp [V] or [B, V], got "
                         f"{tuple(logp.shape)}")
    lead, vocab = tuple(logp.shape[:-1]), logp.shape[-1]
    if tuple(keys.shape) != (*lead, 2):
        raise ValueError(f"sample_draw kernel takes one key a row: keys "
                         f"{tuple(keys.shape)} for logp {tuple(logp.shape)}")
    rows = math.prod(lead)
    if vocab >= 2 ** 31 or rows > 65535:
        raise ValueError(f"sample_draw kernel shape {tuple(logp.shape)} too large")
    dev = logp.device
    if noise_out is not None and (noise_out.dtype != torch.float32
                                  or noise_out.shape != logp.shape
                                  or noise_out.device != dev
                                  or not noise_out.is_contiguous()):
        raise ValueError("noise_out must be a contiguous float32 tensor shaped as logp")
    lp = logp.contiguous()
    kk = keys.contiguous()
    blocks, chunk = _grid(vocab)
    out = torch.empty(lead, dtype=torch.int32, device=dev)
    part_val = torch.empty((rows, blocks), dtype=torch.float32, device=dev)
    part_idx = torch.empty((rows, blocks), dtype=torch.int32, device=dev)
    lib = _library()
    # The raw current-stream handle: the cheap form of
    # torch.cuda.current_stream(dev).cuda_stream, on the decode hot path.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = lib.sample_draw_launch(lp.data_ptr(), kk.data_ptr(),
                                None if noise_out is None else noise_out.data_ptr(),
                                part_val.data_ptr(), part_idx.data_ptr(), out.data_ptr(),
                                rows, vocab, blocks, chunk, dev.index, stream)
    if rc != 0:
        raise RuntimeError("sample_draw kernel launch failed: "
                           + lib.sample_draw_error_string(rc).decode())
    launch_counts.count(sys.modules[__name__], "_launches")
    return out


def sample_draw(key: Key, logp: torch.Tensor,
                noise_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int32 tokens ``[...]`` of float32 logp ``[..., V]``, one key a
    row. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). `noise_out` (float32, logp's shape), if given,
    receives the Gumbel noise, for checking it against the plain version's."""
    if logp.device.type == "cpu":
        if noise_out is not None:
            batch = key.ndim - 1 if isinstance(key, torch.Tensor) else 0
            noise_out.copy_(gumbel(key, logp.shape[batch:], "cpu"))
        return sample_draw_reference(key, logp)
    if logp.device.type == "cuda":
        return _launch(key_tensor(key, logp.device), logp, noise_out)
    raise ValueError(f"sample_draw has no version for device {logp.device}")
