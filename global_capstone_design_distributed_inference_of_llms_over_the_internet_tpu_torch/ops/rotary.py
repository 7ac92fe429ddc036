"""Rotary position embeddings (port of the JAX package's ``ops/rotary.py``).

HF "half-rotation" layout (rotate_half), computed in float32.
"""

from __future__ import annotations

import math

import torch


def rope_frequencies(head_dim: int, theta: float, scaling=None,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32.

    ``scaling`` = (factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings) applies the Llama-3.1 "llama3"
    frequency remap: wavelengths past ``orig_max/low_freq_factor`` are
    slowed by ``factor``, wavelengths below ``orig_max/high_freq_factor``
    are untouched, and the band between interpolates smoothly.
    """
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    # A fill, not a host-to-device copy: this runs inside captured steps.
    inv_freq = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                          device=device), exponents)
    if scaling is None:
        return inv_freq
    factor, low_ff, high_ff, orig_max = scaling
    wavelen = 2.0 * math.pi / inv_freq
    low_wl = orig_max / low_ff
    high_wl = orig_max / high_ff
    smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(wavelen > low_wl, inv_freq / factor,
                       torch.where(wavelen < high_wl, inv_freq, smoothed))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None):
    """cos/sin tables for integer positions [...] -> each [..., head_dim]
    float32, with the duplicated-half layout."""
    inv_freq = rope_frequencies(head_dim, theta, scaling, positions.device)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, Dh]. Computed in float32 and cast
    back to x.dtype."""
    x32 = x.float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return (x32 * c + _rotate_half(x32) * s).to(x.dtype)
