"""Normalization ops (port of the JAX package's ``ops/norms.py``).

Accumulation is float32 regardless of activation dtype; the result is cast
back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * (1.0 / torch.sqrt(var + eps))
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)
