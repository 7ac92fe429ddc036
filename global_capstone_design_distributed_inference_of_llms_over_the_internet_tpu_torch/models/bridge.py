"""Carry a JAX param tree across to the port's layout.

The input is the JAX package's param tree with every array already on the
host as numpy (``jax.tree.map(np.asarray, params)``): nested dicts whose
leaves are numpy arrays or quantized leaves: any object with ``q``, ``s``
and ``dtype`` attributes (the reference's int8 ``QuantizedTensor``) or with
``packed``, ``scales``, ``in_dim`` and ``dtype`` (its ``NF4Tensor``). The
output is the same tree of torch tensors, with quantized leaves as the
port's `QuantizedTensor` and `NF4Tensor`. Nothing of JAX is imported: bfloat16 arrays cross
as their uint16 bit patterns, viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .quant import NF4Tensor, QuantizedTensor


def array_to_torch(a, device="cpu") -> torch.Tensor:
    """numpy array (bfloat16 included) -> torch tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def torch_to_array(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy; bfloat16 comes back as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_jax_tree(tree: Any, device="cpu") -> Any:
    """JAX param tree (numpy leaves) -> the port's param tree on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("packed", "scales", "in_dim", "dtype")):
        return NF4Tensor(array_to_torch(tree.packed, device),
                         array_to_torch(tree.scales, device), int(tree.in_dim),
                         str(tree.dtype))
    if all(hasattr(tree, a) for a in ("q", "s", "dtype")):
        return QuantizedTensor(array_to_torch(tree.q, device),
                               array_to_torch(tree.s, device), str(tree.dtype))
    return array_to_torch(tree, device)
