"""AdamW and the masked cross-entropy of the fine-tuning path.

Port of the part of the JAX package's ``parallel/trainer.py`` that
``runtime/finetune.py`` uses: the inline AdamW (``:53-81``: float32 moments
shaped like the parameters, the reference's bias correction and decoupled
weight decay, a step count) and `softmax_xent` (``:252-258``: the mean
over positions whose target is >= 0). Trees are nested dicts of tensors;
the optimizer state is ``{"mu": tree, "nu": tree, "count": int32 0-d}``,
the reference's layout, so a checkpoint carries across the packages.
`PipelineTrainer` and the mesh engines are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of nested dicts, leaf by leaf across `rest`
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params: Params) -> Params:
    """Zero float32 moments shaped like `params`, on their devices, and a
    zero step count."""
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_update(grads: Params, state: Params, params: Params, *,
                 lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0
                 ) -> Tuple[Params, Params]:
    """One AdamW step: (new params in their dtypes, new state). Moments in
    float32; bias correction ``1 - b ** count`` in float32; the decay is
    decoupled (``p - lr * (step + weight_decay * p)``)."""
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=count.device),
                         count.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=count.device),
                         count.float())
    g32 = tree_map(lambda g: g.float(), grads)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], g32)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"], g32)

    def upd(p, m, v):
        step = (m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device)) + eps)
        p32 = p.float()
        return (p32 - lr * (step + weight_decay * p32)).to(p.dtype)

    return tree_map(upd, params, mu, nu), {"mu": mu, "nu": nu, "count": count}


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over positions with target >= 0 (< 0 = ignore),
    in float32."""
    mask = (targets >= 0).float()
    tgt = targets.clamp(min=0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
