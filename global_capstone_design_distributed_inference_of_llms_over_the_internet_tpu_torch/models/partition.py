"""Stage partitioning: layer spans, stage roles, per-stage forward.

Port of the JAX package's ``models/partition.py``: a model is cut into
contiguous layer spans; the first stage also owns the embeddings, the last
also owns final norm + LM head. ``--splits "s0,s1,s2"`` gives the four
spans [0,s0) [s0,s1) [s1,s2) [s2,L).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..ops.attention import CacheLen
from .config import ModelConfig
from .quant import tree_map
from .transformer import embed_tokens, lm_head, stack_forward

Params = Dict[str, Any]

ROLE_STAGE0 = "stage0"
ROLE_SEGMENT = "segment"
ROLE_LAST = "last"
ROLE_FULL = "full"  # degenerate 1-stage plan: both embeddings and head


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage's role and layer span [start, end)."""

    index: int
    role: str
    start: int
    end: int

    @property
    def num_layers(self) -> int:
        return self.end - self.start

    @property
    def is_first(self) -> bool:
        return self.role in (ROLE_STAGE0, ROLE_FULL)

    @property
    def is_last(self) -> bool:
        return self.role in (ROLE_LAST, ROLE_FULL)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A full partition of a model into pipeline stages."""

    num_layers: int
    stages: Tuple[StageSpec, ...]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def __post_init__(self):
        assert self.stages, "empty plan"
        assert self.stages[0].start == 0
        assert self.stages[-1].end == self.num_layers
        for a, b in zip(self.stages, self.stages[1:]):
            assert a.end == b.start, f"non-contiguous spans: {a} -> {b}"

    @staticmethod
    def from_splits(num_layers: int, splits: Sequence[int]) -> "StagePlan":
        """Reference-CLI style boundaries. splits=[s0,s1,s2] -> 4 stages."""
        bounds = [0, *splits, num_layers]
        assert all(0 < b <= num_layers for b in splits), f"bad splits {splits}"
        assert bounds == sorted(bounds), f"splits must be increasing: {splits}"
        n = len(bounds) - 1
        stages = []
        for i in range(n):
            if n == 1:
                role = ROLE_FULL
            elif i == 0:
                role = ROLE_STAGE0
            elif i == n - 1:
                role = ROLE_LAST
            else:
                role = ROLE_SEGMENT
            stages.append(StageSpec(i, role, bounds[i], bounds[i + 1]))
        return StagePlan(num_layers, tuple(stages))

    @staticmethod
    def even(num_layers: int, num_stages: int) -> "StagePlan":
        """Near-even split into num_stages spans (larger spans first)."""
        base, rem = divmod(num_layers, num_stages)
        bounds = [0]
        for i in range(num_stages):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return StagePlan.from_splits(num_layers, bounds[1:-1])


def parse_splits(splits: str) -> List[int]:
    """"10,20,30" -> [10, 20, 30] (the reference flag format)."""
    return [int(x) for x in splits.split(",") if x.strip()]


def slice_stage_params(cfg: ModelConfig, params: Params, spec: StageSpec) -> Params:
    """Prune a full stacked-parameter tree to one stage's shard: layers
    [start:end] (views), embeddings on the first stage, final norm + head on
    the last (the tied embedding table for tied models)."""
    out: Params = {}
    if spec.num_layers > 0:
        out["layers"] = tree_map(lambda x: x[spec.start:spec.end], params["layers"])
    if spec.is_first:
        out["embed"] = params["embed"]
    if spec.is_last:
        out["final_norm"] = params["final_norm"]
        if cfg.tie_word_embeddings:
            out["embed"] = {**out.get("embed", {}), "wte": params["embed"]["wte"]}
        else:
            out["lm_head"] = params["lm_head"]
    return out


def stage_forward(cfg: ModelConfig, spec: StageSpec, params: Params,
                  inputs: torch.Tensor, k_caches: torch.Tensor,
                  v_caches: torch.Tensor, cache_len: CacheLen
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform stage forward, role-dispatched. inputs: int token ids [B, T]
    for the first stage, float hidden [B, T, D] otherwise. Returns
    (hidden-or-logits, k_caches, v_caches); caches are updated in place.
    `cache_len` is an int or a 0-d int64 device tensor (a captured step)."""
    t = inputs.shape[1]
    positions = cache_len + torch.arange(t, device=inputs.device)[None, :]
    x = embed_tokens(cfg, params["embed"], inputs, positions) if spec.is_first else inputs
    if spec.num_layers > 0:
        x, k_caches, v_caches = stack_forward(cfg, params["layers"], x, positions,
                                              k_caches, v_caches, cache_len)
    if spec.is_last:
        x = lm_head(cfg, params, x)
    return x, k_caches, v_caches
