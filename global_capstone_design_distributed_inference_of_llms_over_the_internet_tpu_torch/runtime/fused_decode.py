"""Fused multi-step decode: the single-device hot path of ``--mode oracle``.

Port of the JAX package's ``runtime/fused_decode.py``: `make_fused_decode`
(greedy) and `make_fused_sample_decode` (the full reference sampler), each
of which runs N decode steps as ONE compiled program (``fori_loop`` over
steps) and calls itself the counterpart of the reference's CUDA-graph
decode. On the card each becomes that graph again: one decode step (embed,
``stack_forward``, the head and the token's choice) is captured once
(``runtime/graphs.py``) and replayed n times, and the host reads the
tokens back once per chunk, not once per token.

The step keeps its state on the device, so a replay needs nothing from the
host: the engine owns the KV cache (``kc``/``vc`` at a bucket length,
zeroed at each prefill), the last token, ``cache_len``, a step index and
the ``[max_steps]`` token buffer. It decodes one sequence, the batch of
``--mode oracle``, its one caller. The step writes its token at the
device step index, then advances the index and ``cache_len`` inside the
graph. On the CPU there is no graph and the same step runs n times.

The sampled engine adds the sampler's state: the four knobs (0-d device
tensors, set once a generation), the recent-token ring and its length
(carried across chunks, as the reference returns them), and ``seed0``:
step i draws with ``PRNGKey(seed0 + i)`` built from the device step index,
the per-token loop's key schedule, and pushes its token into the ring.
Its first token, after the prompt, is drawn by the captured sampler
(`graphs.Sampler`) with ``PRNGKey(seed)``.

Of the reference's design choices these carry over:

  * **Head fused with the token's choice.** The head matmul and the argmax
    (or the sampler) are in the captured step, so no logits leave it and
    only token ids are read.
  * **exact_head.** The head is ``lm_head``'s own expression (the float32
    head of ``models/transformer.py``), the reference's
    ``exact_head=True`` (its sampled engine calls ``lm_head`` too), so the
    tokens are the per-token loop's on the same logits bits. The
    reference's default weight-dtype head (transposed, argmax of its
    float32 upcast) serves its benchmark and ``--mode fused``, which the
    port does not have yet; it comes with ``--mode fused``.

The reference's other choices (caches as the loop carry, one traced layer
body) are about XLA's program and have no counterpart here: the cache is
written in place and the captured step holds every layer's kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.transformer import (
    embed_tokens,
    full_forward,
    init_kv_cache,
    lm_head,
    stack_forward,
)
from ..ops.attention import check_cache_write
from ..ops.sampling import (
    SamplingParams,
    make_recent_buffer,
    push_recent,
    sample_token,
    sampling_scalars,
)
from ..ops.threefry import prng_key
from .graphs import Captured, Sampler, capture

Params = Dict[str, Any]


class FusedDecode:
    """Greedy decode of up to `max_steps` steps a call over a cache of
    `max_len` rows. ``prefill(ids)`` runs the prompt; ``engine(tok, start,
    n)`` then decodes n steps from token `tok` at cache length `start` and
    returns the ``[max_steps]`` int64 tokens on the host (entries at or
    past n are zero). `captures` and `replays` count the graph's capture
    and replays."""

    def __init__(self, cfg: ModelConfig, params: Params, max_steps: int,
                 max_len: int):
        self.cfg = cfg
        self.params = params
        self.max_steps = max_steps
        wte = params["embed"]["wte"]
        self.device = wte.device
        dev = self.device
        self.kc, self.vc = init_kv_cache(cfg, cfg.num_layers, 1, max_len,
                                         dtype=wte.dtype, device=dev)
        self.tok = torch.zeros(1, dtype=torch.int64, device=dev)
        self.cache_len = torch.zeros((), dtype=torch.int64, device=dev)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.toks = torch.zeros(max_steps, dtype=torch.int64, device=dev)
        # A graph on the card; elsewhere the step runs n times.
        self.graphed = self.device.type == "cuda"
        self.captures = 0
        self.replays = 0
        self._graph: Optional[Captured] = None

    def prefill(self, ids: torch.Tensor) -> torch.Tensor:
        """Zero the cache and run the prompt ids [1, T] through
        ``full_forward`` eagerly, as the reference's oracle does. Returns
        the logits [1, T, V]."""
        self.kc.zero_()
        self.vc.zero_()
        check_cache_write(0, ids.shape[1], self.kc.shape[2])
        logits, _, _ = full_forward(self.cfg, self.params,
                                    ids.to(self.device, non_blocking=True),
                                    self.kc, self.vc, 0)
        return logits

    def _step(self) -> torch.Tensor:
        """One decode step on the engine's device state: the token goes to
        entry `index` of `toks`, then `index` and `cache_len` advance."""
        cfg, params = self.cfg, self.params
        pos = self.cache_len.reshape(1, 1)
        x = embed_tokens(cfg, params["embed"], self.tok[:, None], pos)
        h, _, _ = stack_forward(cfg, params["layers"], x, pos, self.kc, self.vc,
                                self.cache_len)
        tok = torch.argmax(lm_head(cfg, params, h)[:, 0], dim=-1)    # [1]
        self.toks.index_copy_(0, self.index[None], tok)
        self.tok.copy_(tok)
        self.index.add_(1)
        self.cache_len.add_(1)
        return self.toks

    def _reset(self, tok: int, start: int) -> None:
        self.tok.fill_(tok)
        self.cache_len.fill_(start)
        self.index.zero_()
        self.toks.zero_()

    def __call__(self, tok: int, start: int, n: int) -> torch.Tensor:
        if not 0 <= n <= self.max_steps:
            raise ValueError(f"n={n} outside [0, {self.max_steps}]")
        check_cache_write(start, n, self.kc.shape[2])
        self._reset(tok, start)
        if not self.graphed:
            for _ in range(n):
                self._step()
            return self.toks.to("cpu", copy=True)
        if self._graph is None and n:
            # The warm-up run inside `capture` is a real step from this
            # state; the state is set again before the replays.
            self._graph = capture(self._step, torch.cuda.graph_pool_handle(),
                                  torch.cuda.Stream(self.device))
            self.captures += 1
            self._reset(tok, start)
        for _ in range(n):
            self._graph.replay()
        self.replays += n
        return self.toks.to("cpu", copy=True)     # the one read of the chunk


def make_fused_decode(cfg: ModelConfig, params: Params, max_steps: int,
                      max_len: int) -> FusedDecode:
    """A greedy engine over `params`, under the reference's name (there the
    caller passes the caches in; here the engine owns them, in the weights'
    dtype as the reference's oracle allocates them; see `FusedDecode`)."""
    return FusedDecode(cfg, params, max_steps, max_len)


class FusedSampleDecode(FusedDecode):
    """Sampled decode (batch 1) with the reference's full sampler in the
    captured step. ``begin(sampling)`` sets the knobs and empties the
    window, ``prefill(ids)`` runs the prompt, ``first_token(logits, seed)``
    draws the first token with the captured sampler and pushes it; then
    ``engine(tok, start, n, seed0)`` decodes n steps, step i keyed
    ``PRNGKey(seed0 + i)``, the window carried on the device from call to
    call."""

    def __init__(self, cfg: ModelConfig, params: Params, max_steps: int,
                 max_len: int):
        super().__init__(cfg, params, max_steps, max_len)
        dev = self.device
        self.recent, self.nvalid = make_recent_buffer(dev)
        # The ring as a call found it: the capture's warm-up step advances
        # it, and the replays start from it again.
        self._recent0, self._nvalid0 = make_recent_buffer(dev)
        self.seed0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.knobs = sampling_scalars(0.0, 1.0, 0, 1.0, dev)
        self.sampling = SamplingParams()
        self.sampler = Sampler(dev)

    def begin(self, sampling: SamplingParams) -> None:
        """Set the knobs of a generation and empty the window."""
        self.sampling = sampling
        for buf, value in zip(self.knobs, (sampling.temperature, sampling.top_p,
                                           sampling.top_k, sampling.repetition_penalty)):
            buf.fill_(value)
        self.recent.zero_()
        self.nvalid.zero_()

    def first_token(self, logits: torch.Tensor, seed: int) -> int:
        """Draw from the prompt's last logits [1, V] with ``PRNGKey(seed)``
        and an empty window (the captured sampler; its read is the one
        sync), then push the token into the ring."""
        tok = self.sampler(logits.float(), (), self.sampling, seed)[0]
        recent, nvalid = push_recent(self.recent, self.nvalid, tok)
        self.recent.copy_(recent)
        self.nvalid.copy_(nvalid)
        return tok

    def _step(self) -> torch.Tensor:
        """One sampled decode step on the engine's device state: the token
        drawn with ``PRNGKey(seed0 + index)`` goes to entry `index` of
        `toks` and into the ring; then `index` and `cache_len` advance."""
        cfg, params = self.cfg, self.params
        pos = self.cache_len.reshape(1, 1)
        x = embed_tokens(cfg, params["embed"], self.tok[:, None], pos)
        h, _, _ = stack_forward(cfg, params["layers"], x, pos, self.kc, self.vc,
                                self.cache_len)
        logits = lm_head(cfg, params, h)[0, 0]                       # [V]
        tok = sample_token(prng_key(self.seed0 + self.index), logits, self.recent,
                           self.nvalid, *self.knobs)
        recent, nvalid = push_recent(self.recent, self.nvalid, tok)
        self.recent.copy_(recent)
        self.nvalid.copy_(nvalid)
        self.toks.index_copy_(0, self.index[None], tok.reshape(1).long())
        self.tok.copy_(tok.reshape(1))
        self.index.add_(1)
        self.cache_len.add_(1)
        return self.toks

    def _reset(self, tok: int, start: int) -> None:
        super()._reset(tok, start)
        self.recent.copy_(self._recent0)
        self.nvalid.copy_(self._nvalid0)

    def __call__(self, tok: int, start: int, n: int, seed0: int) -> torch.Tensor:
        self.seed0.fill_(seed0)
        self._recent0.copy_(self.recent)
        self._nvalid0.copy_(self.nvalid)
        return super().__call__(tok, start, n)


def make_fused_sample_decode(cfg: ModelConfig, params: Params, max_steps: int,
                             max_len: int) -> FusedSampleDecode:
    """A sampled engine over `params`, under the reference's name (there
    the caller threads the caches, the window and its length through each
    call; here the engine keeps them on the device; see
    `FusedSampleDecode`)."""
    return FusedSampleDecode(cfg, params, max_steps, max_len)
