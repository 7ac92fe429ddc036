"""Client-driven distributed fine-tuning: deep prompt tuning and LoRA over
the swarm.

Port of the JAX package's ``runtime/finetune.py``: the training surface of
Petals (``rpc_forward`` / ``rpc_backward`` over block spans, learned
per-block deep prompts, ``petals/server/block_functions.py:57-65``) driven
by a client that owns the embedding, its local span and the LM head, while
remote servers run frozen spans. One step:

  1. local:  x = embed(ids); h0 = blocks[0:s0](x, prompts[0:s0])  (graph kept)
  2. remote: per hop ``train_forward`` (cache-free, blocks only) with the
             hop's prompt and adapter slices; each hop's input kept
  3. local:  loss = xent(lm_head(h_last), targets), its gradient in h_last
  4. remote: hops in reverse, ``backward`` returns the gradients of the
             hop's input, prompts and adapters
  5. local:  the local graph's backward; AdamW over {prompts, lora?,
             embed?, head?}

Servers keep nothing between training calls, so a failed hop re-routes
and retries the whole step (`MAX_STEP_ATTEMPTS`); no journal is replayed.

In PyTorch idiom: tensors on the client's device, initial trainables drawn
from an explicit `torch.Generator` (``seed`` for the prompts, ``seed + 1``
for the adapters; the draws differ from the reference's threefry ones),
the local span's graph kept from step 1 to step 5 (the reference re-runs
its forward inside a jitted vjp; each layer is checkpointed and
recomputed in the backward either way). A hop's output is cast to the
local span's activation dtype, so a step computes the same head whether
its hops were in process or behind a float32 wire.

`save` / `restore` write the trainables and the optimizer state to one
``.npz`` under the reference's keys (``jax.tree_util.keystr`` of the path,
e.g. ``['trainables']['prompts']``, ``['opt']['mu']['lora']['wq']['a']``,
and ``__steps__``), so a file written by either package restores in the
other; a bfloat16 leaf is written as float32 (exact). `export_lora` writes
a pure-LoRA fine-tune as the adapter file ``--lora`` serves.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.bridge import array_to_torch
from ..models.config import ModelConfig
from ..models.lora import DEFAULT_TARGETS, init_lora, save_lora, slice_lora
from ..models.transformer import embed_tokens, lm_head, stack_forward_train
from ..parallel.trainer import adamw_init, adamw_update, softmax_xent, tree_map
from .client import EXOTIC, NoRouteError, PipelineClient
from .errors import retryable_types
from .messages import BackwardRequest, StageRequest

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

MAX_STEP_ATTEMPTS = 3


class _HopFailed(Exception):
    """A remote hop failed: re-route and retry the whole step."""


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _keystr(path: Tuple[str, ...]) -> str:
    """The reference's ``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class DistributedFineTuner:
    """Deep-prompt-tune (and LoRA-tune) a model whose blocks are served by
    remote peers.

    trainables: always ``prompts`` [num_layers, pre_seq, D] float32; with
    ``lora_rank > 0`` also client-owned adapters over every block
    (``models/lora.py``), shipped with each hop's training calls;
    optionally the embedding (``tune_embed``) and the head
    (``tune_head``). `head_params` holds ``final_norm`` and, for an untied
    model, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, client: PipelineClient, head_params: Params, *,
                 pre_seq: int = 8, lr: float = 1e-3, weight_decay: float = 0.0,
                 tune_embed: bool = False, tune_head: bool = False,
                 prompt_init_scale: float = 0.01, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_targets=None, seed: int = 0):
        self.cfg = cfg
        self.client = client
        self.pre_seq = pre_seq
        self.lr = lr
        self.weight_decay = weight_decay
        self.tune_embed = tune_embed
        self.tune_head = tune_head
        self.lora_rank = lora_rank
        self.lora_scale = (lora_alpha / lora_rank) if lora_rank else 0.0

        s0_params = client.stage0.params
        if "embed" not in s0_params:
            raise ValueError("client.stage0 must hold the embedding")
        self.device = client.stage0.device
        self._frozen_embed = s0_params["embed"]
        self._local_layers = s0_params.get("layers")
        self._frozen_head = head_params
        self.s0_end = client.plan.stages[0].end

        gen = torch.Generator(device=self.device).manual_seed(seed)
        prompts = prompt_init_scale * torch.randn(
            (cfg.num_layers, pre_seq, cfg.hidden_size), generator=gen,
            dtype=torch.float32, device=self.device)
        self.trainables: Params = {"prompts": prompts}
        if lora_rank > 0:
            lgen = torch.Generator(device=self.device).manual_seed(seed + 1)
            self.trainables["lora"] = init_lora(lgen, cfg, cfg.num_layers, lora_rank,
                                                targets=lora_targets or DEFAULT_TARGETS)
        if tune_embed:
            self.trainables["embed"] = tree_map(lambda t: t.detach().clone(), self._frozen_embed)
        if tune_head:
            self.trainables["head"] = tree_map(lambda t: t.detach().clone(), head_params)
        self.opt_state = adamw_init(self.trainables)
        self.steps = 0
        self.last_loss: Optional[float] = None
        self._session_n = 0

    # -- local compute ------------------------------------------------------

    def _embed_of(self, tr: Params) -> Params:
        return tr["embed"] if self.tune_embed else self._frozen_embed

    def _head_of(self, tr: Params) -> Params:
        head = tr["head"] if self.tune_head else self._frozen_head
        hp = {"final_norm": head["final_norm"]}
        if self.cfg.tie_word_embeddings:
            hp["embed"] = {"wte": self._embed_of(tr)["wte"]}
        elif "lm_head" in head:
            hp["lm_head"] = head["lm_head"]
        return hp

    def _local_forward(self, tr: Params, ids: torch.Tensor) -> torch.Tensor:
        """Embedding and the local span, with autograd on: h0."""
        b, t = ids.shape
        positions = torch.arange(t, device=ids.device)[None, :].expand(b, t)
        with torch.enable_grad():
            x = embed_tokens(self.cfg, self._embed_of(tr), ids, positions)
            if self._local_layers is not None and self.s0_end > 0:
                lora = slice_lora(tr["lora"], 0, self.s0_end) if "lora" in tr else None
                x = stack_forward_train(self.cfg, self._local_layers, x, positions,
                                        prompts=tr["prompts"][:self.s0_end],
                                        lora=lora, lora_scale=self.lora_scale)
        return x

    def _head_loss(self, tr: Params, h_last: torch.Tensor, targets: torch.Tensor,
                   leaves: List[torch.Tensor]):
        """(loss, its gradient in h_last, its gradients in `leaves`)."""
        with torch.enable_grad():
            h = h_last.detach().requires_grad_()
            loss = softmax_xent(lm_head(self.cfg, self._head_of(tr), h), targets)
            grads = torch.autograd.grad(loss, [h] + leaves, allow_unused=True)
        return loss.detach(), grads[0], grads[1:]

    def _local_backward(self, h0: torch.Tensor, g_h0: torch.Tensor,
                        leaves: List[torch.Tensor]) -> Tuple:
        """The local graph's gradients in `leaves` for h0's gradient."""
        if not h0.requires_grad:
            return (None,) * len(leaves)
        return torch.autograd.grad(h0, leaves, g_h0.to(h0.dtype), allow_unused=True)

    # -- remote hops --------------------------------------------------------

    def _hop_lora(self, tr: Params, hop) -> Optional[Params]:
        if "lora" not in tr:
            return None
        return {t: {k: v.detach() for k, v in ab.items()}
                for t, ab in slice_lora(tr["lora"], hop.start_block, hop.end_block).items()}

    def _remote_forward(self, hops, h: torch.Tensor, seq_len: int, tr: Params,
                        session_id: str):
        """(the last hop's output, each hop's input)."""
        dtype = h.dtype
        prompts = tr["prompts"].detach()
        inputs: List[torch.Tensor] = []
        for hop in hops:
            inputs.append(h)
            req = StageRequest(
                session_id=session_id, hidden=h, seq_len=seq_len, cur_len=0,
                is_prefill=False, max_length=0, train=True,
                prompts=prompts[hop.start_block:hop.end_block],
                lora=self._hop_lora(tr, hop), lora_scale=self.lora_scale,
                start_block=hop.start_block, end_block=hop.end_block)
            try:
                resp = self.client.transport.call(hop.peer_id, req,
                                                  timeout=self.client.request_timeout)
            except retryable_types() as exc:
                self._mark_failed(hop, exc)
                raise _HopFailed from exc
            h = resp.hidden.to(self.device, dtype)
        return h, inputs

    def _remote_backward(self, hops, inputs, grad_out: torch.Tensor, seq_len: int,
                         tr: Params, session_id: str):
        """Hops in reverse: (the gradient of the local span's output,
        prompt gradients [(start, end, grad)], adapter gradients [(start,
        end, tree)])."""
        prompts = tr["prompts"].detach()
        prompt_grads, lora_grads = [], []
        for hop, h_in in zip(reversed(hops), reversed(inputs)):
            breq = BackwardRequest(
                session_id=session_id, hidden=h_in, grad_output=grad_out,
                seq_len=seq_len, prompts=prompts[hop.start_block:hop.end_block],
                lora=self._hop_lora(tr, hop), lora_scale=self.lora_scale,
                start_block=hop.start_block, end_block=hop.end_block)
            try:
                bresp = self.client.transport.backward(hop.peer_id, breq,
                                                       timeout=self.client.request_timeout)
            except retryable_types() as exc:
                self._mark_failed(hop, exc)
                raise _HopFailed from exc
            grad_out = bresp.grad_input.to(self.device)
            if bresp.grad_prompts is not None:
                prompt_grads.append((hop.start_block, hop.end_block,
                                     bresp.grad_prompts.to(self.device)))
            if bresp.grad_lora:
                lora_grads.append((hop.start_block, hop.end_block, bresp.grad_lora))
            elif "lora" in tr:
                # Adapters shipped, none of their gradients back: a peer
                # that dropped them computed the unadapted span. Blame it,
                # so that the retry routes around it.
                self._mark_failed(hop, RuntimeError(
                    "peer returned no LoRA grads (pre-LoRA version?)"))
                raise _HopFailed
        return grad_out, prompt_grads, lora_grads

    def _mark_failed(self, hop, exc) -> None:
        self.client.failed_peers.setdefault(hop.key, set()).add(hop.peer_id)
        logger.warning("finetune hop %s peer %s failed: %s", hop.key, hop.peer_id, exc)

    # -- checkpoints --------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the trainables and the optimizer state to one .npz, keyed
        by tree path as the reference keys it. The frozen blocks stay with
        the servers: this file is the fine-tune."""
        if not path.endswith(".npz"):
            path += ".npz"
        flat = {_keystr(p): _host(leaf) for p, leaf in
                _leaves({"trainables": self.trainables, "opt": self.opt_state})}
        flat["__steps__"] = np.asarray(self.steps)
        np.savez(path, **flat)

    def restore(self, path: str) -> None:
        """The inverse of `save`, for a file of either package; the tuner
        must be built with the same pre_seq, rank and targets."""
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as data:
            def load(tree, prefix):
                if isinstance(tree, dict):
                    return {k: load(v, prefix + (k,)) for k, v in tree.items()}
                return array_to_torch(data[_keystr(prefix)]).to(tree.device, tree.dtype)

            self.trainables = load(self.trainables, ("trainables",))
            self.opt_state = load(self.opt_state, ("opt",))
            self.steps = int(data["__steps__"])

    def export_lora(self, path: str, allow_partial: bool = False) -> None:
        """Write the tuned adapters and their scale as the .npz that
        ``--lora path`` folds into the base weights. It holds the adapters
        only, so a tuner that also trains prompts, the embedding or the
        head is refused unless `allow_partial` (build one with
        ``pre_seq=0, lora_rank=r`` for an exportable pure-LoRA tune)."""
        if "lora" not in self.trainables:
            raise ValueError("no LoRA trainables (construct with lora_rank>0)")
        if not allow_partial and (self.pre_seq > 0 or self.tune_embed or self.tune_head):
            raise ValueError(
                "tuner also trains deep prompts/embed/head, which --lora "
                "serving cannot apply — construct with pre_seq=0 (and no "
                "tune_embed/tune_head) for a pure-LoRA fine-tune, or pass "
                "allow_partial=True to export the adapters alone")
        save_lora(path, self.trainables["lora"], self.lora_scale)

    # -- the step -----------------------------------------------------------

    def step(self, ids, targets) -> float:
        """One fine-tuning step over [B, T] ids and targets (< 0: ignored).
        A failed hop re-routes and retries the step."""
        last_exc: Optional[Exception] = None
        for attempt in range(MAX_STEP_ATTEMPTS):
            try:
                loss = self._step_once(ids, targets, refresh_route=attempt > 0)
                self.last_loss = loss
                self.steps += 1
                return loss
            except _HopFailed as exc:
                last_exc = exc
            except NoRouteError as exc:
                last_exc = exc
                self.client.failed_peers.clear()
        raise RuntimeError(
            f"fine-tune step failed after {MAX_STEP_ATTEMPTS} attempts") from last_exc

    def _step_once(self, ids, targets, refresh_route: bool) -> float:
        # kind "exotic": the training verbs exist on the session engines
        # only; a batched peer in the route would refuse every step.
        hops = self.client.route(refresh=refresh_route, kind=EXOTIC)
        self._session_n += 1
        session_id = f"ft-{id(self):x}-{self._session_n}"
        ids = torch.as_tensor(ids, device=self.device).long()
        targets = torch.as_tensor(targets, device=self.device).long()
        seq_len = int(ids.shape[1])
        tr = tree_map(lambda t: t.detach().requires_grad_(), self.trainables)
        paths = [p for p, _ in _leaves(tr)]
        leaves = [leaf for _, leaf in _leaves(tr)]

        h0 = self._local_forward(tr, ids)
        h_last, inputs = self._remote_forward(hops, h0.detach(), seq_len, tr, session_id)
        loss, g_h, g_head = self._head_loss(tr, h_last, targets, leaves)
        g_h0, prompt_grads, lora_grads = self._remote_backward(
            hops, inputs, g_h, seq_len, tr, session_id)
        g_local = self._local_backward(h0, g_h0, leaves)

        grads: Params = tree_map(torch.zeros_like, self.opt_state["mu"])
        for path, ga, gb in zip(paths, g_head, g_local):
            node = grads
            for k in path[:-1]:
                node = node[k]
            for g in (ga, gb):
                if g is not None:
                    node[path[-1]] = node[path[-1]] + g.float()
        for start, end, g in prompt_grads:
            grads["prompts"][start:end] += g.float()
        for start, end, gtree in lora_grads:
            for t, ab in gtree.items():
                for leaf in ("a", "b"):
                    grads["lora"][t][leaf][start:end] += ab[leaf].to(self.device).float()
        self.trainables, self.opt_state = self._apply(grads, tr)
        return float(loss)

    def _apply(self, grads: Params, tr: Params):
        """AdamW: (new trainables, new optimizer state)."""
        with torch.no_grad():
            return adamw_update(grads, self.opt_state, tree_map(lambda t: t.detach(), tr),
                                lr=self.lr, weight_decay=self.weight_decay)
