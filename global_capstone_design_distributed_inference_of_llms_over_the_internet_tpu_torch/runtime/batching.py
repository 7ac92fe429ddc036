"""Continuous batching: many concurrent sessions, one decode step.

Port of the plain path of the JAX package's ``runtime/batching.py``. The
server owns one slot-major KV cache ``[L, S, max_len, Hkv, Dh]``; every live
session holds a slot, and one step advances every slot at once, with
per-slot lengths and an active mask for the slots that have no token this
round. Sessions join at prefill (a slot is taken and the prompt's keys are
written into its rows), decode through `decode_batch`, and leave through
`end_session`. `BatchingStageAdapter` serves the engine behind the
``StageRequest`` protocol: concurrent decode requests coalesce into one
round, whose first arrival leads it.

On the card each step is a CUDA graph (``runtime/graphs.SlotSteps``): one
per decode width T and one per prefill bucket, the slot index, the slots'
lengths and the active mask staged into the graph as device values. On
the CPU the same step functions run directly.

Burst decode (the reference's serving core, ``batching.py:30-38``): a
full-span engine runs N decode ticks for every live slot in one captured
graph (`decode_burst`, one graph per N). Each tick embeds the carried
token, runs the T = 1 decode body of `_decode_step` and the head, samples
every row on the device (`graphs.sample_rows_packed`, the per-row path of
`sample_round`, row s keyed ``PRNGKey(step_seed_s + i)``), and applies
the host's stop rules in the host's order (the budget, then eos, then the
5-run repeat), so a burst's tokens are bit-equal to the per-step rounds
of the same engine. The host pays one replay and one read a burst;
`burst_stream` keeps every carry on the device and replays burst k+1
before it reads burst k back. `BatchingStageAdapter` coalesces burst
requests into rounds of their own, keyed ``("burst", N)``.

The layer pieces are the reference's (``batching.py:104-142``):
`_layer_mask` and `_residual` here; its ``_softcap_and_mask`` and
``_qscale`` are inside ``ops.attention.slot_attention``, which the
prefill runs over the prompt's fresh keys and the decode step over the
slot caches.

Not ported yet, and refused by the adapter with a retryable
`StageExecutionError`: speculative rows and session rewind (ROADMAP
Queue 1 #3), the prefix store (#1c), push chains.

Deliberate divergences from the reference:
  * The last stage's head runs once a round, inside the captured decode
    step, over row T-1 of every slot (``round_logits``), where the
    reference's adapter runs ``logits(hidden_row)`` once per session after
    the round (``batching.py:1228-1236``). The head's float32 copy of its
    weight is then made once a round, not once a session.
  * The round's leader samples every row of the round before it releases
    the followers (`sample_round`: the argmax when every row is greedy,
    else one captured sampler over the rows, each with its own request's
    knobs, window and key ``PRNGKey(step_seed)``), and reads the tokens
    back in one sync; the reference samples in each waiter's thread
    (``:1368``).
  * `_recover_slot` recycles the slot and keeps the caches: torch donates
    no buffers, so a failed step cannot leave them deleted (``:498-518``).
  * `BatchingStageAdapter.warmup` captures every prefill bucket up to
    ``max_len`` and the decode step of width 1 (and the samplers on the
    last stage, and the burst of ``burst`` ticks on a full-span engine),
    where the reference compiles the smallest bucket only
    (``:1130-1169``): a capture at first use would happen while other
    threads run device work. With no ``rewind`` yet, the burst warms a
    fresh warm-up session.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..models.partition import StageSpec
from ..models.quant import dequant_tree, tree_map
from ..models.transformer import (
    _check_supported,
    _dot,
    _mlp,
    _norm,
    embed_tokens,
    fuse_qkv_params,
    lm_head,
    make_rope,
    qkv_proj,
)
from ..ops.attention import slot_attention, slot_cache_write
from ..ops.rotary import apply_rope
from ..ops.sampling import RECENT_WINDOW, SamplingParams
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from ..telemetry.profiling import get_profiler as _get_profiler
from .client import REPEAT_STOP
from .errors import register as _catalog
from .executor import StageExecutionError, _sample_rows
from .graphs import (
    _FLOATS,
    _NVALID,
    _SEED,
    _TOP_K,
    PACKED_LEN,
    Sampler,
    SlotSteps,
    pack_sampler_inputs,
    sample_rows_packed,
)
from .kv_cache import round_to_bucket
from .messages import StageRequest, StageResponse

Params = Dict[str, Any]

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)

# The client's repeat stop, applied on the device so that a burst stops
# where the per-step loop would.
BURST_REPEAT_STOP = REPEAT_STOP

# A burst's carry, one int64 row a slot: the slot's packed sampler scalars
# (`graphs.pack_sampler_inputs`: window, its length, top_k, the seed of the
# burst's first tick, the float knobs' bits), then the carried token, the
# slot's length, its alive flag, its repeat run, its budget left and its
# eos id (-1: none).
_TOK, _LEN, _ALIVE, _RUN, _LEFT, _EOS = range(PACKED_LEN, PACKED_LEN + 6)
BURST_COLS = PACKED_LEN + 6
# A burst's stop codes, as the reference's (``batching.py:894``).
_BURST_STOPS = {0: None, 1: "eos", 2: "repeat"}


def _burst_entry(rq: StageRequest) -> dict:
    """A burst request's spec in the engine's per-burst form: everything
    the wire ships every step, so failover needs no server-side sampler
    state (the reference's ``_burst_entry``, ``batching.py:74``)."""
    sp = rq.sampling
    return {
        "token": int(rq.hidden.reshape(-1)[0]),
        "seed": int(rq.step_seed),
        "budget": int(rq.burst_budget),
        "eos": rq.eos_token_id,
        "generated": rq.generated_tokens,
        "temperature": sp.temperature,
        "top_p": sp.top_p,
        "top_k": sp.top_k,
        "repetition_penalty": sp.repetition_penalty,
    }


def _push_recent_rows(recent: torch.Tensor, nvalid: torch.Tensor,
                      new: torch.Tensor):
    """`ops.sampling.push_recent` for each row: windows [S, W], their
    lengths [S] and the new tokens [S]."""
    full = nvalid >= RECENT_WINDOW
    shifted = torch.where(full[:, None], torch.roll(recent, -1, dims=1), recent)
    idx = torch.where(full, RECENT_WINDOW - 1, nvalid)
    return (shifted.scatter(1, idx[:, None], new[:, None]),
            torch.clamp(nvalid + 1, max=RECENT_WINDOW))


@_catalog
class SlotFull(RuntimeError):
    """No free slot (admission control — the caller queues or fails over)."""


def _layer_mask(lp: Params, mask: torch.Tensor, q_pos: torch.Tensor,
                k_pos: torch.Tensor) -> torch.Tensor:
    """Intersect the body's mask with this layer's window (the per-layer
    ``window`` leaf of the alternating local/global families): <= 0 means
    global. q_pos/k_pos broadcast against the mask's trailing dims."""
    w = lp.get("window")
    if w is None:
        return mask
    w = w.to(torch.int64)
    return mask & ((k_pos > q_pos - w) | (w <= 0))


def _residual(cfg: ModelConfig, lp: Params, h: torch.Tensor,
              attn_out: torch.Tensor) -> torch.Tensor:
    """Residual + MLP with the optional sandwich norms (ln3 after
    attention, ln4 after the MLP, each before its residual add)."""
    if cfg.post_norms:
        attn_out = _norm(cfg, lp["ln3"], attn_out)
    h = h + attn_out
    mlp_out = _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], h))
    if cfg.post_norms:
        mlp_out = _norm(cfg, lp["ln4"], mlp_out)
    return h + mlp_out


class BatchedStageExecutor:
    """One stage span serving up to `slots` sessions with batched decode."""

    def __init__(self, cfg: ModelConfig, spec: StageSpec, params: Params, *,
                 device, slots: int = 8, max_len: int = 2048,
                 dtype: torch.dtype = torch.float32):
        _check_supported(cfg)
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        # Engine-side fused layout: one wqkv and one wgu matmul per layer.
        self.params = fuse_qkv_params(params)
        self.slots = slots
        self.max_len = max_len
        self.dtype = dtype
        shape = (max(spec.num_layers, 1), slots, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.lengths = np.zeros((slots,), np.int32)   # host-side truth
        self._slot_of: Dict[str, int] = {}
        self._free: List[int] = list(range(slots))
        self.decode_steps = 0                          # batched steps executed
        self.graphs = SlotSteps(self.device)
        # The last stage's samplers: a prefill's row, and a round's rows.
        self.sampler = Sampler(self.device)
        # The last decode round's head output [S, V] (last stage only): the
        # step's static output, read before the next round.
        self.round_logits: Optional[torch.Tensor] = None
        # Burst decode (full-span engines only).
        self.burst_dispatches = 0          # bursts run
        self.burst_tokens = 0              # tokens the bursts emitted
        self._m_burst_ticks = _tm.get("server_burst_ticks")
        self._m_burst_disp = _tm.get("server_burst_dispatches_total")
        self._m_burst_toks = _tm.get("server_burst_tokens_total")

    # ------------------------------------------------------------------
    # Slots
    # ------------------------------------------------------------------

    def slot(self, session_id: str) -> Optional[int]:
        return self._slot_of.get(session_id)

    def _alloc(self, session_id: str) -> int:
        old = self._slot_of.pop(session_id, None)
        if old is not None:                  # re-prefill restarts the session
            self._free.append(old)
        if not self._free:
            raise SlotFull(f"all {self.slots} session slots in use")
        s = self._free.pop()
        self._slot_of[session_id] = s
        return s

    def end_session(self, session_id: str) -> None:
        s = self._slot_of.pop(session_id, None)
        if s is not None:
            self.lengths[s] = 0
            self._free.append(s)

    def _recover_slot(self, session_id: str, s: int) -> None:
        """A failed prefill never established its session: recycle the
        slot with a clean length. The caches stay (nothing is donated)."""
        self._slot_of.pop(session_id, None)
        self.lengths[s] = 0
        self._free.append(s)

    def tokens_left(self) -> int:
        """Admission headroom for heartbeats/info: free slots at full
        length plus the unused tail of every occupied slot."""
        occupied = set(self._slot_of.values())
        free = self.slots - len(occupied)
        return int(free * self.max_len
                   + sum(self.max_len - int(self.lengths[s]) for s in occupied))

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """`x` on the engine's device, a host tensor through pinned memory:
        a copy from pageable memory may wait for the stream."""
        if x.device.type == "cpu" and self.device.type == "cuda":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # Layers
    # ------------------------------------------------------------------

    def _layer(self, li: int) -> Params:
        return dequant_tree(tree_map(lambda a: a[li], self.params["layers"]))

    def _attn_out(self, lp: Params, out: torch.Tensor) -> torch.Tensor:
        out = _dot(out.reshape(*out.shape[:2], -1), lp["attn"]["wo"])
        if "bo" in lp["attn"]:
            out = out + lp["attn"]["bo"]
        return out

    # ------------------------------------------------------------------
    # Prefill: per session, writes the prompt's KV into the slot's rows
    # ------------------------------------------------------------------

    def _prefill_step(self, x: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
        """x: ids [1, T] or hidden [1, T, D] (padded to its bucket);
        scalars: (slot, real length). Causal attention over the fresh
        prompt only (a prefill restarts the session); rows [0, T) of the
        slot take the prompt's keys and values."""
        cfg, spec = self.cfg, self.spec
        slot, t_real = scalars[:1], scalars[1]
        t = x.shape[1]
        dev = x.device
        positions = torch.arange(t, device=dev)[None, :]
        h = (embed_tokens(cfg, self.params["embed"], x, positions)
             if spec.is_first else x)
        rope = make_rope(cfg, positions)
        rows = torch.arange(t, device=dev)[:, None]
        cols = torch.arange(t, device=dev)[None, :]
        mask = (cols <= rows) & (cols < t_real)
        if cfg.sliding_window:
            mask &= cols > rows - cfg.sliding_window
        for li in range(spec.num_layers):
            lp = self._layer(li)
            q, k, v = qkv_proj(cfg, lp["attn"], _norm(cfg, lp["ln1"], h))
            if rope is not None:
                q, k = apply_rope(q, *rope), apply_rope(k, *rope)
            m = _layer_mask(lp, mask, rows, cols)
            out = slot_attention(q, k, v, m[None], scale=cfg.query_scale,
                                 logit_softcap=cfg.attn_softcap)
            h = _residual(cfg, lp, h, self._attn_out(lp, out))
            self.k[li, :, :t].index_copy_(0, slot, k.to(self.dtype))
            self.v[li, :, :t].index_copy_(0, slot, v.to(self.dtype))
        return h

    def prefill(self, session_id: str, x: torch.Tensor,
                prefix_len: int = 0) -> torch.Tensor:
        """Join/restart a session: x = ids [1, T] (first stage) or hidden
        [1, T, D]. Returns the hidden rows [1, T, D], pad trimmed.
        `prefix_len` is accepted and ignored, as by a reference engine with
        no prefix store."""
        del prefix_len
        return self._prefill_full(session_id, x)

    def _prefill_full(self, session_id: str, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"prompt {t} exceeds slot max_len {self.max_len}")
        s = self._alloc(session_id)
        # Bucket-pad the prompt: one graph per bucket; beyond the bucket
        # table, the exact length.
        tb = (t if t > PREFILL_BUCKETS[-1]
              else min(round_to_bucket(t, PREFILL_BUCKETS), self.max_len))
        if tb != t:
            x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, tb - t))
        if self.spec.is_first:
            x = x.long()     # ids cross the wire as int32: one graph a bucket
        x = self._to_device(x)
        try:
            h = self.graphs.run(("prefill", tb, x.dtype), self._prefill_step,
                                x, (s, t))
        except Exception:
            self._recover_slot(session_id, s)
            raise
        self.lengths[s] = t
        return h[:, :t].clone()

    # ------------------------------------------------------------------
    # Batched decode: one step for EVERY active slot
    # ------------------------------------------------------------------

    def _decode_step(self, x: torch.Tensor, scalars: torch.Tensor):
        """One batched step of T tokens per slot. x: ids [S, T] or hidden
        [S, T, D]; scalars: the slots' lengths then their active flags.
        Returns the hidden rows [S, T, D] (inactive slots zeroed), and on
        the last stage also the head's logits [S, V] of row T-1."""
        s_count = x.shape[0]
        return self._decode_rows(x, scalars[:s_count], scalars[s_count:].bool())

    def _decode_rows(self, x: torch.Tensor, lengths: torch.Tensor,
                     active: torch.Tensor):
        """`_decode_step`'s body: lengths int64 [S], active bool [S]. A
        burst's tick runs it too."""
        cfg, spec = self.cfg, self.spec
        t = x.shape[1]
        dev = x.device
        positions = lengths[:, None] + torch.arange(t, device=dev)[None, :]
        h = (embed_tokens(cfg, self.params["embed"], x, positions)
             if spec.is_first else x)
        rope = make_rope(cfg, positions)
        pos_grid = torch.arange(self.max_len, device=dev)[None, None, :]
        qpos = positions[:, :, None]
        allowed = pos_grid <= qpos                       # [S, T, M]
        if cfg.sliding_window:
            allowed &= pos_grid > qpos - cfg.sliding_window
        for li in range(spec.num_layers):
            lp = self._layer(li)
            q, k, v = qkv_proj(cfg, lp["attn"], _norm(cfg, lp["ln1"], h))
            if rope is not None:
                q, k = apply_rope(q, *rope), apply_rope(k, *rope)
            slot_cache_write(self.k[li], k, lengths, active)
            slot_cache_write(self.v[li], v, lengths, active)
            m = _layer_mask(lp, allowed, qpos, pos_grid)
            out = slot_attention(q, self.k[li], self.v[li], m,
                                 scale=cfg.query_scale,
                                 logit_softcap=cfg.attn_softcap)
            h = _residual(cfg, lp, h, self._attn_out(lp, out))
        # Inactive slots computed garbage: zero them.
        h = torch.where(active[:, None, None], h, torch.zeros_like(h))
        if spec.is_last:
            return h, lm_head(cfg, self.params, h[:, t - 1:])[:, 0]
        return h

    def decode_batch(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One batched step. inputs: {session_id: ids [1, T] or hidden
        [1, T, D]}, one width T for every session of the call. Returns
        {session_id: hidden [1, T, D]}; on the last stage `round_logits`
        holds the head's logits of row T-1 of every slot. Sessions not in
        `inputs` are untouched (masked)."""
        if not inputs:
            return {}
        sids = list(inputs)
        t = int(inputs[sids[0]].shape[1])
        rows = []
        for sid in sids:
            if int(inputs[sid].shape[1]) != t:
                raise ValueError(
                    "all sessions in one batched step share one width "
                    f"(got {inputs[sid].shape[1]} vs {t})")
            if sid not in self._slot_of:
                raise KeyError(f"unknown session {sid} (prefill first)")
            if self.lengths[self._slot_of[sid]] + t > self.max_len:
                raise RuntimeError(
                    f"session {sid}: {t} tokens past length "
                    f"{int(self.lengths[self._slot_of[sid]])} exceeds "
                    f"max_len {self.max_len}")
            rows.append(self._slot_of[sid])
        # Built where the inputs are: on the host for a TCP server's rows.
        where = inputs[sids[0]].device
        if self.spec.is_first:
            x = torch.zeros((self.slots, t), dtype=torch.int64, device=where)
        else:
            x = torch.zeros((self.slots, t, self.cfg.hidden_size),
                            dtype=torch.float32, device=where)
        for sid, s in zip(sids, rows):
            x[s].copy_(inputs[sid][0], non_blocking=True)
        x = self._to_device(x)
        active = np.zeros((self.slots,), np.int64)
        active[rows] = 1
        out = self.graphs.run(("decode", t), self._decode_step, x,
                              [int(n) for n in self.lengths] + active.tolist())
        if self.spec.is_last:
            out, self.round_logits = out
        for s in rows:
            self.lengths[s] += t
        self.decode_steps += 1
        return {sid: out[s:s + 1].clone() for sid, s in zip(sids, rows)}

    def sample_round(self, requests: Dict[str, StageRequest]) -> Dict[str, int]:
        """The last round's token for each session of `requests` (last
        stage), from `round_logits`: the argmax of every slot when every
        request is greedy, else every slot through the captured row
        sampler, each session's row under its own knobs, window and key
        ``PRNGKey(step_seed)`` (other slots greedy). One host sync."""
        rows = {sid: self._slot_of[sid] for sid in requests}
        if all(req.sampling.greedy for req in requests.values()):
            tokens = torch.argmax(self.round_logits, dim=-1).tolist()
        else:
            per_row = [((), SamplingParams(temperature=0.0), 0)] * self.slots
            for sid, s in rows.items():
                req = requests[sid]
                per_row[s] = (req.generated_tokens, req.sampling, req.step_seed)
            tokens = self.sampler.rows(self.round_logits, per_row)
        return {sid: int(tokens[s]) for sid, s in rows.items()}

    # ------------------------------------------------------------------
    # Burst decode: N ticks a replay, sampling on the device
    # ------------------------------------------------------------------

    def _burst_step(self, carry: torch.Tensor, n_ticks: int):
        """N decode ticks for every slot, a plain function of the carry
        (int64 [S, BURST_COLS], see `BURST_COLS`) and the slot caches, the
        reference's ``_build_burst`` (``batching.py:692``). Tick i of an
        alive slot embeds its carried token, runs the T = 1 decode body
        (`_decode_rows`, which writes the KV of alive slots only) and the
        head, samples the slot's row as `sample_round` does
        (`sample_rows_packed`) with key ``PRNGKey(seed + i)``, pushes the
        token on the slot's window, and applies the stop rules in the
        host's order: the budget counter, then eos, then the 5-run repeat.
        A stop gates the next tick only: the sampled token is emitted.

        Returns (result int64 [N + 2, S]: the emitted tokens of each tick,
        -1 where the slot was not alive, then each slot's stop code (0
        none, 1 eos, 2 repeat) and its length after the burst; the carry
        after the burst, each seed advanced by the tokens its slot
        emitted).

        Tick i writes the KV rows at ``length + i`` and reads only rows up
        to that one, so running the step twice on the same carry gives the
        same caches and tokens: the warm-up run before a capture, and the
        capture check, rely on it."""
        packed = carry[:, :PACKED_LEN]
        recent, nvalid = packed[:, :RECENT_WINDOW], packed[:, _NVALID]
        seed0 = packed[:, _SEED]
        tok, lengths, run, left, eos = (carry[:, c] for c in (_TOK, _LEN, _RUN, _LEFT, _EOS))
        alive = carry[:, _ALIVE].bool()
        len0 = lengths
        stop = torch.zeros_like(tok)
        toks = []
        for i in range(n_ticks):
            active = alive
            _, logits = self._decode_rows(tok[:, None], lengths, active)
            rows = torch.cat([recent, nvalid[:, None], packed[:, _TOP_K:_SEED],
                              (seed0 + i)[:, None], packed[:, _FLOATS:]], dim=1)
            sampled = sample_rows_packed(logits, rows).long()
            eos_hit = active & (eos >= 0) & (sampled == eos)
            run = torch.where(active, torch.where(sampled == tok, run + 1, 1), run)
            rep_hit = active & (run >= BURST_REPEAT_STOP)
            left = torch.where(active, left - 1, left)
            pushed, grown = _push_recent_rows(recent, nvalid, sampled)
            recent = torch.where(active[:, None], pushed, recent)
            nvalid = torch.where(active, grown, nvalid)
            lengths = torch.where(active, lengths + 1, lengths)
            first = stop == 0
            stop = torch.where(eos_hit & first, 1, stop)
            stop = torch.where(rep_hit & ~eos_hit & first, 2, stop)
            alive = active & ~eos_hit & ~rep_hit & (left > 0)
            tok = torch.where(active, sampled, tok)
            toks.append(torch.where(active, sampled, -1))
        packed = torch.cat([recent, nvalid[:, None], packed[:, _TOP_K:_SEED],
                            (seed0 + lengths - len0)[:, None], packed[:, _FLOATS:]], dim=1)
        carry = torch.cat([packed, torch.stack([tok, lengths, alive.long(), run, left, eos],
                                               dim=1)], dim=1)
        return torch.cat([torch.stack(toks), stop[None], lengths[None]]), carry

    def _burst_prep(self, entries: Dict[str, dict], n_ticks: int):
        """The burst's slot rows and its carry (host ints, BURST_COLS a
        slot), from per-session specs {token, seed, budget, eos (None:
        none), generated, temperature, top_p, top_k, repetition_penalty}
        (the reference's ``_burst_prep``, ``batching.py:827``). A slot's
        budget is clamped to one burst's ticks. Refuses an engine that does
        not span the whole model, N < 1, a budget below 1 and a burst past
        ``max_len``."""
        if not (self.spec.is_first and self.spec.is_last):
            raise RuntimeError(
                "burst decode requires the full model span (on-device "
                "sampling feeds tokens straight back into the embedding)")
        if n_ticks < 1:
            raise ValueError(f"burst of {n_ticks} ticks")
        idle = SamplingParams(temperature=0.0, top_p=1.0, top_k=0, repetition_penalty=1.0)
        carry = [pack_sampler_inputs((), idle, 0) + [0, int(n), 0, 0, 0, -1]
                 for n in self.lengths]
        rows: Dict[str, int] = {}
        for sid, e in entries.items():
            s = self._slot_of.get(sid)
            if s is None:
                raise KeyError(f"unknown session {sid} (prefill first)")
            budget = min(int(e["budget"]), n_ticks)
            if budget < 1:
                raise ValueError(f"session {sid}: burst budget must be >= 1")
            if int(self.lengths[s]) + budget > self.max_len:
                raise RuntimeError(
                    f"session {sid}: burst of {budget} past length "
                    f"{int(self.lengths[s])} exceeds max_len {self.max_len}")
            gen = [int(t) for t in e["generated"]]
            run = next((j for j, t in enumerate(reversed(gen)) if t != gen[-1]), len(gen))
            sp = SamplingParams(temperature=float(e["temperature"]), top_p=float(e["top_p"]),
                                top_k=int(e["top_k"]),
                                repetition_penalty=float(e["repetition_penalty"]))
            eos = e.get("eos")
            carry[s] = (pack_sampler_inputs(gen, sp, int(e["seed"]))
                        + [int(e["token"]), int(self.lengths[s]), 1, run, budget,
                           -1 if eos is None else int(eos)])
            rows[sid] = s
        return rows, carry

    def _burst_dispatch(self, n_ticks: int, carry):
        """One replay of the N-tick graph (captured at its first use) on
        `carry`: host rows, or the carry an earlier burst returned. Returns
        the graph's (result, carry), which its next replay overwrites."""
        out = self.graphs.run_carry(("burst", n_ticks),
                                    lambda c: self._burst_step(c, n_ticks), carry,
                                    (self.slots, BURST_COLS))
        self.decode_steps += 1
        self.burst_dispatches += 1
        self._m_burst_disp.inc()
        self._m_burst_ticks.observe(n_ticks)
        return out

    def _burst_collect(self, rows: Dict[str, int], result: torch.Tensor) -> Dict[str, dict]:
        """Read one burst's result back (its one host sync) and advance the
        host lengths."""
        res = result.tolist()
        toks, stop, lengths = res[:-2], res[-2], res[-1]
        out: Dict[str, dict] = {}
        total = 0
        for sid, s in rows.items():
            m = lengths[s] - int(self.lengths[s])
            total += m
            out[sid] = {"tokens": [toks[i][s] for i in range(m)],
                        "stop": _BURST_STOPS[stop[s]], "cache_len": lengths[s]}
            self.lengths[s] = lengths[s]
        self.burst_tokens += total
        self._m_burst_toks.inc(total)
        return out

    @staticmethod
    def _ready(t: torch.Tensor) -> None:
        """Wait for the work that produces `t` (the phase profiler's fence)."""
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    def decode_burst(self, entries: Dict[str, dict], n_ticks: int) -> Dict[str, dict]:
        """Up to ``n_ticks`` decode ticks for every session of `entries` in
        one replay. Returns {session_id: {tokens, stop, cache_len}}:
        ``tokens`` the emitted ids (<= n_ticks; the device's stops truncate
        them), ``stop`` None, "eos" or "repeat". Sessions join and leave
        between bursts only."""
        if not entries:
            return {}
        prof = _get_profiler()
        with prof.phase("burst_build"):
            rows, carry = self._burst_prep(entries, n_ticks)
        t_d = time.perf_counter()
        result, _ = self._burst_dispatch(n_ticks, carry)
        if prof.enabled:
            # Fenced: the device phase runs from the dispatch to the ready.
            prof.observe("dispatch", time.perf_counter() - t_d)
            self._ready(result)
            prof.device_interval(t_d, time.perf_counter())
        with prof.phase("readback"):
            return self._burst_collect(rows, result)

    def burst_stream(self, entries: Dict[str, dict], n_ticks: int):
        """Bursts of one resident cohort until every session has stopped or
        spent its budget (a generator of {session_id: {tokens, stop,
        cache_len}} blocks, empty ones skipped; the reference's
        ``burst_stream``, ``batching.py:950``). Every carry stays on the
        device: a burst's result is copied on the device and its carry fed
        back into the graph's input before the next replay, which is
        dispatched before this burst is read back, so the one read a
        burst overlaps the next burst. The budget counter starts at the
        whole budget and ticks down across bursts."""
        if not entries:
            return
        prof = _get_profiler()
        with prof.phase("burst_build"):
            rows, carry = self._burst_prep(entries, n_ticks)
        remaining = {sid: int(e["budget"]) for sid, e in entries.items()}
        finished = {sid: False for sid in entries}
        for sid, s in rows.items():
            b = int(entries[sid]["budget"])
            if int(self.lengths[s]) + b > self.max_len:
                raise RuntimeError(
                    f"session {sid}: stream budget of {b} past length "
                    f"{int(self.lengths[s])} exceeds max_len {self.max_len}")
            carry[s][_LEFT] = b
        pending: List[tuple] = []
        done = False
        while not done or pending:
            if not done:
                t_d = time.perf_counter() if prof.enabled else None
                result, carry = self._burst_dispatch(n_ticks, carry)
                if t_d is not None:
                    prof.observe("dispatch", time.perf_counter() - t_d)
                # The next replay overwrites the graph's outputs: keep this
                # burst's result (`carry` is copied into the input first).
                pending.append((result.clone(), t_d))
            # One burst in flight: read the oldest back once a newer one is
            # dispatched, or once every session is done.
            while pending and (done or len(pending) > 1):
                result_p, t_d = pending.pop(0)
                if t_d is not None and prof.enabled:
                    self._ready(result_p)
                    t_r = time.perf_counter()
                    prof.device_interval(t_d, t_r)
                    block = self._burst_collect(rows, result_p)
                    prof.observe("readback", time.perf_counter() - t_r)
                else:
                    block = self._burst_collect(rows, result_p)
                live = {}
                for sid, res in block.items():
                    remaining[sid] -= len(res["tokens"])
                    if res["stop"] is not None or remaining[sid] <= 0:
                        finished[sid] = True
                    if res["tokens"]:
                        live[sid] = res
                if all(finished.values()):
                    done = True
                if live:
                    yield live

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final-stage head over [1, T, D] -> [1, T, V] (float32)."""
        return lm_head(self.cfg, self.params, hidden)


# ---------------------------------------------------------------------------
# Transport adapter: serve the batched engine behind the StageRequest
# protocol, coalescing CONCURRENT decode requests into one step.
# ---------------------------------------------------------------------------

class _Round:
    """One coalescing window: requests that arrive while it is open share a
    single batched step. Rounds are keyed by step width T (seq_len), or by
    ("burst", N), so a round's sessions always share one captured step."""

    __slots__ = ("reqs", "outs", "tokens", "err", "bad", "lengths", "event",
                 "closed", "t_exec")

    def __init__(self):
        self.reqs: Dict[str, StageRequest] = {}
        self.outs: Dict[str, Any] = {}          # hidden rows, or burst results
        self.tokens: Dict[str, int] = {}            # last stage: sampled
        self.lengths: Dict[str, int] = {}
        self.err: Optional[Exception] = None      # whole-round failure
        self.bad: Dict[str, str] = {}             # per-session exclusions
        self.event = threading.Event()
        self.closed = False
        self.t_exec = 0.0    # monotonic instant the round's step started


class _SlotArenaView:
    """KVArena-shaped facade over the slot tables (tokens_left only), for
    the heartbeat and the ``info`` verb. It takes the adapter's lock with a
    bounded wait (a busy adapter returns the last known value), so a long
    prefill never stalls a heartbeat past the registry TTL."""

    def __init__(self, inner: BatchedStageExecutor, lock: threading.Lock):
        self._inner = inner
        self._lock = lock
        self._last = inner.slots * inner.max_len

    def tokens_left(self) -> int:
        if self._lock.acquire(timeout=0.5):
            try:
                self._last = self._inner.tokens_left()
            finally:
                self._lock.release()
        return self._last


def _unported_reason(req: StageRequest) -> Optional[str]:
    """Why this port's adapter refuses a request the reference's serves,
    or None."""
    if req.draft_tokens is not None:
        return "speculative verify is not ported"
    if req.next_servers:
        return "push chains are not ported"
    return None


class BatchingStageAdapter:
    """Drop-in StageExecutor replacement for transports: plain prefill and
    decode (and a failed-over session's replay) ride the batched engine,
    concurrent decode calls coalesced — the FIRST arrival leads its width's
    round, waits ``window_s`` for followers, runs ONE `decode_batch` (and
    on the last stage samples every row), and every waiter picks up its own
    row. On a full-span engine burst requests coalesce the same way into
    rounds keyed ``("burst", N)``, each one `decode_burst`. Other request
    kinds are refused with a retryable stage error, so clients route them
    to a per-session replica."""

    engine = "batched"   # registry capability tag (ServerRecord.engine)

    def __init__(self, inner: BatchedStageExecutor, *,
                 window_s: float = 0.003, peer_id: str = "batched",
                 step_timeout: float = 120.0):
        self.inner = inner
        self.spec = inner.spec
        self.cfg = inner.cfg
        self.window_s = window_s
        self.peer_id = peer_id
        self.step_timeout = step_timeout
        self.requests_served = 0
        self._lock = threading.Lock()
        # Open coalescing rounds, keyed by step width T or ("burst", N).
        self._rounds: Dict[Any, _Round] = {}
        self._m_queue_wait = _tm.get("server_queue_wait_seconds")
        self._m_fill = _tm.get("server_batch_fill_sessions")
        self._m_round = _tm.get("server_decode_round_seconds")
        self.arena = _SlotArenaView(inner, self._lock)

    def warmup(self, burst: int = 0) -> None:
        """Capture the steps serving runs before it serves: a prefill at
        every bucket up to ``max_len`` and the decode step of width 1, on
        the last stage the prefill's and the round's samplers, and with
        ``burst > 0`` on a full-span engine the burst of that many ticks
        (over a fresh warm-up session: the port has no rewind yet), under
        the adapter's lock."""
        first = self.spec.is_first
        d = self.cfg.hidden_size
        inner = self.inner
        sampled = StageRequest(session_id="__warmup__", hidden=None, seq_len=1,
                               cur_len=0, is_prefill=False, max_length=0,
                               sampling=SamplingParams(), generated_tokens=(1, 2, 3))
        with self._lock:
            for tb in sorted({min(b, inner.max_len) for b in PREFILL_BUCKETS}):
                x = (torch.zeros((1, tb), dtype=torch.int64) if first
                     else torch.zeros((1, tb, d), dtype=torch.float32))
                inner.prefill("__warmup__", x)
            # The reference's warm-up session: 4 tokens, then one step.
            h = inner.prefill("__warmup__", x[:, :4])
            step = (torch.zeros((1, 1), dtype=torch.int64) if first
                    else torch.zeros((1, 1, d), dtype=torch.float32))
            inner.decode_batch({"__warmup__": step})
            if self.spec.is_last:
                _sample_rows(inner.logits(h[:, -1:]), 1, sampled, inner.sampler)
                inner.sample_round({"__warmup__": sampled})
            if burst > 0 and self.spec.is_first and self.spec.is_last:
                inner.prefill("__warmup__", x[:, :4])
                inner.decode_burst(
                    {"__warmup__": {"token": 1, "seed": 0, "budget": burst, "eos": None,
                                    "generated": (1,), "temperature": 0.0, "top_p": 1.0,
                                    "top_k": 0, "repetition_penalty": 1.0}}, burst)
            inner.end_session("__warmup__")

    # -- protocol ----------------------------------------------------------

    def forward(self, req: StageRequest) -> StageResponse:
        self.requests_served += 1
        if (req.hypo_ids is not None or req.num_logprobs
                or req.prompts is not None
                or req.start_from_position not in (None, req.cur_len)):
            _ev.emit("task_rejected", session_id=req.session_id,
                     pool="batched", reason="unsupported request kind")
            raise StageExecutionError(
                "batched peer serves plain prefill/decode and replay only "
                "(route beam/training/deep-prompt requests to a per-session "
                "replica)")
        if req.start_block is not None and (
                req.start_block != self.spec.start
                or (req.end_block or self.spec.end) != self.spec.end):
            _ev.emit("task_rejected", session_id=req.session_id,
                     pool="batched", reason="sub-span request")
            raise StageExecutionError("batched peer serves its full span only")
        reason = _unported_reason(req)
        if reason is not None:
            _ev.emit("task_rejected", session_id=req.session_id,
                     pool="batched", reason=reason)
            raise StageExecutionError(f"batched peer: {reason}")
        if req.is_prefill:
            return self._prefill(req)
        if req.burst_len:
            if not (self.spec.is_first and self.spec.is_last):
                _ev.emit("task_rejected", session_id=req.session_id,
                         pool="batched", reason="burst without full span")
                raise StageExecutionError(
                    "burst decode requires a full-span peer (on-device "
                    "sampling feeds tokens back into the embedding)")
            if req.seq_len != 1:
                raise StageExecutionError(
                    "a burst step carries exactly the one last accepted token")
            return self._decode_burst(req)
        if req.seq_len != 1 and not req.is_replay:
            # Replay chunks are plain multi-token KV rebuilds (the client
            # discards the sampled token): decode_batch's T > 1 shape.
            raise StageExecutionError(
                "batched decode is single-token (chunked continuation "
                "belongs to the per-session executor)")
        return self._decode(req)

    def drop_session(self, session_id: str) -> None:
        with self._lock:
            self.inner.end_session(session_id)

    # -- phases ------------------------------------------------------------

    def _respond(self, req: StageRequest, hidden_row: torch.Tensor,
                 cache_len: int, token: Optional[int] = None) -> StageResponse:
        if self.spec.is_last:
            if token is None:
                logits = self.inner.logits(hidden_row[:, -1:])
                token = _sample_rows(logits, 1, req, self.inner.sampler)[0]
            return StageResponse(session_id=req.session_id, token_id=token,
                                 cache_len=cache_len)
        return StageResponse(session_id=req.session_id, hidden=hidden_row,
                             cache_len=cache_len)

    def _prefill(self, req: StageRequest) -> StageResponse:
        with self._lock:  # slot tables + cache tensors are shared state
            try:
                h = self.inner.prefill(req.session_id, req.hidden,
                                       prefix_len=req.prefix_len)
            except StageExecutionError:
                raise
            except Exception as exc:
                # Retryable, as decode's whole-round failures are: the
                # engine recycled the slot.
                raise StageExecutionError(str(exc)) from exc
            cache_len = int(self.inner.lengths[self.inner.slot(req.session_id)])
        return self._respond(req, h, cache_len)

    def _validate(self, req: StageRequest) -> Optional[str]:
        """Per-session admission (caller holds the lock). Returns a refusal
        reason or None. A bad session must never poison its round-mates."""
        s = self.inner.slot(req.session_id)
        if s is None:
            return (f"session {req.session_id}: decode without a slot "
                    "(prefill first; replay-rebuild is per-session only)")
        cur = int(self.inner.lengths[s])
        if cur + req.seq_len > self.inner.max_len:
            return (f"session {req.session_id}: {req.seq_len} tokens past "
                    f"{cur} exceeds max_len {self.inner.max_len}")
        if req.cur_len != cur:
            # The batched path REFUSES a mismatch (the session executor
            # warns and trusts itself): the main cause is a retry after a
            # follower timeout whose step did advance, and the refusal is
            # retryable, so the client fails over and replays. (The
            # reference's rewind for a speculative rollback waits for
            # ROADMAP Queue 1 #3.)
            return (f"session {req.session_id}: cur_len {req.cur_len} != "
                    f"server {cur} (stale retry?)")
        return None

    def _validate_burst(self, req: StageRequest) -> Optional[str]:
        """Burst admission on top of `_validate` (caller holds the lock):
        every refusal `_burst_prep` would raise, so one bad session never
        fails its round-mates."""
        if req.burst_budget < 1:
            return (f"session {req.session_id}: burst budget "
                    f"{req.burst_budget} (want >= 1)")
        cur = int(self.inner.lengths[self.inner.slot(req.session_id)])
        budget = min(int(req.burst_budget), int(req.burst_len))
        if cur + budget > self.inner.max_len:
            return (f"session {req.session_id}: burst of {budget} past "
                    f"{cur} exceeds max_len {self.inner.max_len}")
        return None

    def _decode(self, req: StageRequest) -> StageResponse:
        def run(r: _Round, good: Dict[str, StageRequest]) -> None:
            r.outs = self.inner.decode_batch({s_id: rq.hidden for s_id, rq in good.items()})
            if self.spec.is_last:
                r.tokens = self.inner.sample_round(good)

        r = self._coalesce(req.seq_len, req, self._validate, run)
        return self._respond(req, r.outs[req.session_id], r.lengths[req.session_id],
                             token=r.tokens.get(req.session_id))

    def _decode_burst(self, req: StageRequest) -> StageResponse:
        """Burst requests coalesce into one `decode_burst` a round, keyed
        ``("burst", N)`` so that they never share a round with single-tick
        decodes; sessions join and leave at round (burst) boundaries."""
        n = int(req.burst_len)

        def run(r: _Round, good: Dict[str, StageRequest]) -> None:
            r.outs = self.inner.decode_burst(
                {s_id: _burst_entry(rq) for s_id, rq in good.items()}, n)
            _ev.emit("burst_round", sessions=len(good), ticks=n,
                     tokens=sum(len(o["tokens"]) for o in r.outs.values()))

        r = self._coalesce(("burst", n), req,
                           lambda rq: self._validate(rq) or self._validate_burst(rq), run)
        out = r.outs[req.session_id]
        return StageResponse(session_id=req.session_id, burst_tokens=tuple(out["tokens"]),
                             burst_stop=out["stop"], cache_len=r.lengths[req.session_id])

    def _coalesce(self, key, req: StageRequest, validate, run) -> _Round:
        """Join (or lead) the open round of `key`. The leader sleeps the
        window, re-validates every joiner, and runs ``run(round, good)``
        under the lock; every waiter then gets the round back, or its own
        refusal or the round's failure raised."""
        sid = req.session_id
        t_join = time.monotonic()
        with self._lock:
            reason = validate(req)
            if reason is not None:
                raise StageExecutionError(reason)
            r = self._rounds.get(key)
            if r is None or r.closed:
                r = self._rounds[key] = _Round()
                leader = True       # whoever CREATES the round leads it
            else:
                leader = False
            if sid in r.reqs:
                raise StageExecutionError(
                    f"session {sid}: concurrent decode for one session")
            r.reqs[sid] = req
        if leader:
            # An exception anywhere on the leader's path must still release
            # the followers, else they block for step_timeout.
            try:
                time.sleep(self.window_s)
                with self._lock:
                    r.closed = True
                    if self._rounds.get(key) is r:
                        del self._rounds[key]
                    # Re-validate: a session may have been dropped since it
                    # joined. Exclusions fail only their own waiter.
                    good = {}
                    for s_id, rq in r.reqs.items():
                        reason = validate(rq)
                        if reason is None:
                            good[s_id] = rq
                        else:
                            r.bad[s_id] = reason
                    if good:
                        r.t_exec = time.monotonic()
                        self._m_fill.observe(len(good))
                        run(r, good)
                        r.lengths = {
                            s_id: int(self.inner.lengths[self.inner.slot(s_id)])
                            for s_id in good
                        }
                        self._m_round.observe(time.monotonic() - r.t_exec)
            except Exception as exc:  # whole-round failure
                r.err = exc
                with self._lock:  # a dead round must not accept joiners
                    r.closed = True
                    if self._rounds.get(key) is r:
                        del self._rounds[key]
            finally:
                r.event.set()
        elif not r.event.wait(self.step_timeout):
            raise StageExecutionError("batched step timed out")
        if r.t_exec:
            # Time this session spent parked before its round's step ran.
            self._m_queue_wait.observe(max(0.0, r.t_exec - t_join))
        if r.err is not None:
            raise StageExecutionError(str(r.err)) from r.err
        if sid in r.bad:
            raise StageExecutionError(r.bad[sid])
        return r
