"""Content-addressed prompt-prefix KV store.

Port of the JAX package's ``runtime/prefix_cache.py``. Serving workloads
repeat prompt prefixes: a shared system prompt, a few-shot preamble, one
document asked about many times. On a prefill whose leading rows
chain-hash to stored segments, an executor copies their KV rows into the
session's cache and computes only the rest (``runtime/executor.py``,
``runtime/batching.py``).

Design, as in the reference:

* **Grain-chained rolling digests.** The prefix is split into ``grain``-token
  segments; segment k is keyed by the digest of the coordinates and every
  byte through it (one incremental pass, a snapshot a grain). Lookup walks
  k = 1, 2, ... while the chain is unbroken, so two prompts sharing a
  preamble reuse its whole grains with no annotation of where it ends, and
  a segment is valid only after its exact prefix (its KV depends on every
  row before it).
* **Content-addressed.** The digest covers the bytes entering the span
  (token ids on the first stage, hidden rows downstream) and the execution
  coordinates (block range, batch, dtypes, model), so a hit is the same
  bytes through the same blocks.
* **Per-segment entries**: a grain's KV rows, and off the final stage its
  output rows (the next hop needs every row's hidden state). Evicting a
  middle link shortens every chain through it.
* **Bounded bytes, LRU**, touched root last.

Entries are device tensors that own their memory (clones, never views of a
lease or of a captured step's output); their bytes are ``tensor.nbytes``.

Accepted trade-off, as in the reference: the store is server-wide, so a
client who guesses another session's prefix can see it was served recently
(TTFT, the ``info`` verb's hit counts). Deployments serving mutually
untrusted tenants leave the store off (its default).

Thread-safe: LocalTransport callers and a batched adapter's handler
threads may race `lookup_chain` and `put`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional

import torch

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev

# Tokens per stored segment, as the reference's.
DEFAULT_GRAIN = 64


@dataclasses.dataclass
class PrefixEntry:
    """One grain's KV rows (k/v: ``[span_layers, B, G, kv_heads, head_dim]``
    for a session executor, ``[span_layers, G, kv_heads, head_dim]`` for a
    batched engine) and, off the final stage, its output rows (out:
    ``[B, G, D]``)."""

    k: torch.Tensor
    v: torch.Tensor
    out: Optional[torch.Tensor]
    nbytes: int


def chain_digests(prefix_bytes_per_grain: List[bytes], coords: tuple) -> List[str]:
    """Rolling digests d_1..d_K over grain-sized byte blocks: d_k commits to
    `coords` and every byte through grain k. blake2b with a 16-byte digest,
    as the reference's: it runs on the serving thread of every prefill
    with a store, hits and misses."""
    h = hashlib.blake2b(repr(coords).encode(), digest_size=16)
    out = []
    for blk in prefix_bytes_per_grain:
        h.update(blk)
        out.append(h.hexdigest())
    return out


class PrefixStore:
    """Bounded LRU of `PrefixEntry` keyed by rolling chain digest."""

    def __init__(self, max_bytes: int, grain: int = DEFAULT_GRAIN):
        self.max_bytes = int(max_bytes)
        self.grain = int(grain)
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.used_bytes = 0
        self.hits = 0          # lookups that reused >= 1 grain
        self.misses = 0        # lookups that reused none
        self.grains_reused = 0
        self.evictions = 0
        # Registry mirrors of the counters above (no-ops unless telemetry
        # is on); the ints stay authoritative for `stats()`.
        self._m_hits = _tm.get("server_prefix_cache_hits_total")
        self._m_misses = _tm.get("server_prefix_cache_misses_total")
        self._m_evictions = _tm.get("server_prefix_cache_evictions_total")
        self._m_grains = _tm.get("server_prefix_cache_grains_reused_total")
        self._m_bytes = _tm.get("server_prefix_cache_used_bytes")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup_chain(self, keys: List[str], need_out: bool) -> List[PrefixEntry]:
        """Longest unbroken chain of stored segments for rolling digests
        `keys`; with `need_out` (intermediate stages) a KV-only link ends
        the chain. Touches every returned link, the root last: a chain is
        reachable only through its first link, so the root must be the
        warmest of its chain."""
        got: List[PrefixEntry] = []
        used: List[str] = []
        with self._lock:
            for key in keys:
                entry = self._entries.get(key)
                if entry is None or (need_out and entry.out is None):
                    break
                used.append(key)
                got.append(entry)
            for key in reversed(used):
                self._entries.move_to_end(key)
            if got:
                self.hits += 1
                self.grains_reused += len(got)
                self._m_hits.inc()
                self._m_grains.inc(len(got))
            elif keys:
                self.misses += 1
                self._m_misses.inc()
        return got

    def put(self, key: str, k: torch.Tensor, v: torch.Tensor,
            out: Optional[torch.Tensor]) -> bool:
        """Insert one segment (idempotent per key), evicting LRU entries to
        fit. Returns False when the segment alone exceeds the budget."""
        nbytes = k.nbytes + v.nbytes + (out.nbytes if out is not None else 0)
        if nbytes > self.max_bytes:
            return False
        entry = PrefixEntry(k=k, v=v, out=out, nbytes=nbytes)
        evicted, evicted_bytes = 0, 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.used_bytes -= old.nbytes
            while self.used_bytes + nbytes > self.max_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                self.used_bytes -= victim.nbytes
                self.evictions += 1
                self._m_evictions.inc()
                evicted += 1
                evicted_bytes += victim.nbytes
            self._entries[key] = entry
            self.used_bytes += nbytes
            self._m_bytes.set(self.used_bytes)
        if evicted:
            _ev.emit("prefix_eviction", grains=evicted, bytes=evicted_bytes)
        return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.used_bytes,
                "grain": self.grain,
                "hits": self.hits,
                "misses": self.misses,
                "grains_reused": self.grains_reused,
                "evictions": self.evictions,
            }


def grain_blocks(x: torch.Tensor, n_grains: int, grain: int) -> List[bytes]:
    """The bytes of the first ``n_grains * grain`` rows of `x` ([B, T] ids
    or [B, T, D] hidden rows), one block a grain. A host tensor is read as
    it is; a device tensor's prefix rows are copied to the host once (a
    host sync). numpy has no bfloat16: its bits are read as int16."""
    rows = x[:, :n_grains * grain]
    if rows.device.type != "cpu":
        rows = rows.cpu()
    if rows.dtype == torch.bfloat16:
        rows = rows.view(torch.int16)
    arr = rows.numpy()
    return [arr[:, g * grain:(g + 1) * grain].tobytes() for g in range(n_grains)]
