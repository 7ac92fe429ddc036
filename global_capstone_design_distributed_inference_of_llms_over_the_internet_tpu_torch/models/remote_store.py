"""Remote per-span weight fetch with a bounded, digest-verified disk cache.

Port of the JAX package's ``models/remote_store.py``: Petals servers
download ONLY the checkpoint shards that hold their span's parameters and
manage and evict the disk cache (``petals/server/from_pretrained.py:81-128``,
per-block shard filtering against the HF index; ``:189-213``,
free-space-driven eviction). The store is any static HTTP file server over
an HF checkpoint directory:

  * the layout is exactly an HF checkpoint directory: ``config.json``,
    ``model.safetensors.index.json`` (or a single ``model.safetensors``),
    the shard files, and optionally ``digests.json`` ({filename: sha256});
  * ``shards_for_span`` filters the index's weight map to the files that
    cover ``[start, end)`` for a stage role (the reference's
    ``block_prefix`` filter generalized to a span and its embed / head);
  * fetched shards land in a local cache directory with LRU accounting;
    once the cache exceeds ``max_cache_bytes``, the least recently USED
    shards the current span does not need are deleted;
  * every fetched file is sha256-verified against ``digests.json`` when the
    store publishes one: a truncated or corrupted download fails loudly.

The cache directory's layout and its ``.lru_state.json`` are the JAX
package's byte for byte, so a JAX server and a port server on one host can
share a cache directory. Two differences: the single-file layout's keys
are read with the port's own header reader (``hf_import.SafetensorsFile``)
instead of ``safetensors.safe_open``, and ``load_stage`` ends in the port's
``load_stage_checkpoint`` over the cache directory, on a device.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set

import torch

from .config import ModelConfig

logger = logging.getLogger(__name__)

INDEX = "model.safetensors.index.json"
SINGLE = "model.safetensors"
DIGESTS = "digests.json"

# Layer-scoped key patterns across supported families (hf_import layouts),
# with and without the base-model prefix (LazyCheckpoint alias rule).
_LAYER_RE = re.compile(
    r"^(?:transformer\.)?h\.(\d+)\.|^(?:model\.)?layers\.(\d+)\.")


def _layer_of(key: str) -> Optional[int]:
    m = _LAYER_RE.match(key)
    if m is None:
        return None
    return int(m.group(1) if m.group(1) is not None else m.group(2))


class DigestMismatch(RuntimeError):
    """A fetched shard's sha256 does not match the store's digests.json."""


class RemoteShardStore:
    """Span-scoped shard fetcher over HTTP with a bounded LRU disk cache."""

    # How long a 403 on digests.json is treated as "absent" before the next
    # probe (about one probe and one log line a TTL, not one a shard).
    DIGEST_403_TTL_S = 60.0

    # Tokenizer files a checkpoint MAY publish (absence is normal: clients
    # fall back to the byte tokenizer only when none loads).
    TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                       "special_tokens_map.json", "tokenizer.model",
                       "vocab.json", "merges.txt")

    def __init__(self, base_url: str, cache_dir: str,
                 max_cache_bytes: Optional[int] = None,
                 timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.cache_dir = cache_dir
        self.max_cache_bytes = max_cache_bytes
        self.timeout = timeout
        os.makedirs(cache_dir, exist_ok=True)
        self.fetches: List[str] = []     # every remote GET, in order
        self._digests: Optional[Dict[str, str]] = None
        self._digests_403_until = 0.0
        self._weight_map: Optional[Dict[str, str]] = None
        # One lock serializes fetch, evict and load within the process: a
        # store is memoized and shared by every serving role (elastic
        # servers re-span on background threads), and one thread's eviction
        # must not delete shards another fetched but has not read yet.
        # Processes sharing one cache directory are protected by the grace
        # period: files younger than evict_grace_s are never evicted.
        self._op_lock = threading.RLock()
        self.evict_grace_s = 300.0
        # filename -> last-use WALL-CLOCK time (time.time: stamps are
        # persisted and compared across restarts, where a boot-relative
        # clock would sort new touches below old ones), so the LRU order
        # survives a server restart.
        self._state_path = os.path.join(cache_dir, ".lru_state.json")
        try:
            with open(self._state_path) as f:
                self._lru: Dict[str, float] = dict(json.load(f))
        except (OSError, ValueError):
            self._lru = {}

    # -- transport ---------------------------------------------------------

    def _get(self, name: str) -> bytes:
        url = f"{self.base_url}/{name}"
        self.fetches.append(name)
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            return r.read()

    def _fetch_to_cache(self, name: str, verify: bool = True) -> str:
        """Download `name` into the cache (skipped when present), verify its
        digest, bump its LRU stamp and return the local path."""
        local = os.path.join(self.cache_dir, name)
        if not os.path.exists(local):
            data = self._get(name)
            if verify:
                want = self.digests().get(name)
                if want is not None:
                    got = hashlib.sha256(data).hexdigest()
                    if got != want:
                        raise DigestMismatch(
                            f"{name}: sha256 {got} != published {want}")
            # A temporary name per process AND thread, then an atomic
            # rename: processes of one host share a cache directory and
            # threads of one process share the store, so no two fetchers of
            # one shard write into one file. Either winner's bytes are the
            # digest's.
            tmp = f"{local}.part.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, local)  # never a torn shard under its name
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            # Persist after each download, so a co-hosted process's _evict
            # sees this recency during a long span fetch; hits stay in
            # memory.
            self._touch(name)
            self._persist_lru()
            return local
        self._touch(name)
        return local

    # -- store metadata ----------------------------------------------------

    def digests(self) -> Dict[str, str]:
        with self._op_lock:
            if (self._digests is None
                    and time.monotonic() < self._digests_403_until):
                return {}
            if self._digests is None:
                try:
                    self._digests = json.loads(self._get(DIGESTS))
                except urllib.error.HTTPError as exc:
                    # 404 / 410 say the file is absent: cached. A transient
                    # error (timeout, reset, 5xx) is raised uncached: caching
                    # {} would turn verification off for the process.
                    if exc.code in (404, 410):
                        logger.warning("store publishes no %s; shards are "
                                       "fetched UNVERIFIED", DIGESTS)
                        self._digests = {}
                    elif exc.code == 403:
                        # Static hosting without list permission answers 403
                        # for an absent key, but on a store that publishes
                        # digests it is a broken ACL: treat it as absent for
                        # a short while only, loudly, and probe again.
                        logger.error(
                            "store answered 403 for %s; treating as absent "
                            "for the next %.0fs — shards are UNVERIFIED "
                            "until the store stops forbidding the digest "
                            "file (fix the ACL or delete the file to get a "
                            "clean 404)", DIGESTS, self.DIGEST_403_TTL_S)
                        self._digests_403_until = (
                            time.monotonic() + self.DIGEST_403_TTL_S)
                        return {}
                    else:
                        raise
            return self._digests

    def weight_map(self) -> Dict[str, str]:
        """key -> shard filename (the index is small)."""
        with self._op_lock:
            if self._weight_map is not None:
                return self._weight_map
            try:
                local = self._fetch_to_cache(INDEX)
                try:
                    with open(local) as f:
                        wm = json.load(f)["weight_map"]
                    if not isinstance(wm, dict):
                        raise ValueError("weight_map is not a mapping")
                    self._weight_map = dict(wm)
                    self._persist_lru()
                    return self._weight_map
                except (ValueError, KeyError) as exc:
                    # A present but malformed index (a host answering 200
                    # with an error page): drop the cached copy so that a
                    # retry fetches it again, then try the single file,
                    # naming the real culprit.
                    logger.warning(
                        "%s is present but malformed (%s: %s); dropping "
                        "the cached copy and trying the single-file "
                        "layout", INDEX, type(exc).__name__, exc)
                    try:
                        os.remove(local)
                    except OSError:
                        pass
            except OSError:
                pass
            # A single-file checkpoint: every key lives in model.safetensors.
            from .hf_import import SafetensorsFile

            self._fetch_to_cache(SINGLE)
            keys = SafetensorsFile(os.path.join(self.cache_dir, SINGLE)).keys()
            self._weight_map = {k: SINGLE for k in keys}
            self._persist_lru()
            return self._weight_map

    def fetch_config(self) -> str:
        """Fetch config.json and any published tokenizer file; returns the
        cache directory, then a loadable local checkpoint prefix."""
        with self._op_lock:
            self._fetch_to_cache("config.json")
            for name in self.TOKENIZER_FILES:
                try:
                    self._fetch_to_cache(name)
                except OSError:
                    pass
            self._persist_lru()
            return self.cache_dir

    # -- span logic --------------------------------------------------------

    def shards_for_span(self, start: int, end: int, *, is_first: bool,
                        is_last: bool) -> List[str]:
        """Shard files holding any parameter the span's role needs (the
        per-block filter of ``from_pretrained.py:100-108`` over [start,
        end))."""
        needed: Set[str] = set()
        for key, fname in self.weight_map().items():
            layer = _layer_of(key)
            if layer is not None:
                if start <= layer < end:
                    needed.add(fname)
            elif is_first or is_last:
                # Non-layer tensors: the embeddings (first), the final norm
                # and head (last); the embeddings also serve a tied head.
                needed.add(fname)
        return sorted(needed)

    def ensure_span(self, start: int, end: int, *, is_first: bool,
                    is_last: bool) -> List[str]:
        """Fetch (or reuse) every shard the span needs, then evict the LRU
        excess beyond the byte budget. Returns the local shard paths."""
        with self._op_lock:
            names = self.shards_for_span(start, end, is_first=is_first,
                                         is_last=is_last)
            paths = [self._fetch_to_cache(n) for n in names]
            self._evict(keep=set(names))
            self._persist_lru()
            return paths

    def load_stage(self, cfg: ModelConfig, spec, dtype: Optional[torch.dtype] = None,
                   device="cuda", **load_kw):
        """Fetch the span's shards, then convert them through the local
        per-stage path (``hf_import.load_stage_checkpoint`` over the cache
        directory, on `device`; `load_kw` passed on). The op lock is held
        across fetch AND convert, so another span's eviction cannot delete
        these shards between download and read."""
        from .hf_import import load_stage_checkpoint

        with self._op_lock:
            self.fetch_config()
            self.ensure_span(spec.start, spec.end, is_first=spec.is_first,
                             is_last=spec.is_last)
            return load_stage_checkpoint(self.cache_dir, cfg, spec,
                                         dtype=dtype or torch.float32, device=device,
                                         **load_kw)

    # -- cache management --------------------------------------------------

    def _touch(self, name: str) -> None:
        """In-memory recency bump; the disk write is batched to one
        `_persist_lru` a public operation."""
        self._lru[name] = time.time()

    def _persist_lru(self) -> None:
        try:
            # Merge on write: other processes sharing this cache directory
            # write their stamps to the same file, and a blind rewrite would
            # zero their recency. The newest stamp a key wins; the write is
            # atomic (temporary file, then replace).
            try:
                with open(self._state_path) as f:
                    disk = dict(json.load(f))
            except (OSError, ValueError):
                disk = {}
            for k, v in disk.items():
                if k not in self._lru and not os.path.exists(
                        os.path.join(self.cache_dir, k)):
                    # Evicted, by us or by a co-hosted process: the stamp
                    # is not brought back.
                    continue
                if isinstance(v, (int, float)) and v > self._lru.get(k, 0.0):
                    self._lru[k] = float(v)
            tmp = (f"{self._state_path}.part.{os.getpid()}"
                   f".{threading.get_ident()}")
            with open(tmp, "w") as f:
                json.dump(self._lru, f)
            os.replace(tmp, self._state_path)
        except OSError:  # the cache still works; only the LRU order degrades
            pass

    def cache_bytes(self) -> int:
        total = 0
        for fname in os.listdir(self.cache_dir):
            if fname.endswith(".safetensors"):
                total += os.path.getsize(os.path.join(self.cache_dir, fname))
        return total

    def _evict(self, keep: Set[str]) -> None:
        """Delete the least recently used shards (never `keep`, the span
        being served) until the cache fits the budget
        (``from_pretrained.py:189-213``)."""
        if self.max_cache_bytes is None:
            return
        excess = self.cache_bytes() - self.max_cache_bytes
        if excess <= 0:
            return
        # Publish this process's touches and merge the others' before
        # choosing victims.
        self._persist_lru()
        now = time.time()
        cands = []
        for f in os.listdir(self.cache_dir):
            if not f.endswith(".safetensors") or f in keep:
                continue
            try:
                age = now - os.path.getmtime(os.path.join(self.cache_dir, f))
            except OSError:
                continue
            # Grace period: a file another process just fetched is still
            # inside its fetch-to-read window, visible here by mtime only.
            if age < self.evict_grace_s:
                continue
            cands.append(f)
        cands.sort(key=lambda f: self._lru.get(f, 0.0))
        for fname in cands:
            if excess <= 0:
                break
            path = os.path.join(self.cache_dir, fname)
            try:
                size = os.path.getsize(path)
                os.remove(path)
            except OSError:
                continue
            self._lru.pop(fname, None)
            excess -= size
            logger.info("evicted cached shard %s (%.1f MiB)", fname,
                        size / 2**20)
        if excess > 0:
            # The current span alone exceeds the budget: it is served
            # anyway, and said.
            logger.warning(
                "weight cache over budget by %.1f MiB even after eviction "
                "(the current span needs more than max_cache_bytes)",
                excess / 2**20)
