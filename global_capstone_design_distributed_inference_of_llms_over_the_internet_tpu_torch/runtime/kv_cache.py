"""Session KV-cache arena: fixed budget, admission control, backpressure.

Port of the JAX package's ``runtime/kv_cache.py``. A session declares ``max_length`` up front; every step is checked against
it before dispatch. Buffers are ``[L, B, bucket_len, Hkv, Dh]`` tensors on
the arena's device, with ``max_length`` rounded up to a bucket. When the
arena is full, allocation waits (up to a timeout) for another session to
free memory. Idle sessions can be evicted (`evict_idle`). The arena
publishes its occupancy gauges and allocation counters, and records
``kv_alloc_failed`` / ``kv_backpressure`` / ``kv_eviction`` events, from
host integers it already keeps.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .errors import register as _catalog


@_catalog
class AllocationFailed(RuntimeError):
    """The arena cannot satisfy an allocation within the timeout."""


@_catalog
class AdmissionDenied(RuntimeError):
    """A step would exceed the session's declared max_length."""


def round_to_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n. Raises if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise AllocationFailed(
        f"requested max_length={n} exceeds largest cache bucket {buckets[-1]}")


DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


@dataclasses.dataclass
class KVHandle:
    """One session's cache lease on one stage; `cache_len` valid tokens."""

    session_id: str
    max_length: int
    bucket_len: int
    nbytes: int
    k: torch.Tensor          # [L, B, bucket_len, Hkv, Dh]
    v: torch.Tensor
    cache_len: int = 0
    last_used: float = dataclasses.field(default_factory=time.monotonic)
    freed: bool = False

    def admit(self, new_tokens: int) -> None:
        """Admission check before dispatching a step."""
        if self.cache_len + new_tokens > self.max_length:
            raise AdmissionDenied(
                f"session {self.session_id}: {self.cache_len}+{new_tokens} "
                f"tokens > max_length {self.max_length}")

    def advance(self, new_tokens: int) -> None:
        self.cache_len += new_tokens
        self.last_used = time.monotonic()


class KVArena:
    """Fixed-budget KV allocator for one pipeline stage."""

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 max_bytes: int, *, device, dtype: torch.dtype = torch.bfloat16,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 alloc_timeout: float = 10.0):
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.max_bytes = max_bytes
        self.device = torch.device(device)
        self.dtype = dtype
        self.buckets = tuple(sorted(buckets))
        self.alloc_timeout = alloc_timeout
        # Telemetry (process-global registry; a no-op unless enabled). The
        # gauges are process-level: with several arenas in one process the
        # most recently active one wins, as in the reference.
        self._m_used = _tm.get("server_kv_used_bytes")
        self._m_capacity = _tm.get("server_kv_capacity_bytes")
        self._m_ratio = _tm.get("server_kv_occupancy_ratio")
        self._m_allocs = _tm.get("server_kv_alloc_total")
        self._m_alloc_failures = _tm.get("server_kv_alloc_failures_total")
        self._m_alloc_wait = _tm.get("server_kv_alloc_wait_seconds")
        self._m_evictions = _tm.get("server_kv_evictions_total")
        self._lock = threading.Condition()
        self._used_bytes = 0
        self._handles: Dict[str, KVHandle] = {}
        self._pending: set = set()

    def bytes_for(self, bucket_len: int, num_layers: Optional[int] = None,
                  batch: int = 1) -> int:
        layers = self.num_layers if num_layers is None else num_layers
        per_token = 2 * layers * self.num_kv_heads * self.head_dim
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return per_token * bucket_len * itemsize * batch

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used_bytes

    def _publish_occupancy(self) -> None:
        used = self._used_bytes
        self._m_used.set(used)
        self._m_capacity.set(self.max_bytes)
        if self.max_bytes > 0:
            self._m_ratio.set(used / self.max_bytes)

    def allocate(self, session_id: str, max_length: int,
                 timeout: Optional[float] = None,
                 num_layers: Optional[int] = None, batch: int = 1) -> KVHandle:
        """Lease cache space for a session; blocks (<= timeout) when full."""
        timeout = self.alloc_timeout if timeout is None else timeout
        layers = self.num_layers if num_layers is None else num_layers
        t_alloc = time.monotonic()
        try:
            bucket_len = round_to_bucket(max_length, self.buckets)
            nbytes = self.bytes_for(bucket_len, layers, batch)
            if nbytes > self.max_bytes:
                raise AllocationFailed(f"allocation of {nbytes} bytes can never "
                                       f"fit arena of {self.max_bytes} bytes")
        except AllocationFailed:
            self._m_alloc_failures.inc()
            _ev.emit("kv_alloc_failed", session_id=session_id, reason="oversized")
            raise
        deadline = time.monotonic() + timeout
        with self._lock:
            if session_id in self._handles or session_id in self._pending:
                self._m_alloc_failures.inc()
                _ev.emit("kv_alloc_failed", session_id=session_id,
                         reason="duplicate_session")
                raise AllocationFailed(f"session {session_id} already allocated")
            self._pending.add(session_id)
            try:
                while self.max_bytes - self._used_bytes < nbytes:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._lock.wait(remaining):
                        self._m_alloc_failures.inc()
                        _ev.emit("kv_alloc_failed", session_id=session_id,
                                 reason="arena_full_timeout")
                        raise AllocationFailed(
                            f"arena full: {self._used_bytes}/{self.max_bytes} "
                            f"bytes used, need {nbytes}, timed out after "
                            f"{timeout:.1f}s")
                self._used_bytes += nbytes
            except BaseException:
                self._pending.discard(session_id)
                raise
            wait_s = time.monotonic() - t_alloc
            self._m_alloc_wait.observe(wait_s)
            if wait_s > 0.01:   # only real backpressure, not lock latency
                _ev.emit("kv_backpressure", session_id=session_id,
                         wait_s=round(wait_s, 4))
            self._m_allocs.inc()
            self._publish_occupancy()
        try:
            shape = (layers, batch, bucket_len, self.num_kv_heads, self.head_dim)
            k = torch.zeros(shape, dtype=self.dtype, device=self.device)
            v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        except BaseException:
            # Roll back the reservation (e.g. device OOM) so it never leaks.
            with self._lock:
                self._used_bytes -= nbytes
                self._pending.discard(session_id)
                self._lock.notify_all()
                self._m_alloc_failures.inc()
                self._publish_occupancy()
            raise
        handle = KVHandle(session_id=session_id, max_length=max_length,
                          bucket_len=bucket_len, nbytes=nbytes, k=k, v=v)
        with self._lock:
            self._pending.discard(session_id)
            self._handles[session_id] = handle
        return handle

    def get(self, session_id: str) -> Optional[KVHandle]:
        with self._lock:
            return self._handles.get(session_id)

    def free(self, session_id: str) -> None:
        with self._lock:
            handle = self._handles.pop(session_id, None)
            if handle is None or handle.freed:
                return
            handle.freed = True
            handle.k = None  # type: ignore[assignment]  # drop device buffers
            handle.v = None  # type: ignore[assignment]
            self._used_bytes -= handle.nbytes
            self._lock.notify_all()
            self._publish_occupancy()

    def evict_idle(self, older_than: float) -> int:
        """Free sessions idle longer than `older_than` seconds (abandoned
        clients). Returns how many were freed."""
        now = time.monotonic()
        with self._lock:
            stale = [(sid, h.nbytes) for sid, h in self._handles.items()
                     if now - h.last_used > older_than]
        for sid, _ in stale:
            self.free(sid)
        if stale:
            self._m_evictions.inc(len(stale))
            _ev.emit("kv_eviction", sessions=len(stale),
                     bytes=sum(b for _, b in stale))
        return len(stale)
