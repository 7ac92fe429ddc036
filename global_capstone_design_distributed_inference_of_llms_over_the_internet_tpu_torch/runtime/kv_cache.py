"""Session KV-cache arena: fixed budget, admission control, backpressure.

Port of the JAX package's ``runtime/kv_cache.py``. A session declares ``max_length`` up front; every step is checked against
it before dispatch. Buffers are ``[L, B, bucket_len, Hkv, Dh]`` tensors on
the arena's device, with ``max_length`` rounded up to a bucket. When the
arena is full, allocation waits (up to a timeout) for another session to
free memory. Idle sessions can be evicted (`evict_idle`). The arena
publishes its occupancy gauges and allocation counters, and records
``kv_alloc_failed`` / ``kv_backpressure`` / ``kv_eviction`` events, from
host integers it already keeps.

Deliberate difference from the reference: a freed lease's buffers are
reused in place. A captured step (``runtime/graphs.py``) reads fixed
addresses, so a freed lease's ``k``/``v`` go on a free list keyed by shape
(layers, batch, bucket) and the next lease of that shape takes them, each
zeroed with one ``zero_()`` so it starts as a fresh lease does. Free-listed
bytes count as free for admission (``used_bytes``, ``bytes_left`` and
``tokens_left`` are the reference's); they are released, and the release
hooks told (the executor drops the graphs that read them), when an
allocation of another shape needs the room. Each buffer pair keeps one
``slot`` number for its life, the key its graphs are filed under.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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
    slot: int = -1           # the buffer pair's number in its arena

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
        # Freed buffer pairs by shape, each (slot, k, v, nbytes), and their
        # bytes; called with a slot's number when its buffers are released.
        self._free: Dict[tuple, List[tuple]] = {}
        self._free_bytes = 0
        self._slots = itertools.count()
        self._release_hooks: List[Callable[[int], None]] = []

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

    @property
    def bytes_left(self) -> int:
        with self._lock:
            return self.max_bytes - self._used_bytes

    def tokens_left(self) -> int:
        """Advertised capacity: the ``cache_tokens_left`` a server publishes
        with its heartbeat and its ``info`` frame."""
        return max(0, self.bytes_left) // max(self.bytes_for(1), 1)

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
                shape = (layers, batch, bucket_len, self.num_kv_heads, self.head_dim)
                reused = self._free.get(shape)
                reused = reused.pop() if reused else None
                if reused is not None:
                    self._free_bytes -= reused[3]
                    released = []
                else:
                    released = self._release_free()
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
        for slot in released:
            for hook in self._release_hooks:
                hook(slot)
        try:
            if reused is not None:
                slot, k, v, _ = reused
                k.zero_()
                v.zero_()
            else:
                slot = next(self._slots)
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
                          bucket_len=bucket_len, nbytes=nbytes, k=k, v=v,
                          slot=slot)
        with self._lock:
            self._pending.discard(session_id)
            self._handles[session_id] = handle
        return handle

    def _release_free(self) -> List[int]:
        """Drop free-listed buffer pairs (under the lock, after the new
        lease's bytes joined the used ones) until the leases and what stays
        on the free list fit the budget. Returns the released slots."""
        released = []
        for shape in list(self._free):
            entries = self._free[shape]
            while entries and self._used_bytes + self._free_bytes > self.max_bytes:
                slot, _, _, size = entries.pop()
                self._free_bytes -= size
                released.append(slot)
            if not entries:
                del self._free[shape]
        return released

    def add_release_hook(self, hook: Callable[[int], None]) -> None:
        """Call ``hook(slot)`` whenever a free-listed buffer pair is released."""
        with self._lock:
            self._release_hooks.append(hook)

    def get(self, session_id: str) -> Optional[KVHandle]:
        with self._lock:
            return self._handles.get(session_id)

    def free(self, session_id: str) -> None:
        with self._lock:
            handle = self._handles.pop(session_id, None)
            if handle is None or handle.freed:
                return
            handle.freed = True
            # The buffers go on the free list for the next lease of their
            # shape; the handle lets go of them.
            self._free.setdefault(tuple(handle.k.shape), []).append(
                (handle.slot, handle.k, handle.v, handle.nbytes))
            self._free_bytes += handle.nbytes
            handle.k = None  # type: ignore[assignment]
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
