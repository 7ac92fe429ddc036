"""Session KV-cache arena: fixed budget, admission control, backpressure.

Port of the JAX package's ``runtime/kv_cache.py`` without its telemetry.
A session declares ``max_length`` up front; every step is checked against
it before dispatch. Buffers are ``[L, B, bucket_len, Hkv, Dh]`` tensors on
the arena's device, with ``max_length`` rounded up to a bucket. When the
arena is full, allocation waits (up to a timeout) for another session to
free memory.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import torch

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
    freed: bool = False

    def admit(self, new_tokens: int) -> None:
        """Admission check before dispatching a step."""
        if self.cache_len + new_tokens > self.max_length:
            raise AdmissionDenied(
                f"session {self.session_id}: {self.cache_len}+{new_tokens} "
                f"tokens > max_length {self.max_length}")

    def advance(self, new_tokens: int) -> None:
        self.cache_len += new_tokens


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

    def allocate(self, session_id: str, max_length: int,
                 timeout: Optional[float] = None,
                 num_layers: Optional[int] = None, batch: int = 1) -> KVHandle:
        """Lease cache space for a session; blocks (<= timeout) when full."""
        timeout = self.alloc_timeout if timeout is None else timeout
        layers = self.num_layers if num_layers is None else num_layers
        bucket_len = round_to_bucket(max_length, self.buckets)
        nbytes = self.bytes_for(bucket_len, layers, batch)
        if nbytes > self.max_bytes:
            raise AllocationFailed(f"allocation of {nbytes} bytes can never fit "
                                   f"arena of {self.max_bytes} bytes")
        deadline = time.monotonic() + timeout
        with self._lock:
            if session_id in self._handles or session_id in self._pending:
                raise AllocationFailed(f"session {session_id} already allocated")
            self._pending.add(session_id)
            try:
                while self.max_bytes - self._used_bytes < nbytes:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._lock.wait(remaining):
                        raise AllocationFailed(
                            f"arena full: {self._used_bytes}/{self.max_bytes} "
                            f"bytes used, need {nbytes}, timed out after "
                            f"{timeout:.1f}s")
                self._used_bytes += nbytes
            except BaseException:
                self._pending.discard(session_id)
                raise
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
