"""Admission control: decide at the door, shed with a retry hint.

Every refusal here is CHEAP — a dict lookup and a float compare — and
happens before the request touches the swarm. The alternative (admit
everything, let deadline budgets kill the overflow downstream) spends
prefill compute on requests that were doomed at arrival and turns an
overload into a latency collapse for everyone. Shedding is typed:
:class:`Overloaded` is non-retryable by construction (it is not in any
retry taxonomy) and carries ``retry_after_s`` so a well-behaved client
backs off exactly as long as the controller predicts it must.

Three independent gates, checked in order:

  1. per-tenant token bucket (``rate`` refills/s, ``burst`` capacity) —
     bounds sustained request rate; ``retry_after_s`` is the exact time
     until the bucket refills one token;
  2. per-tenant concurrency cap — bounds one tenant's simultaneous
     footprint (queued + generating) regardless of rate;
  3. global queue-depth watermark — bounds the TOTAL backlog; past it the
     gateway is already behind, and queueing more only converts future
     shed into future timeout.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..runtime.errors import register as _catalog
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev

# Retry hint for refusals with no bucket-derived estimate (concurrency cap,
# full queue): long enough to let a generation finish or the queue drain a
# few entries, short enough that a backing-off client re-probes promptly.
DEFAULT_RETRY_AFTER_S = 0.25


@_catalog
class Overloaded(RuntimeError):
    """Typed, NON-retryable admission refusal.

    Deliberately a plain RuntimeError subclass (like TaskRejected): it must
    never enter the retryable failover taxonomy — retrying immediately is
    exactly what an overloaded gateway needs less of. ``retry_after_s``
    tells the caller when trying again has a chance."""

    def __init__(self, message: str, retry_after_s: float,
                 tenant: Optional[str] = None, reason: str = "overloaded"):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        self.reason = reason


@dataclasses.dataclass
class TenantConfig:
    """One tenant's serving contract (the ``--tenants`` JSON schema)."""

    name: str
    weight: float = 1.0        # fair-queue share (relative)
    rate: float = 50.0         # admissions/s the bucket refills
    burst: float = 100.0       # bucket capacity (max admission burst)
    max_concurrency: int = 64  # queued + generating at once
    # Declared latency objectives (None = no SLO for that dimension). The
    # gateway's SloTracker turns violations into rolling burn rates
    # (gateway_slo_* metrics, --mode top).
    slo_ttft_s: Optional[float] = None    # submit-to-first-token objective
    slo_token_s: Optional[float] = None   # per-decode-token objective
    slo_target: float = 0.99              # fraction that must meet objective

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(f"tenant {self.name}: rate and burst must "
                             "be > 0")
        if self.max_concurrency <= 0:
            raise ValueError(f"tenant {self.name}: max_concurrency must "
                             "be > 0")
        for field in ("slo_ttft_s", "slo_token_s"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"tenant {self.name}: {field} must be > 0")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError(f"tenant {self.name}: slo_target must be in "
                             "(0, 1)")


class TokenBucket:
    """Classic leaky/token bucket with an injectable clock (tests pin
    time). Starts FULL — a tenant's first burst is admitted."""

    def __init__(self, rate: float, burst: float,
                 now: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._now = now
        self._tokens = self.burst
        self._stamp = now()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        t = self._now()
        self._tokens = min(self.burst,
                           self._tokens + (t - self._stamp) * self.rate)
        self._stamp = t

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def time_until(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if they already
        are) — the honest ``retry_after_s`` for a rate refusal."""
        with self._lock:
            self._refill_locked()
            missing = n - self._tokens
        return max(0.0, missing / self.rate)

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


class AdmissionController:
    """The gateway's front gate. ``try_admit`` either passes (and charges
    the tenant's bucket + concurrency slot) or raises :class:`Overloaded`;
    every admit must be paired with ``release`` when the request leaves
    the system (completed, failed, or abandoned)."""

    def __init__(self, tenants: Dict[str, TenantConfig],
                 max_queue_depth: int = 64,
                 now: Callable[[], float] = time.monotonic):
        if not tenants:
            raise ValueError("admission controller needs at least one tenant")
        self.tenants = dict(tenants)
        self.max_queue_depth = int(max_queue_depth)
        self._buckets = {name: TokenBucket(cfg.rate, cfg.burst, now=now)
                         for name, cfg in tenants.items()}
        self._inflight: Dict[str, int] = {name: 0 for name in tenants}
        self._lock = threading.Lock()

    def _shed(self, tenant: str, reason: str, retry_after_s: float,
              message: str) -> Overloaded:
        _tm.get("gateway_shed_total").labels(
            tenant=tenant, reason=reason).inc()
        _tm.get("gateway_requests_total").labels(
            tenant=tenant, outcome="shed").inc()
        _ev.emit("request_shed", tenant=tenant, reason=reason,
                 retry_after_s=round(retry_after_s, 4))
        return Overloaded(message, retry_after_s, tenant=tenant,
                          reason=reason)

    def try_admit(self, tenant: str, queue_depth: int) -> None:
        """Admit one request for `tenant` given the current global queue
        backlog, or raise Overloaded. Order matters: the global watermark
        is checked FIRST so a full gateway never charges a tenant's bucket
        for a request it cannot queue."""
        cfg = self.tenants.get(tenant)
        if cfg is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        if queue_depth >= self.max_queue_depth:
            raise self._shed(
                tenant, "queue_full", DEFAULT_RETRY_AFTER_S,
                f"gateway queue full ({queue_depth} >= "
                f"{self.max_queue_depth})")
        with self._lock:
            if self._inflight[tenant] >= cfg.max_concurrency:
                raise self._shed(
                    tenant, "concurrency", DEFAULT_RETRY_AFTER_S,
                    f"tenant {tenant}: {self._inflight[tenant]} requests "
                    f"in flight >= max_concurrency {cfg.max_concurrency}")
            bucket = self._buckets[tenant]
            if not bucket.try_take(1.0):
                raise self._shed(
                    tenant, "rate", max(bucket.time_until(1.0), 1e-3),
                    f"tenant {tenant}: rate limit ({cfg.rate}/s, burst "
                    f"{cfg.burst}) exceeded")
            self._inflight[tenant] += 1

    def release(self, tenant: str) -> None:
        with self._lock:
            if self._inflight.get(tenant, 0) > 0:
                self._inflight[tenant] -= 1

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)


def parse_tenants_config(
        obj: Dict[str, Any]) -> Tuple[Dict[str, TenantConfig], int, int]:
    """Parse the ``--tenants`` JSON into (tenants, max_queue_depth,
    max_active). Two accepted shapes:

      {"tenants": {"gold": {"weight": 4, "rate": 20, "burst": 40,
                            "max_concurrency": 8}, ...},
       "max_queue_depth": 64, "max_active": 8}

    or the flat form — just the inner tenant mapping — with the global
    knobs defaulted."""
    if "tenants" in obj and isinstance(obj["tenants"], dict):
        raw = obj["tenants"]
        max_queue_depth = int(obj.get("max_queue_depth", 64))
        max_active = int(obj.get("max_active", 8))
    else:
        raw, max_queue_depth, max_active = obj, 64, 8
    if not raw:
        raise ValueError("tenants config is empty")
    tenants = {}
    for name, spec in raw.items():
        spec = spec or {}
        tenants[name] = TenantConfig(
            name=name,
            weight=float(spec.get("weight", 1.0)),
            rate=float(spec.get("rate", 50.0)),
            burst=float(spec.get("burst", 100.0)),
            max_concurrency=int(spec.get("max_concurrency", 64)),
            slo_ttft_s=(float(spec["slo_ttft_s"])
                        if spec.get("slo_ttft_s") is not None else None),
            slo_token_s=(float(spec["slo_token_s"])
                         if spec.get("slo_token_s") is not None else None),
            slo_target=float(spec.get("slo_target", 0.99)),
        )
    return tenants, max_queue_depth, max_active
