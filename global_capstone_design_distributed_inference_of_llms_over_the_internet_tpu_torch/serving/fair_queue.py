"""Weighted fairness: deficit round-robin across tenants, EDF within.

DRR (Shreedhar & Varghese) is the right primitive here because the unit of
service is cheap and uniform — one queued request to start, or one decode
step to run — and we need O(1) scheduling decisions that converge to the
configured weight ratios over any window a few rotations long. Quanta are
normalized by the SMALLEST weight so every tenant earns at least one unit
of credit per rotation visit (no starvation even at extreme ratios), and
an idle tenant's deficit is zeroed — fairness is about contended moments,
not banked credit from quiet ones.

Within a tenant the order is earliest-deadline-first using the same
``deadline_budget_s`` machinery the rest of the stack enforces: among
requests a tenant is entitled to run, the one closest to its SLO goes
first; deadline-less requests sort last (infinity) in FIFO order.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
from typing import Any, Dict, Iterable, Optional, Set, Tuple


class DeficitRoundRobin:
    """Serve-one-unit-per-call DRR over a fixed tenant set.

    ``pick(active)`` returns the tenant entitled to the next unit of
    service among ``active`` (tenants with work), or None when idle. The
    rotation pointer and deficits persist across calls, so consecutive
    picks realize the weight ratios; service within one tenant's quantum
    is consecutive (burst-per-visit, as in classic DRR)."""

    def __init__(self, weights: Dict[str, float]):
        if not weights:
            raise ValueError("DRR needs at least one tenant")
        if any(w <= 0 for w in weights.values()):
            raise ValueError("DRR weights must be > 0")
        self._order = sorted(weights)
        wmin = min(weights.values())
        self._quantum = {t: weights[t] / wmin for t in self._order}
        self._deficit = {t: 0.0 for t in self._order}
        self._idx = 0

    def pick(self, active: Set[str]) -> Optional[str]:
        active = {t for t in active if t in self._deficit}
        if not active:
            return None
        for t in self._order:
            if t not in active:
                self._deficit[t] = 0.0
        n = len(self._order)
        # Bounded: one full rotation grants every active tenant a quantum
        # >= 1, so a serve happens within 2n iterations — unless a tenant
        # was burst-charged into debt (charge(); deficit << 0), in which
        # case it needs one extra rotation per unit of debt to re-earn
        # credit before its next serve.
        debt = max(0.0, -min(self._deficit[t] for t in active))
        for _ in range((2 * n) * (int(debt) + 1) + 1):
            t = self._order[self._idx]
            if t in active and self._deficit[t] >= 1.0:
                self._deficit[t] -= 1.0
                return t
            self._idx = (self._idx + 1) % n
            t = self._order[self._idx]
            if t in active:
                self._deficit[t] += self._quantum[t]
        raise AssertionError("DRR failed to converge")  # pragma: no cover

    def charge(self, tenant: str, units: float) -> None:
        """Debit service beyond the single unit ``pick()`` already took —
        burst serving charges one pick N tokens, not 1 (each scheduler
        pick runs an N-tick burst). The deficit may go negative; the
        tenant re-earns credit across subsequent rotations, which is
        exactly how classic DRR amortizes variable packet sizes, so
        served-TOKEN ratios still converge to the weights at burst
        granularity."""
        if tenant in self._deficit and units > 0:
            self._deficit[tenant] -= float(units)


class FairQueue:
    """Thread-safe tenant-fair queue: DRR picks the tenant, EDF picks the
    request. ``push`` never blocks (admission already bounded depth);
    ``pop`` blocks up to ``timeout`` for work."""

    def __init__(self, weights: Dict[str, float]):
        self._drr = DeficitRoundRobin(weights)
        # (deadline_at or +inf, submission seq, item): EDF with FIFO ties.
        self._heaps: Dict[str, list] = {t: [] for t in weights}
        self._seq = itertools.count()
        self._cond = threading.Condition()

    def push(self, tenant: str, item: Any,
             deadline_at: Optional[float] = None) -> int:
        """Enqueue; returns the total depth AFTER the push."""
        key = math.inf if deadline_at is None else float(deadline_at)
        with self._cond:
            if tenant not in self._heaps:
                raise KeyError(f"unknown tenant {tenant!r}")
            heapq.heappush(self._heaps[tenant], (key, next(self._seq), item))
            self._cond.notify()
            return sum(len(h) for h in self._heaps.values())

    def _pop_locked(self) -> Optional[Tuple[str, Any]]:
        active = {t for t, h in self._heaps.items() if h}
        tenant = self._drr.pick(active)
        if tenant is None:
            return None
        _, _, item = heapq.heappop(self._heaps[tenant])
        return tenant, item

    def try_pop(self) -> Optional[Tuple[str, Any]]:
        with self._cond:
            return self._pop_locked()

    def pop(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[str, Any]]:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: any(self._heaps.values()), timeout):
                return None
            return self._pop_locked()

    def depth(self) -> int:
        with self._cond:
            return sum(len(h) for h in self._heaps.values())

    def depths(self) -> Dict[str, int]:
        with self._cond:
            return {t: len(h) for t, h in self._heaps.items()}

    def drain(self) -> Iterable[Tuple[str, Any]]:
        """Remove and return everything queued (shutdown path)."""
        out = []
        with self._cond:
            for t, h in self._heaps.items():
                out.extend((t, item) for _, _, item in h)
                h.clear()
        return out
