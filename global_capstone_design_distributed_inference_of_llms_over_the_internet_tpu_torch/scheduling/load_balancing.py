"""Load balancing: span placement over the block axis (Petals Appendix D).

Behavior-parity port of BOTH objective variants the reference carries
(deliberately divergent — see the comparison at ``src/load_balancing.py:181-195``):

  * ``objective="weakest"`` — the mini-Petals variant
    (``src/load_balancing.py:175-209``): place the span over the window that
    minimizes (window min, window mean, start index) — fill the most
    bottlenecked segment first. Supports a ``min_block`` floor protecting the
    client-local layer prefix (``src/main.py:338-339``).
  * ``objective="minmax"`` — the upstream Petals variant
    (``petals/server/block_selection.py:23-25``): lexicographic comparison of
    the SORTED window throughputs (classic min-max placement).

Rule 1 (`choose_best_blocks`) picks a joining server's span; rule 2
(`should_choose_other_blocks`) periodically simulates "what if I moved, and
everyone then relaxed?" and triggers a re-span when the swarm's bottleneck
throughput would improve by more than ``1/balance_quality``.

Race-avoidance details preserved (SURVEY.md §5.2): deterministic peer
ordering before accumulation (float-sum order stability), the ``(1 + eps)``
self-removal that biases ties toward the current position, the disjoint-
pipeline guard, and the quality eps-guard against rebalance oscillation.
The relaxation loop is capped at 10 iterations for "weakest"
(``src/load_balancing.py:339-355``) and unbounded for "minmax"
(``petals/server/block_selection.py:70-86`` runs ``while moved``) — capped
here too by a large safety bound so a pathological cycle cannot hang a
server's rebalance thread.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .registry import ServerRecord, ServerState

EPS = 1e-3

WEAKEST = "weakest"
MINMAX = "minmax"

_MAX_RELAX_ITERS = {WEAKEST: 10, MINMAX: 1000}


@dataclasses.dataclass
class Span:
    """One server's contiguous block span (RemoteSpanInfo analogue)."""

    peer_id: str
    start: int
    end: int
    throughput: float

    @property
    def length(self) -> int:
        return self.end - self.start

    def move_to(self, new_start: int) -> None:
        self.start, self.end = new_start, new_start + self.length


def spans_from_records(records: Sequence[ServerRecord],
                       include_states: Sequence[str] = (
                           ServerState.JOINING, ServerState.ONLINE,
                       )) -> Dict[str, Span]:
    """Build the per-peer span map from registry records.

    The reference reconstructs spans from per-block DHT records
    (``src/load_balancing.py:61-148``), including a quirk where a peer
    advertising disjoint ranges keeps only its LAST span; our registry stores
    one contiguous span per server record, so this is a direct projection —
    a peer registered twice keeps the later record (same last-wins outcome).
    """
    out: Dict[str, Span] = {}
    for r in records:
        if r.state not in include_states:
            continue
        out[r.peer_id] = Span(r.peer_id, r.start_block, r.end_block, r.throughput)
    return out


def compute_block_throughputs(spans: Dict[str, Span], total_blocks: int) -> np.ndarray:
    """Per-block summed throughput. Accumulation order is sorted by peer id so
    identical swarms always produce bit-identical floats — unordered sums
    jitter at the ULP level and cause spurious rebalances
    (``petals/server/block_selection.py:13-16``)."""
    th = np.zeros(total_blocks)
    for span in sorted(spans.values(), key=lambda s: s.peer_id):
        th[span.start:span.end] += span.throughput
    return th


def choose_best_start(
    throughputs: np.ndarray,
    num_blocks: int,
    min_block: int = 0,
    objective: str = WEAKEST,
) -> int:
    """Best start index for a span of num_blocks under the given objective."""
    n = len(throughputs)
    if n < num_blocks:
        return max(0, int(min_block))
    max_i = n - num_blocks
    lo = int(max(0, min(min_block, max_i)))
    windows = range(lo, max_i + 1)
    if objective == WEAKEST:
        return min(
            windows,
            key=lambda i: (
                float(np.min(throughputs[i:i + num_blocks])),
                float(np.mean(throughputs[i:i + num_blocks])),
                i,
            ),
        )
    if objective == MINMAX:
        return min(
            windows,
            key=lambda i: (sorted(throughputs[i:i + num_blocks].tolist()), i),
        )
    raise ValueError(f"unknown objective {objective!r}")


def choose_best_blocks(
    num_blocks: int,
    records: Sequence[ServerRecord],
    total_blocks: int,
    min_block: int = 0,
    objective: str = WEAKEST,
) -> List[int]:
    """Rule 1: a joining server picks the span that best helps the swarm."""
    spans = spans_from_records(records)
    th = compute_block_throughputs(spans, total_blocks)
    start = choose_best_start(th, num_blocks, min_block=min_block,
                              objective=objective)
    return list(range(start, start + num_blocks))


def should_choose_other_blocks(
    local_peer_id: str,
    records: Sequence[ServerRecord],
    total_blocks: int,
    balance_quality: float = 0.75,
    min_block: int = 0,
    objective: str = WEAKEST,
    rng: Optional[np.random.Generator] = None,
) -> bool:
    """Rule 2: should this server re-span? Simulates its own move plus an
    iterative relaxation of every peer, then compares bottleneck throughput.

    balance_quality > 1.0 forces True (debugging hook, both variants).
    """
    _tm.get("scheduler_rebalance_checks_total").inc()
    if balance_quality > 1.0:
        _tm.get("scheduler_rebalance_moves_total").inc()
        _ev.emit("rebalance_recommended", peer=local_peer_id,
                 quality=0.0, threshold=balance_quality)
        return True
    # Seeded default: the re-span coin flip must be reproducible across
    # soak reruns when the server wiring does not inject its own generator.
    rng = rng or np.random.default_rng(0)

    spans = spans_from_records(records)
    th = compute_block_throughputs(spans, total_blocks)

    # Bottleneck is evaluated over the SERVABLE range [min_block, total):
    # with a protected client-local prefix no server ever covers
    # [0, min_block), so the reference's full-range min is pinned at 0 and its
    # rule 2 can never fire when min_block > 0 (``src/load_balancing.py:297``
    # + ``:357-366`` — initial and new throughput both 0). Restricting the
    # window restores the rule's intent; min_block=0 reproduces the reference
    # exactly.
    lo_eval = int(max(0, min(min_block, total_blocks)))

    def bottleneck(a: np.ndarray) -> float:
        view = a[lo_eval:]
        return float(np.min(view)) if len(view) else 0.0

    initial = bottleneck(th)

    if local_peer_id not in spans:
        return False
    local = spans[local_peer_id]

    # Remove own span; (1 + eps) biases ties toward staying put.
    lo = max(0, min(local.start, total_blocks - 1))
    hi = min(local.end, total_blocks)
    if hi > lo:
        th[lo:hi] -= local.throughput * (1 + EPS)

    # Disjoint-pipeline guard: if removing us would zero out some block, a
    # move would disconnect the swarm.
    if initial > EPS and bottleneck(th) <= 0:
        return False

    new_start = choose_best_start(th, local.length, min_block=min_block,
                                  objective=objective)
    if local.start == new_start:
        return False

    th[local.start:local.end] += local.throughput * EPS
    local.move_to(new_start)
    th[local.start:local.end] += local.throughput

    moved, it = True, 0
    while moved and it < _MAX_RELAX_ITERS[objective]:
        it += 1
        order = list(spans.keys())
        rng.shuffle(order)
        moved = False
        for pid in order:
            span = spans[pid]
            th[span.start:span.end] -= span.throughput * (1 + EPS)
            cand = choose_best_start(th, span.length, min_block=min_block,
                                     objective=objective)
            th[span.start:span.end] += span.throughput * EPS
            if span.start != cand:
                span.move_to(cand)
                moved = True
            th[span.start:span.end] += span.throughput

    new = bottleneck(th)
    if new < initial or new < EPS:
        return False
    quality = initial / new
    move = quality < balance_quality - EPS
    if move:
        _tm.get("scheduler_rebalance_moves_total").inc()
        _ev.emit("rebalance_recommended", peer=local_peer_id,
                 quality=round(quality, 4), threshold=balance_quality)
    return move
