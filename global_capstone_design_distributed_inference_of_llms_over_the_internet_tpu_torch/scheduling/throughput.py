"""Server throughput self-measurement — the scalar each server gossips.

Behavior-parity port of the reference's two-tier scheme:

  * compute term (``src/throughput_measurement.py:15-154``): time a dummy
    batch-1 seq-1 forward, 2 warmup + 10 timed steps, report requests/sec,
    surviving per-step failures;
  * network term (``src/throughput_measurement.py:157-190``): requests/sec a
    link can carry = bandwidth / per-request payload (one fp16 hidden-state
    tensor), default 100 Mbps when unmeasured;
  * combination (``:193-263``): final = min(compute, network × (1 − relay
    penalty 0.2)), falling back to network-only and finally a 10.0 rps
    constant so a server can always advertise something;
  * persistent JSON cache keyed by (model, device, dtype) with an
    expected-blocks-per-request correction, from the vendored full version
    (``petals/server/throughput.py:65-100``).

On TPU the compute probe times the jitted stage step (compile excluded by the
warmup steps) and the network term models the DCN/ICI hop instead of a WAN
speedtest — the reference's speedtest-cli dependency is deliberately dropped
(SURVEY.md §7.4).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

DEFAULT_BANDWIDTH_MBPS = 100.0   # src/throughput_measurement.py:180-183
RELAY_PENALTY = 0.2              # src/throughput_measurement.py:237-250
FALLBACK_RPS = 10.0              # src/throughput_measurement.py:253-255
WARMUP_STEPS = 2
TIMED_STEPS = 10


def measure_compute_rps(
    step: Callable[[], object],
    warmup_steps: int = WARMUP_STEPS,
    timed_steps: int = TIMED_STEPS,
) -> Optional[float]:
    """Requests/sec of `step` (a zero-arg callable running one batch-1 seq-1
    forward and blocking until done). Per-step failures are survived; returns
    None if no step succeeded (``src/throughput_measurement.py:105-132``)."""
    for _ in range(warmup_steps):
        try:
            step()
        except Exception as exc:
            logger.warning("throughput warmup step failed: %s", exc)
    total, ok = 0.0, 0
    for _ in range(timed_steps):
        try:
            t0 = time.perf_counter()
            step()
            total += time.perf_counter() - t0
            ok += 1
        except Exception as exc:
            logger.warning("throughput timed step failed: %s", exc)
    if ok == 0 or total <= 0:
        return None
    return ok / total


def estimate_network_rps(
    bandwidth_mbps: Optional[float],
    request_bytes: int,
) -> float:
    """Requests/sec the network link sustains for one hidden-state payload."""
    bw = bandwidth_mbps if bandwidth_mbps and bandwidth_mbps > 0 else DEFAULT_BANDWIDTH_MBPS
    if request_bytes <= 0:
        return FALLBACK_RPS
    return (bw * 1e6 / 8.0) / request_bytes


def hidden_request_bytes(hidden_size: int, seq_len: int = 1, batch: int = 1,
                         bytes_per_elem: int = 2) -> int:
    """Per-request wire payload: one fp16/bf16 hidden tensor [B, T, D]."""
    return batch * seq_len * hidden_size * bytes_per_elem


def get_server_throughput(
    step: Optional[Callable[[], object]],
    hidden_size: int,
    *,
    bandwidth_mbps: Optional[float] = None,
    use_relay: bool = False,
    num_blocks: int = 1,
    cache_path: Optional[str] = None,
    cache_key: Optional[str] = None,
) -> float:
    """The advertised scalar: min(compute, network·(1−relay_penalty)).

    `num_blocks` applies the vendored expected-blocks-per-request correction
    ``(num_blocks + 1) / 2`` (``petals/server/throughput.py:96-100``): a
    client chain rarely uses every block a server holds.
    """
    if cache_path and cache_key:
        try:
            with open(cache_path) as f:
                cached = json.load(f)
            if cache_key in cached:
                return float(cached[cache_key])
        except (OSError, ValueError):
            pass

    compute_rps = None
    if step is not None:
        try:
            compute_rps = measure_compute_rps(step)
        except Exception as exc:
            logger.warning("compute throughput probe failed entirely: %s", exc)
    if compute_rps is not None and num_blocks > 1:
        compute_rps = compute_rps * 2.0 / (num_blocks + 1)

    network_rps = estimate_network_rps(
        bandwidth_mbps, hidden_request_bytes(hidden_size)
    )
    if use_relay:
        network_rps *= 1.0 - RELAY_PENALTY

    # Fallback chain: min(compute, network) -> network-only when the compute
    # probe failed. estimate_network_rps itself bottoms out at FALLBACK_RPS
    # (degenerate payload size), so a server can always advertise something.
    result = min(compute_rps, network_rps) if compute_rps is not None else network_rps

    if cache_path and cache_key:
        try:
            cached = {}
            if os.path.exists(cache_path):
                with open(cache_path) as f:
                    cached = json.load(f)
            cached[cache_key] = result
            tmp = cache_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cached, f)
            os.replace(tmp, cache_path)
        except OSError as exc:
            logger.warning("could not persist throughput cache: %s", exc)
    return result
