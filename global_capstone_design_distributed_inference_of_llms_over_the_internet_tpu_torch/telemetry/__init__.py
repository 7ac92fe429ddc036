"""Swarm telemetry: metrics registry, request tracing, Prometheus exposition.

Dependency-free (no prometheus_client, no opentelemetry — the container does
not grow packages). Three layers:

  * `metrics`   — counters / gauges / fixed-bucket histograms in a thread-safe
                  registry; strict no-op when disabled.
  * `tracing`   — Dapper-style spans carried through the stage wire protocol.
  * `exposition`— Prometheus text rendering + the compact per-server summary
                  the ``info``/``status`` path embeds.
  * `events`    — the flight recorder: a bounded ring of structured events
                  (failover, replay, rebalance, evictions, …) dumped to JSONL
                  on crash/signal/demand.
  * `doctor`    — post-mortem analysis of those dumps (``--mode doctor``).
  * `logging`   — the structured stdlib-logging formatter (text or
                  ``--log-json``) carrying the same trace/session fields.

The process-global registry and tracer start DISABLED; `enable()` (wired to
``--telemetry`` in main.py) flips both and materializes the full metric schema
so a scrape always shows every family.

Components that must meter regardless of the global flag (PipelineClient —
its `recoveries` counter is load-bearing API) own a private always-enabled
`MetricsRegistry` instead.
"""

from .catalog import SPEC, all_names, get, register_all
from .events import (
    EVENTS,
    EventRecorder,
    all_event_names,
    emit,
    get_recorder,
    install_crash_hooks,
    load_dump,
)
from .exposition import render, summary
from .logging import (
    StructuredFormatter,
    clear_log_context,
    log_context,
    set_log_context,
    setup_logging,
)
from .metrics import (
    COUNTER,
    DEFAULT_LATENCY_BUCKETS,
    GAUGE,
    HISTOGRAM,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from .profiling import (
    DIGEST_FIELDS,
    PHASES,
    PhaseProfiler,
    disable_phase_profiling,
    enable_phase_profiling,
    get_profiler,
    stats_digest,
)
from .tracing import NOOP_SPAN, Span, Tracer, get_tracer, new_id, reconstruct


def enabled() -> bool:
    return get_registry().enabled


def enable() -> None:
    """Turn on process-wide telemetry: metrics + tracing + flight recorder,
    full schema."""
    get_registry().enable()
    get_tracer().set_enabled(True)
    get_recorder().enable()
    register_all(get_registry())


def disable() -> None:
    get_registry().disable()
    get_tracer().set_enabled(False)
    get_recorder().disable()


__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM", "DEFAULT_LATENCY_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "NOOP_SPAN", "Span", "Tracer", "get_tracer", "new_id", "reconstruct",
    "SPEC", "all_names", "get", "register_all",
    "EVENTS", "EventRecorder", "all_event_names", "emit", "get_recorder",
    "install_crash_hooks", "load_dump",
    "StructuredFormatter", "setup_logging", "set_log_context",
    "clear_log_context", "log_context",
    "render", "summary",
    "DIGEST_FIELDS", "PHASES", "PhaseProfiler", "get_profiler",
    "enable_phase_profiling", "disable_phase_profiling", "stats_digest",
    "enable", "disable", "enabled",
]
