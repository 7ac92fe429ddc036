"""Prometheus text exposition (format version 0.0.4) for MetricsRegistry.

Pure string rendering — this is what the ``metrics`` wire verb returns and
what ``--mode metrics`` prints, so an operator can point any Prometheus-
compatible scraper (or `curl | grep`) at a swarm without the runtime growing
a client-library dependency.
"""

from __future__ import annotations

from typing import Dict, Optional

from .metrics import COUNTER, GAUGE, HISTOGRAM, MetricsRegistry


def _fmt_value(v: float) -> str:
    """Prometheus-friendly number: integers without a trailing .0, floats via
    repr (shortest round-trip), infinities spelled +Inf/-Inf."""
    if v != v:                       # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(pairs, extra: Optional[Dict[str, str]] = None) -> str:
    items = list(pairs)
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in items
    )
    return "{" + body + "}"


def render(registry: MetricsRegistry) -> str:
    """Full exposition: every family, every child, deterministic order."""
    lines = []
    for fam, children in registry.collect():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if not children and not fam.label_names:
            # Unlabeled family that was declared but never fetched: the
            # registry materializes the child lazily — fetch it now so the
            # family still exposes a zero sample.
            children = (registry.get(fam.name),)
        for m in children:
            if fam.kind in (COUNTER, GAUGE):
                lines.append(
                    f"{fam.name}{_fmt_labels(m.labels)} "
                    f"{_fmt_value(m.value)}"
                )
            elif fam.kind == HISTOGRAM:
                cum = m.bucket_counts()
                for bound, c in zip(m.buckets, cum[:-1]):
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(m.labels, {'le': _fmt_value(bound)})} "
                        f"{c}"
                    )
                lines.append(
                    f"{fam.name}_bucket"
                    f"{_fmt_labels(m.labels, {'le': '+Inf'})} {cum[-1]}"
                )
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(m.labels)} "
                    f"{_fmt_value(m.sum)}"
                )
                lines.append(
                    f"{fam.name}_count{_fmt_labels(m.labels)} {m.count}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def _hist_family_stats(registry: MetricsRegistry, name: str):
    """(count, sum, p50, p95) aggregated over every child of a histogram
    family, or zeros when absent/empty."""
    fam = None
    for f in registry.families():
        if f.name == name:
            fam = f
            break
    if fam is None:
        return 0, 0.0, None, None
    with fam._lock:
        children = tuple(fam._children.values())
    if not children:
        return 0, 0.0, None, None
    count = sum(c.count for c in children)
    total = sum(c.sum for c in children)
    # Quantiles over the merged bucket counts (children share bucket edges).
    best = max(children, key=lambda c: c.count)
    if count == 0:
        return 0, 0.0, None, None
    if len(children) == 1:
        return count, total, children[0].quantile(0.5), children[0].quantile(0.95)
    merged = [0] * (len(best.buckets) + 1)
    for c in children:
        with c._lock:
            for i, n in enumerate(c._counts):
                merged[i] += n
    from .metrics import Histogram
    import threading as _th
    agg = Histogram(name, (), registry._enabled, _th.Lock(), best.buckets)
    agg._counts = merged
    agg._count = count
    agg._sum = total
    return count, total, agg.quantile(0.5), agg.quantile(0.95)


def summary(registry: MetricsRegistry) -> Dict[str, object]:
    """Compact per-server aggregate for the heartbeat/info frame: steps/s,
    p50/p95 step latency (ms), cache hit rate. Cheap enough to compute on
    every ``info`` round trip."""
    count, _total, p50, p95 = _hist_family_stats(
        registry, "server_step_latency_seconds")
    uptime = max(registry.uptime_s(), 1e-9)

    def _val(name: str) -> float:
        m = registry.get(name)
        if m is None or not hasattr(m, "value"):
            return 0.0
        return float(m.value)

    hits = _val("server_prefix_cache_hits_total")
    misses = _val("server_prefix_cache_misses_total")
    lookups = hits + misses
    return {
        "steps_total": count,
        "steps_per_s": round(count / uptime, 3),
        "step_p50_ms": None if p50 is None else round(p50 * 1e3, 3),
        "step_p95_ms": None if p95 is None else round(p95 * 1e3, 3),
        "cache_hit_rate": None if lookups == 0 else round(hits / lookups, 4),
    }
