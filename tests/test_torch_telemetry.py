"""Telemetry in the port: the copied package, its unit behaviour, and the
served path's signals held to the JAX package's.

  * each of the 9 files of the port's ``telemetry/`` is byte-equal to the
    JAX package's (the package is framework-free; the port keeps its own
    copy because it imports nothing of the JAX package);
  * the reference's network-free unit tests (tests/test_telemetry.py,
    tests/test_events.py, tests/test_profiling.py) run against the port's
    copy, the profiled and traced pipeline ones through the port's cluster;
  * parity: the same weights and prompt through the JAX cluster
    (tests/test_runtime_pipeline.py ``build_cluster``) and the port's, with
    both packages' telemetry on, give equal counters per label set, equal
    histogram counts, the same event sequence (time and id fields aside)
    and the same span trees (names, kinds, parent links, phase); the KV
    arena's failure and eviction counters and events equal the JAX arena's;
  * trace propagation over two remote hops of the port's pipeline.

Timings are never compared. A series one package never touched counts as
zero: the JAX client holds handles of the deadline and route-cache
families, whose code is not ported, and its transport one of the ping
histogram; all three stay at zero on this path.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import threading

import jax
import pytest

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    one_torch_thread,
    port_cfg,
)
from test_runtime_pipeline import build_cluster, tiny_cfg

from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    telemetry as jtelemetry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSampling,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    telemetry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    PHASES,
    EventRecorder,
    MetricsRegistry,
    Tracer,
    all_event_names,
    catalog,
    doctor,
    events,
    exposition,
    get_tracer,
    load_dump,
    reconstruct,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry.profiling import (
    DIGEST_FIELDS,
    PhaseProfiler,
    disable_phase_profiling,
    enable_phase_profiling,
    get_profiler,
    stats_digest,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu"
PORT_PKG = JAX_PKG + "_torch"
TELEMETRY_FILES = ("__init__.py", "catalog.py", "doctor.py", "events.py",
                   "exposition.py", "logging.py", "metrics.py", "profiling.py",
                   "tracing.py")
PROMPT = [5, 9, 23, 7, 81]
# Event fields that carry a duration: measured, so never compared.
TIME_FIELDS = {"seconds", "wait_s"}


@pytest.fixture(scope="module")
def weights():
    """tests/test_runtime_pipeline.py's tiny config and weights, and the
    same bridged to the port."""
    jcfg = tiny_cfg()
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), bridged(jparams)


def _port_client(weights, splits="3,6"):
    _, _, tcfg, tparams = weights
    return build_port_cluster(tcfg, tparams, splits)[0]


# -- the copy -----------------------------------------------------------------

def test_telemetry_package_has_exactly_the_copied_files():
    assert sorted(p.name for p in (REPO / PORT_PKG / "telemetry").glob("*.py")) == \
        sorted(p.name for p in (REPO / JAX_PKG / "telemetry").glob("*.py")) == \
        sorted(TELEMETRY_FILES)


@pytest.mark.parametrize("name", TELEMETRY_FILES)
def test_telemetry_file_is_byte_equal_to_the_original(name):
    assert (REPO / PORT_PKG / "telemetry" / name).read_bytes() == \
        (REPO / JAX_PKG / "telemetry" / name).read_bytes()


@pytest.mark.parametrize("table", ["metrics", "events", "phases", "digest"])
def test_every_catalogued_name_is_documented(table):
    """The port's catalogs are documented once, in docs/OBSERVABILITY.md
    (the port's side of tests/test_metrics_documented.py)."""
    names = {"metrics": catalog.all_names(), "events": all_event_names(),
             "phases": PHASES, "digest": DIGEST_FIELDS}[table]
    doc = (REPO / "docs" / "OBSERVABILITY.md").read_text(encoding="utf-8")
    assert names
    assert [n for n in names if f"`{n}`" not in doc] == []


# -- metrics (tests/test_telemetry.py:39-162) ---------------------------------

def test_histogram_bucket_edges():
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("lat", "", buckets=(1.0, 2.0, 5.0))
    # le is inclusive (Prometheus cumulative semantics).
    for v in (0.5, 1.0, 1.5, 2.0, 5.0, 7.0):
        h.observe(v)
    assert h.bucket_counts() == [2, 4, 5, 6]
    assert h.count == 6
    assert abs(h.sum - 17.0) < 1e-9


def test_histogram_quantiles():
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("lat", "", buckets=(1.0, 2.0, 4.0))
    assert h.quantile(0.5) is None
    for _ in range(10):
        h.observe(1.5)
    q = h.quantile(0.5)
    assert 1.0 < q <= 2.0
    assert h.quantile(1.0) == 2.0
    h.observe(100.0)                           # +Inf clamps to the last bound
    assert h.quantile(1.0) == 4.0


def test_disabled_registry_is_noop():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("c", "")
    g = reg.gauge("g", "")
    h = reg.histogram("h", "", buckets=(1.0,))
    c.inc(5)
    g.set(3)
    h.observe(0.5)
    assert c.value == 0.0 and g.value == 0.0 and h.count == 0
    reg.enable()
    c.inc(5)
    assert c.value == 5.0                      # same handle, flag flipped


def test_counter_gauge_histogram_concurrency():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("reqs_total", "", labels=("k",)).labels(k="x")
    g = reg.gauge("occ", "")
    h = reg.histogram("lat", "", buckets=(0.5, 1.0))
    n_threads, n_iters = 8, 2000

    def work():
        for _ in range(n_iters):
            c.inc()
            g.inc(2.0)
            g.dec(1.0)
            h.observe(0.7)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = n_threads * n_iters
    assert c.value == float(total)
    assert abs(g.value - total) < 1e-6
    assert h.count == total
    assert h.bucket_counts() == [0, total, total]


def test_exposition_golden_output():
    reg = MetricsRegistry(enabled=True)
    reg.counter("requests_total", "Requests.",
                labels=("outcome",)).labels(outcome="ok").inc(2)
    reg.gauge("occupancy", "Occupancy.").set(0.5)
    h = reg.histogram("lat_seconds", "Latency.", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert exposition.render(reg) == (
        "# HELP lat_seconds Latency.\n"
        "# TYPE lat_seconds histogram\n"
        'lat_seconds_bucket{le="0.1"} 1\n'
        'lat_seconds_bucket{le="1"} 2\n'
        'lat_seconds_bucket{le="+Inf"} 3\n'
        "lat_seconds_sum 5.55\n"
        "lat_seconds_count 3\n"
        "# HELP occupancy Occupancy.\n"
        "# TYPE occupancy gauge\n"
        "occupancy 0.5\n"
        "# HELP requests_total Requests.\n"
        "# TYPE requests_total counter\n"
        'requests_total{outcome="ok"} 2\n'
    )


def test_register_all_exposes_required_families():
    reg = MetricsRegistry(enabled=True)
    catalog.register_all(reg)
    text = exposition.render(reg)
    for name in ("server_step_latency_seconds", "server_tokens_total",
                 "server_kv_occupancy_ratio", "server_prefix_cache_hits_total",
                 "client_retries_total"):
        assert f"# TYPE {name} " in text
    for name in catalog.all_names():
        assert f"# HELP {name} " in text


def test_summary_aggregate():
    reg = MetricsRegistry(enabled=True)
    step = catalog.get("server_step_latency_seconds", reg)
    for _ in range(10):
        step.labels(phase="decode").observe(0.004)
    catalog.get("server_prefix_cache_hits_total", reg).inc(3)
    catalog.get("server_prefix_cache_misses_total", reg).inc(1)
    s = exposition.summary(reg)
    assert s["steps_total"] == 10
    assert s["steps_per_s"] > 0
    assert 1.0 <= s["step_p50_ms"] <= 10.0
    assert s["cache_hit_rate"] == 0.75


# -- tracing (tests/test_telemetry.py:164-190) --------------------------------

def test_wire_context_roundtrip():
    tr = Tracer(enabled=True)
    root = tr.start_span("pipeline_step", kind="client")
    ctx = root.wire_context(hop=2)
    assert set(ctx) == {"trace_id", "parent", "hop"}
    assert ctx["trace_id"] == root.trace_id
    assert ctx["parent"] == root.span_id
    assert ctx["hop"] == 2
    srv = tr.span_from_wire(ctx, "server_forward", kind="server")
    assert srv.trace_id == root.trace_id
    assert srv.parent_id == root.span_id
    srv.end()
    root.end()
    wire = srv.to_wire()
    assert wire["trace_id"] == root.trace_id
    assert wire["start_s"] <= wire["end_s"]


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    s = tr.start_span("x")
    assert not s
    assert s.wire_context(0) is None and s.to_wire() is None
    assert tr.span_from_wire({"trace_id": "t", "parent": "p", "hop": 0},
                             "y") is not None
    assert tr.spans() == ()


def test_trace_propagation_two_stage_pipeline(weights):
    """Each step through the port's 2-remote-hop pipeline is one trace: a
    client root, a client span per hop and a server span per hop
    (LocalTransport, at the serving boundary), the server's window inside
    its client hop's, and each hop carrying its server's wire span."""
    telemetry.enable()
    tracer = get_tracer()
    tracer.clear()
    try:
        _port_client(weights).generate(PROMPT, max_new_tokens=3,
                                       sampling=SamplingParams(temperature=0.0))
        traces = reconstruct(tracer.spans())
        decode_traces, prefill_traces = [], []
        for spans in traces.values():
            roots = [s for s in spans if s.name == "pipeline_step"]
            assert len(roots) == 1, "one root span per pipeline step"
            (decode_traces if roots[0].attrs.get("phase") == "decode"
             else prefill_traces).append((roots[0], spans))
        assert len(prefill_traces) == 1
        assert len(decode_traces) == 2
        assert any(s.name == "hop:stage0" for s in prefill_traces[0][1])
        for root, spans in decode_traces:
            hops = {s.name: s for s in spans
                    if s.kind == "client" and s.name.startswith("hop:")}
            servers = [s for s in spans if s.name == "server_forward"]
            assert set(hops) == {"hop:stage1", "hop:stage2"}
            assert len(servers) == 2
            for s in spans:
                assert s.end_s is not None and s.end_s >= s.start_s
                if s is not root:
                    assert s.parent_id == root.span_id
            by_peer = {s.attrs.get("peer"): s for s in servers}
            for hop in hops.values():
                srv = by_peer[hop.attrs["peer"]]
                assert hop.start_s <= srv.start_s and srv.end_s <= hop.end_s
                assert hop.attrs["server"]["span_id"] == srv.span_id
                assert srv.attrs["cache_len"] == len(PROMPT) + root.attrs["step"]
    finally:
        telemetry.disable()
        tracer.clear()


# -- flight recorder (tests/test_events.py:52-208) ----------------------------

def test_catalog_rejects_unknown_event_names():
    rec = EventRecorder(enabled=True)
    with pytest.raises(KeyError):
        rec.emit("not_a_real_event")
    off = EventRecorder(enabled=False)
    off.emit("not_a_real_event")               # disabled: no catalog lookup
    assert len(off) == 0


def test_disabled_recorder_records_nothing():
    rec = EventRecorder(enabled=False)
    rec.emit("hop_retry", hop="stage1", attempt=1)
    assert len(rec) == 0
    rec.enable()
    rec.emit("hop_retry", hop="stage1", attempt=1)
    assert len(rec) == 1


def test_ring_overflow_keeps_newest_and_counts_drops():
    rec = EventRecorder(capacity=4, enabled=True)
    for i in range(6):
        rec.emit("hop_retry", hop="stage1", attempt=i)
    assert len(rec) == 4
    assert rec.dropped == 2
    assert [e.fields["attempt"] for e in rec.events()] == [2, 3, 4, 5]
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0


def test_severity_override_and_validation():
    rec = EventRecorder(enabled=True)
    rec.emit("hop_retry", hop="stage1", severity="error")
    assert rec.events()[0].severity == "error"
    with pytest.raises(ValueError):
        rec.emit("hop_retry", hop="stage1", severity="screaming")


def test_dump_roundtrip_and_truncated_tail(tmp_path):
    rec = EventRecorder(enabled=True)
    rec.emit("session_start", session_id="s1", trace_id="t1",
             kind="greedy", prompt_len=5)
    rec.emit("failover", session_id="s1", hop="stage1",
             old_peer="a", new_peer="b")
    path = tmp_path / "ev.jsonl"
    rec.dump(str(path))
    d = load_dump(str(path))
    assert d["meta"]["pid"] == os.getpid()
    assert d["meta"]["capacity"] == rec.capacity
    assert d["metrics"] is None                # the port's global registry is off
    assert [e["event"] for e in d["events"]] == ["session_start", "failover"]
    first = d["events"][0]
    assert first["session"] == "s1" and first["trace"] == "t1"
    assert first["sub"] == "client" and first["sev"] == "info"
    assert first["fields"] == {"kind": "greedy", "prompt_len": 5}
    path.write_text(path.read_text(encoding="utf-8") + '{"event": "hop_re',
                    encoding="utf-8")
    d2 = load_dump(str(path))
    assert [e["event"] for e in d2["events"]] == ["session_start", "failover"]


def test_dump_embeds_metrics_snapshot(tmp_path):
    reg = MetricsRegistry(enabled=True)
    reg.counter("client_retries_total", "Retries.").inc(2)
    rec = EventRecorder(enabled=True)
    rec.emit("hop_retry", hop="stage1", attempt=1)
    path = tmp_path / "ev.jsonl"
    rec.dump(str(path), registry=reg)
    d = load_dump(str(path))
    assert d["metrics"] is not None
    assert "client_retries_total 2" in d["metrics"]["exposition"]
    assert any("client_retries_total=2" in a for a in doctor.anomalies([d]))


_CHILD_FATAL = textwrap.dedent(f"""
    import sys
    from {PORT_PKG}.telemetry import events
    events.get_recorder().enable()
    events.install_crash_hooks(sys.argv[1])
    events.emit("process_start", mode="serve", pid=0)
    events.emit("hop_retry", hop="stage1", attempt=1)
    raise ValueError("boom in the serving loop")
""")


def test_fatal_exception_leaves_parseable_dump(tmp_path):
    dump = tmp_path / "crash.jsonl"
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_FATAL, str(dump)],
        cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "boom in the serving loop" in proc.stderr
    d = load_dump(str(dump))
    names = [e["event"] for e in d["events"]]
    assert names[0] == "process_start"
    assert names[-1] == "fatal_exception"
    last = d["events"][-1]
    assert last["fields"]["type"] == "ValueError"
    assert "boom in the serving loop" in last["fields"]["message"]
    assert "ValueError" in last["fields"]["trace_tail"]


_CHILD_SIGNAL = textwrap.dedent(f"""
    import sys, time
    from {PORT_PKG}.telemetry import events
    events.get_recorder().enable()
    events.install_crash_hooks(sys.argv[1])
    events.emit("process_start", mode="serve", pid=0)
    print("ready", flush=True)
    while True:
        time.sleep(0.05)
""")


def test_sigterm_dumps_then_terminates_with_signal_exit(tmp_path):
    dump = tmp_path / "sig.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD_SIGNAL, str(dump)],
        cwd=str(REPO), stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        proc.kill()
        proc.stdout.close()
    assert rc == -signal.SIGTERM
    d = load_dump(str(dump))
    names = [e["event"] for e in d["events"]]
    assert names[0] == "process_start"
    assert names[-1] == "signal_dump"
    assert d["events"][-1]["fields"]["signal"] == "SIGTERM"


def test_install_crash_hooks_uninstall_restores_hooks(tmp_path):
    prev = sys.excepthook
    uninstall = events.install_crash_hooks(str(tmp_path / "x.jsonl"))
    assert sys.excepthook is not prev
    uninstall()
    assert sys.excepthook is prev


# -- doctor units (tests/test_events.py:284-359) ------------------------------

def _mk(name, wall, **kw):
    ev = {"event": name, "wall": wall, "ts": wall}
    for k in ("session", "trace", "fields"):
        if k in kw:
            ev[k] = kw.pop(k)
    assert not kw
    return ev


def test_merge_timeline_orders_across_processes():
    streams = [
        {"meta": {"pid": 1}, "metrics": None,
         "events": [_mk("failover", 10.0), _mk("session_start", 2.0)]},
        {"meta": {"pid": 2}, "metrics": None,
         "events": [_mk("hop_retry", 5.0)]},
    ]
    tl = doctor.merge_timeline(streams)
    assert [(e["event"], e["_src"]) for e in tl] == [
        ("session_start", "pid1"), ("hop_retry", "pid2"), ("failover", "pid1")]


def test_failure_chains_collapse_repeats_and_split_on_gaps():
    tl = [
        _mk("transport_timeout", 1.0, session="s", fields={"peer": "p1"}),
        _mk("hop_retry", 1.1, session="s", fields={"hop": "stage1", "attempt": 1}),
        _mk("hop_retry", 1.2, session="s", fields={"hop": "stage1", "attempt": 1}),
        _mk("failover", 1.3, session="s",
            fields={"hop": "stage1", "old_peer": "p1", "new_peer": "p2"}),
        _mk("transport_timeout", 101.0, session="s", fields={"peer": "p2"}),
    ]
    chains = doctor.failure_chains(tl)
    assert len(chains) == 2
    assert chains[0]["chain"] == (
        "p1 timeout -> retry stage1 attempt 1 (x2) "
        "-> failover stage1: p1 -> p2")
    assert chains[1]["chain"] == "p2 timeout"


def test_failure_chains_cover_faults_breaker_and_deadline():
    tl = [
        _mk("fault_injected", 1.0, session="s",
            fields={"kind": "reset_mid_frame", "peer": "p1", "site": "send"}),
        _mk("hop_retry", 1.1, session="s", fields={"hop": "stage1", "attempt": 1}),
        _mk("breaker_open", 1.2, session="s", fields={"peer": "p1", "backoff_s": 0.5}),
        _mk("breaker_half_open", 1.9, session="s", fields={"peer": "p1"}),
        _mk("breaker_close", 2.0, session="s", fields={"peer": "p1"}),
        _mk("deadline_rejected", 102.0, session="t",
            fields={"peer": "p2", "budget_s": -0.1}),
        _mk("deadline_expired", 102.1, session="t", fields={"over_s": 0.2}),
    ]
    chains = doctor.failure_chains(tl)
    assert len(chains) == 2
    assert chains[0]["sessions"] == {"s"}
    assert chains[0]["chain"] == (
        "injected reset_mid_frame at p1 -> retry stage1 attempt 1 "
        "-> breaker OPEN on p1 (backoff 0.5s) "
        "-> breaker half-open probe of p1 -> breaker closed on p1")
    assert chains[1]["sessions"] == {"t"}
    assert "rejected expired deadline" in chains[1]["chain"]
    assert "deadline expired client-side" in chains[1]["chain"]


def test_replay_costs_sum_per_session():
    tl = [
        _mk("replay_done", 1.0, session="a", fields={"tokens": 100}),
        _mk("replay_done", 2.0, session="a", fields={"tokens": 50}),
        _mk("replay_done", 3.0, session="b", fields={"tokens": 7}),
    ]
    assert doctor.replay_costs(tl) == {"a": 150, "b": 7}


# -- phase profiler and critical path (tests/test_profiling.py:73-236) --------

def test_profiler_default_off_is_shared_noop():
    p = PhaseProfiler(enabled=False)
    b1, b2 = p.phase("dispatch"), p.phase("device")
    assert b1 is b2                        # one shared bracket, no allocation
    with b1:
        pass
    p.observe("dispatch", 1.0)
    p.device_interval(0.0, 1.0)
    assert p.snapshot() == {}
    assert p.bubble_fraction() == 0.0
    assert get_profiler().enabled is False


def test_phase_attribution_sums_to_wall():
    reg = MetricsRegistry(enabled=True)
    p = PhaseProfiler(enabled=True, registry=reg)
    wall = 0.0
    for name, dur in (("gateway_queue", 0.004), ("burst_build", 0.002),
                      ("dispatch", 0.001), ("device", 0.010),
                      ("readback", 0.003)):
        p.observe(name, dur)
        wall += dur
    snap = p.snapshot()
    assert sum(st["total_s"] for st in snap.values()) == pytest.approx(wall)
    assert snap["device"]["count"] == 1
    assert snap["device"]["mean_s"] == pytest.approx(0.010)
    fam = reg.get("server_phase_seconds")
    by_phase = {dict(h.labels)["phase"]: h for h in fam.children()}
    assert by_phase["device"].count == 1
    assert by_phase["device"].sum == pytest.approx(0.010)


def test_bubble_fraction_synthetic_stall():
    p = PhaseProfiler(enabled=True, registry=MetricsRegistry(enabled=False))
    p.device_interval(0.0, 1.0)
    p.device_interval(1.5, 2.5)            # a 0.5 s stall in 2.5 s of wall
    assert p.bubble_fraction() == pytest.approx(0.2)
    p2 = PhaseProfiler(enabled=True, registry=MetricsRegistry(enabled=False))
    p2.device_interval(0.0, 1.0)
    p2.device_interval(0.8, 1.9)           # overlapped: no idle time
    assert p2.bubble_fraction() == pytest.approx(0.0)


def test_profiled_pipeline_populates_server_phase(weights):
    """With the profiler on, the port's 2-remote-stage generation fills the
    serving boundary's ``server`` phase, one observation per remote call.
    (The reference's client-side ``socket`` phase comes with the TCP client,
    which the port does not have yet.)"""
    enable_phase_profiling()
    prof = get_profiler()
    prof.reset()
    try:
        _port_client(weights).generate(PROMPT, max_new_tokens=3,
                                       sampling=SamplingParams(temperature=0.0))
        snap = prof.snapshot()
        assert snap["server"]["count"] == 2 * 3    # 2 remote stages, 3 steps
        assert snap["server"]["total_s"] > 0.0
        assert "socket" not in snap
    finally:
        disable_phase_profiling()
        prof.reset()


def test_stats_digest_has_every_field():
    reg = MetricsRegistry(enabled=True)
    catalog.register_all(reg)
    d = stats_digest(registry=reg, profiler=PhaseProfiler(enabled=True))
    assert set(d) == set(DIGEST_FIELDS)
    for v in d.values():
        assert isinstance(v, (int, float))


def _trace_a_generation(weights, tmp_path):
    """A traced generation through the port's 2-remote-hop pipeline, dumped
    as the doctor would load it."""
    telemetry.enable()
    tracer = get_tracer()
    tracer.clear()
    events.get_recorder().clear()
    try:
        _port_client(weights).generate(PROMPT, max_new_tokens=3,
                                       sampling=SamplingParams(temperature=0.0))
        path = str(tmp_path / "trace.jsonl")
        events.get_recorder().dump(path, registry=telemetry.get_registry())
        return load_dump(path), path
    finally:
        telemetry.disable()
        tracer.clear()
        events.get_recorder().clear()
        telemetry.get_registry().reset()


def test_critical_path_parts_sum_to_wall(weights, tmp_path):
    stream, _ = _trace_a_generation(weights, tmp_path)
    assert stream["spans"], "dump carried no _spans record"
    reports = doctor.critical_path_reports([stream])
    decode = [r for r in reports if r["phase"] == "decode"]
    assert len(reports) == 3 and len(decode) == 2
    for r in reports:
        parts = r["parts"]
        assert set(parts) == {"network", "queue", "compute", "replay", "client"}
        assert sum(parts.values()) == pytest.approx(r["wall_s"], rel=1e-9, abs=1e-12)
        for k in ("network", "queue", "compute", "replay"):
            assert parts[k] >= 0.0
        assert parts["client"] >= -1e-9
    for r in decode:
        assert r["hops"] == 2
        assert r["parts"]["compute"] > 0.0
        names = [n for n, _ in r["path"]]
        assert names[0] == "pipeline_step"
        assert names[1].startswith("hop:")
        assert names[2] == "server_forward"


def test_doctor_cli_renders_critical_path(weights, tmp_path, capsys):
    _, path = _trace_a_generation(weights, tmp_path)
    assert tmain.main(["--mode", "doctor", "--dumps", path, "--critical_path"]) == 0
    out = capsys.readouterr().out
    assert "critical path" in out
    assert "compute" in out and "network" in out
    assert tmain.main(["--mode", "doctor", "--dumps", path]) == 0
    assert "critical path" not in capsys.readouterr().out


# -- parity with the JAX package on the same weights --------------------------

def _series(reg):
    """{(family, labels): value} of counters and {..: count} of histograms."""
    out = {}
    for fam, children in reg.collect():
        for child in children:
            if fam.kind == "counter":
                out[(fam.name, child.labels)] = child.value
            elif fam.kind == "histogram":
                out[(fam.name, child.labels)] = child.count
    return out


def _event_view(ev):
    fields = {k: v for k, v in ev.fields.items() if k not in TIME_FIELDS}
    return (ev.name, ev.subsystem, ev.severity, ev.session_id is not None,
            json.dumps(fields, sort_keys=True))


def _tree(span, children):
    """A span and its subtree, ids dropped: name, kind, phase, the peer of a
    server span, whether a hop carries its server's span, and the children
    in a canonical order."""
    kids = sorted((_tree(c, children) for c in children.get(span.span_id, ())),
                  key=repr)
    return (span.name, span.kind, span.attrs.get("phase"), span.attrs.get("step"),
            span.attrs.get("peer") if span.kind == "server" else None,
            "server" in span.attrs, tuple(kids))


def _span_trees(spans):
    trees = []
    for trace in reconstruct(spans).values():
        children, roots = {}, []
        ids = {s.span_id for s in trace}
        for s in trace:
            if s.parent_id in ids:
                children.setdefault(s.parent_id, []).append(s)
            else:
                roots.append(s)
        assert len(roots) == 1
        trees.append((roots[0].start_s, _tree(roots[0], children)))
    return [t for _, t in sorted(trees, key=lambda t: t[0])]


def _observe(tel, build_client, sampling_cls):
    """One greedy generation with `tel`'s telemetry on: (tokens, global
    series, client series, events, span trees). The registry is emptied
    before the cluster is built: components fetch their handles when they
    are made."""
    tel.get_registry().reset()
    client = build_client()
    tel.enable()
    for clear in (tel.get_tracer().clear, tel.get_recorder().clear):
        clear()
    try:
        res = client.generate(PROMPT, max_new_tokens=4,
                              sampling=sampling_cls(temperature=0.0))
        return (res.tokens, _series(tel.get_registry()), _series(client.metrics),
                [_event_view(e) for e in tel.get_recorder().events()],
                _span_trees(tel.get_tracer().spans()))
    finally:
        tel.disable()
        tel.get_tracer().clear()
        tel.get_recorder().clear()
        tel.get_registry().reset()


@pytest.fixture(scope="module")
def both_packages(weights):
    jcfg = weights[0]
    ref = _observe(jtelemetry, lambda: build_cluster(jcfg, splits="3,6")[0], JSampling)
    port = _observe(telemetry, lambda: _port_client(weights), SamplingParams)
    assert port[0] == ref[0], "the parity run needs equal tokens"
    return ref, port


@pytest.mark.parametrize("registry", ["global", "client"])
def test_parity_counters_and_histogram_counts(both_packages, registry):
    ref, port = both_packages
    i = {"global": 1, "client": 2}[registry]
    assert port[i], "no series recorded"
    keys = set(ref[i]) | set(port[i])
    diff = {k: (ref[i].get(k, 0), port[i].get(k, 0)) for k in keys
            if ref[i].get(k, 0) != port[i].get(k, 0)}
    assert not diff, diff


def test_parity_event_sequence(both_packages):
    ref, port = both_packages
    assert [e[0] for e in port[3]][:2] == ["session_start", "server_session_open"]
    assert port[3] == ref[3]


def _arena_story(tel, arena):
    """Allocation failures of each kind, then an eviction of every idle
    session: (events, global series, used-bytes gauge)."""
    tel.enable()
    tel.get_recorder().clear()
    try:
        arena.allocate("a", 100)
        for sid, max_length, timeout in (("a", 100, None), ("big", 10 ** 6, None),
                                         ("b", 100, None), ("c", 100, 0.0)):
            try:
                arena.allocate(sid, max_length, timeout=timeout)
            except RuntimeError as exc:
                assert type(exc).__name__ == "AllocationFailed"
        assert arena.evict_idle(older_than=-1.0) == 2
        return ([_event_view(e) for e in tel.get_recorder().events()],
                _series(tel.get_registry()),
                tel.get_registry().get("server_kv_used_bytes").value)
    finally:
        tel.disable()
        tel.get_recorder().clear()
        tel.get_registry().reset()


def test_parity_kv_arena_failures_and_eviction():
    """The arena's counters and events (kv_alloc_failed of each reason,
    kv_eviction) equal the JAX arena's for the same calls; room for two
    sessions of the smallest bucket."""
    import jax.numpy as jnp
    import torch

    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.kv_cache import (
        KVArena as JArena,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.kv_cache import (
        KVArena as TArena,
    )

    shape = dict(num_layers=2, num_kv_heads=2, head_dim=8)
    room = 2 * TArena(**shape, max_bytes=1, device="cpu").bytes_for(128)
    jtelemetry.get_registry().reset()
    ref = _arena_story(jtelemetry, JArena(**shape, max_bytes=room, dtype=jnp.bfloat16))
    telemetry.get_registry().reset()
    port = _arena_story(telemetry, TArena(**shape, max_bytes=room, device="cpu",
                                          dtype=torch.bfloat16))
    assert [e[0] for e in port[0]] == ["kv_alloc_failed"] * 3 + ["kv_eviction"]
    assert port == ref


def test_parity_span_trees(both_packages):
    ref, port = both_packages
    assert len(port[4]) == 4                   # a prefill and 3 decode steps
    assert port[4] == ref[4]
