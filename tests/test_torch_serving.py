"""The port's serving gateway (``serving/``: admission, fair queue, gateway)
and the pipeline client's deadlines and priority, against the JAX
package's.

  * the primitives: `TokenBucket`, `AdmissionController`,
    `DeficitRoundRobin`, `FairQueue` and the ``--tenants`` parser driven
    by one call script on one injected clock in both packages: the same
    decisions, shed reasons and ``retry_after_s``;
  * the SLO burn-rate tests of ``tests/test_profiling.py:289-320`` on the
    port's `SloTracker`;
  * client deadlines: a spent budget raises `DeadlineExceeded` before any
    hop is dialed (``client_deadline_expired_total``, the
    ``deadline_expired`` event); every hop's ``deadline_budget_s`` and
    ``priority`` are the JAX client's for the same session, and the burst
    path stamps both too;
  * the gateway over loopback TCP in both packages on the same bridged
    weights (the reference's overload drill, ``main.py:2024``): each
    admitted request's tokens equal the sequential run's and the other
    package's; gold:bronze served tokens within +/-25% of 4:1; a strict
    gateway sheds with ``rate``, ``concurrency`` and ``queue_full``, each
    with ``retry_after_s > 0``; the port's gateway with ``burst=4`` over a
    full-span batched peer gives the same tokens at burst granularity; a
    request whose budget is spent in the queue comes back as
    ``DeadlineExceeded``;
  * ``--mode gateway`` and two ``--mode submit`` processes against a CLI
    swarm.

Greedy tokens are compared exactly; the primitives' decisions and retry
hints exactly (both run the same float arithmetic on the same clock).
"""

import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    one_torch_thread,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    telemetry as ttelemetry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    errors as terrors,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    DeadlineExceeded,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.serving import (
    gateway as tgateway,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    catalog as tcatalog,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    events as tevents,
)

from test_runtime_pipeline import build_cluster, tiny_cfg

JAX_PKG = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu"
PORT_PKG = JAX_PKG + "_torch"
PROMPT = [1, 2, 3, 4, 5]
MAX_NEW = 6
SPLITS = (3, 5)
WEIGHTS = {"gold": 4.0, "bronze": 1.0}
PER_TENANT = 2


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the primitives: one script, both packages --------------------------------

def _primitives_trace(pkg):
    """Every decision of a fixed call script on an injected clock."""
    s = _mod(pkg, "serving")
    out = []
    clk = FakeClock()
    b = s.TokenBucket(rate=2.0, burst=4.0, now=clk)
    out.append([b.try_take(1.0) for _ in range(5)])
    out.append(b.time_until(1.0))
    clk.t += 0.3
    out += [b.tokens, b.try_take(0.5), b.time_until(2.0)]
    clk.t += 100.0
    out.append(b.tokens)

    ac = s.AdmissionController(
        {"t": s.TenantConfig("t", rate=1.0, burst=2.0, max_concurrency=1),
         "u": s.TenantConfig("u", rate=0.5, burst=1.0, max_concurrency=3)},
        max_queue_depth=2, now=clk)
    script = [("t", 2), ("t", 0), ("t", 0), ("release", "t"), ("t", 0),
              ("release", "t"), ("t", 0), ("tick", 0.4), ("t", 0), ("tick", 0.6),
              ("t", 0), ("u", 1), ("u", 1), ("tick", 1.5), ("u", 0), ("u", 2)]
    for who, arg in script:
        if who == "release":
            ac.release(arg)
            out.append(("inflight", arg, ac.inflight(arg)))
        elif who == "tick":
            clk.t += arg
        else:
            try:
                ac.try_admit(who, queue_depth=arg)
                out.append(("admit", who))
            except s.Overloaded as exc:
                out.append(("shed", who, exc.reason, exc.retry_after_s, exc.tenant))

    drr = s.DeficitRoundRobin({"gold": 4.0, "bronze": 1.0, "free": 0.5})
    active = ({"gold", "bronze", "free"}, {"bronze"}, {"gold", "free"})
    out.append([drr.pick(active[i % 3]) for i in range(60)])
    drr.charge("gold", 3)
    out.append([drr.pick({"gold", "bronze"}) for _ in range(12)])

    q = s.FairQueue({"gold": 4.0, "bronze": 1.0})
    for i in range(6):
        q.push("gold", f"g{i}", deadline_at=None if i % 2 else 10.0 - i)
        q.push("bronze", f"b{i}", deadline_at=5.0 + i if i % 3 else None)
    out.append((q.depth(), q.depths()))
    out.append([q.try_pop() for _ in range(8)])
    out.append(sorted(q.drain()))
    out.append(q.try_pop())
    for cfg in ({"tenants": {"gold": {"weight": 4, "rate": 20, "slo_ttft_s": 0.5},
                             "bronze": {}}, "max_queue_depth": 7, "max_active": 3},
                {"solo": {"weight": 2, "max_concurrency": 5}}):
        tenants, qd, ma = s.parse_tenants_config(cfg)
        out.append(({k: vars(v) for k, v in tenants.items()}, qd, ma))
    for bad in ({"weight": 0}, {"rate": 0}, {"burst": -1}, {"max_concurrency": 0},
                {"slo_ttft_s": 0}, {"slo_target": 1.0}):
        try:
            s.TenantConfig("t", **bad)
            out.append(("accepted", bad))
        except ValueError as exc:
            out.append(("refused", str(exc)))
    return out


def test_primitives_decide_as_the_jax_package():
    """Token bucket, the three admission gates in order, DRR (with a burst
    charge), the EDF fair queue and the tenants parser: the same trace of
    decisions, reasons and retry hints."""
    assert _primitives_trace(PORT_PKG) == _primitives_trace(JAX_PKG)


def test_overloaded_is_a_shed_outside_the_retryable_taxonomy():
    s = _mod(PORT_PKG, "serving")
    exc = s.Overloaded("full", 0.25, tenant="t", reason="queue_full")
    assert isinstance(exc, RuntimeError)
    assert not isinstance(exc, terrors.retryable_types())
    assert terrors.policy_of(exc).policy == terrors.TAXONOMY["Overloaded"].policy


# -- SLO burn rates (tests/test_profiling.py:289-320) ------------------------

def test_slo_burn_rate_math_with_injected_clock():
    s = _mod(PORT_PKG, "serving")
    t = [0.0]
    cfg = s.TenantConfig(name="gold", slo_ttft_s=0.1, slo_token_s=0.01, slo_target=0.9)
    trk = tgateway.SloTracker({"gold": cfg}, window_s=60.0, now=lambda: t[0])
    # 8 good + 2 bad TTFTs at a 90% target: bad fraction 0.2 over an error
    # budget of 0.1, burning at 2x the sustainable rate.
    for _ in range(8):
        trk.observe("gold", "ttft", 0.05)
    for _ in range(2):
        trk.observe("gold", "ttft", 0.25)
    assert trk.burn_rate("gold", "ttft") == pytest.approx(2.0)
    for _ in range(5):
        trk.observe("gold", "token", 0.005)
    snap = trk.snapshot()
    assert snap["gold"]["ttft"] == pytest.approx(2.0)
    assert snap["gold"]["token"] == 0.0
    # Two minutes later the bad epoch has aged out of the window.
    t[0] = 120.0
    trk.observe("gold", "ttft", 0.05)
    assert trk.burn_rate("gold", "ttft") == 0.0


def test_slo_tracker_ignores_undeclared_objectives():
    s = _mod(PORT_PKG, "serving")
    trk = tgateway.SloTracker({"free": s.TenantConfig(name="free")}, window_s=60.0)
    trk.observe("free", "ttft", 99.0)
    trk.observe("unknown-tenant", "ttft", 99.0)
    assert trk.burn_rate("free", "ttft") == 0.0
    assert trk.snapshot() == {}


# -- client deadlines and priority --------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


class _Recording:
    """Wraps a transport's `call`: every request sent, in order."""

    def __init__(self, transport):
        self.sent = []
        self.inner = transport.call

        def call(peer_id, req, timeout=None):
            self.sent.append(req)
            return self.inner(peer_id, req, timeout)

        transport.call = call


def test_spent_budget_raises_before_any_dial(weights):
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, "3,5")
    rec = _Recording(transport)
    tevents.get_recorder().enable()
    tevents.get_recorder().clear()
    try:
        steps = client.generate_stepwise(PROMPT, MAX_NEW, session_id="late",
                                         deadline_at=time.monotonic() - 0.5)
        with pytest.raises(DeadlineExceeded, match="deadline exceeded"):
            next(steps)
        names = [e.name for e in tevents.get_recorder().events()]
    finally:
        tevents.get_recorder().disable()
        tevents.get_recorder().clear()
    assert rec.sent == []
    assert client._m_deadline.value == 1
    assert "deadline_expired" in names
    # A fresh budget serves the session in full.
    assert len(client.generate(PROMPT, MAX_NEW, deadline_s=60.0).tokens) == MAX_NEW


def test_hop_headers_match_the_jax_client(weights):
    """The same session in both packages with a 60 s budget and priority
    0.25: every hop request (prefill and decode) carries a budget in
    (0, 60] and the priority, as the JAX client's do, and the tokens are
    the same."""
    jcfg, jp, tcfg, tp = weights
    jclient, jtransport, *_ = build_cluster(jcfg, "3,5")
    jtrans = _Recording(jtransport)
    tclient, ttransport = build_port_cluster(tcfg, tp, "3,5")
    ttrans = _Recording(ttransport)
    got = {}
    for name, client in (("jax", jclient), ("port", tclient)):
        steps = list(client.generate_stepwise(PROMPT, MAX_NEW, session_id="s1",
                                              deadline_s=60.0, priority=0.25))
        got[name] = steps[-1].result.tokens

    def headers(sent):
        return [(r.start_block, bool(r.is_prefill), r.priority,
                 r.deadline_budget_s is not None and 0 < r.deadline_budget_s <= 60.0)
                for r in sent]

    assert headers(ttrans.sent) == headers(jtrans.sent)
    assert all(h[2] == 0.25 and h[3] for h in headers(ttrans.sent))
    assert len(ttrans.sent) == 2 * MAX_NEW
    assert [int(t) for t in got["port"]] == [int(t) for t in got["jax"]]
    assert tclient._session_priority == {}


# -- the gateway over loopback TCP --------------------------------------------

def _swarm(pkg, cfg, params, burst=0):
    """Registry, stages 1..N behind TCP servers (and, with `burst`, a
    full-span batched peer), and a factory of pipeline clients sharing one
    stage 0: the reference's overload drill's swarm (main.py:2024)."""
    port = pkg == PORT_PKG
    dev = {"device": "cpu"} if port else {}
    ex_mod, net = _mod(pkg, "runtime.executor"), _mod(pkg, "runtime.net")
    cl_mod, part = _mod(pkg, "runtime.client"), _mod(pkg, "models.partition")
    pool = _mod(pkg, "runtime.task_pool")
    plan = part.StagePlan.from_splits(cfg.num_layers, SPLITS)
    stage_params = lambda spec: part.slice_stage_params(cfg, params, spec)  # noqa: E731
    reg_server = net.RegistryServer(host="127.0.0.1", port=0)
    reg_server.start()
    reg = net.RemoteRegistry(reg_server.address)
    servers, transports = [reg_server], []
    for spec in plan.stages[1:]:
        ex = ex_mod.StageExecutor(cfg, spec, stage_params(spec),
                                  peer_id=f"overload-s{spec.index}", **dev)
        srv = net.TcpStageServer(ex, host="127.0.0.1", port=0, wire_dtype="f32",
                                 runtime=pool.StageRuntime())
        srv.start()
        rec = cl_mod.make_server_record(ex.peer_id, spec)
        rec.address = srv.address
        reg.register(rec)
        servers.append(srv)
    if burst:
        batching = _mod(pkg, "runtime.batching")
        full = part.StageSpec(index=0, role=part.ROLE_FULL, start=0, end=cfg.num_layers)
        bex = batching.BatchedStageExecutor(cfg, full, stage_params(full),
                                            slots=2 * PER_TENANT, max_len=64, **dev)
        bad = batching.BatchingStageAdapter(bex, window_s=0.0, peer_id="overload-burst")
        bad.warmup(burst=burst)
        bsrv = net.TcpStageServer(bad, runtime=None, host="127.0.0.1", port=0,
                                  wire_dtype="f32")
        bsrv.start()
        brec = cl_mod.make_server_record(bad.peer_id, full, engine="batched")
        brec.address = bsrv.address
        reg.register(brec)
        servers.append(bsrv)
    ex0 = ex_mod.StageExecutor(cfg, plan.stages[0], stage_params(plan.stages[0]),
                               peer_id="overload-client", **dev)

    def client():
        tx = net.TcpTransport(reg, wire_dtype="f32")
        transports.append(tx)
        return cl_mod.PipelineClient(cfg, plan, ex0, tx, reg, request_timeout=30.0,
                                     settle_seconds=0.0, seed=0)

    def close():
        for tx in transports:
            tx.close()
        for srv in servers:
            srv.stop()

    return client, close


def _variant(i):
    k = i % len(PROMPT)
    return PROMPT[k:] + PROMPT[:k]


def _soak(pkg, cfg, params, burst=0):
    """The drill's two phases: 2 gold and 2 bronze requests preloaded on a
    paused gateway and released (tokens, the served-token log), then a
    strict gateway that is never resumed (the three shed gates), and a
    request whose 10 ms budget is spent in the queue."""
    s = _mod(pkg, "serving")
    client, close = _swarm(pkg, cfg, params, burst)
    out = {}
    gateways = []
    try:
        base = client()
        total = 2 * PER_TENANT
        greedy = _mod(pkg, "ops.sampling").SamplingParams(temperature=0.0)
        out["baseline"] = [list(base.generate(_variant(i), MAX_NEW, sampling=greedy,
                                              session_id=f"base-{i}").tokens)
                           for i in range(total)]
        tenants = {n: s.TenantConfig(n, weight=w, rate=1000.0, burst=1000.0)
                   for n, w in WEIGHTS.items()}
        gw = s.GatewayServer([client()], tenants, port=0, max_queue_depth=64,
                             max_active=total, start_paused=True, burst=burst)
        gateways.append(gw)
        gw.start()
        order = ["gold"] * PER_TENANT + ["bronze"] * PER_TENANT
        got = {}

        def submit(i, tenant):
            got[i] = s.GatewaySubmitClient(gw.address).submit(
                tenant, _variant(i), MAX_NEW, deadline_s=60.0,
                session_id=f"ov-{tenant}-{i}", timeout=90.0)

        threads = [threading.Thread(target=submit, args=(i, t), daemon=True)
                   for i, t in enumerate(order)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 15.0
        while gw.queue.depth() < total and time.monotonic() < deadline:
            time.sleep(0.01)
        assert gw.queue.depth() == total
        gw.resume()
        for th in threads:
            th.join(timeout=120.0)
        out["tokens"] = [got[i]["tokens"] for i in range(total)]
        out["step_log"] = list(gw.step_log)
        out["gold_total"] = sum(len(out["baseline"][i]) for i in range(PER_TENANT))

        # A budget spent while queued: the session's first hop refuses.
        late = s.GatewayServer([client()], tenants, port=0, start_paused=True)
        gateways.append(late)
        late.start()
        err = {}

        def submit_late():
            try:
                s.GatewaySubmitClient(late.address).submit("gold", PROMPT, 2,
                                                           deadline_s=0.01, timeout=30.0)
            except RuntimeError as exc:
                err["msg"] = str(exc)

        th = threading.Thread(target=submit_late, daemon=True)
        th.start()
        while late.queue.depth() < 1:
            time.sleep(0.01)
        time.sleep(0.05)
        late.resume()
        th.join(timeout=30.0)
        out["late"] = err.get("msg")

        strict = {"slow": s.TenantConfig("slow", rate=1000.0, burst=1000.0,
                                         max_concurrency=1),
                  "bursty": s.TenantConfig("bursty", rate=1e-3, burst=1.0),
                  "filler": s.TenantConfig("filler", rate=1000.0, burst=1000.0)}
        gw2 = s.GatewayServer([client()], strict, port=0, max_queue_depth=3,
                              max_active=1, start_paused=True)
        gateways.append(gw2)
        gw2.start()
        sub = s.GatewaySubmitClient(gw2.address)
        sheds, bgs = [], []
        for depth, (tenant, want) in enumerate((("slow", "concurrency"),
                                                ("bursty", "rate"),
                                                ("filler", "queue_full"))):
            th = threading.Thread(target=lambda t=tenant: _quietly(sub, t), daemon=True)
            th.start()
            bgs.append(th)
            while gw2.queue.depth() < depth + 1:
                time.sleep(0.01)
            with pytest.raises(s.Overloaded) as ei:
                sub.submit(tenant, PROMPT, 2, timeout=10.0)
            sheds.append((tenant, ei.value.reason, ei.value.retry_after_s > 0))
        gw2.stop()
        for th in bgs:
            th.join(timeout=10.0)
        out["sheds"] = sheds
        out["info"] = s.GatewaySubmitClient(gw.address).info()
    finally:
        for g in gateways:
            g.stop()
        close()
    return out


def _quietly(sub, tenant):
    try:
        sub.submit(tenant, PROMPT, 2, timeout=30.0)
    except Exception:  # noqa: BLE001 — the stop fails the queued waiter
        pass


def _fair(out, slack):
    """Served tokens over the contended window (up to gold's last token)
    within +/-25% of 4:1, with one service quantum of slack (a token, or
    a burst)."""
    log, gold, cut = out["step_log"], 0, len(out["step_log"])
    for pos, tenant in enumerate(log):
        gold += tenant == "gold"
        if gold == out["gold_total"]:
            cut = pos + 1
            break
    window = log[:cut]
    g = window.count("gold")
    b = len(window) - g
    return g == out["gold_total"] and abs(b - g / 4.0) <= max(slack, 0.25 * g / 4.0)


@pytest.fixture(scope="module")
def soaks(weights):
    jcfg, jp, tcfg, tp = weights
    return {"jax": _soak(JAX_PKG, jcfg, jp), "port": _soak(PORT_PKG, tcfg, tp)}


def test_gateway_tokens_equal_the_sequential_run_and_the_jax_gateway(soaks):
    for side in ("jax", "port"):
        assert soaks[side]["tokens"] == soaks[side]["baseline"], side
    assert soaks["port"]["tokens"] == [[int(t) for t in r] for r in soaks["jax"]["tokens"]]


def test_gateway_serves_tokens_by_weight(soaks):
    for side in ("jax", "port"):
        assert _fair(soaks[side], 1.0), (side, soaks[side]["step_log"])


def test_gateway_sheds_as_the_jax_gateway(soaks):
    assert soaks["port"]["sheds"] == soaks["jax"]["sheds"] == [
        ("slow", "concurrency", True), ("bursty", "rate", True),
        ("filler", "queue_full", True)]


def test_gateway_reports_a_spent_budget_and_its_info(soaks):
    for side in ("jax", "port"):
        assert soaks[side]["late"] is not None and "DeadlineExceeded" in soaks[side]["late"]
    info = soaks["port"]["info"]
    assert info["role"] == "gateway" and info["tenants"] == ["bronze", "gold"]
    assert info == soaks["jax"]["info"]


def test_gateway_bursts_give_the_same_tokens(weights, soaks, monkeypatch):
    """burst=4 over a full-span batched peer: sessions decode 4 ticks a
    scheduler pick (the DRR charged each burst's tokens), the tokens the
    per-step baseline's, fairness within one burst of slack; every burst
    request carries the session's budget and priority."""
    _, _, tcfg, tp = weights
    net = _mod(PORT_PKG, "runtime.net")
    sent = []
    call = net.TcpTransport.call

    def recording(self, peer_id, req, timeout=None):
        sent.append(req)
        return call(self, peer_id, req, timeout)

    monkeypatch.setattr(net.TcpTransport, "call", recording)
    out = _soak(PORT_PKG, tcfg, tp, burst=4)
    assert out["tokens"] == out["baseline"] == soaks["port"]["baseline"]
    assert _fair(out, 4.0), out["step_log"]
    bursts = [r for r in sent if r.burst_len]
    assert bursts and all(r.burst_len == 4 and r.deadline_budget_s is not None
                          and r.priority in (0.25, 1.0) for r in bursts)


def test_gateway_telemetry_families_are_in_the_catalog():
    """The families the gateway writes are the byte-equal catalog's."""
    for name in ("gateway_shed_total", "gateway_requests_total", "gateway_queue_depth",
                 "gateway_queue_wait_seconds", "gateway_ttft_seconds",
                 "gateway_tokens_served_total", "gateway_active_sessions",
                 "gateway_slo_burn_rate", "client_deadline_expired_total"):
        assert tcatalog.get(name, ttelemetry.MetricsRegistry(enabled=True)) is not None


# -- the CLI ------------------------------------------------------------------

def _port_cli(*argv):
    # One intra-op thread a process: six of them share the test's cores.
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", f"{PORT_PKG}.main", *argv,
                             "--device", "cpu"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env)


def _handshake(proc, prefix, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline().decode("utf-8", errors="replace")
        if line.startswith(prefix):
            return line.strip()
        if not line and proc.poll() is not None:
            raise AssertionError(f"process exited {proc.returncode} before {prefix!r}")
    raise AssertionError(f"no {prefix!r} line")


def test_cli_gateway_and_submit_match_mode_local():
    """``--mode registry``, one ``--mode serve`` (two stages: ``--splits
    6``), ``--mode gateway`` with two tenants, and a ``--mode submit``
    process per tenant: each prints the token ids ``--mode local`` prints
    for the prompt and exits 0."""
    common = ["--model", "gpt2", "--quant", "int8", "--seed", "1", "--splits", "6",
              "--wire_dtype", "f32"]
    gen = ["--max_new_tokens", "4", "--temperature", "0", "--prompt", "Hi there"]
    procs = []
    try:
        procs.append(_port_cli("--mode", "registry", "--registry_port", "0"))
        addr = _handshake(procs[0], "REGISTRY_ADDR=").split("=", 1)[1]
        procs.append(_port_cli("--mode", "serve", "--stage", "1", "--registry_addr", addr,
                               *common))
        local = _port_cli("--mode", "local", *common, *gen)
        procs.append(local)
        _handshake(procs[1], "SERVING ")
        gw = _port_cli("--mode", "gateway", "--registry_addr", addr, *common,
                       "--tenants", json.dumps({"gold": {"weight": 4}, "bronze": {}}))
        procs.append(gw)
        gw_addr = re.search(r"addr=(\S+)", _handshake(gw, "GATEWAY ")).group(1)
        subs = [_port_cli("--mode", "submit", "--gateway_addr", gw_addr, "--tenant", t,
                          "--deadline_s", "120", *common, *gen) for t in ("gold", "bronze")]
        procs += subs
        want = re.findall(r"^TOKENS=(\[[0-9, ]*\])$",
                          local.communicate(timeout=180)[0].decode(), re.M)
        assert local.returncode == 0 and len(want) == 1
        for sub in subs:
            out = sub.communicate(timeout=180)[0].decode("utf-8", errors="replace")
            assert sub.returncode == 0, out
            assert re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M) == want
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


@pytest.mark.parametrize("mode", ["local", "oracle", "serve", "client", "gateway"])
def test_model_modes_refuse_to_run_on_the_cpu_unless_asked(monkeypatch, mode):
    """Every mode that loads weights runs on ``--device cuda`` (the
    default) and, with no GPU, exits before loading anything rather than
    quietly using the CPU (``--mode gateway`` included)."""
    tmain = _mod(PORT_PKG, "main")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmain, "init_params", lambda *a, **k: pytest.fail("weights drawn"))
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        tmain.main(["--mode", mode, "--model", "gpt2", "--stage", "1"])
