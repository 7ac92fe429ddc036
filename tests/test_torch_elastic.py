"""Elastic load-balanced servers and block-coverage routing in the port,
held against the JAX package on the same inputs.

Sizing (`block_bytes`, `choose_num_blocks`, `derive_num_blocks`), the
spans elastic servers choose (first joiner, reinforcing joiner, the
`min_block` floor), rule 2 on stacked servers (the mover and its new
span), TTL expiry and the heartbeat's self-heal, generation through
overlapping elastic spans with a sub-span hop, the greedy and the latency
module routers' hops on the same records, failover through the module
branch, a TCP server that is re-spanning, ``--mode local
--use_load_balancing`` and ``--mode status``.

Tiny llama, 8 layers, float32, the port on its plain kernels (the CPU).
Both packages get the same seeds (``random.Random``) and the same records.
Tolerance: tokens, spans and hops are compared for equality; the last
hop's logits at every step within the pipeline tests' float32 parity
(``_torch_port_helpers.assert_close``, RTOL = ATOL = 1e-5 of the logits'
scale)."""

import random
import socket
import time

import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    jax_mode_generate,
    jax_params,
    one_torch_thread,
    port_args,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    main as jmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    config as jconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    quant as jquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    slice_stage_params as jslice,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    client as jclient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    executor as jexecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    server as jserver,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    transport as jtransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling import (
    registry as jregistry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    config as tconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
    slice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    errors as terrors,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    executor as texecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    net as tnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    server as tserver,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    PipelineClient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    LocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
    ServerRecord,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling import (
    throughput as tthroughput,
)

MIN_BLOCK = 2          # the client-local prefix [0, 2)
PROMPT = [5, 9, 23, 7, 101, 44]
NEW_TOKENS = 6
GREEDY = (0.0, 0.9, 50, 1.5)
SOCKET_TIMEOUT_S = 10.0


def tiny_cfg_j():
    return jconfig.llama_config(vocab_size=257, hidden_size=64, num_layers=8,
                                num_heads=4, num_kv_heads=2, intermediate_size=128,
                                max_position_embeddings=256)


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg_j()
    jp = jax_params(jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


class Pair:
    """One swarm in each package over the same weights: a registry, an
    in-process transport and elastic servers made by `add`."""

    def __init__(self, weights, ttl=None):
        self.jcfg, self.jp, self.tcfg, self.tp = weights
        self.jreg = jregistry.PlacementRegistry(rng=random.Random(0))
        self.treg = PlacementRegistry(rng=random.Random(0))
        if ttl is not None:
            self.jreg.ttl = self.treg.ttl = ttl
        self.jtx = jtransport.LocalTransport()
        self.ttx = LocalTransport()
        self.servers = {}

    def add(self, peer, num_blocks, seed, span=None, throughput=None, **kw):
        """An elastic server of each package; joins by rule 1, or takes
        `span` as given (a stacked or overlapping layout)."""
        j = jserver.ElasticStageServer(
            peer, self.jcfg, lambda spec: jslice(self.jcfg, self.jp, spec), self.jreg,
            self.jtx, num_blocks=num_blocks, total_blocks=self.jcfg.num_layers,
            min_block=MIN_BLOCK, rng=random.Random(seed), **kw)
        t = tserver.ElasticStageServer(
            peer, self.tcfg, lambda spec: slice_stage_params(self.tcfg, self.tp, spec),
            self.treg, self.ttx, num_blocks=num_blocks, total_blocks=self.tcfg.num_layers,
            min_block=MIN_BLOCK, rng=random.Random(seed),
            executor_kwargs={"device": "cpu"}, **kw)
        for s in (j, t):
            if throughput is not None:
                s.throughput = throughput
            if span is None:
                s.start_serving()
            else:
                s.load_span(s._spec_for(*span))
        self.servers[peer] = (j, t)
        return j, t

    def spans(self):
        return {p: ((j.spec.start, j.spec.end), (t.spec.start, t.spec.end))
                for p, (j, t) in self.servers.items()}

    def clients(self, **kw):
        jplan = JStagePlan.from_splits(self.jcfg.num_layers, [MIN_BLOCK])
        tplan = StagePlan.from_splits(self.tcfg.num_layers, [MIN_BLOCK])
        j0 = jexecutor.StageExecutor(self.jcfg, jplan.stages[0],
                                     jslice(self.jcfg, self.jp, jplan.stages[0]),
                                     peer_id="client-local")
        t0 = StageExecutor(self.tcfg, tplan.stages[0],
                           slice_stage_params(self.tcfg, self.tp, tplan.stages[0]),
                           peer_id="client-local", device="cpu")
        jc = jclient.PipelineClient(self.jcfg, jplan, j0, self.jtx, self.jreg,
                                    use_module_routing=True, settle_seconds=0.0, **kw)
        tc = PipelineClient(self.tcfg, tplan, t0, self.ttx, self.treg,
                            use_module_routing=True, settle_seconds=0.0, **kw)
        return jc, tc


def _hops(route):
    return [(h.key, h.peer_id, h.start_block, h.end_block, h.expect_token) for h in route]


def _generate_both(monkeypatch, jc, tc, n=NEW_TOKENS):
    """Greedy tokens of both clients, and the last hop's logits row at every
    step of each."""
    jlog, tlog = [], []
    j_rows, t_rows = jexecutor._sample_rows, texecutor._sample_rows

    def j_tap(logits, t_real, req):
        jlog.append(np.asarray(logits[:, t_real - 1], np.float64))
        return j_rows(logits, t_real, req)

    def t_tap(logits, t_real, req, sampler):
        tlog.append(logits[:, t_real - 1].double().numpy())
        return t_rows(logits, t_real, req, sampler)

    monkeypatch.setattr(jexecutor, "_sample_rows", j_tap)
    monkeypatch.setattr(texecutor, "_sample_rows", t_tap)
    jres = jc.generate(PROMPT, n, sampling=JSamplingParams(*GREEDY))
    tres = tc.generate(PROMPT, n, sampling=SamplingParams(*GREEDY))
    return jres.tokens, tres.tokens, jlog, tlog


# ---------------------------------------------------------------------------
# Sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int8", "nf4"])
def test_block_sizing_matches_jax(quant):
    """params_per_block, block_bytes and choose_num_blocks: equal to the
    JAX package's for every preset, at both weight widths and four
    budgets."""
    assert tquant.QUANT_BITS == jquant.QUANT_BITS
    for name in jconfig.PRESETS:
        jcfg, tcfg = jconfig.get_config(name), tconfig.get_config(name)
        assert tquant.params_per_block(tcfg) == jquant.params_per_block(jcfg), name
        for dtype_bytes in (2, 4):
            per = jquant.block_bytes(jcfg, dtype_bytes, quant)
            assert tquant.block_bytes(tcfg, dtype_bytes, quant) == per, name
            for budget in (per // 2, 3 * per, 40 << 30, 80 << 30):
                kw = dict(dtype_bytes=dtype_bytes, quant=quant, attn_cache_bytes=1 << 30)
                assert (tquant.choose_num_blocks(tcfg, budget, **kw)
                        == jquant.choose_num_blocks(jcfg, budget, **kw)), (name, budget)
    with pytest.raises(ValueError, match="unknown quant"):
        tquant.block_bytes(tconfig.get_config("gpt2"), 2, "fp8")


class _FakeDevice:
    def __init__(self, limit, in_use=0):
        self._stats = {"bytes_limit": limit, "bytes_in_use": in_use}

    def memory_stats(self):
        return self._stats


# (model, dtype_bytes, quant, limit, in use, arena)
DERIVE_CASES = {
    "llama_8b_int8_80g": ("llama-3.1-8b", 2, "int8", 80 << 30, 2 << 30, 1 << 30),
    "llama_8b_bf16_busy": ("llama-3.1-8b", 2, "none", 80 << 30, 60 << 30, 1 << 30),
    "llama_8b_nf4_24g": ("llama-3.1-8b", 2, "nf4", 24 << 30, 1 << 30, 1 << 30),
    "gpt2_f32_small": ("gpt2", 4, "none", 1 << 30, 0, 64 << 20),
}


@pytest.mark.parametrize("case", sorted(DERIVE_CASES))
def test_derive_num_blocks_matches_jax(monkeypatch, case):
    """The same free and limit bytes give the JAX function's count: a fake
    device there, a patched ``torch.cuda.mem_get_info`` here (free = limit
    - in use; this process's allocator caches nothing on the CPU)."""
    name, dtype_bytes, quant, limit, in_use, arena = DERIVE_CASES[case]
    kw = dict(dtype_bytes=dtype_bytes, quant=quant, attn_cache_bytes=arena)
    want = jserver.derive_num_blocks(jconfig.get_config(name),
                                     device=_FakeDevice(limit, in_use), **kw)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (limit - in_use, limit))
    got = tserver.derive_num_blocks(tconfig.get_config(name), device="cuda", **kw)
    assert got == want and got >= 1


def test_derive_num_blocks_raises_when_nothing_fits_and_is_none_on_the_cpu(monkeypatch):
    kw = dict(dtype_bytes=2, attn_cache_bytes=1 << 30)
    with pytest.raises(RuntimeError, match="cannot fit one"):
        jserver.derive_num_blocks(tiny_cfg_j(), device=_FakeDevice(1 << 30), **kw)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1 << 30, 1 << 30))
    with pytest.raises(RuntimeError, match="cannot fit one"):
        tserver.derive_num_blocks(port_cfg(tiny_cfg_j()), device="cuda", **kw)
    assert tserver.derive_num_blocks(port_cfg(tiny_cfg_j()), device="cpu") is None
    assert tserver.derive_num_blocks(port_cfg(tiny_cfg_j())) is None   # no card here


# ---------------------------------------------------------------------------
# Placement: rule 1, rule 2, TTL
# ---------------------------------------------------------------------------

# Each layout: the servers' (num_blocks, seed) in join order.
JOINS = {"first_joiner": [(6, 1)], "reinforcing_joiner": [(6, 1), (3, 2)],
         "min_block_floor": [(3, 1)], "three_thirds": [(2, 1), (2, 2), (2, 3)]}


@pytest.mark.parametrize("layout", sorted(JOINS))
def test_elastic_joins_choose_the_jax_spans(weights, layout):
    pair = Pair(weights)
    for i, (num_blocks, seed) in enumerate(JOINS[layout]):
        pair.add(f"srv-{i}", num_blocks, seed)
    for peer, (jspan, tspan) in pair.spans().items():
        assert tspan == jspan and tspan[0] >= MIN_BLOCK, peer
        jrec, trec = pair.jreg.get(peer), pair.treg.get(peer)
        assert (trec.state, trec.final_stage) == (jrec.state, jrec.final_stage) == (
            "online", jspan[1] == 8)
    if layout == "first_joiner":
        assert pair.spans()["srv-0"][1] == (2, 8)
    if layout == "reinforcing_joiner":
        assert pair.spans()["srv-1"][1] == (2, 5)


def test_rule2_moves_the_jax_server_on_stacked_spans(weights):
    """Three strong servers stacked on [2,5) beside a weak final one: the
    same server moves, to the same span, in both packages."""
    pair = Pair(weights)
    pair.add("srv-final", 6, 7)
    for i, name in enumerate(("srv-x", "srv-y", "srv-z")):
        pair.add(name, 3, 10 + i, span=(2, 5), throughput=3.0)
    moved = {}
    for name in ("srv-x", "srv-y", "srv-z"):
        j, t = pair.servers[name]
        moved[name] = (j.maybe_rebalance(), t.maybe_rebalance())
    assert all(jm == tm for jm, tm in moved.values()), moved
    assert any(jm for jm, _ in moved.values())
    assert pair.spans() == {p: (js, js) for p, (js, _) in pair.spans().items()}
    for name, (jm, _) in moved.items():
        j, t = pair.servers[name]
        assert t.rebalances == j.rebalances == int(jm)
        if jm:
            assert (t.spec.start, t.spec.end) != (2, 5)
            assert name in pair.ttx.peers() and pair.ttx.executor(name) is t.executor


def test_probe_advertises_the_compute_term(weights):
    """probe_throughput: 2 untimed and 10 timed one-token forwards, each in
    a session of its own that is dropped after it; both packages advertise
    a value below the network term and publish it, the port's the compute
    term of its own timed steps (x 2 / (blocks + 1))."""
    pair = Pair(weights)
    j, t = pair.add("srv-a", 6, 1, probe_throughput=True)
    network = tthroughput.estimate_network_rps(
        None, tthroughput.hidden_request_bytes(pair.tcfg.hidden_size))
    steps = t.probe_steps
    timed = [st["seconds"] for st in steps if st["timed"]]
    assert len(steps) == 12 and len(timed) == 10
    assert sum(st["captures"] for st in steps) == 0          # no graph on the CPU
    assert t.throughput == pytest.approx(len(timed) / sum(timed) * 2 / 7, rel=0.05)
    for s, reg in ((j, pair.jreg), (t, pair.treg)):
        assert 0 < s.throughput < network
        assert reg.get("srv-a").throughput == s.throughput
    assert t.executor.arena.used_bytes == 0                   # every probe lease freed


def test_failed_respan_restores_the_old_span(weights):
    pair = Pair(weights)
    pair.add("srv-final", 6, 7)
    j, t = pair.add("srv-x", 3, 10, span=(2, 5), throughput=3.0)
    for s in (j, t):
        good, calls = s.params_provider, []

        def flaky(spec, good=good, calls=calls):
            calls.append(spec)
            if len(calls) == 1:        # the new span's load fails
                raise OSError("weights unavailable")
            return good(spec)

        s.params_provider = flaky
        s.balance_quality = 2.0        # > 1: rule 2 says move
        assert s.maybe_rebalance() is False and len(calls) == 2
        assert (s.spec.start, s.spec.end) == (2, 5) and s.rebalances == 0
    assert pair.treg.get("srv-x").state == pair.jreg.get("srv-x").state == "online"


def test_ttl_expiry_and_heartbeat_self_heal(weights):
    pair = Pair(weights, ttl=0.05)
    j, t = pair.add("srv-a", 6, 1)
    time.sleep(0.1)                    # no heartbeat: the records expire
    assert pair.jreg.live_servers() == [] and pair.treg.live_servers() == []
    assert not pair.treg.heartbeat("srv-a") and not pair.jreg.heartbeat("srv-a")
    j.heartbeat_once()
    t.heartbeat_once()
    assert [r.peer_id for r in pair.treg.live_servers()] == ["srv-a"]
    assert [r.peer_id for r in pair.jreg.live_servers()] == ["srv-a"]
    t.shutdown()
    assert pair.treg.get("srv-a") is None and "srv-a" not in pair.ttx.peers()
    assert t.executor is None and t.spec is None


# ---------------------------------------------------------------------------
# Generation and routing
# ---------------------------------------------------------------------------

def test_overlapping_elastic_spans_generate_the_jax_tokens(monkeypatch, weights):
    """[2,6) and [4,8) overlap: the second hop enters [4,8) at block 6 (a
    sub-span hop). Greedy tokens equal the JAX elastic swarm's, and the
    last hop's logits agree at every step."""
    pair = Pair(weights)
    pair.add("srv-a", 4, 1)
    pair.add("srv-b", 4, 2)
    assert {p: s[1] for p, s in pair.spans().items()} == {"srv-a": (2, 6), "srv-b": (4, 8)}
    jc, tc = pair.clients()
    assert _hops(tc.route()) == _hops(jc.route()) == [
        ("blocks2", "srv-a", 2, 6, False), ("blocks6", "srv-b", 6, 8, True)]
    jt, tt, jlog, tlog = _generate_both(monkeypatch, jc, tc)
    assert tt == jt and len(tt) == NEW_TOKENS
    assert len(tlog) == len(jlog) == NEW_TOKENS
    for a, b in zip(tlog, jlog):
        assert_close(a, b)
    # The sub-span hop ran on srv-b's executor as its own unit.
    assert (2, 4) in pair.servers["srv-b"][1].executor._subspans


# Records both routers see: (peer, start, end, throughput, final, next-hop RTTs).
ROUTE_RECORDS = [
    ("a", 2, 6, 1.0, False, {"c": 0.030, "d": 0.002}),
    ("b", 2, 5, 4.0, False, {"d": 0.001}),
    ("c", 5, 8, 1.0, True, None),
    ("d", 4, 8, 2.0, True, None),
    ("e", 6, 8, 8.0, True, None),
]
CLIENT_RTTS = {"a": 0.040, "b": 0.001}


@pytest.mark.parametrize("planner", ["greedy", "latency"])
def test_module_routes_match_the_jax_client(weights, planner):
    """The same records, published RTTs and stubbed pings give the same
    hops; latency routing implies module routing in both."""
    pair = Pair(weights)
    for peer, start, end, thr, final, rtts in ROUTE_RECORDS:
        for reg in (pair.jreg, pair.treg):
            rec_cls = jregistry.ServerRecord if reg is pair.jreg else ServerRecord
            reg.register(rec_cls(peer_id=peer, start_block=start, end_block=end,
                                 throughput=thr, final_stage=final, next_server_rtts=rtts))
        for tx in (pair.jtx, pair.ttx):
            tx.add_peer(peer, None)
            tx.rtts = dict(CLIENT_RTTS)
    jplan = JStagePlan.from_splits(pair.jcfg.num_layers, [MIN_BLOCK])
    tplan = StagePlan.from_splits(pair.tcfg.num_layers, [MIN_BLOCK])
    by_latency = planner == "latency"
    jc = jclient.PipelineClient(pair.jcfg, jplan, None, pair.jtx, pair.jreg,
                                route_by_latency=by_latency, use_module_routing=not by_latency)
    tc = PipelineClient(pair.tcfg, tplan, None, pair.ttx, pair.treg,
                        route_by_latency=by_latency, use_module_routing=not by_latency)
    assert tc.use_module_routing and jc.use_module_routing
    hops = _hops(tc.route(affinity="ignored"))
    assert hops == _hops(jc.route())
    # The latency planner enters "a" mid-span at block 5 (a sub-span hop).
    want = ([("blocks2", "b", 2, 5, False), ("blocks5", "a", 5, 6, False),
             ("blocks6", "e", 6, 8, True)] if by_latency
            else [("blocks2", "a", 2, 6, False), ("blocks6", "e", 6, 8, True)])
    assert hops == want
    assert list(tc._routes) == [("plain", None, None)]     # affinity ignored


def test_module_failover_replaces_the_hop_like_jax(monkeypatch, weights):
    """srv-b and srv-c both hold [4,8); the route enters the pinned srv-b at
    block 6. Killed after its 3rd decode step, it is replaced by the peer
    the JAX client picks (srv-c: it covers the hop's whole span), and the
    tokens equal the fault-free run's."""
    pair = Pair(weights)
    pair.add("srv-a", 4, 1, span=(2, 6))
    pair.add("srv-b", 4, 2, span=(4, 8))
    pair.add("srv-c", 4, 3, span=(4, 8))
    jc, tc = pair.clients()
    jt, tt, _, _ = _generate_both(monkeypatch, jc, tc)
    assert tt == jt
    for tx in (pair.jtx, pair.ttx):
        decodes = []

        def tap(peer, req, tx=tx, decodes=decodes):
            if peer == "srv-b" and not req.is_prefill and not req.is_replay:
                decodes.append(peer)
                if len(decodes) == 3:
                    tx.kill(peer)

        tx.on_call = tap
    jk, tk, _, _ = _generate_both(monkeypatch, jc, tc)
    assert tk == jk == tt
    jhop, thop = jc.route()[-1], tc.route()[-1]
    assert (thop.key, thop.peer_id) == (jhop.key, jhop.peer_id) == ("blocks6", "srv-c")
    assert tc.recoveries == jc.recoveries == 1


def test_respanning_tcp_server_is_a_retryable_stage_error(weights):
    """A TcpStageServer with no executor answers every request with the
    retryable stage error "server is re-spanning"; a module-routed client
    pinned to it fails over to the replica and gets the tokens of a swarm
    without it."""
    _, _, tcfg, tp = weights
    reg_srv = tnet.RegistryServer()
    reg_srv.start()
    servers, transports = [], []
    try:
        spec = StagePlan.from_splits(tcfg.num_layers, [MIN_BLOCK]).stages[1]
        respanning = tnet.TcpStageServer(None, StageRuntime(), peer_id="respanning")
        live_ex = StageExecutor(tcfg, spec, slice_stage_params(tcfg, tp, spec),
                                peer_id="live", device="cpu")
        live = tnet.TcpStageServer(live_ex, StageRuntime())
        assert live.peer_id == "live" and respanning.peer_id == "respanning"
        remote = tnet.RemoteRegistry(reg_srv.address, timeout=SOCKET_TIMEOUT_S)
        for srv, thr in ((live, 1.0), (respanning, 9.0)):
            srv.start()
            servers.append(srv)
            remote.register(ServerRecord(peer_id=srv.peer_id, start_block=spec.start,
                                         end_block=spec.end, throughput=thr,
                                         final_stage=True, address=srv.address))

        def client():
            tx = tnet.TcpTransport(tnet.RemoteRegistry(reg_srv.address,
                                                       timeout=SOCKET_TIMEOUT_S),
                                   wire_dtype="f32")
            transports.append(tx)
            plan = StagePlan.from_splits(tcfg.num_layers, [MIN_BLOCK])
            stage0 = StageExecutor(tcfg, plan.stages[0],
                                   slice_stage_params(tcfg, tp, plan.stages[0]),
                                   peer_id="client-local", device="cpu")
            return PipelineClient(tcfg, plan, stage0, tx, tx.registry, use_module_routing=True,
                                  settle_seconds=0.0, request_timeout=SOCKET_TIMEOUT_S)

        c = client()
        req = tnet.StageRequest(session_id="r", hidden=torch.zeros(1, 1, tcfg.hidden_size),
                                seq_len=1, cur_len=0, is_prefill=True, max_length=8)
        with pytest.raises(StageExecutionError, match="server is re-spanning") as err:
            c.transport.call("respanning", req, SOCKET_TIMEOUT_S)
        assert isinstance(err.value, terrors.retryable_types())
        assert c.route()[0].peer_id == "respanning"
        got = c.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY)).tokens
        assert c.recoveries == 1 and c.route(refresh=True)[0].peer_id == "live"
        remote.unregister("respanning")
        fault_free = client().generate(PROMPT, NEW_TOKENS,
                                       sampling=SamplingParams(*GREEDY)).tokens
        assert got == fault_free
        respanning.executor = live_ex          # swapped in: it serves again
        assert c.transport.call("respanning", req, SOCKET_TIMEOUT_S).token_id is not None
    finally:
        for tx in transports:
            tx.close()
        for srv in servers:
            srv.stop()
        reg_srv.stop()


def test_local_mode_with_load_balancing_matches_jax(monkeypatch, weights):
    """``--mode local --use_load_balancing``: 3 elastic servers over the
    blocks past ``--splits`` (the same spans as JAX's) and a module-routed
    client with the JAX package's tokens."""
    jcfg, jp, tcfg, tp = weights
    argv = ["--mode", "local", "--use_load_balancing", "--splits", "2,4,6", "--seed", "0"]
    jgen, _ = jax_mode_generate(monkeypatch, argv, jcfg, jp)
    client, servers = tmain.build_local_swarm(port_args(argv), tcfg, tp)
    assert [(s.spec.start, s.spec.end) for s in servers] == [(2, 4), (4, 6), (6, 8)]
    assert client.use_module_routing and client.registry.ttl == float("inf")
    jres = jgen(PROMPT, NEW_TOKENS, sampling=JSamplingParams(*GREEDY))
    tres = client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY))
    assert tres.tokens == jres.tokens


# ---------------------------------------------------------------------------
# --mode status
# ---------------------------------------------------------------------------

def _dead_address():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def _status_records(case):
    """The records of each case of the JAX CLI's status tests."""
    if case == "covered":
        return [dict(peer_id="a", start_block=0, end_block=4, throughput=2.0,
                     next_server_rtts={"b": 0.012}),
                dict(peer_id="b", start_block=4, end_block=8, final_stage=True)]
    if case in ("uncovered", "no_final"):
        return [dict(peer_id="a", start_block=0, end_block=4, throughput=2.0,
                     next_server_rtts={"b": 0.012})]
    if case == "unreachable":
        return [dict(peer_id="dead-peer", start_block=0, end_block=8, final_stage=True,
                     address=_dead_address())]
    return []


STATUS_CASES = {"covered": (["--total_blocks", "8"], 0, ["2 live server(s)", "[0,8)x1",
                                                       "b:12.0ms"]),
                "uncovered": (["--total_blocks", "8"], 2, ["UNCOVERED"]),
                "no_final": ([], 2, ["no live FINAL-stage server", "inferred"]),
                "unreachable": (["--total_blocks", "8"], 2, []),
                "empty": ([], 1, ["no live servers"]),
                "client_local": (["--total_blocks", "8", "--splits", "2"], 2,
                                 ["[0,2) client-local; [2,4)x1, [4,8)x0  <-- UNCOVERED"])}


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_status_mode_prints_and_exits_as_the_jax_cli(capsys, case):
    """The port's ``--mode status`` and the JAX package's on one registry
    service: the same coverage line, the same exit code, the lines
    tests/test_cli.py expects of the JAX CLI, and an unreachable server
    named on stderr."""
    argv_extra, want_rc, want_lines = STATUS_CASES[case]
    reg = tnet.RegistryServer(port=0)
    reg.start()
    try:
        remote = tnet.RemoteRegistry(reg.address)
        for rec in _status_records("uncovered" if case == "client_local" else case):
            remote.register(ServerRecord(**rec))
        argv = ["--mode", "status", "--registry_addr", reg.address, *argv_extra]
        rc = tmain.main(argv)
        tout = capsys.readouterr()
        jrc = jmain.main(argv)
        jout = capsys.readouterr()
    finally:
        reg.stop()
    assert rc == jrc == want_rc
    for line in want_lines:
        assert line in tout.out
    cov = [line for line in tout.out.splitlines() if line.startswith("coverage:")]
    assert cov == [line for line in jout.out.splitlines() if line.startswith("coverage:")]
    if case == "unreachable":
        assert "dead-peer" in tout.err and "unreachable" in tout.err
