"""Server-to-server push chains of the port, against the JAX package's.

With ``use_push_chain`` the client makes one call a step, to the route's
first hop, naming the others in ``next_servers``; each server hands its
output to the next hop and relays the final token back. Held to the
reference's ``tests/test_push_chain.py``: tokens equal to the per-hop walk
and to the JAX package's chain on the same bridged weights (greedy and
seeded sampled), one client call a step, a killed downstream peer blamed
(not the entry hop) and the chain replayed onto its replica, a transient
failure with no replica recovered, the chain over TCP at wire f32 and
bf16 (and through a JAX server in the middle), the sampled stream window
(the first hop appends the token sampled downstream), and a chain through
batched servers, which relay above their engine.

Tiny llama (``tests/_torch_port_helpers.py``), 4 layers: stage 0 in the
client, stages 1-3 one layer each. Tolerance: none, tokens are compared
for equality (the two frameworks agree to float32 rounding on these
weights, ``test_torch_pipeline.py``).
"""

import random

import pytest

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    jax_params,
    one_torch_thread,
    port_args,
    port_cfg,
    tiny_llama_j,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    parse_splits as jparse_splits,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    slice_stage_params as jslice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    net as jnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
    PipelineClient as JPipelineClient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
    make_server_record as jmake_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.transport import (
    LocalTransport as JLocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling.registry import (
    PlacementRegistry as JPlacementRegistry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
    parse_splits,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    batching as tbatching,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    net as tnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    PipelineClient,
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)

SPLITS = "1,2,3"
PROMPT = [101, 7, 300, 45, 2]
NEW_TOKENS = 8
GREEDY = (0.0, 0.9, 50, 1.5)
# A repetition penalty strong enough that a frozen stream window shows.
SAMPLED = (0.8, 0.95, 50, 1.6)
KNOBS = {"greedy": GREEDY, "sampled": SAMPLED}
REQUEST_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


def jax_local_chain(weights, knobs, n=NEW_TOKENS):
    """The JAX package's push chain over its LocalTransport."""
    jcfg, jp, _, _ = weights
    plan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
    transport = JLocalTransport()
    registry = JPlacementRegistry(rng=random.Random(0))
    for spec in plan.stages[1:]:
        peer = f"j-s{spec.index}"
        transport.add_peer(peer, JStageExecutor(
            jcfg, spec, jslice_stage_params(jcfg, jp, spec), peer_id=peer))
        registry.register(jmake_server_record(peer, spec))
    stage0 = JStageExecutor(jcfg, plan.stages[0],
                            jslice_stage_params(jcfg, jp, plan.stages[0]),
                            peer_id="client-local")
    client = JPipelineClient(jcfg, plan, stage0, transport, registry,
                             settle_seconds=0.0, seed=0, use_push_chain=True)
    return client.generate(PROMPT, n, sampling=JSamplingParams(*knobs)).tokens


@pytest.fixture(scope="module")
def references(weights):
    """The JAX package's chain tokens and the port's per-hop walk's, greedy
    and seeded sampled (the per-hop walk is the port's own baseline)."""
    _, _, tcfg, tp = weights
    ref = {}
    for kind, knobs in KNOBS.items():
        ref[f"jax_{kind}"] = jax_local_chain(weights, knobs)
        client, _ = build_port_cluster(tcfg, tp, SPLITS)
        ref[f"per_hop_{kind}"] = client.generate(PROMPT, NEW_TOKENS,
                                                 sampling=SamplingParams(*knobs)).tokens
    return ref


def chain_cluster(weights, replicas=1):
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS, replicas=replicas)
    client.use_push_chain = True
    return client, transport


@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_chain_matches_per_hop_walk_and_jax(weights, references, kind):
    client, _ = chain_cluster(weights)
    res = client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*KNOBS[kind]))
    assert len(res.tokens) == NEW_TOKENS
    assert res.tokens == references[f"per_hop_{kind}"] == references[f"jax_{kind}"]
    # One chain timing, not one a hop.
    assert set(client.last_prefill_stage_times) == {client.CHAIN_KEY}


def test_chain_makes_one_client_call_a_step(weights):
    client, transport = chain_cluster(weights)
    entry_calls = []
    # The transport recurses down the chain; the client's own calls are the
    # ones that still name both downstream hops.
    transport.on_call = lambda peer, req: (len(req.next_servers) == 2
                                           and entry_calls.append(peer))
    res = client.generate(PROMPT, 4, sampling=SamplingParams(*GREEDY))
    assert len(res.tokens) == 4
    assert len(entry_calls) == 4          # the prefill and 3 decode steps
    assert set(entry_calls) == {"peer-s1-r0"}


def test_chain_failover_blames_the_downstream_peer_and_replays(weights, references):
    """The middle hop killed after its 3rd decode step: the chain error
    blacklists it, not the entry hop, and the whole chain is replayed onto
    the replica with the fault-free tokens."""
    client, transport = chain_cluster(weights, replicas=2)
    seen, killed = [0], {}

    def on_call(peer, req):
        if not req.is_prefill and not req.is_replay and "-s2-" in peer:
            seen[0] += 1
            killed.setdefault("peer", peer)
            if seen[0] == 3:
                transport.kill(peer)

    transport.on_call = on_call
    res = client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY))
    assert res.tokens == references["per_hop_greedy"]
    assert client.recoveries >= 1
    assert killed["peer"] in client.failed_peers.get("stage2", set())
    assert not {p for p in transport.peers() if "-s1-" in p} & client.failed_peers.get(
        "stage1", set())


def test_chain_transient_failure_without_replicas_recovers(weights, references):
    """One flake with no spare replica: the amnesty retries the same peer,
    and the client is healthy for the next generation."""
    client, transport = chain_cluster(weights)
    transport.fail_next("peer-s2-r0", 1)
    res = client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY))
    assert res.tokens == references["per_hop_greedy"]
    assert client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY)).tokens == \
        references["per_hop_greedy"]


class TcpSwarm:
    """Stage servers of either package behind TCP (``pkgs[i]`` serves stage
    i + 1; ``batched`` puts the port's stages on batched engines; each
    server's default wire dtype `server_wire`, else the clients'), and
    clients of either package over one PlacementRegistry."""

    def __init__(self, weights, wire_dtype, pkgs=("port", "port", "port"), batched=False,
                 server_wire=None):
        jcfg, jp, tcfg, tp = weights
        self.weights, self.wire_dtype = weights, wire_dtype
        self.registry = PlacementRegistry(rng=random.Random(0))
        self.jregistry = JPlacementRegistry(rng=random.Random(0))
        self.servers = []
        self.transports = []
        jplan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
        tplan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
        args = port_args([])
        server_wire = server_wire or wire_dtype
        for index, pkg in enumerate(pkgs, start=1):
            peer = f"{pkg}-s{index}"
            if pkg == "jax":
                spec = jplan.stages[index]
                srv = jnet.TcpStageServer(JStageExecutor(
                    jcfg, spec, jslice_stage_params(jcfg, jp, spec), peer_id=peer),
                    wire_dtype=server_wire)
            elif batched:
                spec = tplan.stages[index]
                engine = tbatching.BatchedStageExecutor(
                    tcfg, spec, tmain._stage_params(args, tcfg, tp, spec), slots=2,
                    max_len=64, device="cpu")
                srv = tnet.TcpStageServer(tbatching.BatchingStageAdapter(
                    engine, peer_id=peer, window_s=0.0), None, wire_dtype=server_wire)
            else:
                spec = tplan.stages[index]
                srv = tnet.TcpStageServer(StageExecutor(
                    tcfg, spec, tmain._stage_params(args, tcfg, tp, spec), peer_id=peer,
                    device="cpu"), StageRuntime(), wire_dtype=server_wire)
            srv.start()
            self.servers.append(srv)
            engine_tag = "batched" if batched and pkg == "port" else "session"
            for reg, mk in ((self.registry, make_server_record),
                            (self.jregistry, jmake_server_record)):
                rec = mk(peer, tplan.stages[index], engine=engine_tag)
                rec.address = srv.address
                reg.register(rec)

    def client(self, pkg, chain):
        jcfg, jp, tcfg, tp = self.weights
        if pkg == "jax":
            transport = jnet.TcpTransport(self.jregistry, wire_dtype=self.wire_dtype)
            plan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
            stage0 = JStageExecutor(jcfg, plan.stages[0],
                                    jslice_stage_params(jcfg, jp, plan.stages[0]),
                                    peer_id="client-local")
            client = JPipelineClient(jcfg, plan, stage0, transport, self.jregistry,
                                     settle_seconds=0.0, seed=0, use_push_chain=chain,
                                     request_timeout=REQUEST_TIMEOUT_S)
        else:
            transport = tnet.TcpTransport(self.registry, wire_dtype=self.wire_dtype)
            plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
            stage0 = StageExecutor(tcfg, plan.stages[0],
                                   tmain._stage_params(port_args([]), tcfg, tp, plan.stages[0]),
                                   peer_id="client-local", device="cpu")
            client = PipelineClient(tcfg, plan, stage0, transport, self.registry,
                                    settle_seconds=0.0, seed=0, use_push_chain=chain,
                                    request_timeout=REQUEST_TIMEOUT_S)
        self.transports.append(transport)
        return client

    def stop(self):
        for t in self.transports:
            t.close()
        for srv in self.servers:
            srv.stop()


def counted(transport):
    """Count the client's own calls on `transport`, by peer."""
    calls = []
    call = transport.call

    def wrapped(peer_id, req, timeout=None):
        calls.append(peer_id)
        return call(peer_id, req, timeout)

    transport.call = wrapped
    return calls


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16"])
def test_chain_over_tcp_matches_the_per_hop_walk(weights, references, wire_dtype):
    """Servers whose default wire dtype is f32, clients at `wire_dtype`: a
    chain hop hands the next one what the per-hop walk would, the
    activation at the client's precision."""
    swarm = TcpSwarm(weights, wire_dtype, server_wire="f32")
    try:
        per_hop = swarm.client("port", chain=False).generate(
            PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY)).tokens
        chain = swarm.client("port", chain=True)
        calls = counted(chain.transport)
        tokens = chain.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY)).tokens
    finally:
        swarm.stop()
    assert tokens == per_hop
    if wire_dtype == "f32":
        assert tokens == references["per_hop_greedy"] == references["jax_greedy"]
    # One client call a step, each to the first hop.
    assert calls == ["port-s1"] * NEW_TOKENS


@pytest.mark.parametrize("client_pkg,stage2_pkg", [("port", "jax"), ("jax", "port")])
def test_chain_crosses_packages(weights, references, client_pkg, stage2_pkg):
    """A JAX server pushes to the port's and the port's to JAX's: the
    push frames are the reference's."""
    pkgs = ("port", stage2_pkg, "port") if client_pkg == "port" else ("jax", stage2_pkg, "jax")
    swarm = TcpSwarm(weights, "f32", pkgs=pkgs)
    try:
        client = swarm.client(client_pkg, chain=True)
        knobs = GREEDY
        sp = (SamplingParams if client_pkg == "port" else JSamplingParams)(*knobs)
        tokens = client.generate(PROMPT, NEW_TOKENS, sampling=sp).tokens
    finally:
        swarm.stop()
    assert tokens == references["jax_greedy"]


def test_chain_over_tcp_sampled_stream_window(weights, references):
    """Seeded sampling with a repetition penalty over a streamed chain: the
    first hop appends the token sampled downstream to its stream's window,
    or the last stage's penalty would see the window of stream_open."""
    swarm = TcpSwarm(weights, "f32")
    try:
        tokens = swarm.client("port", chain=True).generate(
            PROMPT, NEW_TOKENS, sampling=SamplingParams(*SAMPLED)).tokens
        first = swarm.servers[0]
        assert first.stream_opens >= 1 and first.stream_steps >= NEW_TOKENS - 1
    finally:
        swarm.stop()
    assert tokens == references["per_hop_sampled"] == references["jax_sampled"]


def test_chain_through_batched_servers(weights, references):
    """Batched servers relay above their engine: the chain's tokens equal
    the session engines' per-hop walk."""
    swarm = TcpSwarm(weights, "f32", batched=True)
    try:
        chain = swarm.client("port", chain=True)
        calls = counted(chain.transport)
        tokens = chain.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY)).tokens
    finally:
        swarm.stop()
    assert tokens == references["per_hop_greedy"]
    assert calls == ["port-s1"] * NEW_TOKENS


def test_concurrent_chains_share_the_pooled_relay(weights, references):
    """Eight chain sessions at once on one swarm: every hop's pooled
    connection to the next is shared by the handler threads under its lock
    (a frame interleaved with another would corrupt both), with a short
    switch interval to shuffle the threads."""
    import sys
    import threading

    swarm = TcpSwarm(weights, "f32")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = {}, {}
    try:
        clients = [swarm.client("port", chain=True) for _ in range(8)]

        def run(i):
            try:
                got[i] = clients[i].generate(PROMPT, NEW_TOKENS,
                                             sampling=SamplingParams(*GREEDY)).tokens
            except Exception as exc:      # surfaced below
                errors[i] = exc

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(clients))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        swarm.stop()
    assert not errors
    assert got == {i: references["per_hop_greedy"] for i in range(8)}
