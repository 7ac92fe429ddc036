"""The port's NAT relay plane, against the JAX package's.

A server that fails the dial-back vote attaches to a reachable volunteer
and serves through it: clients dial the volunteer and stamp every frame
``relay_to``; the volunteer forwards it verbatim over a pooled circuit.
Held to the reference's ``tests/test_relay.py``: a relay-only server
serving a generation with the JAX package's tokens (provably through the
volunteer: its advertised address is a closed port), shedding by a
saturated volunteer, failover when the volunteer dies mid-generation (the
breaker blames the volunteer, not the peer behind it), the relayed record
found again through a gossip mirror with every registry down, the
``breaker_peer`` blame of push frames and of the client's recovery path,
and a JAX volunteer relaying for a port server and the reverse.

Tiny llama (``tests/_torch_port_helpers.py``), 4 layers in 2 stages:
stage 0 in the client, the NAT'd server on [2, 4). Tolerance: none,
tokens are compared for equality.
"""

import random

import numpy as np
import pytest
import torch

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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling.gossip import (
    GossipNode as JGossipNode,
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
    net as tnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    PipelineClient,
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    PeerUnavailable,
    PushChainError,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.gossip import (
    GossipNode,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
    ServerRecord,
    rec_to_dict,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    events,
)

SPLITS = "2"
PROMPT = [101, 7, 300, 45]
NEW_TOKENS = 6
GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.7, 0.9, 50, 1.5)
# Nothing listens here: a direct dial fails at once (the NAT model of these
# tests), so a generation that completes rode the relay.
UNROUTABLE = "127.0.0.1:9"


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


@pytest.fixture(scope="module")
def references(weights):
    """The port's in-process tokens, greedy and seeded sampled; the
    relay tests that cross packages add the JAX package's."""
    _, _, tcfg, tp = weights
    client, _ = build_port_cluster(tcfg, tp, SPLITS)
    return {kind: client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*knobs)).tokens
            for kind, knobs in (("greedy", GREEDY), ("sampled", SAMPLED))}


def volunteer(pkg, peer_id, capacity, registry, **kw):
    """A relay volunteer of either package: an executor-less stage server
    and its empty-span record."""
    if pkg == "jax":
        srv = jnet.TcpStageServer(None, wire_dtype="f32", peer_id=peer_id,
                                  relay_capacity=capacity, **kw)
    else:
        srv = tnet.TcpStageServer(None, None, wire_dtype="f32", peer_id=peer_id,
                                  relay_capacity=capacity, **kw)
    srv.start()
    rec = ServerRecord(peer_id=peer_id, start_block=0, end_block=0, address=srv.address,
                       relay_capacity=capacity)
    registry.register(rec)
    return srv, rec


def nat_stage(weights, pkg, peer_id, registry):
    """A stage-1 server of either package that binds locally and
    advertises an address nothing can dial."""
    jcfg, jp, tcfg, tp = weights
    if pkg == "jax":
        spec = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS)).stages[1]
        srv = jnet.TcpStageServer(JStageExecutor(
            jcfg, spec, jslice_stage_params(jcfg, jp, spec), peer_id=peer_id), wire_dtype="f32")
    else:
        spec = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS)).stages[1]
        srv = tnet.TcpStageServer(StageExecutor(
            tcfg, spec, tmain._stage_params(port_args([]), tcfg, tp, spec), peer_id=peer_id,
            device="cpu"), StageRuntime(), wire_dtype="f32")
    srv.start()
    rec = make_server_record(peer_id, StagePlan.from_splits(
        tcfg.num_layers, parse_splits(SPLITS)).stages[1])
    rec.address = UNROUTABLE
    registry.register(rec)
    return srv, rec


def port_client(weights, transport, registry, **kw):
    _, _, tcfg, tp = weights
    plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
    stage0 = StageExecutor(tcfg, plan.stages[0],
                           tmain._stage_params(port_args([]), tcfg, tp, plan.stages[0]),
                           peer_id="client-local", device="cpu")
    return PipelineClient(tcfg, plan, stage0, transport, registry, settle_seconds=0.0,
                          seed=0, **kw)


def jax_client(weights, transport, registry):
    jcfg, jp, _, _ = weights
    plan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
    stage0 = JStageExecutor(jcfg, plan.stages[0],
                            jslice_stage_params(jcfg, jp, plan.stages[0]),
                            peer_id="client-local")
    return JPipelineClient(jcfg, plan, stage0, transport, registry, settle_seconds=0.0, seed=0)


def test_relay_only_server_serves_end_to_end(weights, references):
    """The dial-back vote fails, the server attaches to the volunteer and
    serves greedy and seeded sampled generations with the in-process
    tokens, through the volunteer (its own address is a closed port)."""
    registry = PlacementRegistry(rng=random.Random(0))
    vsrv, _ = volunteer("port", "vol-1", 2, registry)
    nsrv, nrec = nat_stage(weights, "port", "nat-s1", registry)
    transport = tnet.TcpTransport(registry, wire_dtype="f32")
    try:
        assert tnet.check_direct_reachability(transport, registry, UNROUTABLE) is False
        assert tnet.check_direct_reachability(transport, registry, nsrv.address) is True
        got = tnet.attach_via_relay(transport, registry, "nat-s1", nsrv.address)
        assert got is not None and got["relay"] == "vol-1"
        assert got["ttl"] == tnet.TcpStageServer.RELAY_CIRCUIT_TTL
        nrec.relay_via = "vol-1"
        registry.register(nrec)
        assert "nat-s1" in vsrv._relay_targets
        client = port_client(weights, transport, registry)
        for kind, knobs in (("greedy", GREEDY), ("sampled", SAMPLED)):
            res = client.generate(PROMPT, NEW_TOKENS, sampling=SamplingParams(*knobs))
            assert res.tokens == references[kind]
        assert nsrv.request_log.tail(1)      # the NAT'd server did the work
    finally:
        transport.close()
        vsrv.stop()
        nsrv.stop()


def test_relay_attach_sheds_when_saturated():
    """A saturated volunteer refuses a new circuit (PeerUnavailable), renews
    an existing one, and the picker moves the newcomer to a spare one."""
    registry = PlacementRegistry(rng=random.Random(0))
    v1, _ = volunteer("port", "vol-1", 2, registry)
    v2, _ = volunteer("port", "vol-2", 1, registry)
    transport = tnet.TcpTransport(registry, wire_dtype="f32")
    try:
        for peer in ("p1", "p2"):
            assert tnet.attach_via_relay(transport, registry, peer,
                                         "127.0.0.1:5001")["relay"] == "vol-1"
        with pytest.raises(PeerUnavailable, match="capacity"):
            transport.relay_attach("vol-1", "p3", "127.0.0.1:5003")
        transport.relay_attach("vol-1", "p1", "127.0.0.1:5001")
        assert tnet.attach_via_relay(transport, registry, "p3",
                                     "127.0.0.1:5003")["relay"] == "vol-2"
    finally:
        transport.close()
        v1.stop()
        v2.stop()


def test_relay_failover_when_the_volunteer_dies(weights, references):
    """The volunteer stopped two steps in: the NAT'd server re-attaches to
    the standby, the client fails over with the fault-free tokens, and the
    breaker blames the dead volunteer, never the relayed peer."""
    events.get_recorder().enable()
    events.get_recorder().clear()
    registry = PlacementRegistry(rng=random.Random(0))
    v1, _ = volunteer("port", "vol-1", 2, registry)
    v2, _ = volunteer("port", "vol-2", 1, registry)
    nsrv, nrec = nat_stage(weights, "port", "nat-s1", registry)
    transport = tnet.TcpTransport(registry, wire_dtype="f32")
    try:
        assert tnet.attach_via_relay(transport, registry, "nat-s1",
                                     nsrv.address)["relay"] == "vol-1"
        nrec.relay_via = "vol-1"
        registry.register(nrec)
        client = port_client(weights, transport, registry)
        got = []
        for i, step in enumerate(client.generate_stepwise(
                PROMPT, NEW_TOKENS, sampling=SamplingParams(*GREEDY))):
            got.extend(step.new_tokens)
            if i == 1:
                v1.stop()
                again = tnet.attach_via_relay(transport, registry, "nat-s1", nsrv.address,
                                              exclude=("vol-1",))
                assert again is not None and again["relay"] == "vol-2"
                nrec.relay_via = "vol-2"
                registry.register(nrec)
        assert got == references["greedy"]
        assert client.recoveries >= 1
        assert (client.breaker._peers.get("vol-1", {}).get("fails", 0) >= 1
                or client.breaker.state("vol-1") != "closed")
        assert client.breaker._peers.get("nat-s1", {}).get("fails", 0) == 0
        assert client.breaker.allow("nat-s1")
        assert "relay_forward_error" in [e.name for e in events.get_recorder().events()]
    finally:
        events.get_recorder().disable()
        events.get_recorder().clear()
        transport.close()
        for s in (v1, v2, nsrv):
            s.stop()


def test_relayed_record_found_through_gossip_after_seed_loss(weights, references, tmp_path):
    """The relay_via record is gossip payload: replicated to the
    volunteer's mirror, it serves a fresh client (peers cache, both
    registries down), which generates through the volunteer."""
    cache = str(tmp_path / "peers.json")
    seeds = [tnet.RegistryServer(), tnet.RegistryServer()]
    for s in seeds:
        s.start()
    pair = ",".join(s.address for s in seeds)
    reg1 = tnet.RemoteRegistry(pair, timeout=2.0, peers_cache=cache)
    vnode = GossipNode("vol-1", ttl=60.0, rng=random.Random(0))
    vsrv = tnet.TcpStageServer(None, None, wire_dtype="f32", peer_id="vol-1", gossip=vnode,
                               relay_capacity=2)
    vsrv.start()
    vnode.self_address = vsrv.address
    vrec = ServerRecord(peer_id="vol-1", start_block=0, end_block=0, address=vsrv.address,
                        relay_capacity=2)
    vnode.publish(rec_to_dict(vrec))
    reg1.register(vrec)
    nsrv, nrec = nat_stage(weights, "port", "nat-s1", reg1)
    transport = tnet.TcpTransport(reg1, wire_dtype="f32")
    tx2 = None
    try:
        assert tnet.attach_via_relay(transport, reg1, "nat-s1", nsrv.address)["relay"] == "vol-1"
        nrec.relay_via = "vol-1"
        reg1.register(nrec)
        nnode = GossipNode("nat-s1", ttl=60.0, rng=random.Random(1))
        nnode.publish(rec_to_dict(nrec))
        tnet.gossip_exchange(nnode, vsrv.address)
        reg1.live_servers()                  # writes the peers cache
        for s in seeds:
            s.stop()
        reg2 = tnet.RemoteRegistry(pair, timeout=0.5, peers_cache=cache)
        recs = {r.peer_id: r for r in reg2.live_servers()}
        assert recs["nat-s1"].relay_via == "vol-1"
        tx2 = tnet.TcpTransport(reg2, wire_dtype="f32")
        res = port_client(weights, tx2, reg2).generate(PROMPT, NEW_TOKENS,
                                                        sampling=SamplingParams(*GREEDY))
        assert res.tokens == references["greedy"]
    finally:
        transport.close()
        if tx2 is not None:
            tx2.close()
        vsrv.stop()
        nsrv.stop()
        for s in seeds:
            s.stop()


def test_push_error_frame_carries_breaker_peer():
    """kind="push" error frames split routing blame (``peer``) from the
    breaker's (``breaker_peer``), as the JAX transport maps them."""
    for transport, err in ((tnet.TcpTransport(PlacementRegistry()), PushChainError),
                           (jnet.TcpTransport(PlacementRegistry()), Exception)):
        frame = {"verb": "error", "kind": "push", "peer": "tgt", "breaker_peer": "vol-1",
                 "message": "relay died"}
        with pytest.raises(err) as ei:
            transport._parse_response("entry", frame, b"")
        assert (ei.value.peer_id, ei.value.breaker_peer_id) == ("tgt", "vol-1")
        frame.pop("breaker_peer")
        with pytest.raises(err) as ei:
            transport._parse_response("entry", frame, b"")
        assert (ei.value.peer_id, ei.value.breaker_peer_id) == ("tgt", None)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_push_chain_blames_the_volunteer_only_when_it_is_dead(weights, pkg):
    """A pushing server (either package) that cannot dial the next hop's
    volunteer blames the volunteer for the breaker and the hop for
    routing; a live volunteer without the circuit blames the hop alone."""
    _, _, tcfg, tp = weights
    spec = StagePlan.from_splits(tcfg.num_layers, parse_splits("1,2")).stages[1]
    registry = PlacementRegistry(rng=random.Random(0))
    if pkg == "jax":
        jcfg, jp = weights[0], weights[1]
        jspec = JStagePlan.from_splits(jcfg.num_layers, jparse_splits("1,2")).stages[1]
        s1 = jnet.TcpStageServer(JStageExecutor(
            jcfg, jspec, jslice_stage_params(jcfg, jp, jspec), peer_id="entry-s1"),
            wire_dtype="f32")
    else:
        s1 = tnet.TcpStageServer(StageExecutor(
            tcfg, spec, tmain._stage_params(port_args([]), tcfg, tp, spec),
            peer_id="entry-s1", device="cpu"), StageRuntime(), wire_dtype="f32")
    s1.start()
    rec = make_server_record("entry-s1", spec)
    rec.address = s1.address
    registry.register(rec)
    vsrv, _ = volunteer("port", "vol-1", 2, registry)
    transport = tnet.TcpTransport(registry, wire_dtype="f32")

    def req(nxt):
        return StageRequest(session_id=f"blame-{nxt['relay_via']}",
                            hidden=torch.zeros(1, 3, tcfg.hidden_size), seq_len=3, cur_len=0,
                            is_prefill=True, max_length=16, start_block=spec.start,
                            end_block=spec.end, next_servers=(nxt,))

    try:
        with pytest.raises(PushChainError) as ei:
            transport.call("entry-s1", req({"peer_id": "tgt", "relay_via": "vol-dead",
                                            "address": UNROUTABLE, "start_block": spec.end,
                                            "end_block": tcfg.num_layers}))
        assert (ei.value.peer_id, ei.value.breaker_peer_id) == ("tgt", "vol-dead")
        with pytest.raises(PushChainError) as ei:
            transport.call("entry-s1", req({"peer_id": "tgt", "relay_via": "vol-1",
                                            "address": vsrv.address, "start_block": spec.end,
                                            "end_block": tcfg.num_layers}))
        assert (ei.value.peer_id, ei.value.breaker_peer_id) == ("tgt", None)
    finally:
        transport.close()
        s1.stop()
        vsrv.stop()


def test_client_breaker_blames_breaker_peer_id_not_the_hop(weights, references):
    """A retryable failure carrying ``breaker_peer_id`` feeds that peer's
    breaker; without it the hop takes the blame."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    blamed, fired = [], {"relay": False, "plain": False}
    record = client.breaker.record_failure
    client.breaker.record_failure = lambda peer: (blamed.append(peer), record(peer))[1]
    call = transport.call

    def fail_once(which, breaker_peer):
        def wrapped(peer_id, req, timeout=None):
            if not fired[which]:
                fired[which] = True
                exc = PeerUnavailable(f"{which} failure")
                if breaker_peer:
                    exc.breaker_peer_id = breaker_peer
                raise exc
            return call(peer_id, req, timeout)
        return wrapped

    transport.call = fail_once("relay", "vol-1")
    assert client.generate(PROMPT, 4, sampling=SamplingParams(*GREEDY)).tokens == \
        references["greedy"][:4]
    assert blamed == ["vol-1"]
    transport.call = fail_once("plain", None)
    assert client.generate(PROMPT, 4, sampling=SamplingParams(*GREEDY)).tokens == \
        references["greedy"][:4]
    assert blamed == ["vol-1", "peer-s1-r0"]


@pytest.mark.parametrize("volunteer_pkg,stage_pkg,client_pkg",
                         [("jax", "port", "port"), ("port", "jax", "jax")])
def test_relay_crosses_packages(weights, references, volunteer_pkg, stage_pkg, client_pkg):
    """A JAX volunteer relays for a port server (to a port client), and a
    port volunteer for a JAX server (to a JAX client): the relay frames and
    the attach verb are the reference's."""
    registry = PlacementRegistry(rng=random.Random(0))
    vsrv, _ = volunteer(volunteer_pkg, "vol-1", 2, registry)
    nsrv, nrec = nat_stage(weights, stage_pkg, "nat-s1", registry)
    net = tnet if stage_pkg == "port" else jnet
    tx = (tnet if client_pkg == "port" else jnet).TcpTransport(registry, wire_dtype="f32")
    # The NAT'd server's own side of the join, with its package's functions.
    stx = net.TcpTransport(registry, wire_dtype="f32")
    try:
        assert net.check_direct_reachability(stx, registry, UNROUTABLE) is False
        assert net.attach_via_relay(stx, registry, "nat-s1", nsrv.address)["relay"] == "vol-1"
        nrec.relay_via = "vol-1"
        registry.register(nrec)
        if client_pkg == "port":
            client, sp = port_client(weights, tx, registry), SamplingParams(*SAMPLED)
        else:
            client, sp = jax_client(weights, tx, registry), JSamplingParams(*SAMPLED)
        assert client.generate(PROMPT, NEW_TOKENS, sampling=sp).tokens == references["sampled"]
        assert client.generate(PROMPT, NEW_TOKENS, sampling=(
            SamplingParams if client_pkg == "port" else JSamplingParams)(*GREEDY)).tokens == \
            references["greedy"]
    finally:
        tx.close()
        stx.close()
        vsrv.stop()
        nsrv.stop()


def test_jax_gossip_node_replicates_relay_via():
    """The record schema crosses packages: a JAX node's relay_via record,
    gossiped into a port mirror, keeps its relay fields."""
    node = GossipNode("mirror", ttl=30.0, rng=random.Random(0))
    srv = tnet.TcpStageServer(None, None, wire_dtype="f32", peer_id="mirror", gossip=node)
    srv.start()
    try:
        jnode = JGossipNode("nat-s1", ttl=30.0, rng=random.Random(1))
        jnode.publish({"peer_id": "nat-s1", "start_block": 2, "end_block": 4,
                       "address": UNROUTABLE, "relay_via": "vol-1", "relay_capacity": None,
                       "final_stage": True, "stage_index": 1})
        jnet.gossip_exchange(jnode, srv.address)
        (rec,) = node.live_servers()
        assert (rec.peer_id, rec.relay_via, rec.address) == ("nat-s1", "vol-1", UNROUTABLE)
    finally:
        srv.stop()


def test_relay_forward_needs_no_executor_and_decodes_nothing(weights):
    """The volunteer forwards bytes: an executor-less port volunteer relays
    a classic forward frame (a CPU numpy payload) unchanged, and counts it
    in ``relay_forwarded_total``."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
        telemetry as ttel,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
        catalog,
    )

    ttel.enable()
    try:
        registry = PlacementRegistry(rng=random.Random(0))
        vsrv, _ = volunteer("port", "vol-1", 1, registry)
        nsrv, nrec = nat_stage(weights, "port", "nat-s1", registry)
        tx = tnet.TcpTransport(registry, wire_dtype="f32")
        try:
            tnet.attach_via_relay(tx, registry, "nat-s1", nsrv.address)
            nrec.relay_via = "vol-1"
            registry.register(nrec)
            fwd = catalog.get("relay_forwarded_total")
            before = fwd.labels(outcome="ok").value
            info = tx.info("nat-s1")
            assert info["peer_id"] == "nat-s1" and info["start_block"] == 2
            hidden = np.random.default_rng(0).standard_normal((1, 2, 256)).astype(np.float32)
            resp = tx.call("nat-s1", StageRequest(
                session_id="r", hidden=torch.from_numpy(hidden), seq_len=2, cur_len=0,
                is_prefill=True, is_replay=True, max_length=8, start_block=2, end_block=4))
            assert resp.token_id is not None
            assert fwd.labels(outcome="ok").value - before == 2
        finally:
            tx.close()
            vsrv.stop()
            nsrv.stop()
    finally:
        ttel.disable()
