"""The port's swarm over TCP on loopback, against its own in-process
cluster and against the JAX package's swarm on the same bridged weights.

Tiny llama (``tests/_torch_port_helpers.py``), 4 layers in 4 stages: stage 0
in the client, stages 1-3 one layer each behind a ``TcpStageServer``
(port servers run their compute on a ``StageRuntime`` thread), discovered
through a ``RegistryServer``. Greedy and seeded sampled tokens of a port
client with port servers equal the port's ``--mode local`` and the JAX
package's TCP swarm at wire ``f32`` and ``bf16``; mixed chains (a JAX
client with the port's stage-2 server, a port client with JAX's) give the
same tokens, so streams interoperate. Failover onto a replica, the
``info`` / ``reach_check`` / ``end_session`` verbs, refusals (a step
without ``stream_open``, a request field the port does not implement, a
verb it does not serve, a CLI flag it does not port, a spent deadline, a
model mismatch), the registry service, and the CLI swarm as processes.

Tolerance: none. Tokens are compared for equality: the two frameworks
agree to float32 rounding on these weights (``test_torch_pipeline.py``)
and the wire codec is bit-equal (``test_torch_net.py``). Every socket has
a timeout (``REQUEST_TIMEOUT_S``).
"""

import dataclasses
import json
import os
import pathlib
import random
import re
import select
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    telemetry as ttel,
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
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.server import (
    FixedStageServer,
    _pinger_from_transport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    DeadlineExceeded,
    LocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    ServerRecord,
)

SPLITS = "1,2,3"
PROMPT = [101, 7, 300, 45, 2, 411, 19]
NEW_TOKENS = 8
REQUEST_TIMEOUT_S = 60.0
SOCKET_TIMEOUT_S = 10.0
GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.7, 0.9, 50, 1.5)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


class Swarm:
    """A port registry service and TCP stage servers of either package:
    ``layout`` maps a stage index to the packages of its replicas (peer ids
    ``{pkg}-s{stage}-r{replica}``). `stop()` tears everything down."""

    def __init__(self, weights, layout, wire_dtype):
        jcfg, jp, tcfg, tp = weights
        self.weights, self.wire_dtype = weights, wire_dtype
        self.registry_srv = tnet.RegistryServer()
        self.registry_srv.start()
        self.address = self.registry_srv.address
        self.servers = {}
        self.transports = []
        jplan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
        tplan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
        args = port_args([])
        for index, pkgs in layout.items():
            for r, pkg in enumerate(pkgs):
                peer = f"{pkg}-s{index}-r{r}"
                if pkg == "jax":
                    spec = jplan.stages[index]
                    ex = JStageExecutor(jcfg, spec, jslice_stage_params(jcfg, jp, spec),
                                        peer_id=peer)
                    srv = jnet.TcpStageServer(ex, wire_dtype=wire_dtype)
                else:
                    spec = tplan.stages[index]
                    ex = StageExecutor(tcfg, spec, tmain._stage_params(args, tcfg, tp, spec),
                                       peer_id=peer, device="cpu")
                    srv = tnet.TcpStageServer(ex, StageRuntime(), wire_dtype=wire_dtype)
                srv.start()
                self.servers[peer] = srv
                rec = make_server_record(peer, tplan.stages[index])
                rec.address = srv.address
                self.registry_srv.registry.register(rec)

    def client(self, pkg):
        jcfg, jp, tcfg, tp = self.weights
        if pkg == "jax":
            registry = jnet.RemoteRegistry(self.address)
            transport = jnet.TcpTransport(registry, wire_dtype=self.wire_dtype)
            plan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
            stage0 = JStageExecutor(jcfg, plan.stages[0],
                                    jslice_stage_params(jcfg, jp, plan.stages[0]),
                                    peer_id="client-local")
            client = JPipelineClient(jcfg, plan, stage0, transport, registry,
                                     settle_seconds=0.0, seed=0,
                                     request_timeout=REQUEST_TIMEOUT_S)
        else:
            registry = tnet.RemoteRegistry(self.address)
            transport = tnet.TcpTransport(registry, wire_dtype=self.wire_dtype)
            plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
            stage0 = StageExecutor(tcfg, plan.stages[0],
                                   tmain._stage_params(port_args([]), tcfg, tp, plan.stages[0]),
                                   peer_id="client-local", device="cpu")
            client = PipelineClient(tcfg, plan, stage0, transport, registry,
                                    settle_seconds=0.0, seed=0,
                                    request_timeout=REQUEST_TIMEOUT_S)
        self.transports.append(transport)
        return client

    def stop(self):
        for t in self.transports:
            t.close()
        for srv in self.servers.values():
            srv.stop()
        self.registry_srv.stop()


def _generate(client, pkg, knobs, n=NEW_TOKENS):
    sampling = (JSamplingParams if pkg == "jax" else SamplingParams)(*knobs)
    return client.generate(PROMPT, n, sampling=sampling).tokens


def _swarm_tokens(weights, layout, wire_dtype, client_pkg, knobs):
    swarm = Swarm(weights, layout, wire_dtype)
    try:
        return _generate(swarm.client(client_pkg), client_pkg, knobs), swarm
    finally:
        swarm.stop()


ALL = {pkg: {1: [pkg], 2: [pkg], 3: [pkg]} for pkg in ("jax", "port")}


@pytest.fixture(scope="module")
def references(weights):
    """Greedy tokens of the port's --mode local cluster and of the JAX
    package's TCP swarm at each wire dtype, and the seeded sampled ones."""
    _, _, tcfg, tp = weights
    local = build_port_cluster(tcfg, tp, SPLITS)[0]
    ref = {"local": _generate(local, "port", GREEDY),
           "local_sampled": _generate(local, "port", SAMPLED)}
    for wd in ("f32", "bf16"):
        ref[f"jax_{wd}"] = _swarm_tokens(weights, ALL["jax"], wd, "jax", GREEDY)[0]
    ref["jax_sampled"] = _swarm_tokens(weights, ALL["jax"], "f32", "jax", SAMPLED)[0]
    return ref


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16"])
def test_port_swarm_matches_local_and_jax_swarm(weights, references, wire_dtype):
    tokens, _ = _swarm_tokens(weights, ALL["port"], wire_dtype, "port", GREEDY)
    assert len(tokens) == NEW_TOKENS
    assert tokens == references["local"] == references[f"jax_{wire_dtype}"]


def test_seeded_sampled_tokens_equal(weights, references):
    tokens, _ = _swarm_tokens(weights, ALL["port"], "f32", "port", SAMPLED)
    assert tokens == references["local_sampled"] == references["jax_sampled"]


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("client_pkg,stage2_pkg", [("jax", "port"), ("port", "jax")])
def test_mixed_chain(weights, references, wire_dtype, client_pkg, stage2_pkg):
    """One package's client through a chain whose stage-2 server is the
    other package's: the same greedy tokens as either package alone, over
    streams (stream_open once, then steps) on the foreign server."""
    layout = {1: [client_pkg], 2: [stage2_pkg], 3: [client_pkg]}
    tokens, swarm = _swarm_tokens(weights, layout, wire_dtype, client_pkg, GREEDY)
    assert tokens == references[f"jax_{wire_dtype}"] == references["local"]
    foreign = swarm.servers[f"{stage2_pkg}-s2-r0"]
    assert foreign.stream_opens == 1 and foreign.stream_steps == NEW_TOKENS


@pytest.fixture(scope="module")
def weights_bf16():
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg, dtype=jnp.bfloat16)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


@pytest.fixture(scope="module")
def references_bf16(weights_bf16):
    """The JAX-only chain's greedy tokens on the bfloat16 model, per wire
    dtype."""
    return {wd: _swarm_tokens(weights_bf16, ALL["jax"], wd, "jax", GREEDY)[0]
            for wd in ("f32", "bf16")}


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("client_pkg,stage2_pkg", [("jax", "port"), ("port", "jax")])
def test_mixed_chain_bfloat16(weights_bf16, references_bf16, wire_dtype, client_pkg,
                              stage2_pkg):
    """A bfloat16 model: a server computes an arriving activation in the
    float32 the wire decodes to (bf16 weights against float32 activations),
    the reference's engine, and a port executor built without ``act_dtype``
    (as ``--mode serve`` builds it) does the same, so a chain mixing the
    packages gives the JAX-only chain's greedy tokens at either wire."""
    layout = {1: [client_pkg], 2: [stage2_pkg], 3: [client_pkg]}
    tokens, swarm = _swarm_tokens(weights_bf16, layout, wire_dtype, client_pkg, GREEDY)
    assert len(tokens) == NEW_TOKENS
    assert tokens == references_bf16[wire_dtype]
    assert swarm.servers[f"{stage2_pkg}-s2-r0"].stream_steps == NEW_TOKENS


def test_server_span_ends_before_the_encode(weights, monkeypatch):
    """The server_forward span ends at compute completion, before the
    hidden state's host copy and encode (the reference's
    ``net.py:1316-1323``): with every encode slowed by DELAY_S, each server
    span stays shorter than DELAY_S, while the encodes did run."""
    delay_s = 0.25
    encode = tnet._encode_tensor
    encoded = []

    def slow_encode(arr, wire_dtype):
        encoded.append(tuple(arr.shape))
        time.sleep(delay_s)
        return encode(arr, wire_dtype)

    monkeypatch.setattr(tnet, "_encode_tensor", slow_encode)
    ttel.enable()
    ttel.get_tracer().clear()
    try:
        swarm = Swarm(weights, ALL["port"], "f32")
        try:
            _generate(swarm.client("port"), "port", GREEDY, n=2)
        finally:
            swarm.stop()
        spans = [sp for sp in ttel.get_tracer().spans() if sp.name == "server_forward"]
    finally:
        ttel.disable()
        ttel.get_tracer().clear()
    assert {sp.attrs["peer"] for sp in spans} == {"port-s1-r0", "port-s2-r0", "port-s3-r0"}
    assert len(encoded) >= 2 * len(spans) // 3
    assert all(sp.duration_s is not None and sp.duration_s < delay_s for sp in spans), \
        [sp.duration_s for sp in spans]


def test_failover_onto_replica(weights, references):
    """The pinned stage-2 server stop()s after its 2nd decode step; the
    client fails over to the replica, replays the journal (classic frames)
    and reopens its stream there, with the fault-free tokens."""
    swarm = Swarm(weights, {1: ["port"], 2: ["port", "port"], 3: ["port"]}, "f32")
    try:
        client = swarm.client("port")
        transport = client.transport
        call = transport.call
        seen = {"decode": 0, "pinned": None}

        def stop_after_two(peer_id, req, timeout=None):
            resp = call(peer_id, req, timeout)
            if "-s2-" in peer_id and not req.is_prefill and not req.is_replay:
                seen["pinned"] = seen["pinned"] or peer_id
                if peer_id == seen["pinned"]:
                    seen["decode"] += 1
                    if seen["decode"] == 2:
                        swarm.servers[peer_id].stop()
            return resp

        transport.call = stop_after_two
        tokens = _generate(client, "port", GREEDY)
        assert tokens == references["local"]
        assert client.recoveries >= 1
        pinned = seen["pinned"]
        replica = next(s for p, s in swarm.servers.items() if "-s2-" in p and p != pinned)
        assert replica.executor.requests_served > 0 and replica.stream_opens >= 1
        assert pinned in client.failed_peers["stage2"]
    finally:
        swarm.stop()


@pytest.fixture
def port_swarm(weights):
    swarm = Swarm(weights, ALL["port"], "f32")
    yield swarm
    swarm.stop()


def test_info_reach_check_and_end_session(port_swarm):
    """``info`` reports the span and capacity, ``reach_check`` dials for
    its caller, and ``end_session`` drops the stream state with the KV."""
    client = port_swarm.client("port")
    for i in range(3):
        client.generate(PROMPT, 2, sampling=SamplingParams(*GREEDY), session_id=f"es-{i}")
    transport = client.transport
    a, b = port_swarm.servers["port-s1-r0"], port_swarm.servers["port-s2-r0"]
    info = transport.info("port-s1-r0")
    assert (info["verb"], info["start_block"], info["end_block"]) == ("info", 1, 2)
    assert info["cache_tokens_left"] > 0 and info["requests_served"] == 6
    assert info["version"] == 1 and info["recent_requests"]
    assert info["peer_id"] == "port-s1-r0" and info["engine"] == "session"
    assert transport.reach_check("port-s1-r0", b.address) is True
    with socket.socket() as s:                            # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        dead = "127.0.0.1:%d" % s.getsockname()[1]
    assert transport.reach_check("port-s1-r0", dead) is False
    for srv in port_swarm.servers.values():
        assert sum(len(d) for d in srv._streams.values()) == 0
        assert srv.executor.arena.used_bytes == 0
    assert a.stream_opens == 3 and a.stream_steps == 6
    # A JAX transport reads the port server's info the same way.
    jt = jnet.TcpTransport(jnet.RemoteRegistry(port_swarm.address))
    try:
        assert jt.info("port-s3-r0")["end_block"] == 4
        assert jt.alive("port-s3-r0")
    finally:
        jt.close()


def _raw_exchange(address, header, body=b""):
    host, port = address.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=SOCKET_TIMEOUT_S) as s:
        s.settimeout(SOCKET_TIMEOUT_S)
        tnet._send_frame(s, header, body)
        return tnet._recv_frame(s)[0]


def test_step_without_stream_open_refused(port_swarm):
    meta, body = tnet._encode_tensor(np.zeros((1, 1, 256), np.float32), "f32")
    h = _raw_exchange(port_swarm.servers["port-s1-r0"].address,
                      {"verb": "step", "session_id": "ghost", "seq_len": 1,
                       "cur_len": 0, "tensor": meta}, body)
    assert h["verb"] == "error" and h["kind"] == "stage"
    assert h["stream_closed"] and h["reason"] == "no_stream"
    assert "stream_open" in h["message"]


UNPORTED_FIELDS = {
    "hypo_ids": {"hypo_ids": (0,)},
    "num_logprobs": {"num_logprobs": 2},
    "draft_tokens": {"draft_tokens": (3, 4)},
    "prompts": {"prompts": torch.zeros(1, 2, 256)},
    "burst_len": {"burst_len": 4, "burst_budget": 4},
    "start_from_position": {"start_from_position": 0},
}
# Fields once refused here and served since (the speculative, beam and
# deep-prompt slices), each with its value when unset. Zero prompts add
# nothing, so the prompt step's rows equal the plain step's.
SERVED_FIELDS = {"draft_tokens": None, "start_from_position": None, "hypo_ids": None,
                 "num_logprobs": 0, "prompts": None}


@pytest.mark.parametrize("field", sorted(UNPORTED_FIELDS))
def test_unported_request_field_gets_a_stage_error_frame(port_swarm, field):
    """A field the port's executor does not implement is refused with a
    ``kind: "stage"`` frame naming it, never served without it. The
    speculative, beam and deep-prompt fields are served: a prefill of stage
    1 that carries one answers the hidden rows of the same prefill without
    it."""
    req = tnet.StageRequest(session_id="f", hidden=torch.zeros(1, 1, 256), seq_len=1,
                            cur_len=0, is_prefill=True, max_length=8,
                            **UNPORTED_FIELDS[field])
    if field in SERVED_FIELDS:
        transport = port_swarm.client("port").transport
        got = transport.call("port-s1-r0", req, SOCKET_TIMEOUT_S)
        plain = transport.call("port-s1-r0", dataclasses.replace(req, **{
            field: SERVED_FIELDS[field]}), SOCKET_TIMEOUT_S)
        assert got.hidden is not None and torch.equal(got.hidden, plain.hidden)
        return
    tensors = [tnet._host_array(req.hidden)]
    if req.prompts is not None:
        tensors.append(tnet._host_array(req.prompts))
    metas, body = tnet._encode_tensors(tensors, "f32")
    hdr = tnet._request_header(req, metas[0],
                               prompts_meta=metas[1] if len(metas) > 1 else None)
    h = _raw_exchange(port_swarm.servers["port-s1-r0"].address, hdr, body)
    assert h["verb"] == "error" and h["kind"] == "stage"
    assert repr(field) in h["message"] and "not ported" in h["message"]
    with pytest.raises(StageExecutionError, match=field):
        port_swarm.client("port").transport.call("port-s1-r0", req, SOCKET_TIMEOUT_S)


def test_next_servers_is_relayed_as_a_chain(port_swarm):
    """A ``forward`` naming ``next_servers`` (the reference's push chain):
    stage 1 computes, hands its output to stage 2, which hands it to stage
    3, and the final token comes back on the first connection, equal to
    the same activation walked hop by hop."""
    addr = {p: port_swarm.servers[f"port-s{p}-r0"].address for p in (1, 2, 3)}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 256))
                         .astype(np.float32))

    def request(sid, hidden, start, nxt=()):
        return tnet.StageRequest(session_id=sid, hidden=hidden, seq_len=3, cur_len=0,
                                 is_prefill=True, max_length=8, start_block=start,
                                 end_block=start + 1, next_servers=nxt)

    def exchange(peer, req):
        meta, body = tnet._encode_tensor(tnet._host_array(req.hidden), "f32")
        hdr = dict(tnet._request_header(req, meta), wire_dtype="f32")
        host, port = addr[peer].rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=SOCKET_TIMEOUT_S) as s:
            s.settimeout(SOCKET_TIMEOUT_S)
            tnet._send_frame(s, hdr, body)
            h, payload = tnet._recv_frame(s)
        return h, payload

    chain = exchange(1, request("chain", x, 1, (
        {"peer_id": "port-s2-r0", "address": addr[2], "start_block": 2, "end_block": 3},
        {"peer_id": "port-s3-r0", "address": addr[3], "start_block": 3, "end_block": 4})))[0]
    hidden = x
    for peer in (1, 2):
        h, payload = exchange(peer, request("walk", hidden, peer))
        hidden = tnet._to_tensor(tnet._decode_tensor(h["tensor"], payload))
    walk = exchange(3, request("walk", hidden, 3))[0]
    assert chain["verb"] == walk["verb"] == "token"
    assert chain["token_id"] == walk["token_id"] and chain["cache_len"] == walk["cache_len"]


def _control_plane_servers(pkg):
    """An executor-less server of `pkg` with a gossip mirror holding one
    record and a relay capacity of 2, as a ``--mode serve`` volunteer."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling import (
        gossip as jgossip,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling import (
        gossip as tgossip,
    )

    gossip_mod = jgossip if pkg == "jax" else tgossip
    node = gossip_mod.GossipNode("cp", ttl=30.0, rng=random.Random(0))
    node.publish({"peer_id": "p1", "start_block": 1, "end_block": 2, "stage_index": 1,
                  "address": "127.0.0.1:9"})
    if pkg == "jax":
        srv = jnet.TcpStageServer(None, wire_dtype="f32", peer_id="cp", gossip=node,
                                  relay_capacity=2)
    else:
        srv = tnet.TcpStageServer(None, None, wire_dtype="f32", peer_id="cp", gossip=node,
                                  relay_capacity=2)
    srv.start()
    return srv


CONTROL_VERBS = {
    "gossip": {"verb": "gossip", "peer_id": "g", "digest": {}},
    "relay_attach": {"verb": "relay_attach", "peer_id": "nat", "address": "127.0.0.1:9"},
    "swarm-stats": {"verb": "swarm-stats"},
    "list": {"verb": "list"},
}


@pytest.mark.parametrize("verb", sorted(CONTROL_VERBS))
def test_control_plane_verb_gets_the_reference_answer(verb):
    """The control-plane verbs a port server now serves, answered as a JAX
    server with the same mirror and relay capacity answers them (record
    ages and the stats digest's values are the process's own)."""
    answers = []
    for pkg in ("jax", "port"):
        srv = _control_plane_servers(pkg)
        try:
            h = _raw_exchange(srv.address, dict(CONTROL_VERBS[verb]))
        finally:
            srv.stop()
        for rec in (*h.get("records", ()), *h.get("entries", ())):
            rec.pop("age_s", None)    # seconds since the record's refresh
            rec.pop("ttl_s", None)    # seconds of liveness left
        if "self" in h:
            h["self"] = sorted(h["self"])
        answers.append(h)
    assert answers[1] == answers[0]
    assert answers[1]["verb"] in ("gossip", "ok", "swarm-stats", "records")


@pytest.mark.parametrize("verb", ["register", "no_such_verb"])
def test_unported_verb_gets_unknown_verb_frame(port_swarm, verb):
    """A verb this server does not serve (``register`` needs a gossip
    mirror, which these servers have not) gets the reference's frame."""
    h = _raw_exchange(port_swarm.servers["port-s2-r0"].address,
                      {"verb": verb, "session_id": "v"})
    assert h == {"verb": "error", "message": f"unknown verb {verb!r}"}


@pytest.mark.parametrize("verb", ["train_forward", "backward"])
def test_training_verbs_are_served(port_swarm, verb):
    """Both training verbs reach the training path: a frame whose tensor
    count its header does not account for gets a stage error that names
    the mismatch, not ``unknown verb``."""
    metas, body = tnet._encode_tensors([np.zeros((1, 1, 256), np.float32)] * 3, "f32")
    h = _raw_exchange(port_swarm.servers["port-s2-r0"].address,
                      {"verb": verb, "session_id": "v", "seq_len": 1, "start_block": 2,
                       "end_block": 3, "has_prompts": False, "tensors": metas}, body)
    assert h["verb"] == "error" and h["kind"] == "stage", h
    want = 1 if verb == "train_forward" else 2
    assert f"{verb} frame carries 3 tensors, want {want}" in h["message"]


def test_jax_gossip_round_with_a_port_server_converges():
    """A JAX node's anti-entropy round with a port server's mirror: both
    sides end with the union of their records."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling.gossip import (
        GossipNode,
    )

    srv = _control_plane_servers("port")
    try:
        node = GossipNode("g")
        node.publish({"peer_id": "p2", "start_block": 2, "end_block": 3, "stage_index": 2,
                      "address": "127.0.0.1:8"})
        assert jnet.gossip_exchange(node, srv.address, timeout=SOCKET_TIMEOUT_S) == (1, 1)
        assert sorted(r.peer_id for r in node.live_servers()) == ["p1", "p2"]
        assert sorted(r.peer_id for r in srv.gossip.live_servers()) == ["p1", "p2"]
    finally:
        srv.stop()


def test_spent_deadline_and_model_mismatch_refused(port_swarm):
    client = port_swarm.client("port")
    req = tnet.StageRequest(session_id="d", hidden=torch.zeros(1, 1, 256), seq_len=1,
                            cur_len=0, is_prefill=True, max_length=8,
                            deadline_budget_s=-1.0)
    with pytest.raises(DeadlineExceeded):
        client.transport.call("port-s1-r0", req, SOCKET_TIMEOUT_S)
    other = tnet.TcpTransport(tnet.RemoteRegistry(port_swarm.address), model="other")
    port_swarm.servers["port-s1-r0"].model = "tiny"
    try:
        req.deadline_budget_s = None
        with pytest.raises(StageExecutionError, match="model mismatch"):
            other.call("port-s1-r0", req, SOCKET_TIMEOUT_S)
    finally:
        other.close()


@pytest.mark.parametrize("flag", [["--sp", "2"], ["--tp", "2"],
                                  ["--use_cpu_offload", "--batched"]])
def test_unported_serve_flag_exits_naming_it(flag):
    """``--sp`` and ``--tp`` exit naming themselves; host offload is ported,
    and ``--batched`` refuses it with the reference's message."""
    want = ("--batched keeps its span resident .* drop --use_cpu_offload/--keep_layers_on_gpu"
            if "--batched" in flag else f"{flag[0]} is not ported")
    with pytest.raises(SystemExit, match=want):
        tmain.main(["--mode", "serve", "--stage", "1", "--device", "cpu",
                    "--registry_addr", "127.0.0.1:1", *flag])


def test_relay_capacity_flag_is_served():
    """``--relay_capacity N`` passes the flag check (the CLI runs a
    volunteer in tests/test_torch_gossip.py)."""
    args = tmain.build_parser().parse_args(["--mode", "serve", "--stage", "1",
                                            "--relay_capacity", "2", "--device", "cpu"])
    tmain.refuse_unported_flags(args)
    assert args.relay_capacity == 2


@pytest.mark.parametrize("mode", ["serve", "client", "local"])
def test_burst_flag_is_served(mode):
    """``--burst N`` passes the flag check in every mode that takes it
    (``--mode serve --stage 0 --batched`` runs it as processes in
    tests/test_torch_serve_batched.py)."""
    args = tmain.build_parser().parse_args(["--mode", mode, "--stage", "0", "--batched",
                                            "--burst", "4", "--device", "cpu"])
    tmain.refuse_unported_flags(args)
    assert args.burst == 4


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_registry_ttl_expiry_and_discovery(client_pkg):
    """The port's registry service: a registered record is discovered, a
    heartbeat keeps it, and it expires after its TTL (the JAX package's
    ``RemoteRegistry`` speaks to it the same way)."""
    reg = tnet.RegistryServer(ttl=0.3)
    reg.start()
    try:
        remote = (tnet if client_pkg == "port" else jnet).RemoteRegistry(
            reg.address, timeout=SOCKET_TIMEOUT_S)
        remote.register(ServerRecord(peer_id="p1", start_block=0, end_block=4,
                                     stage_index=1, address="127.0.0.1:1"))
        assert [r.peer_id for r in remote.live_servers()] == ["p1"]
        assert remote.discover_stage(1) == "p1" and remote.ttl == 0.3
        assert remote.heartbeat("p1") is True
        assert remote.heartbeat("ghost") is False
        time.sleep(0.5)
        assert remote.live_servers() == []
        assert remote.discover_stage(1) is None
    finally:
        reg.stop()


def test_registry_ha_standby_and_stale_cache(tmp_path):
    """Writes reach every registry; reads fail over to the standby when
    the primary dies; with both dead the last snapshot serves under its
    TTL, and the peers cache keeps the addresses for a fresh process."""
    primary, standby = tnet.RegistryServer(), tnet.RegistryServer()
    primary.start()
    standby.start()
    cache = tmp_path / "peers.json"
    remote = tnet.RemoteRegistry(f"{primary.address},{standby.address}",
                                 timeout=2.0, peers_cache=str(cache))
    remote.register(ServerRecord(peer_id="p1", start_block=0, end_block=4,
                                 stage_index=1, address="127.0.0.1:9"))
    assert primary.registry.get("p1") and standby.registry.get("p1")
    primary.stop()
    assert remote.discover_stage(1) == "p1"
    standby.stop()
    assert remote.discover_stage(1) == "p1"            # stale-cache grace
    assert remote.stale_info()["stale"] and remote.stale_info()["seeds_down"]
    assert "127.0.0.1:9" in cache.read_text()


@pytest.mark.parametrize("front_end", ["local_transport", "tcp"])
def test_fixed_stage_server_heartbeat_rejoins_and_pings(weights, port_swarm, front_end):
    """FixedStageServer, joined to a `LocalTransport` or, as ``--mode
    serve`` runs it, behind a TCP server whose address it advertises: its
    heartbeat re-registers after the registry forgot it, and it publishes
    the RTTs of its next hops, pinged over the port's TCP transport."""
    _, _, tcfg, tp = weights
    registry = tnet.RemoteRegistry(port_swarm.address)
    pinger = tnet.TcpTransport(registry)
    spec = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS)).stages[1]
    local = LocalTransport() if front_end == "local_transport" else None
    srv = FixedStageServer("fixed-s1", tcfg, spec,
                           tmain._stage_params(port_args([]), tcfg, tp, spec),
                           registry, local,
                           executor_kwargs={"device": "cpu"},
                           pinger=_pinger_from_transport(pinger))
    tcp = None
    try:
        if local is None:
            tcp = tnet.TcpStageServer(srv.executor, StageRuntime())
            tcp.start()
            srv.address = tcp.address
        srv.start_serving()
        if local is not None:
            assert local.executor("fixed-s1") is srv.executor
        port_swarm.registry_srv.registry.unregister("fixed-s1")
        srv.heartbeat_once()
        rec = port_swarm.registry_srv.registry.get("fixed-s1")
        assert rec is not None and rec.stage_index == 1
        assert rec.address == (tcp and tcp.address)
        if tcp is not None:
            assert pinger.info("fixed-s1")["peer_id"] == "fixed-s1"
        assert set(srv.next_server_rtts) == {"port-s2-r0"}
        assert 0.0 < srv.next_server_rtts["port-s2-r0"] < SOCKET_TIMEOUT_S
        srv.shutdown()
        assert port_swarm.registry_srv.registry.get("fixed-s1") is None
    finally:
        pinger.close()
        if tcp is not None:
            tcp.stop()


def test_act_dtype_casts_an_arriving_activation(weights):
    """A bfloat16 stage given ``act_dtype`` (``--dtype``, as ``main`` passes
    it) computes a float32 arrival, which is what the wire decodes to,
    exactly as the same activation sent in bfloat16."""
    _, _, tcfg, _ = weights
    args = port_args(["--dtype", "bfloat16"])
    params = tmain.init_params(tcfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    spec = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS)).stages[1]
    ex = StageExecutor(tcfg, spec, tmain._stage_params(args, tcfg, params, spec),
                       device="cpu", act_dtype=tmain._DTYPE_MAP[args.dtype])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, tcfg.hidden_size), dtype=np.float32)).to(torch.bfloat16)
    out = [ex.forward(tnet.StageRequest(session_id=f"cast-{i}", hidden=h, seq_len=4,
                                        cur_len=0, is_prefill=True, max_length=8)).hidden
           for i, h in enumerate((x.float(), x))]
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], out[1])


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_load_stage_model_equals_the_full_inits_slice(stage):
    """``serve`` and ``client`` keep their stage's weights only, equal to
    that stage's slice of the full init (every layer is still drawn)."""
    args = port_args(["--model", "gpt2", "--seed", "3"])
    cfg, full = tmain.load_model(args)
    spec = tmain.stage_plan(args, cfg).stages[stage]
    _, shard = tmain.load_stage_model(args, spec)
    want = tmain._stage_params(args, cfg, full, spec)

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    got, ref = dict(leaves(shard)), dict(leaves(want))
    assert sorted(got) == sorted(ref)
    for name, t in ref.items():
        assert torch.equal(got[name], t), name
    assert ("final_norm" in shard) == spec.is_last
    assert shard["layers"]["ln1"]["w"].shape[0] == spec.num_layers


def _port_cli(*argv, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", tmain.__name__, "--device", "cpu", *argv],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, bufsize=0,
        env=dict(os.environ, PYTHONIOENCODING="utf-8"), **kw)


def _handshake(proc, prefix, timeout_s=120.0):
    """The child's first stdout line starting with `prefix`, waiting at most
    `timeout_s`. stdout is an unbuffered pipe, so `select` sees every byte
    that `readline` has not consumed."""
    deadline = time.monotonic() + timeout_s
    while (left := deadline - time.monotonic()) > 0:
        ready, _, _ = select.select([proc.stdout], [], [], left)
        if not ready:
            break
        line = proc.stdout.readline().decode("utf-8", errors="replace")
        if line.startswith(prefix):
            return line.strip()
        if not line:
            break                          # the child closed its stdout
    raise AssertionError(f"no {prefix!r} line")


def test_cli_swarm_matches_mode_local():
    """``--mode registry``, three ``--mode serve`` processes and ``--mode
    client`` (gpt2, int8, port 0 everywhere): the client prints the
    generation and the token ids ``--mode local`` prints."""
    common = ["--model", "gpt2", "--quant", "int8", "--seed", "1"]
    gen = ["--max_new_tokens", "5", "--temperature", "0", "--prompt", "Hi there"]
    procs = []
    try:
        procs.append(_port_cli("--mode", "registry", "--registry_port", "0"))
        addr = _handshake(procs[0], "REGISTRY_ADDR=").split("=", 1)[1]
        for k in (1, 2, 3):
            procs.append(_port_cli("--mode", "serve", "--stage", str(k),
                                   "--registry_addr", addr, *common))
        lines = [_handshake(p, "SERVING ") for p in procs[1:]]
        assert [ln.split()[1:3] for ln in lines] == [
            ["stage=1", "span=[3,6)"], ["stage=2", "span=[6,9)"], ["stage=3", "span=[9,12)"]]
        client = _port_cli("--mode", "client", "--registry_addr", addr, *common, *gen)
        local = _port_cli("--mode", "local", *common, *gen)
        procs += [client, local]
        out_client = client.communicate(timeout=180)[0].decode("utf-8", errors="replace")
        out_local = local.communicate(timeout=180)[0].decode("utf-8", errors="replace")
        assert client.returncode == 0 and local.returncode == 0
        block = out_local[out_local.index("=== Generation"):out_local.index("\nTTFT")]
        assert block in out_client
        ids = [re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M) for out in (out_local, out_client)]
        assert len(ids[0]) == 1 and ids[0] == ids[1] and json.loads(ids[0][0])
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
