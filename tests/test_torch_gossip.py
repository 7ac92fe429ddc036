"""The port's gossip control plane, against the JAX package's.

Every ``--mode serve`` process embeds a `GossipNode` (``scheduling/gossip.py``,
a byte-equal copy of the JAX package's) and answers the registry
service's verbs from it, so any live stage server bootstraps a client
after every registry is gone. Held to the reference's
``tests/test_gossip.py``: a port mirror answers register / heartbeat /
list / unregister with a JAX mirror's frames; one ``gossip_exchange``
round converges both sides, port with port and port with JAX, each
initiating; a ``gossip_drop`` fault loses one round and the next
converges; both registries killed mid-generation with the in-flight
generation and a client bootstrapped from the peers cache both giving the
JAX package's tokens, and a restarted registry re-adopted; ``swarm-stats``
from any server; an elastic server answering the control plane while it
re-spans; and the CLI (``--mode serve --relay_capacity``, a server behind
``--public_ip`` that nothing listens on joining through it, a client
through a mirror after the registry is SIGKILLed).

Tiny llama (``tests/_torch_port_helpers.py``), 4 layers in 3 stages for the
in-process swarm; gpt2 for the CLI. Tolerance: none, tokens are compared
for equality.
"""

import errno
import json
import os
import random
import re
import signal
import subprocess
import sys
import time

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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    net as jnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.faults import (
    FaultPlan as JFaultPlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling.gossip import (
    GossipNode as JGossipNode,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.faults import (
    FaultPlan,
    FaultRule,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.gossip import (
    GossipLoop,
    GossipNode,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    ServerRecord,
    rec_to_dict,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    catalog,
    events,
)

SPLITS = "1,2,3"
PROMPT = [101, 7, 300, 45, 2]
NEW_TOKENS = 6
GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.7, 0.9, 50, 1.5)
SOCKET_TIMEOUT_S = 10.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


def _rec(peer, addr="127.0.0.1:1"):
    return ServerRecord(peer_id=peer, start_block=0, end_block=4, stage_index=1, address=addr)


class StaticRegistry:
    """A transport's registry that knows one record."""

    def __init__(self, rec):
        self.rec = rec

    def get(self, peer_id):
        return self.rec if peer_id == self.rec.peer_id else None


def mirror(pkg, peer_id, **kw):
    """An executor-less stage server of either package with a gossip
    mirror: the control plane without the data plane."""
    if pkg == "jax":
        node = JGossipNode(peer_id, ttl=30.0, rng=random.Random(0))
        srv = jnet.TcpStageServer(None, wire_dtype="f32", peer_id=peer_id, gossip=node, **kw)
    else:
        node = GossipNode(peer_id, ttl=30.0, rng=random.Random(0))
        srv = tnet.TcpStageServer(None, None, wire_dtype="f32", peer_id=peer_id, gossip=node,
                                  **kw)
    srv.start()
    node.self_address = srv.address
    return node, srv


def registry_verbs(pkg):
    """What a RemoteRegistry pointed at a stage server of `pkg` sees: the
    heartbeat contract, the listed records, the tombstone."""
    node, srv = mirror(pkg, "mirror")
    try:
        rr = tnet.RemoteRegistry(srv.address, timeout=SOCKET_TIMEOUT_S)
        rr.register(_rec("p1", addr="127.0.0.1:9"))
        out = [rr.heartbeat("p1"), rr.heartbeat("ghost"),
               [rec_to_dict(r) for r in rr.live_servers()], rr.ttl]
        rr.unregister("p1")
        out += [rr.live_servers(), node.digest()]
        return out
    finally:
        srv.stop()


def test_stage_server_answers_registry_verbs_as_the_jax_one():
    got = registry_verbs("port")
    assert got == registry_verbs("jax")
    assert got[:2] == [True, False] and got[2][0]["peer_id"] == "p1"
    assert got[4] == [] and "p1" in got[5]       # the tombstone circulates


@pytest.mark.parametrize("a_pkg,b_pkg", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_gossip_exchange_converges_both_sides(a_pkg, b_pkg):
    """One digest-then-delta round, initiated by `a`: both mirrors end with
    the union, whichever package each side is."""
    na, sa = mirror(a_pkg, "na")
    nb, sb = mirror(b_pkg, "nb")
    try:
        na.publish(rec_to_dict(_rec("pa", addr="127.0.0.1:21")))
        nb.publish(rec_to_dict(_rec("pb", addr="127.0.0.1:22")))
        exchange = (tnet if a_pkg == "port" else jnet).gossip_exchange
        assert exchange(na, sb.address) == (1, 1)
        for node in (na, nb):
            assert {r.peer_id for r in node.live_servers()} == {"pa", "pb"}
        assert na.digest() == nb.digest()
    finally:
        sa.stop()
        sb.stop()


def test_gossip_drop_fault_then_reconverge():
    """``gossip_drop`` swallows one round's frame (the initiator's read
    times out); the next round converges."""
    node, srv = mirror("port", "flaky", allow_fault_injection=True)
    try:
        other = GossipNode("initiator", ttl=30.0)
        other.publish(rec_to_dict(_rec("pc", addr="127.0.0.1:31")))
        srv.fault_plan = FaultPlan([FaultRule("gossip_drop", side="server", verb="gossip",
                                              times=1)])
        with pytest.raises((TimeoutError, OSError)):
            tnet.gossip_exchange(other, srv.address, timeout=0.6)
        assert node.live_count() == 0
        tnet.gossip_exchange(other, srv.address, timeout=5.0)
        assert {r.peer_id for r in node.live_servers()} == {"pc"}
        assert [f["kind"] for f in srv.fault_plan.report()] == ["gossip_drop"]
    finally:
        srv.stop()


def test_gossip_fault_plan_installs_over_the_wire_from_jax():
    """The gated ``fault`` verb takes a JAX-built plan at the gossip site."""
    node, srv = mirror("port", "flaky", allow_fault_injection=True)
    tx = jnet.TcpTransport(StaticRegistry(_rec("flaky", addr=srv.address)))
    try:
        tx.install_fault_plan("flaky", JFaultPlan.from_dict(
            {"rules": [{"kind": "gossip_drop", "side": "server", "verb": "gossip",
                        "times": 1}]}))
        other = JGossipNode("initiator", ttl=30.0)
        other.publish(rec_to_dict(_rec("pd", addr="127.0.0.1:32")))
        with pytest.raises((TimeoutError, OSError)):
            jnet.gossip_exchange(other, srv.address, timeout=0.6)
        jnet.gossip_exchange(other, srv.address, timeout=5.0)
        assert {r.peer_id for r in node.live_servers()} == {"pd"}
    finally:
        tx.close()
        srv.stop()


def seed_registry():
    """A seed RegistryServer on a port below Linux's default ephemeral range
    (32768-60999), so that no bind(0) or connect() takes the port after the
    seed stops and the restart test can bind it again."""
    for port in random.Random().sample(range(20000, 32768), 64):
        try:
            return tnet.RegistryServer(port=port)
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE:
                raise
    raise RuntimeError("no free seed port")


class GossipSwarm:
    """Two registries and a port stage server a remote stage, each with a
    mirror and a gossip loop, as ``--mode serve`` runs them."""

    def __init__(self, weights, cache, interval_s=0.25):
        _, _, tcfg, tp = weights
        self.tcfg, self.tp = tcfg, tp
        self.plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
        self.seeds = []
        for _ in range(2):
            rs = seed_registry()
            rs.start()
            self.seeds.append(rs)
        self.seed_addrs = ",".join(rs.address for rs in self.seeds)
        self.registry = tnet.RemoteRegistry(self.seed_addrs, timeout=2.0, peers_cache=cache)
        self.servers, self.nodes, self.recs, self.loops, self.transports = [], [], [], [], []
        args = port_args([])
        for spec in self.plan.stages[1:]:
            peer = f"g-s{spec.index}"
            node = GossipNode(peer, rng=random.Random(spec.index))
            srv = tnet.TcpStageServer(StageExecutor(
                tcfg, spec, tmain._stage_params(args, tcfg, tp, spec), peer_id=peer,
                device="cpu"), StageRuntime(), wire_dtype="f32", gossip=node)
            srv.start()
            node.self_address = srv.address
            rec = make_server_record(peer, spec)
            rec.address = srv.address
            self.registry.register(rec)
            node.publish(rec_to_dict(rec))
            self.servers.append(srv)
            self.nodes.append(node)
            self.recs.append(rec)
        addrs = [s.address for s in self.servers]
        for node, rec in zip(self.nodes, self.recs):
            loop = GossipLoop(node, tnet.gossip_exchange,
                              record_fn=lambda r=rec: dict(rec_to_dict(r), stats={"x": 1.0}),
                              extra_peers_fn=lambda: list(addrs), interval_s=interval_s)
            loop.start()
            self.loops.append(loop)
        deadline = time.monotonic() + 30.0
        while (any(n.live_count() < len(self.servers) for n in self.nodes)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        self.stage0 = StageExecutor(tcfg, self.plan.stages[0],
                                    tmain._stage_params(args, tcfg, tp, self.plan.stages[0]),
                                    peer_id="client-local", device="cpu")

    def client(self, registry, stage0=None):
        tx = tnet.TcpTransport(registry, wire_dtype="f32")
        self.transports.append(tx)
        return PipelineClient(self.tcfg, self.plan, stage0 or self.stage0, tx, registry,
                              settle_seconds=0.0, seed=0, request_timeout=30.0)

    def stop(self):
        for loop in self.loops:
            loop.stop()
        for tx in self.transports:
            tx.close()
        for srv in self.servers:
            srv.stop()
        for rs in self.seeds:
            rs.stop()


class KillAfter:
    """Stage 0 that runs `kill` after its `n`-th forward: the registries die
    at a fixed step of the generation."""

    def __init__(self, inner, n, kill):
        self._inner, self._n, self._kill, self.calls = inner, n, kill, 0

    def forward(self, req):
        out = self._inner.forward(req)
        self.calls += 1
        if self.calls == self._n:
            self._kill()
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX package's tokens of the same requests (its in-process
    cluster on the same weights)."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        StagePlan as JStagePlan,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        parse_splits as jparse_splits,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        slice_stage_params as jslice,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
        PipelineClient as JPipelineClient,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
        make_server_record as jrecord,
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

    jcfg, jp, _, _ = weights
    plan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS))
    transport, registry = JLocalTransport(), JPlacementRegistry(rng=random.Random(0))
    for spec in plan.stages[1:]:
        transport.add_peer(f"j{spec.index}", JStageExecutor(
            jcfg, spec, jslice(jcfg, jp, spec), peer_id=f"j{spec.index}"))
        registry.register(jrecord(f"j{spec.index}", spec))
    client = JPipelineClient(jcfg, plan, JStageExecutor(
        jcfg, plan.stages[0], jslice(jcfg, jp, plan.stages[0]), peer_id="client-local"),
        transport, registry, settle_seconds=0.0, seed=0)
    return {kind: client.generate(PROMPT, NEW_TOKENS, sampling=JSamplingParams(*knobs)).tokens
            for kind, knobs in (("greedy", GREEDY), ("sampled", SAMPLED))}


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_registry_loss_mid_generation_and_peers_cache_bootstrap(weights, jax_tokens, tmp_path,
                                                                kind):
    """Both registries stopped after the prefill and a decode step: the
    in-flight generation ends with the JAX package's tokens; every mirror
    holds the 3 records; a fresh client with only the peers cache
    bootstraps through a mirror (``gossip_fallback``) to the same tokens;
    a restarted registry is re-adopted."""
    ttel.enable()
    events.get_recorder().clear()
    sp = SamplingParams(*(GREEDY if kind == "greedy" else SAMPLED))
    swarm = GossipSwarm(weights, str(tmp_path / "peers.json"))
    try:
        assert [n.live_count() for n in swarm.nodes] == [3, 3, 3]
        clean = swarm.client(swarm.registry).generate(PROMPT, NEW_TOKENS, sampling=sp)
        assert clean.tokens == jax_tokens[kind]

        def kill_seeds():
            for rs in swarm.seeds:
                rs.stop()

        chaos = swarm.client(swarm.registry, KillAfter(swarm.stage0, 2, kill_seeds))
        assert chaos.generate(PROMPT, NEW_TOKENS, sampling=sp).tokens == jax_tokens[kind]
        assert len(swarm.registry.live_servers()) == 3      # a mirror answers
        fallback = catalog.get("client_registry_fallback_reads_total")
        before = fallback.value
        reg2 = tnet.RemoteRegistry(swarm.seed_addrs, timeout=0.5,
                                   peers_cache=str(tmp_path / "peers.json"))
        assert len(reg2.live_servers()) == 3
        assert fallback.value == before + 1
        assert reg2.stale_info()["seeds_down"]
        names = [e.name for e in events.get_recorder().events()]
        assert {"registry_unreachable", "gossip_fallback", "gossip_served_discovery"} <= set(names)
        fresh = swarm.client(reg2).generate(PROMPT, NEW_TOKENS, sampling=sp)
        assert fresh.tokens == jax_tokens[kind]
        # A registry restarted on the first one's port is re-adopted.
        host, port = swarm.seeds[0].address.rsplit(":", 1)
        restored = tnet.RegistryServer(host=host, port=int(port))
        restored.start()
        swarm.seeds.append(restored)
        for rec in swarm.recs:
            reg2.register(rec)
        assert len(reg2.live_servers()) == 3 and not reg2.stale_info()["seeds_down"]
        recovered = [e for e in events.get_recorder().events() if e.name == "registry_recovered"]
        assert recovered and recovered[-1].fields.get("source") == "seed"
    finally:
        ttel.disable()
        events.get_recorder().clear()
        swarm.stop()


def test_swarm_stats_lists_every_record_with_its_digest(weights, tmp_path):
    """``swarm-stats`` from any server: its own digest and the 3 live
    records, each with the stats digest its origin gossips; the JAX
    transport reads the same frame."""
    swarm = GossipSwarm(weights, str(tmp_path / "peers.json"))
    try:
        tx = tnet.TcpTransport(swarm.registry)
        jtx = jnet.TcpTransport(swarm.registry)
        try:
            for srv, peer in zip(swarm.servers, ("g-s1", "g-s2", "g-s3")):
                stats = tx.swarm_stats(peer)
                assert stats["peer_id"] == peer and isinstance(stats["self"], dict)
                assert sorted(r["peer_id"] for r in stats["records"]) == ["g-s1", "g-s2", "g-s3"]
                assert all(r["stats"] == {"x": 1.0} for r in stats["records"])
                assert sorted(stats["self"]) == sorted(jtx.swarm_stats(peer)["self"])
        finally:
            tx.close()
            jtx.close()
        # A server without a mirror answers with no records.
        bare = tnet.TcpStageServer(None, None, peer_id="bare")
        bare.start()
        bare_tx = tnet.TcpTransport(StaticRegistry(_rec("bare", bare.address)))
        try:
            assert bare_tx.swarm_stats("bare")["records"] == []
        finally:
            bare_tx.close()
            bare.stop()
    finally:
        swarm.stop()


def test_elastic_server_answers_the_control_plane_while_re_spanning(weights):
    """With no executor (between two spans) a server still gossips and
    serves the registry verbs and swarm-stats, while a forward gets the
    retryable "server is re-spanning" error."""
    node, srv = mirror("port", "lb-1")
    try:
        assert srv.executor is None
        other = GossipNode("peer", ttl=30.0)
        other.publish(rec_to_dict(_rec("peer", addr="127.0.0.1:41")))
        assert tnet.gossip_exchange(other, srv.address)[1] == 0
        assert {r.peer_id for r in node.live_servers()} == {"peer"}
        rr = tnet.RemoteRegistry(srv.address, timeout=SOCKET_TIMEOUT_S)
        assert [r.peer_id for r in rr.live_servers()] == ["peer"]
        tx = tnet.TcpTransport(StaticRegistry(_rec("lb-1", srv.address)), wire_dtype="f32")
        try:
            assert [r["peer_id"] for r in tx.swarm_stats("lb-1")["records"]] == ["peer"]
            with pytest.raises(StageExecutionError, match="re-spanning"):
                tx.call("lb-1", tnet.StageRequest(
                    session_id="s", hidden=torch.zeros(1, 1, 256), seq_len=1, cur_len=0,
                    is_prefill=True, max_length=8))
        finally:
            tx.close()
    finally:
        srv.stop()


def _cli(*argv):
    return subprocess.Popen([sys.executable, "-m", tmain.__name__, "--device", "cpu", *argv],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            bufsize=0, env=dict(os.environ, PYTHONIOENCODING="utf-8"))


def _lines_until(proc, prefix, timeout_s=120.0):
    """The child's stdout lines up to the first that starts with `prefix`."""
    import select

    seen, deadline = [], time.monotonic() + timeout_s
    while (left := deadline - time.monotonic()) > 0:
        ready, _, _ = select.select([proc.stdout], [], [], left)
        if not ready:
            break
        line = proc.stdout.readline().decode("utf-8", errors="replace")
        if not line:
            break
        seen.append(line.strip())
        if line.startswith(prefix):
            return seen
    raise AssertionError(f"no {prefix!r} line in {seen}")


def test_cli_relay_volunteer_nat_server_and_registry_loss(tmp_path):
    """``--mode registry``; ``--mode serve --stage 1 --relay_capacity 2``;
    ``--mode serve --stage 2`` advertising ``--public_ip 127.0.0.2``, where
    nothing listens, which fails the dial-back vote and prints its
    ``RELAY:`` line; a ``--mode client`` with ``--peers_cache``; then the
    registry SIGKILLed and a second client with the same cache prints the
    same ``TOKENS=`` through a gossip mirror (gpt2, int8, 3 stages)."""
    common = ["--model", "gpt2", "--quant", "int8", "--seed", "1", "--splits", "4,8",
              "--wire_dtype", "f32"]
    cache = str(tmp_path / "peers.json")
    gen = ["--max_new_tokens", "4", "--temperature", "0", "--prompt", "Hi there",
           "--peers_cache", cache]
    procs = []
    try:
        procs.append(_cli("--mode", "registry", "--registry_port", "0"))
        addr = _lines_until(procs[0], "REGISTRY_ADDR=")[-1].split("=", 1)[1]
        procs.append(_cli("--mode", "serve", "--stage", "1", "--registry_addr", addr,
                          "--relay_capacity", "2", *common))
        assert _lines_until(procs[1], "SERVING ")[-1].split()[1:3] == ["stage=1", "span=[4,8)"]
        procs.append(_cli("--mode", "serve", "--stage", "2", "--registry_addr", addr,
                          "--public_ip", "127.0.0.2", *common))
        lines = _lines_until(procs[2], "SERVING ")
        relay = [ln for ln in lines if ln.startswith("RELAY:")]
        assert len(relay) == 1 and "via volunteer stage1-" in relay[0]
        assert "addr=127.0.0.2:" in lines[-1]
        outs = []
        for i in range(2):
            client = _cli("--mode", "client", "--registry_addr", addr, *common, *gen)
            procs.append(client)
            out = client.communicate(timeout=180)[0].decode("utf-8", errors="replace")
            assert client.returncode == 0, out
            outs.append(out)
            if i == 0:
                procs[0].send_signal(signal.SIGKILL)
                procs[0].wait(timeout=30)
        ids = [re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M) for out in outs]
        assert len(ids[0]) == 1 and ids[0] == ids[1] and json.loads(ids[0][0])
        assert json.load(open(cache))["addresses"]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
