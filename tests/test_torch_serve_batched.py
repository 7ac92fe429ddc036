"""The port's batched engine in the serving path: a ``TcpStageServer``
with no runtime (compute inline on the handler threads) in front of a
``BatchingStageAdapter``, advertised as ``engine=batched``, over loopback.

Counterparts of ``tests/test_serve_batched.py``: concurrent clients
coalesce into shared rounds with the JAX package's tokens (:121), ``info``
reports the engine and its rounds (:163), a plain session prefers the
batched replica (:176), and a killed batched peer fails over to a session
replica (:237). Plus a JAX client against the port's batched server, and
``--mode serve --batched`` as processes.

Burst decode over loopback TCP (full-span batched servers, the whole tiny
model on 4 slots of 64 rows): a JAX client asking for ``burst=4`` from a
port server and a port client from a JAX server give the unpartitioned
loop's tokens, and the ``burst`` reply frame's bytes equal the JAX
server's; ``--mode serve --stage 0 --batched --burst 4`` and ``--mode
client --burst 4`` as processes.

Tiny llama of ``tests/test_runtime_pipeline.py`` (8 layers), splits 2,4:
stage 0 [0, 2) in the client, stage 1 [2, 4) a session server (its compute
on a ``StageRuntime``), stage 2 [4, 8) the batched final stage; wire f32.
Tolerance: none, tokens are compared for equality with the JAX package's
unpartitioned loop (``oracle_generate``), greedy and seeded sampled.
"""

import json
import re
import socket
import struct
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    one_torch_thread,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    batching as jbatching,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
    parse_splits,
    slice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    net as tnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.batching import (
    BatchedStageExecutor,
    BatchingStageAdapter,
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

from test_runtime_pipeline import oracle_generate, tiny_cfg
from test_torch_tcp import REPO, _handshake, _port_cli

SPLITS = "2,4"   # 8 layers -> stage0 [0,2) client, stage1 [2,4), stage2 [4,8) final
GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.7, 0.9, 50, 1.5)
TIMEOUT_S = 300


class Swarm:
    """A RegistryServer, a session server for stage 1 and a batched server
    for stage 2 (``bat-s2``), all port servers over loopback TCP."""

    def __init__(self):
        self.jcfg = tiny_cfg()
        self.jp = j_init_params(jax.random.PRNGKey(0), self.jcfg)
        self.cfg = port_cfg(self.jcfg)
        self.params = bridged(self.jp)
        self.plan = StagePlan.from_splits(self.cfg.num_layers, parse_splits(SPLITS))
        # Long TTL: records are registered once, with no heartbeat thread.
        self.registry = tnet.RegistryServer(ttl=600.0)
        self.registry.start()
        self.servers = {}
        self.serve("sess-s1", StageExecutor(self.cfg, self.plan.stages[1],
                                            self._shard(1), peer_id="sess-s1",
                                            device="cpu"), StageRuntime())
        engine = BatchedStageExecutor(self.cfg, self.plan.stages[2], self._shard(2),
                                      slots=4, max_len=64, device="cpu")
        # A generous window, so that concurrent clients share rounds.
        self.adapter = BatchingStageAdapter(engine, peer_id="bat-s2", window_s=0.05)
        self.adapter.warmup()
        self.serve("bat-s2", self.adapter, None)

    def _shard(self, stage):
        return slice_stage_params(self.cfg, self.params, self.plan.stages[stage])

    def serve(self, peer, executor, runtime):
        srv = tnet.TcpStageServer(executor, runtime, wire_dtype="f32")
        srv.start()
        self.servers[peer] = srv
        spec = executor.spec
        rec = make_server_record(peer, spec, engine=getattr(executor, "engine", "session"))
        rec.address = srv.address
        self.registry.registry.register(rec)

    def session_replica(self):
        """A session server for stage 2 beside the batched one."""
        self.serve("sess-s2", StageExecutor(self.cfg, self.plan.stages[2], self._shard(2),
                                            peer_id="sess-s2", device="cpu"),
                   StageRuntime())

    def client(self, name, seed=0):
        registry = tnet.RemoteRegistry(self.registry.address)
        transport = tnet.TcpTransport(registry, wire_dtype="f32")
        stage0 = StageExecutor(self.cfg, self.plan.stages[0], self._shard(0),
                               peer_id=f"client-{name}", device="cpu")
        return PipelineClient(self.cfg, self.plan, stage0, transport, registry,
                              settle_seconds=0.0, seed=seed), transport

    def oracle(self, prompt, n, knobs, seed=0):
        return oracle_generate(self.jcfg, self.jp, prompt, n, JSamplingParams(*knobs),
                               seed=seed)

    def stop(self):
        for srv in self.servers.values():
            srv.stop()
        self.registry.stop()


@pytest.fixture
def swarm():
    s = Swarm()
    yield s
    s.stop()


def test_concurrent_clients_coalesce_with_jax_parity(swarm):
    """Three concurrent TCP clients (two greedy, one seeded sampled): every
    client's tokens equal the JAX package's unpartitioned loop, and the
    batched final stage ran fewer rounds than the per-session total."""
    n_tokens = 6
    runs = {"a": ([5, 9, 23, 7], GREEDY, 0), "b": ([11, 3, 40], SAMPLED, 3),
            "c": ([17, 29, 2, 31, 8], GREEDY, 0)}
    results, errors = {}, {}
    barrier = threading.Barrier(len(runs))
    before = swarm.adapter.inner.decode_steps

    def run(name, prompt, knobs, seed):
        try:
            client, tx = swarm.client(name, seed)
            barrier.wait(timeout=30)
            results[name] = client.generate(prompt, max_new_tokens=n_tokens,
                                            sampling=SamplingParams(*knobs)).tokens
            tx.close()
        except Exception as exc:  # surfaced below
            errors[name] = exc

    threads = [threading.Thread(target=run, args=(n, *v)) for n, v in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not errors, errors
    for name, (prompt, knobs, seed) in runs.items():
        assert results[name] == swarm.oracle(prompt, n_tokens, knobs, seed), name
    steps = swarm.adapter.inner.decode_steps - before
    assert n_tokens - 1 <= steps < len(runs) * (n_tokens - 1)


def test_info_advertises_engine_and_rounds(swarm):
    client, tx = swarm.client("probe")
    client.generate([5, 9], max_new_tokens=3, sampling=SamplingParams(*GREEDY))
    info = tx.info("bat-s2")
    assert info["engine"] == "batched"
    assert info["decode_steps"] >= 2
    assert info["cache_tokens_left"] == 4 * 64       # every session ended
    assert tx.info("sess-s1")["engine"] == "session"
    assert "decode_steps" not in tx.info("sess-s1")
    tx.close()


def test_plain_route_prefers_batched_replica(swarm):
    """With a session replica and a batched replica of the final stage, a
    plain session routes to the batched peer and generates the JAX loop's
    tokens."""
    swarm.session_replica()
    client, tx = swarm.client("route")
    assert client.route()[-1].peer_id == "bat-s2"
    prompt = [5, 9, 23, 7]
    assert client.generate(prompt, max_new_tokens=5,
                           sampling=SamplingParams(*GREEDY)).tokens == \
        swarm.oracle(prompt, 5, GREEDY)
    assert swarm.adapter.requests_served >= 5
    tx.close()


def test_batched_failover_to_session_replica(swarm):
    """Stop the batched final stage mid-generation: the client fails over
    to the session replica (its replay lands on a peer that accepts it)
    and the greedy tokens are preserved."""
    swarm.session_replica()
    client, tx = swarm.client("fo")
    prompt = [5, 9, 23, 7]
    calls = [0]
    orig_call = tx.call

    def failing_call(peer_id, request, timeout=None):
        if peer_id == "bat-s2":
            calls[0] += 1
            if calls[0] == 3:          # mid-decode, after some tokens
                swarm.servers["bat-s2"].stop()
        return orig_call(peer_id, request, timeout=timeout)

    tx.call = failing_call
    got = client.generate(prompt, max_new_tokens=6, sampling=SamplingParams(*GREEDY)).tokens
    assert got == swarm.oracle(prompt, 6, GREEDY)
    assert client.recoveries >= 1
    assert client.route()[-1].peer_id == "sess-s2"
    tx.close()


@pytest.mark.parametrize("knobs", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_jax_client_on_port_batched_server(swarm, knobs):
    """The JAX package's client (its stage 0, TcpTransport and registry
    client) through the port's session and batched servers: the JAX loop's
    tokens."""
    jplan = JStagePlan.from_splits(swarm.jcfg.num_layers, jparse_splits(SPLITS))
    registry = jnet.RemoteRegistry(swarm.registry.address)
    transport = jnet.TcpTransport(registry, wire_dtype="f32")
    stage0 = JStageExecutor(swarm.jcfg, jplan.stages[0],
                            jslice(swarm.jcfg, swarm.jp, jplan.stages[0]), peer_id="jclient")
    client = JPipelineClient(swarm.jcfg, jplan, stage0, transport, registry,
                             settle_seconds=0.0, seed=5)
    try:
        prompt = [17, 29, 2, 31, 8]
        got = client.generate(prompt, max_new_tokens=6,
                              sampling=JSamplingParams(*knobs)).tokens
        assert got == swarm.oracle(prompt, 6, knobs, seed=5)
        assert client.route()[-1].peer_id == "bat-s2"
    finally:
        transport.close()


def test_cli_batched_swarm_matches_mode_local():
    """``--mode registry``, three ``--mode serve --batched`` processes and
    two concurrent ``--mode client`` processes (gpt2, int8, wire f32, port
    0 everywhere): each client prints the token ids ``--mode local`` prints
    for its prompt."""
    common = ["--model", "gpt2", "--quant", "int8", "--seed", "1", "--wire_dtype", "f32"]
    gen = ["--max_new_tokens", "5", "--temperature", "0"]
    prompts = ("Hi there", "Batched")
    procs = []

    def ids(out):
        found = re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M)
        assert len(found) == 1, out[-2000:]
        return found[0]

    try:
        procs.append(_port_cli("--mode", "registry", "--registry_port", "0"))
        addr = _handshake(procs[0], "REGISTRY_ADDR=").split("=", 1)[1]
        for k in (1, 2, 3):
            procs.append(_port_cli("--mode", "serve", "--stage", str(k), "--batched",
                                   "--slots", "2", "--max_session_len", "64",
                                   "--registry_addr", addr, *common))
        lines = [_handshake(p, "SERVING ", timeout_s=TIMEOUT_S) for p in procs[1:]]
        assert [ln.split()[1] for ln in lines] == ["stage=1", "stage=2", "stage=3"]
        clients = [_port_cli("--mode", "client", "--registry_addr", addr, *common,
                             *gen, "--prompt", p) for p in prompts]
        procs += clients
        outs = [c.communicate(timeout=TIMEOUT_S)[0].decode("utf-8", errors="replace")
                for c in clients]
        assert [c.returncode for c in clients] == [0, 0]
        for prompt, out in zip(prompts, outs):
            local = subprocess.run(
                [sys.executable, "-m", tmain.__name__, "--device", "cpu", "--mode", "local",
                 *common, *gen, "--prompt", prompt], cwd=REPO, capture_output=True,
                timeout=TIMEOUT_S)
            assert local.returncode == 0
            assert ids(out) == ids(local.stdout.decode("utf-8", errors="replace"))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def test_sequential_session_takes_a_round_a_step(swarm):
    """Sessions one after another (no concurrency): a round each step, the
    session engine's tokens, and the slot freed at the end."""
    client, tx = swarm.client("solo")
    before = swarm.adapter.inner.decode_steps
    prompt = [3, 1, 4, 1, 5]
    got = client.generate(prompt, max_new_tokens=4, sampling=SamplingParams(*SAMPLED)).tokens
    assert got == swarm.oracle(prompt, 4, SAMPLED)
    assert swarm.adapter.inner.decode_steps - before == 3
    assert np.all(swarm.adapter.inner.lengths == 0)
    tx.close()


# -- burst decode over loopback TCP ---------------------------------------------

BURST_PROMPT = [5, 9, 23, 7, 81]


def full_span_server(pkg, jcfg, jp, cfg, params):
    """A full-span batched server of `pkg` (peer ``{pkg}-full``) at wire f32:
    the port's behind a TcpStageServer with no runtime, warmed up with the
    4-tick burst; the JAX one as its tests build it."""
    if pkg == "jax":
        inner = jbatching.BatchedStageExecutor(
            jcfg, JStagePlan.even(jcfg.num_layers, 1).stages[0], jp, slots=4, max_len=64)
        inner.lengths = inner.lengths.astype(np.int64)   # test_torch_batching.py's reason
        adapter = jbatching.BatchingStageAdapter(inner, window_s=0.0, peer_id="jax-full")
        srv = jnet.TcpStageServer(adapter, wire_dtype="f32")
    else:
        inner = BatchedStageExecutor(cfg, StagePlan.even(cfg.num_layers, 1).stages[0], params,
                                     slots=4, max_len=64, device="cpu")
        adapter = BatchingStageAdapter(inner, window_s=0.0, peer_id="port-full")
        adapter.warmup(burst=4)
        srv = tnet.TcpStageServer(adapter, None, wire_dtype="f32")
    srv.start()
    return srv, adapter


class BurstSwarm:
    """A RegistryServer and the full-span server of one package."""

    def __init__(self, pkg):
        self.jcfg = tiny_cfg()
        self.jp = j_init_params(jax.random.PRNGKey(0), self.jcfg)
        self.cfg = port_cfg(self.jcfg)
        self.params = bridged(self.jp)
        self.registry = tnet.RegistryServer(ttl=600.0)
        self.registry.start()
        self.server, self.adapter = full_span_server(pkg, self.jcfg, self.jp, self.cfg,
                                                     self.params)
        rec = make_server_record(self.adapter.peer_id,
                                 StagePlan.even(self.cfg.num_layers, 1).stages[0],
                                 engine="batched")
        rec.address = self.server.address
        self.registry.registry.register(rec)

    def client(self, pkg, seed):
        if pkg == "jax":
            plan = JStagePlan.from_splits(self.jcfg.num_layers, jparse_splits(SPLITS))
            registry = jnet.RemoteRegistry(self.registry.address)
            transport = jnet.TcpTransport(registry, wire_dtype="f32")
            stage0 = JStageExecutor(self.jcfg, plan.stages[0],
                                    jslice(self.jcfg, self.jp, plan.stages[0]), peer_id="jclient")
            return JPipelineClient(self.jcfg, plan, stage0, transport, registry,
                                   settle_seconds=0.0, seed=seed), transport
        plan = StagePlan.from_splits(self.cfg.num_layers, parse_splits(SPLITS))
        registry = tnet.RemoteRegistry(self.registry.address)
        transport = tnet.TcpTransport(registry, wire_dtype="f32")
        stage0 = StageExecutor(self.cfg, plan.stages[0],
                               slice_stage_params(self.cfg, self.params, plan.stages[0]),
                               peer_id="tclient", device="cpu")
        return PipelineClient(self.cfg, plan, stage0, transport, registry,
                              settle_seconds=0.0, seed=seed), transport

    def stop(self):
        self.server.stop()
        self.registry.stop()


@pytest.mark.parametrize("client_pkg,server_pkg,knobs",
                         [("jax", "port", SAMPLED), ("port", "jax", SAMPLED)],
                         ids=["jax-client-port-server", "port-client-jax-server"])
def test_burst_across_packages_over_tcp(client_pkg, server_pkg, knobs):
    """A client of one package asks the other package's full-span server
    for bursts of 4, seeded sampled (greedy runs in the CLI test): the
    unpartitioned loop's tokens, every decode request a burst (no
    fallback)."""
    swarm = BurstSwarm(server_pkg)
    client, transport = swarm.client(client_pkg, seed=5)
    try:
        sp = (JSamplingParams if client_pkg == "jax" else SamplingParams)(*knobs)
        got = client.generate(BURST_PROMPT, max_new_tokens=10, sampling=sp, burst=4)
        want = oracle_generate(swarm.jcfg, swarm.jp, BURST_PROMPT, 10,
                               JSamplingParams(*knobs), seed=5)
        assert got.tokens == want
        assert swarm.adapter.inner.burst_dispatches >= len(got.decode_times_s) > 0
    finally:
        transport.close()
        swarm.stop()


def _raw_frame(sock):
    """One whole reply frame off the socket, as bytes."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "peer closed"
            buf += chunk
        return buf

    head = exact(8)
    header = exact(struct.unpack("<I", head[4:])[0])
    plen = exact(4)
    return head + header + plen + exact(struct.unpack("<I", plen)[0] + 4)


def test_burst_reply_bytes_equal_jax():
    """The same prefill and burst request to a port and a JAX full-span
    server: the ``burst`` reply frames are byte-equal (header key order,
    tokens, stop, cache length, an empty payload and its checksum)."""
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    cfg, params = port_cfg(jcfg), bridged(jp)
    frames, servers = [], []
    try:
        for pkg in ("jax", "port"):
            srv, _ = full_span_server(pkg, jcfg, jp, cfg, params)
            servers.append(srv)
            host, port = srv.address.rsplit(":", 1)
            with socket.create_connection((host, int(port)), timeout=TIMEOUT_S) as s:
                s.settimeout(TIMEOUT_S)
                sp = SamplingParams(*SAMPLED)
                pre = tnet.StageRequest(session_id="b", hidden=torch.tensor([BURST_PROMPT]),
                                        seq_len=5, cur_len=0, is_prefill=True, max_length=64,
                                        sampling=sp, step_seed=3)
                meta, body = tnet._encode_tensor(tnet._host_array(pre.hidden), "f32")
                tnet._send_frame(s, tnet._request_header(pre, meta), body)
                first = tnet._recv_frame(s)[0]["token_id"]
                req = tnet.StageRequest(session_id="b", hidden=torch.tensor([[first]]), seq_len=1,
                                        cur_len=5, is_prefill=False, max_length=64,
                                        sampling=sp, generated_tokens=(first,), step_seed=4,
                                        burst_len=4, burst_budget=4, eos_token_id=None)
                meta, body = tnet._encode_tensor(tnet._host_array(req.hidden), "f32")
                tnet._send_frame(s, tnet._request_header(req, meta), body)
                frames.append(_raw_frame(s))
    finally:
        for srv in servers:
            srv.stop()
    assert frames[1] == frames[0]
    header = json.loads(frames[1][8:8 + struct.unpack("<I", frames[1][4:8])[0]])
    assert list(header) == ["verb", "session_id", "tokens", "stop", "cache_len"]
    assert header["verb"] == "burst" and len(header["tokens"]) == 4
    assert header["cache_len"] == 9


def test_cli_burst_server_and_client(tmp_path):
    """``--mode registry``, ``--mode serve --stage 0 --batched --burst 4``
    (gpt2, int8, wire f32) and ``--mode client --burst 4``: the client's
    token ids equal ``--mode local --burst 4``'s, which has no full-span
    peer and falls back to the per-step loop (its ``burst_fallback``
    event), while the client's bursts emit none."""
    common = ["--model", "gpt2", "--quant", "int8", "--seed", "1", "--wire_dtype", "f32",
              "--max_new_tokens", "6", "--temperature", "0", "--prompt", "Burst", "--burst", "4"]
    procs = []

    def events(path):
        return [json.loads(line).get("event") for line in path.read_text().splitlines()
                if line.strip()]

    try:
        procs.append(_port_cli("--mode", "registry", "--registry_port", "0"))
        addr = _handshake(procs[0], "REGISTRY_ADDR=").split("=", 1)[1]
        procs.append(_port_cli("--mode", "serve", "--stage", "0", "--batched", "--slots", "2",
                               "--max_session_len", "64", "--registry_addr", addr, *common))
        line = _handshake(procs[1], "SERVING ", timeout_s=TIMEOUT_S)
        assert line.split()[1:3] == ["stage=0", "span=[0,12)"]
        client = _port_cli("--mode", "client", "--registry_addr", addr, *common,
                           "--events-dump", str(tmp_path / "client.jsonl"))
        procs.append(client)
        out = client.communicate(timeout=TIMEOUT_S)[0].decode("utf-8", errors="replace")
        assert client.returncode == 0, out[-2000:]
        local = subprocess.run(
            [sys.executable, "-m", tmain.__name__, "--device", "cpu", "--mode", "local",
             *common, "--events-dump", str(tmp_path / "local.jsonl")], cwd=REPO,
            capture_output=True, timeout=TIMEOUT_S)
        assert local.returncode == 0
        ids = [re.findall(r"^TOKENS=(\[[0-9, ]*\])$", o, re.M)
               for o in (out, local.stdout.decode("utf-8", errors="replace"))]
        assert len(ids[0]) == 1 and ids[0] == ids[1]
        assert "burst_fallback" not in events(tmp_path / "client.jsonl")
        assert "burst_fallback" in events(tmp_path / "local.jsonl")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
