"""Speculative decoding and session rewind on the port's session engine
against the JAX package's, on the same weights: counterparts of
``tests/test_speculative.py``.

Covered: the byte-equal n-gram drafter (``runtime/speculative.py``),
``threefry.split`` against ``jax.random.split``, the plain
``speculative_verify`` against the reference's host loop and its device
form (``speculative_verify_rows``, what the captured sampler runs) against
the plain one, then through the pipeline: perfect, garbage and n-gram
drafts, greedy and seeded sampled, over four stages in process, over TCP
and as push chains; a failover mid-generation (the replacement is replayed
the accepted rows only); EOS inside an accepted run; the journal amend of
a merged last entry (the port cuts the rejected tail, the reference keeps
the first rows); the captured verification through a CPU stub of a graph;
``--mode local --speculative_k``.

Tokens are compared exactly: the port and the reference draw from the
same threefry keys (``ops/threefry.py``), and the tiny float32 model's
logits agree to a few ulps, far from any near-tie of these prompts.
"""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    jax_mode_generate,
    one_torch_thread,
    port_args,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsampling,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
    parse_splits,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    sampling as tsampling,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    threefry as tf3,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
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
    greedy_verify,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.speculative import (
    ngram_draft,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)

from test_runtime_pipeline import build_cluster, tiny_cfg
from test_speculative import garbage_draft, perfect_draft

SPLITS = "2,4,6"
PROMPT = [5, 9, 23, 7, 81]
NEW = 16
K = 4
GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.7, 0.9, 50, 1.5)
KNOBS = {"greedy": GREEDY, "sampled": SAMPLED}
DRAFTERS = ("perfect", "garbage", "ngram")
REQUEST_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


def drafter(name, plain_tokens, vocab):
    """A fresh draft function of `name` (garbage drafts restart their seed,
    so the two packages' runs see the same ones)."""
    if name == "perfect":
        return perfect_draft(plain_tokens, len(PROMPT))
    if name == "garbage":
        return garbage_draft(vocab)
    return None             # the client's default: n-gram prompt lookup


@pytest.fixture(scope="module")
def references(weights):
    """The JAX package's plain and speculative tokens of PROMPT, greedy and
    sampled, per drafter (its four-stage cluster on the same weights), and
    its speculative rounds."""
    jcfg = weights[0]
    ref = {}
    for kind, knobs in KNOBS.items():
        client = build_cluster(jcfg, splits=SPLITS)[0]
        sp = JSamplingParams(*knobs)
        ref[("plain", kind)] = client.generate(PROMPT, NEW, sampling=sp).tokens
        for name in DRAFTERS:
            res = client.generate(
                PROMPT, NEW, sampling=sp, speculative_k=K,
                draft_fn=drafter(name, ref[("plain", kind)], jcfg.vocab_size))
            ref[(name, kind)] = res.tokens
            ref[(name, kind, "rounds")] = len(res.decode_times_s)
    return ref


# ---------------------------------------------------------------------------
# The key schedule and the verification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_split_equals_jax_random_split(n):
    for seed in (0, 1, 42, 123456789, 2 ** 31 - 1):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)).tolist()
        assert [list(k) for k in tf3.split(tf3.prng_key(seed), n)] == want
        key = torch.tensor(tf3.prng_key(seed))
        assert tf3.split(key, n).tolist() == want
        # A batch of keys splits each alone; chained splits as the host
        # loop takes them.
        batch = torch.stack([key, tf3.split(key, 2)[1]])
        assert tf3.split(batch, n)[0].tolist() == want
        rng = tf3.prng_key(seed)
        jrng = jax.random.PRNGKey(seed)
        for _ in range(3):
            rng, _, _ = tf3.split(rng, 3)
            jrng, _, _ = jax.random.split(jrng, 3)
        assert list(rng) == np.asarray(jrng).tolist()


# (logits maker, drafts maker, window, knobs): each draws seeds 0..7.
def _peaked(rng, v):
    logits = rng.standard_normal((K + 1, v)).astype(np.float32) * 4
    return logits


VERIFY_CASES = {
    # Drafts the argmax of cool rows: mostly accepted, bonus paths.
    "accept": (lambda rng, v: _peaked(rng, v) * 3, "argmax", [], (0.5, 1.0, 0, 1.0)),
    # Drafts a token the top-k cut removed: rejected at once.
    "reject": (_peaked, "cut", [], (0.8, 0.9, 4, 1.0)),
    # Random drafts under the penalty (a repeated window) and both filters.
    "penalty-filters": (_peaked, "random", [3, 3, 3, 7, 9, 3], (0.7, 0.9, 50, 1.5)),
    # No filter and no penalty; the argmax of the first row, then random.
    "plain": (_peaked, "first", [11, 12], (1.0, 1.0, 0, 1.0)),
    # top_k = 1: p(d) = 1 for the top token (always accepted), 0 for any other.
    "one-hot": (_peaked, "first", [], (0.9, 1.0, 1, 1.0)),
}


def _drafts(kind, logits, rng, v, top_k):
    if kind == "argmax":
        return [int(np.argmax(row)) for row in logits[:K]]
    if kind == "cut":
        return [int(np.argsort(row)[0]) for row in logits[:K]]
    if kind == "first":
        return [int(np.argmax(logits[0]))] + [int(x) for x in rng.integers(0, v, K - 1)]
    return [int(x) for x in rng.integers(0, v, K)]


def _window(tokens):
    recent = np.zeros(jsampling.RECENT_WINDOW, np.int32)
    recent[:len(tokens)] = tokens
    return recent


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_speculative_verify_equals_jax(case):
    """The plain version equals the reference's host loop, tokens and
    n_accepted, on the same logits, drafts, window and key; the device
    form's CPU run equals the plain version."""
    make_logits, kind, window, knobs = VERIFY_CASES[case]
    v = 64
    outcomes = set()
    for seed in range(8):
        rng = np.random.default_rng(seed)
        logits = make_logits(rng, v)
        drafts = _drafts(kind, logits, rng, v, knobs[2])
        recent = _window(window)
        jt, jn = jsampling.speculative_verify(
            jax.random.PRNGKey(seed), jnp.asarray(logits), drafts, recent, len(window), *knobs)
        pt, pn = tsampling.speculative_verify(
            tf3.prng_key(seed), torch.from_numpy(logits), drafts, torch.from_numpy(recent),
            len(window), *knobs)
        assert ([int(t) for t in jt], int(jn)) == (pt, pn)
        packed = torch.tensor([tgraphs.pack_verify_inputs(window, SamplingParams(*knobs),
                                                          seed, drafts)])
        row = tgraphs.verify_rows_packed(torch.from_numpy(logits)[None], packed)[0].tolist()
        assert (row[:row[-1] + 1], row[-1]) == (pt, pn)
        assert row[row[-1] + 1:K + 1] == [0] * (K - row[-1])
        outcomes.add(pn)
    if case == "accept":
        assert K in outcomes                      # the bonus path
    if case == "reject":
        assert outcomes == {0}
    if case == "one-hot":
        assert outcomes == {1}                    # the top token, then a miss


def test_device_form_verifies_each_request_alone():
    """Requests batched into one call of the captured sampler's verify form
    (their own knobs, windows, seeds and drafts; one greedy) verify as each
    would alone: the sampled ones as the plain version, the greedy one
    against the raw argmax. The host schedule is the plain loop's."""
    v = 64
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, K + 1, v)).astype(np.float32) * 3
    drafts = [[int(np.argmax(r)) for r in logits[0, :K]],
              [int(x) for x in rng.integers(0, v, K)],
              [int(np.argmax(logits[2, 0])), int(np.argmax(logits[2, 1])), 1, 2]]
    windows = [[4, 4, 4], [], [9]]
    knobs = [(0.7, 0.9, 50, 1.5), (1.0, 1.0, 0, 1.0), (0.0, 0.9, 50, 1.5)]
    seeds = [3, 4, 5]
    out = tgraphs.Sampler("cpu").verify(torch.from_numpy(logits), [
        (windows[b], SamplingParams(*knobs[b]), seeds[b], drafts[b]) for b in range(3)])
    for b in range(2):
        want = tsampling.speculative_verify(
            tf3.prng_key(seeds[b]), torch.from_numpy(logits[b]), drafts[b],
            torch.from_numpy(_window(windows[b])), len(windows[b]), *knobs[b])
        assert (list(out[b][0]), out[b][1]) == want
    greedy = greedy_verify(np.argmax(logits[2], -1).tolist(), drafts[2])
    assert out[2] == greedy and greedy[1] == 2
    # The schedule: position i's window holds d_1..d_i; the keys the chain
    # of PRNGKey(seed) that the host loop splits.
    wins, key_u, key_r = tsampling.verify_schedule(windows[0], drafts[0], seeds[0])
    assert wins[-1] == windows[0] + drafts[0] and len(key_u) == K and len(key_r) == K + 1
    rng = tf3.prng_key(seeds[0])
    for i in range(K):
        rng, ku, kr = tf3.split(rng, 3)
        assert (key_u[i], key_r[i]) == (ku, kr)
    assert key_r[K] == tf3.split(rng, 2)[1]


def test_ngram_drafter_is_the_reference_copy():
    assert ngram_draft([1, 2, 3, 4, 9, 1, 2], 2) == (3, 4)
    assert ngram_draft([7, 1, 7, 5, 9, 7], 1, max_ngram=1) == (5,)
    assert ngram_draft([1, 2, 3], 3) == ()


# ---------------------------------------------------------------------------
# Through the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DRAFTERS)
@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_speculative_tokens_equal_jax(weights, references, kind, name):
    """Four stages in process: the port's speculative tokens equal the
    JAX package's at the same weights, seed and drafts, in as many rounds;
    greedy ones equal the plain run's too. Perfect greedy drafts take
    ceil((NEW - 1) / (K + 1)) rounds."""
    _, _, tcfg, tp = weights
    client, _ = build_port_cluster(tcfg, tp, SPLITS)
    sp = SamplingParams(*KNOBS[kind])
    plain = client.generate(PROMPT, NEW, sampling=sp).tokens
    assert plain == references[("plain", kind)]
    res = client.generate(PROMPT, NEW, sampling=sp, speculative_k=K,
                          draft_fn=drafter(name, plain, tcfg.vocab_size))
    assert res.tokens == references[(name, kind)]
    assert len(res.decode_times_s) == references[(name, kind, "rounds")]
    if kind == "greedy":
        assert res.tokens == plain
        if name == "perfect":
            assert len(res.decode_times_s) == math.ceil((len(plain) - 1) / (K + 1))


def test_rewinding_step_is_no_mismatch(weights, caplog):
    """A decode step that carries start_from_position below the server's
    length rewinds without the past-len warning; one past it is refused."""
    _, _, tcfg, tp = weights
    plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
    ex = StageExecutor(tcfg, plan.stages[1],
                       tmain._stage_params(port_args([]), tcfg, tp, plan.stages[1]),
                       device="cpu")
    d = tcfg.hidden_size
    ex.forward(StageRequest("s", torch.zeros(1, 5, d), 5, 0, True, 32))
    ex.forward(StageRequest("s", torch.zeros(1, 3, d), 3, 5, False, 32))
    caplog.clear()
    with caplog.at_level("WARNING"):
        out = ex.forward(StageRequest("s", torch.zeros(1, 2, d), 2, 6, False, 32,
                                      start_from_position=6))
    assert out.cache_len == 8 and "mismatch" not in caplog.text
    with pytest.raises(StageExecutionError, match="rewind to 9 outside"):
        ex.forward(StageRequest("s", torch.zeros(1, 1, d), 1, 9, False, 32,
                                start_from_position=9))


def test_final_stage_refuses_a_step_of_another_width(weights):
    _, _, tcfg, tp = weights
    plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
    ex = StageExecutor(tcfg, plan.stages[-1],
                       tmain._stage_params(port_args([]), tcfg, tp, plan.stages[-1]),
                       device="cpu")
    d = tcfg.hidden_size
    ex.forward(StageRequest("s", torch.zeros(1, 5, d), 5, 0, True, 32))
    with pytest.raises(StageExecutionError, match="want K\\+1"):
        ex.forward(StageRequest("s", torch.zeros(1, 2, d), 2, 5, False, 32,
                                draft_tokens=(1, 2)))
    assert ex.arena.get("s").cache_len == 5


class TcpStages:
    """The port's stages 1-3 behind TCP servers (session executors with a
    compute thread each, wire f32) and clients over one registry."""

    def __init__(self, weights):
        _, _, tcfg, tp = weights
        self.weights = weights
        self.registry = PlacementRegistry(rng=random.Random(0))
        self.plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS))
        self.servers, self.transports = [], []
        for spec in self.plan.stages[1:]:
            peer = f"tcp-s{spec.index}"
            srv = tnet.TcpStageServer(StageExecutor(
                tcfg, spec, tmain._stage_params(port_args([]), tcfg, tp, spec),
                peer_id=peer, device="cpu"), StageRuntime(), wire_dtype="f32")
            srv.start()
            self.servers.append(srv)
            rec = make_server_record(peer, spec)
            rec.address = srv.address
            self.registry.register(rec)

    def client(self, chain=False):
        _, _, tcfg, tp = self.weights
        transport = tnet.TcpTransport(self.registry, wire_dtype="f32")
        self.transports.append(transport)
        stage0 = StageExecutor(tcfg, self.plan.stages[0],
                               tmain._stage_params(port_args([]), tcfg, tp,
                                                   self.plan.stages[0]),
                               peer_id="client-local", device="cpu")
        return PipelineClient(tcfg, self.plan, stage0, transport, self.registry,
                              settle_seconds=0.0, seed=0, use_push_chain=chain,
                              request_timeout=REQUEST_TIMEOUT_S)

    def stop(self):
        for t in self.transports:
            t.close()
        for srv in self.servers:
            srv.stop()


@pytest.fixture(scope="module")
def tcp_stages(weights):
    stages = TcpStages(weights)
    yield stages
    stages.stop()


@pytest.mark.parametrize("chain", [False, True], ids=["per-hop", "chain"])
@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_speculative_over_tcp(weights, references, tcp_stages, kind, chain):
    """Over TCP at wire f32, per hop and as a push chain (the final hop's
    ``spec`` reply relayed back unchanged): the in-process tokens."""
    client = tcp_stages.client(chain=chain)
    sp = SamplingParams(*KNOBS[kind])
    res = client.generate(PROMPT, NEW, sampling=sp, speculative_k=K,
                          draft_fn=drafter("perfect", references[("plain", kind)],
                                           weights[2].vocab_size))
    assert res.tokens == references[("perfect", kind)]


@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_speculative_push_chain_in_process(weights, references, kind):
    """LocalTransport's chain returns the final stage's verified run as it
    came: the per-hop tokens."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    client.use_push_chain = True
    entries = []
    transport.on_call = lambda peer, req: len(req.next_servers) == 2 and entries.append(peer)
    res = client.generate(PROMPT, NEW, sampling=SamplingParams(*KNOBS[kind]),
                          speculative_k=K, draft_fn=drafter("garbage", None, tcfg.vocab_size))
    assert res.tokens == references[("garbage", kind)]
    # One entry call a step: the prefill and each round.
    assert len(entries) == 1 + len(res.decode_times_s)


def test_speculative_failover_replays_only_accepted_rows(weights, references):
    """The pinned stage-2 peer fails after the second round: the client
    fails over to its replica, which is replayed the journal, contiguous
    rows that end where the retried round starts (no rejected draft among
    them), and the tokens equal the fault-free run's."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS, replicas=2)
    seen = {"peer": None, "calls": 0}
    replays, retried = [], []

    def tap(peer_id, req):
        if req.is_replay:
            replays.append((peer_id, req.cur_len, req.seq_len))
            return
        if req.start_block != 4:
            return
        if seen["peer"] is None:
            seen["peer"] = peer_id
        seen["calls"] += 1
        if seen["calls"] == 3:                     # prefill + 2 rounds done
            transport.fail_next(seen["peer"], 1)
        if seen["calls"] >= 3 and peer_id != seen["peer"]:
            retried.append(req.cur_len)

    transport.on_call = tap
    res = client.generate(PROMPT, NEW, sampling=SamplingParams(*GREEDY), speculative_k=K,
                          draft_fn=drafter("garbage", None, tcfg.vocab_size))
    assert res.tokens == references[("garbage", "greedy")]
    assert client.recoveries == 1
    assert replays and retried
    pos = 0
    for _, cur, n in replays:
        assert cur == pos
        pos += n
    assert pos == retried[0]


def test_speculative_eos_inside_accepted_run(weights, references):
    _, _, tcfg, tp = weights
    client, _ = build_port_cluster(tcfg, tp, SPLITS)
    ref = references[("plain", "greedy")]
    j = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i] and i % (K + 1) != 1)
    res = client.generate(PROMPT, NEW, sampling=SamplingParams(*GREEDY), eos_token_id=ref[j],
                          speculative_k=K, draft_fn=drafter("perfect", ref, tcfg.vocab_size))
    assert res.tokens == ref[:j + 1]
    assert res.stopped_by == "eos"


def test_journal_amend_of_a_merged_entry_keeps_the_prompt(weights, references):
    """With one journal entry a hop, the first round is merged into the
    prefill's entry before it is amended. The reference cuts the entry to
    the round's accepted rows (the prompt's rows go); the port drops the
    rejected tail and keeps them, so a failover afterwards replays the
    whole session and the tokens stay the fault-free run's."""
    jcfg, _, tcfg, tp = weights
    sp_j, sp_t = JSamplingParams(*GREEDY), SamplingParams(*GREEDY)
    ref = references[("plain", "greedy")]
    jclient = build_cluster(jcfg, splits=SPLITS)[0]
    jclient.journal_max_entries = 1
    client, transport = build_port_cluster(tcfg, tp, SPLITS, replicas=2)
    client.journal_max_entries = 1
    garbage = drafter("garbage", None, tcfg.vocab_size)
    kept = []
    for c, sp in ((jclient, sp_j), (client, sp_t)):
        steps = c.generate_stepwise(PROMPT, NEW, sampling=sp, session_id="amend",
                                    speculative_k=K,
                                    draft_fn=drafter("garbage", None, tcfg.vocab_size))
        next(steps)                 # the prefill
        next(steps)                 # the first round: one token kept
        kept.append([(e.cur_len, e.seq_len) for e in c.journal["stage2"]["amend"]])
        steps.close()
    assert kept[0] == [(0, 1)]                       # the reference's cut
    assert kept[1] == [(0, len(PROMPT) + 1)]         # the port's
    failed = {"n": 0}

    def tap(peer_id, req):
        if req.start_block == 4 and not req.is_replay:
            failed["n"] += 1
            if failed["n"] == 3:
                transport.fail_next(peer_id, 1)

    transport.on_call = tap
    res = client.generate(PROMPT, NEW, sampling=sp_t, speculative_k=K, draft_fn=garbage)
    assert client.recoveries == 1 and res.tokens == ref


# ---------------------------------------------------------------------------
# Captured verification (CPU stub of a graph) and the CLI
# ---------------------------------------------------------------------------

class StubGraph:
    """A CPU stand-in for a CUDA graph: replay() runs the captured function
    again into the same static output (a tensor or a tuple of them)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        pairs = zip(self.out, new) if isinstance(self.out, tuple) else [(self.out, new)]
        for out, value in pairs:
            out.copy_(value)


class HostInts:
    """StagedInts without pinned memory."""

    def __init__(self, shape, device):
        self.tensor = torch.zeros(shape, dtype=torch.int64)

    def load(self, values):
        self.tensor.view(-1).copy_(torch.tensor(values, dtype=torch.int64))
        return self.tensor


@pytest.fixture
def stub_sampler_graphs(monkeypatch):
    def record(fn, pool, stream):
        out = fn()
        return StubGraph(fn, out), out

    monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
    monkeypatch.setattr(tgraphs, "_record", record)
    monkeypatch.setattr(tgraphs, "StagedInts", HostInts)
    monkeypatch.setattr(tgraphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraphs.torch.cuda, "Stream", lambda *a, **k: None)


def test_warmup_captures_the_verification_of_every_width(weights, references,
                                                         stub_sampler_graphs):
    """The final stage's warm-up with speculative_k captures the sampled
    verification of widths 2..K+1; a sampled speculative generation then
    captures no sampler graph and replays one a sampled round, with the
    tokens of the direct run."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    last = transport.executor(transport.peers()[-1])
    last.sampler.enabled = True
    last.warmup(speculative_k=K)
    # The warm-up steps' sampler, then one verify graph a width.
    assert last.sampler.captures == 1 + K
    last.sampler.replays = 0
    res = client.generate(PROMPT, NEW, sampling=SamplingParams(*SAMPLED), speculative_k=K,
                          draft_fn=drafter("garbage", None, tcfg.vocab_size))
    assert res.tokens == references[("garbage", "sampled")]
    assert last.sampler.captures == 1 + K
    # Each round one verify replay; the prefill's token one more.
    assert last.sampler.replays == len(res.decode_times_s) + 1


def test_cli_local_speculative_prints_the_plain_tokens(monkeypatch, capsys, weights):
    """``--mode local --speculative_k 4`` prints the TOKENS= of the run
    without it (greedy) and of the JAX package's ``--mode local
    --speculative_k 4``; ``--mode oracle`` warns and ignores the flag."""
    jcfg, jp, tcfg, tp = weights
    base = ["--mode", "local", "--splits", SPLITS, "--temperature", "0",
            "--max_new_tokens", str(NEW), "--prompt", "spec spec spec decoding"]
    lines = []
    for extra in ([], ["--speculative_k", str(K)]):
        assert tmain.run_local(port_args(base + extra), tcfg, tp) == 0
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("TOKENS=")])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    jgen, jargs = jax_mode_generate(monkeypatch, base + ["--speculative_k", str(K)], jcfg, jp)
    ids = [i % tcfg.vocab_size for i in tmain.load_tokenizer().encode(jargs.prompt)]
    jres = jgen(ids, NEW, sampling=JSamplingParams(temperature=0.0), speculative_k=K)
    assert lines[1][0] == f"TOKENS={jres.tokens}"
    oracle = port_args(["--mode", "oracle", "--temperature", "0", "--max_new_tokens", "4",
                        "--speculative_k", str(K)])
    with pytest.MonkeyPatch.context() as mp:
        warned = []
        mp.setattr(tmain.logger, "warning", lambda *a, **k: warned.append(a[0] % a[1:]))
        assert tmain.run_oracle(oracle, tcfg, tp) == 0
    assert any("--speculative_k is ignored in --mode oracle" in w for w in warned)
