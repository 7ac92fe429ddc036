"""Beam search and top-N logprobs on the port's session engines against the
JAX package's, on the same weights: counterparts of
``tests/test_beam_search.py``.

Covered: ``PipelineClient.beam_search`` against the reference's for 1, 2
and 4 beams with and without EOS (one beam: the greedy tokens); one final
stage step's ``top_tokens`` / ``top_logprobs`` against the reference
executor's; `_merge_entries`' composition of reorders against the
reference's on random permutations; failover mid-search with and without a
coalesced journal; the prefill at batch 1; the arena's accounting after the
growth and after the session ends; ``hypo_ids`` refusals; the in-place
reorder (same buffers, same slot) and the growth into a pair of the new
shape; a beam search through captured steps (a CPU stub of the graph
object) that replays its steps and captures nothing the second time; beam
over TCP across packages both ways; the "exotic" route around a batched
peer; and the push chain's refusal.

Tolerance: tokens are compared exactly (the two frameworks' float32
logits agree to a few ulps, far from any near-tie of these prompts);
scores within 1e-5 relative and log-probs within 1e-5 absolute (float32
sums in other orders). Equal log-probs may come in another order: a
differing token must tie its counterpart within the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    one_torch_thread,
    port_args,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    slice_stage_params as jslice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    client as jclient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.messages import (
    StageRequest as JStageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    client as tclient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.kv_cache import (
    KVArena,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)

from test_runtime_pipeline import build_cluster, tiny_cfg
from test_torch_graphs import stub_graphs  # noqa: F401 (a fixture)
from test_torch_tcp import Swarm

SPLITS = "2,4,6"
PROMPT = [5, 9, 23, 7, 81]
NEW = 6
TOL = 1e-5
BEAMS = (1, 2, 4)


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


@pytest.fixture(scope="module")
def references(weights):
    """The JAX package's beam results of PROMPT (one cluster, compiled
    once a batch shape): per beam count, without EOS and with EOS the
    third token of that search (so the EOS rules fire); and the port's
    greedy tokens (the JAX package's, ``test_torch_pipeline.py``)."""
    jcfg, _, tcfg, tp = weights
    client = build_cluster(jcfg, splits=SPLITS)[0]
    ref = {"greedy": build_port_cluster(tcfg, tp, SPLITS)[0].generate(
        PROMPT, NEW, sampling=SamplingParams(temperature=0.0)).tokens}
    for nb in BEAMS:
        plain = client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=nb)
        ref[(nb, None)] = plain
        ref[(nb, "eos")] = client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=nb,
                                              eos_token_id=plain.tokens[2])
    return ref


def eos_of(references, nb, eos):
    return None if eos is None else references[(nb, None)].tokens[2]


@pytest.mark.parametrize("eos", [None, "eos"])
@pytest.mark.parametrize("nb", BEAMS)
def test_beam_search_equals_jax(weights, references, nb, eos):
    """The reference's tokens and, within 1e-5 relative, its score; one
    beam gives the greedy tokens."""
    _, _, tcfg, tp = weights
    client, _ = build_port_cluster(tcfg, tp, SPLITS)
    got = client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=nb,
                             eos_token_id=eos_of(references, nb, eos))
    want = references[(nb, eos)]
    assert got.tokens == want.tokens
    np.testing.assert_allclose(got.score, want.score, rtol=TOL)
    assert got.num_beams == nb
    if nb == 1 and eos is None:
        assert got.tokens == references["greedy"][:len(got.tokens)]
    if eos is not None:
        assert got.tokens[-1] == eos_of(references, nb, eos) or len(got.tokens) == NEW


def assert_candidates_close(got_tokens, got_logp, want_tokens, want_logp):
    got_logp, want_logp = np.asarray(got_logp), np.asarray(want_logp)
    assert got_logp.shape == want_logp.shape
    np.testing.assert_allclose(got_logp, want_logp, rtol=0, atol=TOL)
    for r, (gt, wt) in enumerate(zip(got_tokens, want_tokens)):
        for j, (a, b) in enumerate(zip(gt, wt)):
            if a != b:   # equal log-probs in another order
                lp = dict(zip(wt, want_logp[r]))
                assert a in lp and abs(lp[a] - got_logp[r, j]) <= TOL, (r, j, a, b)


def test_top_logprobs_equal_the_jax_executor(weights):
    """The final stage's prefill at batch 1, a step that grows it to 3 rows
    and a step that permutes them, each with num_logprobs = 6, against the
    reference executor on the same arriving rows."""
    jcfg, jp, tcfg, tp = weights
    spec_j = build_cluster(jcfg, splits=SPLITS)[4].stages[-1]
    spec_t = build_port_cluster(tcfg, tp, SPLITS)[0].plan.stages[-1]
    jex = JStageExecutor(jcfg, spec_j, jslice_stage_params(jcfg, jp, spec_j))
    tex = StageExecutor(tcfg, spec_t, tmain._stage_params(port_args([]), tcfg, tp, spec_t),
                        device="cpu")
    rng = np.random.default_rng(0)
    d = jcfg.hidden_size
    steps = [(rng.standard_normal((1, 5, d)).astype(np.float32), True, 0, None),
             (rng.standard_normal((3, 1, d)).astype(np.float32), False, 5, (0, 0, 0)),
             (rng.standard_normal((3, 1, d)).astype(np.float32), False, 6, (2, 0, 0))]
    for hidden, prefill, cur, hypo in steps:
        kw = dict(session_id="s", seq_len=hidden.shape[1], cur_len=cur, is_prefill=prefill,
                  max_length=16, hypo_ids=hypo, num_logprobs=6)
        want = jex.forward(JStageRequest(hidden=jnp.asarray(hidden), **kw))
        got = tex.forward(StageRequest(hidden=torch.from_numpy(hidden), **kw))
        assert got.is_beam and got.token_id is None and got.cache_len == want.cache_len
        assert_candidates_close(got.top_tokens, got.top_logprobs, want.top_tokens,
                                want.top_logprobs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_entries_composes_reorders_like_jax(seed):
    """Coalescing a run of entries, each with a random reorder (or none),
    gives the reference's hidden rows and composed hypo_ids."""
    rng = np.random.default_rng(seed)
    nb, d = 4, 3
    entries = []
    for i in range(6):
        hidden = rng.standard_normal((nb, i % 2 + 1, d)).astype(np.float32)
        hypo = None if i == 0 or rng.random() < 0.3 else tuple(
            int(v) for v in rng.integers(0, nb, nb))
        entries.append((hidden, hypo))
    want = jclient.JournalEntry(entries[0][0], entries[0][0].shape[1], 0, entries[0][1])
    got = tclient.JournalEntry(torch.from_numpy(entries[0][0]), entries[0][0].shape[1], 0,
                               entries[0][1])
    cur = entries[0][0].shape[1]
    for hidden, hypo in entries[1:]:
        want = jclient._merge_entries(want, jclient.JournalEntry(hidden, hidden.shape[1],
                                                                 cur, hypo))
        got = tclient._merge_entries(got, tclient.JournalEntry(torch.from_numpy(hidden),
                                                               hidden.shape[1], cur, hypo))
        cur += hidden.shape[1]
        assert np.array_equal(got.hidden.numpy(), want.hidden)
        assert got.hypo_ids == want.hypo_ids
        assert (got.seq_len, got.cur_len) == (want.seq_len, want.cur_len)


@pytest.mark.parametrize("coalesced", [False, True], ids=["journal", "coalesced"])
@pytest.mark.parametrize("nb", BEAMS)
def test_failover_mid_search_replays_the_reorders(weights, references, nb, coalesced):
    """The pinned stage-2 peer dies after its 3rd beam step: its replica is
    replayed the journal with each entry's reorder (composed by merges when
    the journal is bounded at 2 entries) and the tokens and score are the
    JAX package's fault-free run's. One beam's reorders are all the
    identity, sent as None."""
    _, _, tcfg, tp = weights
    want = references[(nb, None)]
    client, transport = build_port_cluster(tcfg, tp, SPLITS, replicas=2)
    if coalesced:
        client.journal_max_entries = 2
    seen, replayed, journal = [0], [], []

    def on_call(peer_id, req):
        if req.is_replay:
            if not replayed:    # the journal the replay walks
                journal.extend(e.hypo_ids for e in client.journal["stage2"][req.session_id])
            replayed.append((req.hidden.shape[0], req.hypo_ids))
        elif not req.is_prefill and "s2" in peer_id:
            seen[0] += 1
            if seen[0] == 3:
                transport.kill(peer_id)

    transport.on_call = on_call
    got = client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=nb)
    assert got.tokens == want.tokens
    np.testing.assert_allclose(got.score, want.score, rtol=TOL)
    assert client.recoveries >= 1
    # The first replayed entry goes as a prefill, without its reorder.
    assert replayed and replayed[0][1] is None
    growth = None if nb == 1 else (0,) * nb
    if coalesced:
        # The growth and the reorders after it composed into the first
        # entry: a prefill of nb rows.
        assert len(journal) <= 3 and (journal[0] is None) == (nb == 1)
        assert replayed[0][0] == nb
    else:
        assert len(journal) == len(replayed) and journal[1] == growth
        assert [h for _, h in replayed[1:]] == journal[1:]


def test_prefill_runs_once_at_batch_one(weights):
    """Every stage's prefill, stage 0's included, runs one row; the first
    step grows every stage to num_beams rows with (0,) * num_beams."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    calls = []
    forward = client.stage0.forward

    def stage0(req):
        calls.append(("stage0", req.is_prefill, tuple(req.hidden.shape[:1]), req.hypo_ids))
        return forward(req)

    client.stage0.forward = stage0
    transport.on_call = lambda peer, req: calls.append(
        (peer, req.is_prefill, tuple(req.hidden.shape[:1]), req.hypo_ids))
    client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=3)
    prefills = [c for c in calls if c[1]]
    assert len(prefills) == 4 and all(c[2] == (1,) for c in prefills)
    first_step = [c for c in calls if not c[1]][:4]
    assert all(c[2] == (3,) and c[3] == (0, 0, 0) for c in first_step)


def test_arena_accounting_balanced_after_growth_and_session_end(weights):
    """After the growth each stage's lease holds nb rows of the batch-1
    lease's bytes; after the session ends nothing is leased and both pairs
    sit on the free list (their bytes counted once)."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    nb = 4
    executors = [client.stage0] + [transport.executor(p) for p in transport.peers()]
    one_row = {id(ex): ex.arena.bytes_for(128, ex.arena.num_layers, 1) for ex in executors}
    during = []

    def on_call(peer, req):
        if not req.is_prefill and req.hypo_ids is None and not during:
            during.extend((ex.arena.used_bytes, nb * one_row[id(ex)]) for ex in executors)

    transport.on_call = on_call
    client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=nb)
    assert during and all(used == want for used, want in during)
    for ex in executors:
        assert ex.arena.used_bytes == 0
        assert ex.arena._free_bytes == (1 + nb) * one_row[id(ex)]
        assert sorted(shape[1] for shape in ex.arena._free) == [1, nb]


def test_growth_past_the_budget_is_a_stage_error(weights):
    """resize_batch never waits: an arena that cannot hold the grown rows
    refuses the step at once, and the session keeps its batch-1 lease."""
    _, _, tcfg, tp = weights
    spec = build_port_cluster(tcfg, tp, SPLITS)[0].plan.stages[1]
    ex = StageExecutor(tcfg, spec, tmain._stage_params(port_args([]), tcfg, tp, spec),
                       device="cpu")
    ex.arena.max_bytes = 2 * ex.arena.bytes_for(128, spec.num_layers, 1)
    d = tcfg.hidden_size
    ex.forward(StageRequest("s", torch.zeros(1, 3, d), 3, 0, True, 16))
    with pytest.raises(StageExecutionError, match="cannot grow"):
        ex.forward(StageRequest("s", torch.zeros(4, 1, d), 1, 3, False, 16,
                                hypo_ids=(0, 0, 0, 0)))
    handle = ex.arena.get("s")
    assert handle.k.shape[1] == 1 and ex.arena.used_bytes == handle.nbytes


@pytest.mark.parametrize("hypo", [(0, 5), (-1, 0), (0,)], ids=["past", "negative", "rows"])
def test_bad_hypo_ids_are_refused(weights, hypo):
    """Out-of-range ids (checked on the host, before any device index) and
    a row count that is not the batch's raise StageExecutionError, and the
    session steps on after it."""
    _, _, tcfg, tp = weights
    _, transport = build_port_cluster(tcfg, tp, SPLITS)
    ex = transport.executor(transport.peers()[0])
    d = tcfg.hidden_size
    ex.forward(StageRequest("s", torch.zeros(2, 3, d), 3, 0, True, 16))
    with pytest.raises(StageExecutionError, match="hypo_ids"):
        ex.forward(StageRequest("s", torch.zeros(2, 1, d), 1, 3, False, 16, hypo_ids=hypo))
    assert ex.forward(StageRequest("s", torch.zeros(2, 1, d), 1, 3, False, 16)).cache_len == 4


def test_reorder_moves_rows_in_place_and_growth_moves_to_a_new_pair():
    """A same-batch reorder writes the lease's own buffers (same storage,
    same slot: a captured step reads the new rows), valid positions only;
    growth takes a pair of the new shape, the old pair going on the free
    list, and a later session of that shape takes it back."""
    arena = KVArena(num_layers=2, num_kv_heads=1, head_dim=2, max_bytes=1 << 20,
                    device="cpu", dtype=torch.float32)
    h = arena.allocate("a", 8, batch=1)
    h.k.copy_(torch.randn(h.k.shape))
    h.advance(5)
    old_k, old_slot = h.k.clone(), h.slot
    arena.resize_batch("a", 3, (0, 0, 0))
    assert h.k.shape[1] == 3 and h.slot != old_slot
    assert torch.equal(h.k[:, :, :5], old_k[:, [0, 0, 0], :5])
    assert arena.used_bytes == h.nbytes == 3 * arena.bytes_for(128, 2, 1)
    h.k[:, 1, :5] += 1.0
    before = h.k.clone()
    ptrs, slot = (h.k.data_ptr(), h.v.data_ptr()), h.slot
    h.reorder((1, 2, 1))
    assert (h.k.data_ptr(), h.v.data_ptr()) == ptrs and h.slot == slot
    assert torch.equal(h.k[:, :, :5], before[:, [1, 2, 1], :5])
    assert torch.equal(h.k[:, :, 5:], before[:, :, 5:])
    arena.free("a")
    assert arena.allocate("b", 8, batch=1).slot == old_slot
    assert arena.allocate("c", 8, batch=3).slot == slot


def test_beam_through_captured_steps(weights, references, stub_graphs):
    """With every step and the top-N call captured (a CPU stub that replays
    the captured function over the tensors it was captured with), the
    tokens are the direct run's: every reorder wrote the buffers the
    graphs read. The second search captures nothing: its batch-1 lease and
    its grown lease take the freed pairs and their graphs."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    executors = [client.stage0] + [transport.executor(p) for p in transport.peers()]
    for ex in executors:
        ex.graphs.enabled = ex.sampler.enabled = True
    want = references[(4, None)]
    for run in range(2):
        got = client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=4)
        assert got.tokens == want.tokens
        np.testing.assert_allclose(got.score, want.score, rtol=TOL)
        if run == 0:
            captures = [(ex.graphs.captures, ex.sampler.captures) for ex in executors]
            for ex in executors:
                ex.graphs.replays = ex.sampler.replays = 0
    assert [(ex.graphs.captures, ex.sampler.captures) for ex in executors] == captures
    # One replay a step on every stage; one top-N replay a step on the last.
    assert all(ex.graphs.replays == NEW for ex in executors)
    assert executors[-1].sampler.replays == NEW
    assert {k[0] for k in executors[-1].sampler._graphs} == {"topn"}


@pytest.fixture(scope="module")
def tcp_clients(weights):
    """Per direction, a client of one package against TCP stage servers of
    the other (wire f32, stages split as ``test_torch_tcp.py`` splits
    them): "jax-port" (the port encodes the ``beam`` reply) and
    "port-jax" (the port decodes it)."""
    swarms, clients = [], {}
    for client_pkg, server_pkg in (("jax", "port"), ("port", "jax")):
        swarm = Swarm(weights, {1: [server_pkg], 2: [server_pkg], 3: [server_pkg]}, "f32")
        swarms.append(swarm)
        clients[f"{client_pkg}-{server_pkg}"] = swarm.client(client_pkg)
    yield clients
    for swarm in swarms:
        swarm.stop()


@pytest.mark.parametrize("direction", ["jax-port", "port-jax"])
@pytest.mark.parametrize("nb", BEAMS)
def test_beam_over_tcp_across_packages(weights, references, tcp_clients, nb, direction):
    """Across packages over TCP: the JAX package's in-process tokens and,
    within 1e-5 relative, its score."""
    got = tcp_clients[direction].beam_search(PROMPT, max_new_tokens=NEW, num_beams=nb)
    want = references[(nb, None)]
    assert got.tokens == want.tokens
    np.testing.assert_allclose(got.score, want.score, rtol=TOL)


def test_beam_session_routes_around_a_batched_peer(weights, references):
    """Stage 2 has a session peer and one registered as a batched engine: a
    plain session takes the batched peer, a beam session (the "exotic"
    kind) the session peer, whatever the prompt's affinity."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    spec = client.plan.stages[2]
    transport.add_peer("batched-s2", StageExecutor(
        tcfg, spec, tmain._stage_params(port_args([]), tcfg, tp, spec), device="cpu"))
    client.registry.register(make_server_record("batched-s2", spec, engine="batched"))
    seen = []
    transport.on_call = lambda peer, req: seen.append((peer, req.num_logprobs > 0))
    client.generate(PROMPT, 2, sampling=SamplingParams(temperature=0.0))
    assert ("batched-s2", False) in seen
    seen.clear()
    got = client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=2)
    assert got.tokens == references[(2, None)].tokens
    assert seen and not any(peer == "batched-s2" for peer, _ in seen)


def test_beam_search_refuses_a_push_chain(weights):
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, SPLITS)
    client.use_push_chain = True
    calls = []
    transport.on_call = lambda peer, req: calls.append(peer)
    with pytest.raises(ValueError, match="use_push_chain"):
        client.beam_search(PROMPT, max_new_tokens=NEW, num_beams=2)
    assert not calls and client.stage0.arena.used_bytes == 0
