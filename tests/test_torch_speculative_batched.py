"""Speculative rounds and session rewind on the port's batched engine and
its adapter against the JAX package's, on the same weights: counterparts
of the speculative tests of ``tests/test_batching.py``.

Covered: a multi-token step (the verify width) and `rewind` on the engine,
the head over every row of the round (``round_rows``) against the JAX
head; rewind bounds; draft steps of two sessions coalesced into one round
and verified row by row (greedy and seeded sampled), with each slot rewound
past its rejected tail; a speculative client routed to a batched peer;
sampled speculative tokens of a batched peer equal to a session peer's;
the adapter's warm-up of the speculative widths and their verify graphs
through a CPU stub of a graph. Tolerances as ``tests/test_torch_batching.py``.
"""

import dataclasses
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    one_torch_thread,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    batching as jbatching,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    batching as tbatching,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    PipelineClient,
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    LocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)

from test_runtime_pipeline import tiny_cfg
from test_speculative import perfect_draft
from test_torch_batching import (
    GREEDY,
    PROMPTS,
    SAMPLED,
    _jreq,
    _treq,
    engines,
    jax_engine,
    weights,
)
from test_torch_speculative import HostInts, StubGraph

# The reference's batched-engine tests stop at stage 1 of a 2-stage split.
SPLIT = "4"


def _cluster_spec(jcfg):
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
        StagePlan,
        parse_splits,
    )

    return StagePlan.from_splits(jcfg.num_layers, parse_splits(SPLIT))


def test_batched_multi_token_step_and_rewind():
    """A T = 3 step for one session (the other masked) gives the JAX
    engine's hidden rows and, in ``round_rows``, its head over every row;
    a rewind then regenerates from the accepted prefix as the JAX engine
    does, and the other session is untouched."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=4)
    je, te = engines(jcfg, jp, tp, slots=2)
    pa, pb = PROMPTS["a"], PROMPTS["b"]
    toks = {}
    for sid, p in (("a", pa), ("b", pb)):
        hj = je.prefill(sid, np.asarray(p, np.int32)[None, :])
        ht = te.prefill(sid, torch.tensor([p]))
        assert_close(ht, hj)
        toks[sid] = int(jnp.argmax(je.logits(hj)[0, -1]))
    step = [toks["a"], 17, 33]
    oj = je.decode_batch({"a": jnp.asarray([step], jnp.int32)})
    ot = te.decode_batch({"a": torch.tensor([step])})
    assert_close(ot["a"], oj["a"])
    lj = je.logits(oj["a"])[0]
    assert_close(te.round_rows[te.slot("a")], lj)
    assert_close(te.round_logits[te.slot("a")], lj[-1])
    for eng in (je, te):
        eng.rewind("a", len(pa) + 1)
    nxt = int(jnp.argmax(lj[0]))
    oj = je.decode_batch({"a": jnp.asarray([[nxt]], jnp.int32)})
    ot = te.decode_batch({"a": torch.tensor([[nxt]])})
    assert_close(ot["a"], oj["a"])
    assert_close(te.round_logits[te.slot("a")], je.logits(oj["a"])[0, -1])
    oj = je.decode_batch({"b": jnp.asarray([[toks["b"]]], jnp.int32)})
    ot = te.decode_batch({"b": torch.tensor([[toks["b"]]])})
    assert_close(te.round_logits[te.slot("b")], je.logits(oj["b"])[0, -1])
    assert list(te.lengths) == [int(n) for n in je.lengths]


def test_batched_rewind_bounds():
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=4)
    je, te = engines(jcfg, jp, tp, slots=1, max_len=32)
    for eng, x in ((je, np.asarray([[1, 2, 3]], np.int32)), (te, torch.tensor([[1, 2, 3]]))):
        eng.prefill("s", x)
        with pytest.raises(ValueError):
            eng.rewind("s", 4)
        with pytest.raises(KeyError):
            eng.rewind("nope", 0)
        eng.rewind("s", 2)
        assert int(eng.lengths[eng.slot("s")]) == 2


def _coalesced(adapter, mk, sp, drafts_of, firsts):
    """Draft steps of "a" and "b" (K = 2) entering `adapter` together."""
    barrier = threading.Barrier(2)
    out = {}

    def run(sid):
        p = PROMPTS[sid]
        drafts = drafts_of[sid]
        barrier.wait(timeout=60)
        out[sid] = adapter.forward(mk(
            sid, [firsts[sid], *drafts], len(p), False, draft_tokens=tuple(drafts),
            start_from_position=len(p), sampling=sp, generated_tokens=(firsts[sid],),
            step_seed=11))

    threads = [threading.Thread(target=run, args=(sid,)) for sid in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(out) == {"a", "b"}
    return out


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_adapter_coalesces_speculative_rounds(kind):
    """Two draft steps enter each package's adapter together: one batched
    step of width K + 1 serves both, each row verifies alone (greedy:
    perfect drafts accept both, never-matching ones none), each slot is
    rewound past its rejected tail, and the port answers what the JAX
    adapter answers."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=6)
    je, te = engines(jcfg, jp, tp, slots=4)
    ja = jbatching.BatchingStageAdapter(je, window_s=1.0)
    ta = tbatching.BatchingStageAdapter(te, window_s=1.0)
    jsp, tsp = JSamplingParams(*GREEDY), SamplingParams(*GREEDY)
    firsts, follow = {}, {}
    for sid, p in PROMPTS.items():
        if sid not in ("a", "b"):
            continue
        firsts[sid] = ja.forward(_jreq(sid, p, 0, True, sampling=jsp)).token_id
        assert ta.forward(_treq(sid, p, 0, True, sampling=tsp)).token_id == firsts[sid]
        # The greedy continuation: two steps of the JAX engine, rewound.
        oj = je.decode_batch({sid: jnp.asarray([[firsts[sid]]], jnp.int32)})
        r1 = int(jnp.argmax(je.logits(oj[sid])[0, -1]))
        oj = je.decode_batch({sid: jnp.asarray([[r1]], jnp.int32)})
        follow[sid] = (r1, int(jnp.argmax(je.logits(oj[sid])[0, -1])))
        je.rewind(sid, len(p))
    drafts_of = {"a": follow["a"], "b": ((follow["b"][0] + 1) % jcfg.vocab_size,) * 2}
    knobs = GREEDY if kind == "greedy" else SAMPLED
    results = []
    for adapter, mk, sp, eng in ((ja, _jreq, JSamplingParams(*knobs), je),
                                 (ta, _treq, SamplingParams(*knobs), te)):
        before = eng.decode_steps
        out = _coalesced(adapter, mk, sp, drafts_of, firsts)
        assert eng.decode_steps == before + 1          # one coalesced round
        results.append({sid: (tuple(int(t) for t in r.tokens), r.n_accepted, r.cache_len,
                              int(eng.lengths[eng.slot(sid)])) for sid, r in out.items()})
    assert results[1] == results[0]
    if kind == "greedy":
        got = results[1]
        assert got["a"][:2] == ((*follow["a"], got["a"][0][2]), 2)
        assert got["b"][:2] == ((follow["b"][0],), 0)
        assert got["b"][3] == len(PROMPTS["b"]) + 1
        assert got["a"][3] == len(PROMPTS["a"]) + 3


def _jax_spec_client(jcfg, jp, peer, engine):
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        StagePlan as JStagePlan,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        parse_splits as jparse_splits,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        slice_stage_params as jslice,
    )

    plan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLIT))
    transport = JLocalTransport()
    transport.add_peer("peer", peer)
    registry = JPlacementRegistry(rng=random.Random(0))
    registry.register(jrecord("peer", plan.stages[1], engine=engine))
    stage0 = JStageExecutor(jcfg, plan.stages[0], jslice(jcfg, jp, plan.stages[0]),
                            peer_id="client-local")
    return JPipelineClient(jcfg, plan, stage0, transport, registry, settle_seconds=0.0,
                           seed=0)


def _port_spec_client(jcfg, tp, peer, engine):
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
        slice_stage_params,
    )

    tcfg = port_cfg(jcfg)
    plan = _cluster_spec(tcfg)
    transport = LocalTransport()
    transport.add_peer("peer", peer)
    registry = PlacementRegistry(rng=random.Random(0))
    registry.register(make_server_record("peer", plan.stages[1], engine=engine))
    stage0 = StageExecutor(tcfg, plan.stages[0], slice_stage_params(tcfg, tp, plan.stages[0]),
                           peer_id="client-local", device="cpu")
    return PipelineClient(tcfg, plan, stage0, transport, registry, settle_seconds=0.0, seed=0)


def _port_peers(jcfg, tp):
    """The port's stage 1 on a batched engine and on a session engine."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
        slice_stage_params,
    )

    tcfg = port_cfg(jcfg)
    spec = _cluster_spec(tcfg).stages[1]
    params = slice_stage_params(tcfg, tp, spec)
    inner = tbatching.BatchedStageExecutor(tcfg, spec, params, slots=4, max_len=64,
                                           device="cpu")
    return (tbatching.BatchingStageAdapter(inner, window_s=0.0, peer_id="peer"),
            StageExecutor(tcfg, spec, params, peer_id="peer", device="cpu"))


def test_client_speculative_on_batched_peer():
    """A speculative session routes to the batched peer (kind "spec"), its
    rounds verify there, and its greedy tokens, with perfect drafts, equal
    the plain run's and the JAX package's in ceil(11 / 5) = 3 rounds; the
    n-gram drafter's greedy tokens equal them too."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=7)
    prompt = PROMPTS["a"]
    batched, _ = _port_peers(jcfg, tp)
    client = _port_spec_client(jcfg, tp, batched, "batched")
    sp = SamplingParams(temperature=0.0)
    plain = client.generate(prompt, 12, sampling=sp).tokens
    steps = batched.inner.decode_steps
    res = client.generate(prompt, 12, sampling=sp, speculative_k=4,
                          draft_fn=perfect_draft(plain, len(prompt)))
    assert res.tokens == plain
    assert batched.inner.decode_steps - steps == 3
    assert client.generate(prompt, 12, sampling=sp, speculative_k=3).tokens == plain
    jpeer = jbatching.BatchingStageAdapter(
        jax_engine(jcfg, _cluster_spec(jcfg).stages[1], _jslice_stage(jcfg, jp),
                   slots=4, max_len=64),
        window_s=0.0, peer_id="peer")
    jclient = _jax_spec_client(jcfg, jp, jpeer, "batched")
    jres = jclient.generate(prompt, 12, sampling=JSamplingParams(temperature=0.0),
                            speculative_k=4, draft_fn=perfect_draft(plain, len(prompt)))
    assert jres.tokens == plain


def _jslice_stage(jcfg, jp):
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        slice_stage_params as jslice,
    )

    return jslice(jcfg, jp, _cluster_spec(jcfg).stages[1])


def test_sampled_speculative_batched_equals_session_engine_and_jax():
    """temperature > 0 with the n-gram drafter (a repetitive prompt): the
    batched peer's tokens equal the session peer's, and the JAX batched
    peer's at the same seed."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=3)
    prompt = [3, 1, 4, 1, 5, 3, 1, 4]
    batched, session = _port_peers(jcfg, tp)
    sp = SamplingParams(temperature=0.7, top_p=0.9)
    got = [_port_spec_client(jcfg, tp, peer, engine).generate(
        prompt, 10, sampling=sp, speculative_k=3).tokens
        for peer, engine in ((batched, "batched"), (session, "session"))]
    assert got[0] == got[1]
    je = jax_engine(jcfg, _cluster_spec(jcfg).stages[1], _jslice_stage(jcfg, jp),
                    slots=4, max_len=64)
    jclient = _jax_spec_client(jcfg, jp, jbatching.BatchingStageAdapter(
        je, window_s=0.0, peer_id="peer"), "batched")
    want = jclient.generate(prompt, 10, sampling=JSamplingParams(temperature=0.7, top_p=0.9),
                            speculative_k=3).tokens
    assert got[0] == want


def test_adapter_warmup_captures_the_speculative_widths(monkeypatch):
    """``warmup(speculative_k=3)`` on a last-stage adapter (graphs through a
    CPU stub) captures the decode step of widths 1..4 and the verify graph
    of widths 2..4, each on the warm-up session rewound to its prompt; a
    sampled round of width 4 then captures nothing and verifies as the
    direct run does."""
    def record(fn, pool, stream):
        out = fn()
        return StubGraph(fn, out), out

    monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
    monkeypatch.setattr(tgraphs, "_record", record)
    monkeypatch.setattr(tgraphs, "StagedInts", HostInts)
    monkeypatch.setattr(tgraphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraphs.torch.cuda, "Stream", lambda *a, **k: None)
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=6)
    _, te = engines(jcfg, jp, tp, slots=2, max_len=32)
    te.graphs.enabled = te.sampler.enabled = True
    adapter = tbatching.BatchingStageAdapter(te, window_s=0.0)
    adapter.warmup(speculative_k=3)
    keys = [key for key, _ in te.graphs.entries()]
    assert [k for k in keys if k[0] == "decode"] == [("decode", t) for t in (1, 2, 3, 4)]
    verify = sorted(k for k in te.sampler._graphs if k[0] == "verify")
    assert verify == [("verify", 2, t, jcfg.vocab_size) for t in (2, 3, 4)]
    assert te.slot("__warmup__") is None
    captures = (te.graphs.captures, te.sampler.captures)
    sp = SamplingParams(*SAMPLED)
    p = PROMPTS["a"]
    first = adapter.forward(_treq("a", p, 0, True, sampling=sp)).token_id
    req = _treq("a", [first, 1, 2, 3], len(p), False, draft_tokens=(1, 2, 3),
                start_from_position=len(p), sampling=sp, generated_tokens=(first,),
                step_seed=5)
    graphed = adapter.forward(req)
    assert (te.graphs.captures, te.sampler.captures) == captures
    te.graphs.enabled = te.sampler.enabled = False
    direct = adapter.forward(dataclasses.replace(req))
    assert (direct.tokens, direct.n_accepted) == (graphed.tokens, graphed.n_accepted)
