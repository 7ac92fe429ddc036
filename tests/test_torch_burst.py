"""Burst decode in the port (``runtime/batching.py``: `decode_burst`,
`burst_stream`, the adapter's burst rounds; ``runtime/client.py``:
``generate(..., burst=N)``) against the JAX package's, on the same bridged
weights: the tiny llama of ``tests/test_runtime_pipeline.py`` (8 layers),
full-span engines of 4 slots x 64 rows.

Counterparts of ``tests/test_burst.py:157-330`` and ``:379-400``: the
engine's bursts greedy and seeded sampled (tokens, stop reasons, cache
lengths), eos in the middle of a burst, a stream whose budget spans
bursts, the refusals, int8 and NF4 trees against the dequantized burst,
one step call a burst in a client generation, the client against the JAX
client and the unpartitioned loop (eos in a burst, the fallback and its
event, failover across a burst boundary, the speculative combination).
Plus what the port adds: a burst equals the per-step rounds of the same
engine (`decode_batch` + `sample_round`), the step run twice on one carry
gives the same caches and tokens (the warm-up before a capture), the
captured path through a CPU stub of a graph, and the burst telemetry
families and ``burst_round`` events against the JAX adapter's. The
swarms over loopback TCP and the burst CLI are in
tests/test_torch_serve_batched.py.

Tolerance: none. Every comparison is of token ids, stop reasons and
lengths, for equality.
"""

import json
import math
import threading

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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    telemetry as jtel,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSampling,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    batching as jbatching,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.messages import (
    StageRequest as JStageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    telemetry as ttel,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
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
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    _sample_rows,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)

from test_burst import _add_burst_peer as j_add_burst_peer
from test_burst import _sample as j_sample
from test_runtime_pipeline import build_cluster, oracle_generate, tiny_cfg

GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.9, 0.95, 50, 1.3)           # tests/test_burst.py's SAMPLED
KNOBS = {"greedy": GREEDY, "sampled": SAMPLED}
PROMPT = [5, 9, 23, 7, 81]
PROMPTS = {"a": [5, 9, 23, 7], "b": [11, 3, 40], "c": [17, 29, 2, 31, 8]}
SLOTS, MAX_LEN = 4, 64


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


@pytest.fixture(scope="module")
def oracle(weights):
    """The JAX package's unpartitioned loop on PROMPT, each (knobs, tokens)
    run once for the module."""
    jcfg, jp, _, _ = weights
    runs = {}

    def run(knobs, n):
        if (knobs, n) not in runs:
            runs[knobs, n] = oracle_generate(jcfg, jp, PROMPT, n, JSampling(*knobs))
        return runs[knobs, n]

    return run


def t_full(tcfg):
    return StagePlan.even(tcfg.num_layers, 1).stages[0]


def t_engine(tcfg, params, slots=SLOTS, max_len=MAX_LEN):
    return tbatching.BatchedStageExecutor(tcfg, t_full(tcfg), params, slots=slots,
                                          max_len=max_len, device="cpu")


def j_engine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN):
    """The JAX engine with int64 lengths, as tests/test_torch_batching.py
    builds it (its module docstring says why)."""
    ex = jbatching.BatchedStageExecutor(jcfg, JStagePlan.even(jcfg.num_layers, 1).stages[0],
                                        jp, slots=slots, max_len=max_len)
    ex.lengths = ex.lengths.astype(np.int64)
    return ex


def t_request(sid, sp, generated=(), step_seed=0):
    return StageRequest(session_id=sid, hidden=None, seq_len=1, cur_len=0,
                        is_prefill=False, max_length=MAX_LEN, sampling=sp,
                        generated_tokens=tuple(generated[-50:]), step_seed=step_seed)


def t_first(ex, sid, prompt, sp, seed):
    """Prefill a session on the port's engine; its first token as the
    adapter samples it."""
    h = ex.prefill(sid, torch.tensor([prompt]))
    return _sample_rows(ex.logits(h[:, -1:]), 1, t_request(sid, sp, (), seed), ex.sampler)[0]


def j_first(ex, sid, prompt, knobs, seed):
    h = ex.prefill(sid, np.asarray([prompt], np.int32))
    return j_sample(ex.logits(h[:, -1:])[0, -1], [], seed, JSampling(*knobs))


def entry(g, knobs, seed, max_new, eos):
    t, p, k, rp = knobs
    return {"token": g[-1], "seed": seed + len(g), "budget": max_new - len(g), "eos": eos,
            "generated": tuple(g[-50:]), "temperature": t, "top_p": p, "top_k": k,
            "repetition_penalty": rp}


def run_bursts(ex, firsts, knobs, seed, max_new, n_ticks, eos=None):
    """The decode_burst driver of tests/test_burst.py (`_bursty`), on either
    package's engine: the stateless per-burst spec shipped each burst.
    Returns (tokens by session, every burst's results)."""
    gen = {sid: [tok] for sid, tok in firsts.items()}
    live, blocks = set(gen), []
    while live:
        entries = {sid: entry(gen[sid], knobs, seed, max_new, eos)
                   for sid in sorted(live) if len(gen[sid]) < max_new}
        live &= set(entries)
        if not entries:
            break
        res = ex.decode_burst(entries, n_ticks)
        blocks.append(res)
        for sid, r in res.items():
            gen[sid].extend(r["tokens"])
            if r["stop"] is not None:
                live.discard(sid)
    return gen, blocks


def t_bursty(weights, knobs, max_new, n_ticks, eos=None, params=None, seed=0):
    _, _, tcfg, tp = weights
    ex = t_engine(tcfg, tp if params is None else params)
    firsts = {sid: t_first(ex, sid, p, SamplingParams(*knobs), seed)
              for sid, p in PROMPTS.items()}
    gen, blocks = run_bursts(ex, firsts, knobs, seed, max_new, n_ticks, eos)
    return gen, blocks, ex


def j_bursty(weights, knobs, max_new, n_ticks, eos=None, seed=0):
    jcfg, jp, _, _ = weights
    ex = j_engine(jcfg, jp)
    firsts = {sid: j_first(ex, sid, p, knobs, seed) for sid, p in PROMPTS.items()}
    gen, blocks = run_bursts(ex, firsts, knobs, seed, max_new, n_ticks, eos)
    return gen, blocks, ex


def _done(g, max_new, eos):
    return (len(g) >= max_new
            or (len(g) > 1 and eos is not None and g[-1] == eos)
            or (len(g) >= 5 and len(set(g[-5:])) == 1))


def t_stepped(weights, knobs, max_new, eos=None, seed=0):
    """The same sessions run per step on a port engine: one `decode_batch`
    and one `sample_round` a token, the host's stop rules."""
    _, _, tcfg, tp = weights
    ex = t_engine(tcfg, tp)
    sp = SamplingParams(*knobs)
    gen = {sid: [t_first(ex, sid, p, sp, seed)] for sid, p in PROMPTS.items()}
    while True:
        live = [sid for sid in sorted(gen) if not _done(gen[sid], max_new, eos)]
        if not live:
            return gen
        ex.decode_batch({sid: torch.tensor([[gen[sid][-1]]]) for sid in live})
        toks = ex.sample_round({sid: t_request(sid, sp, gen[sid], seed + len(gen[sid]))
                                for sid in live})
        for sid in live:
            gen[sid].append(toks[sid])


# -- the engine ------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_burst_engine_matches_jax_and_per_step_rounds(weights, kind):
    """12 tokens a session at 4 ticks a burst: every burst's tokens, stop
    and cache length equal the JAX engine's, the tokens equal the same
    engine's per-step rounds, and a burst serves every live session (at
    most ceil(11 / 4) bursts)."""
    knobs = KNOBS[kind]
    want, jblocks, jex = j_bursty(weights, knobs, 12, 4)
    got, blocks, tex = t_bursty(weights, knobs, 12, 4)
    assert blocks == jblocks
    assert got == want
    assert t_stepped(weights, knobs, 12) == got
    assert tex.burst_dispatches == jex.burst_dispatches <= math.ceil((12 - 1) / 4)
    assert tex.burst_tokens == jex.burst_tokens == sum(len(g) - 1 for g in got.values())
    assert tex.decode_steps == tex.burst_dispatches


def test_burst_engine_eos_mid_burst_truncates(weights):
    full = t_stepped(weights, GREEDY, 12)
    eos = full["a"][4]
    want, jblocks, _ = j_bursty(weights, GREEDY, 12, 4, eos=eos)
    got, blocks, _ = t_bursty(weights, GREEDY, 12, 4, eos=eos)
    assert blocks == jblocks and got == want
    assert t_stepped(weights, GREEDY, 12, eos=eos) == got
    assert any(r["stop"] == "eos" for b in blocks for r in b.values())
    # The cut landed inside a burst for at least one session.
    assert any(len(g) < len(full[sid]) for sid, g in got.items())


def test_burst_stream_budget_spans_bursts(weights):
    """burst_stream seeds the budget counter with the whole budget, which
    ticks down on the device across bursts: the JAX stream's blocks, the
    per-step tokens, at least 3 productive bursts and at most one burst
    in flight past the last."""
    jcfg, jp, tcfg, tp = weights
    out = []
    for ex, first in ((j_engine(jcfg, jp), lambda ex, sid, p: j_first(ex, sid, p, SAMPLED, 0)),
                      (t_engine(tcfg, tp), lambda ex, sid, p: t_first(
                          ex, sid, p, SamplingParams(*SAMPLED), 0))):
        gen = {sid: [first(ex, sid, p)] for sid, p in PROMPTS.items()}
        entries = {sid: entry(g, SAMPLED, 0, 12, None) for sid, g in gen.items()}
        blocks = list(ex.burst_stream(entries, 4))
        for block in blocks:
            for sid, r in block.items():
                gen[sid].extend(r["tokens"])
        out.append((gen, blocks, ex.burst_dispatches))
    (jgen, jblocks, jdisp), (gen, blocks, disp) = out
    assert blocks == jblocks and gen == jgen
    assert gen == t_stepped(weights, SAMPLED, 12)
    assert len(blocks) >= 3 and disp == jdisp <= len(blocks) + 1


REFUSALS = {
    "stream-past-max-len": (RuntimeError, "max_len"),
    "burst-past-max-len": (RuntimeError, "max_len"),
    "budget-below-1": (ValueError, "budget"),
    "no-ticks": (ValueError, "burst of 0"),
    "not-full-span": (RuntimeError, "full model span"),
}


@pytest.fixture(scope="module")
def refusing(weights):
    """Per package: an engine of 2 slots x 16 rows holding session "s"
    (PROMPT, 5 rows), and one over the second half of the model only.
    Every refusal raises before it changes either."""
    jcfg, jp, tcfg, tp = weights
    je, te = j_engine(jcfg, jp, 2, 16), t_engine(tcfg, tp, 2, 16)
    je.prefill("s", np.asarray([PROMPT], np.int32))
    te.prefill("s", torch.tensor([PROMPT]))
    return {"jax": (je, jbatching.BatchedStageExecutor(
                jcfg, JStagePlan.even(jcfg.num_layers, 2).stages[1], jp, slots=2, max_len=16)),
            "port": (te, tbatching.BatchedStageExecutor(
                tcfg, StagePlan.even(tcfg.num_layers, 2).stages[1], tp, slots=2, max_len=16,
                device="cpu"))}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_burst_refusals_match_jax(refusing, case):
    """Both engines refuse a budget past max_len (stream and burst), a
    budget below 1, N < 1 and an engine that does not span the model."""
    err, match = REFUSALS[case]
    for pkg in ("jax", "port"):
        full, half = refusing[pkg]
        ex = half if case == "not-full-span" else full
        e = entry([7], GREEDY, 0, 65 if "max-len" in case else 8, None)
        if case == "burst-past-max-len":
            e["budget"] = 12
        if case == "budget-below-1":
            e["budget"] = 0
        n = 0 if case == "no-ticks" else (16 if case == "burst-past-max-len" else 4)
        with pytest.raises(err, match=match):
            if case == "stream-past-max-len":
                list(ex.burst_stream({"s": e}, n))
            else:
                ex.decode_burst({"s": e}, n)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_burst_engine_quantized_matches_dequantized(weights, mode):
    """Bursts over an int8 or NF4 tree (through the kernels' plain
    versions on the CPU) emit the tokens of bursts over the same weights
    dequantized."""
    tp = weights[3]
    qparams = tquant.quantize_params(tp, mode)
    got, _, _ = t_bursty(weights, GREEDY, 10, 4, params=qparams)
    want, _, _ = t_bursty(weights, GREEDY, 10, 4, params=tquant.dequant_tree(qparams))
    assert got == want


def test_burst_step_run_twice_on_one_carry_is_the_same(weights):
    """The warm-up before a capture runs the step on the call's own carry,
    and the replay runs it again: the second run gives the first's
    result, carry and caches (tick i writes row length + i and reads no
    row past it)."""
    _, _, tcfg, tp = weights
    ex = t_engine(tcfg, tp)
    sp = SamplingParams(*SAMPLED)
    firsts = {sid: t_first(ex, sid, p, sp, 0) for sid, p in PROMPTS.items()}
    rows, carry = ex._burst_prep({sid: entry([t], SAMPLED, 0, 12, None)
                                  for sid, t in firsts.items()}, 4)
    carry = torch.tensor(carry)
    first = ex._burst_step(carry, 4)
    k1, v1 = ex.k.clone(), ex.v.clone()
    second = ex._burst_step(carry, 4)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(ex.k, k1) and torch.equal(ex.v, v1)
    # The carry hands on: lengths and seeds advanced by the emitted ticks.
    res, out = first
    for sid, s in rows.items():
        emitted = int((res[:4, s] >= 0).sum())
        assert int(out[s, tbatching._LEN]) == ex.lengths[s] + emitted == int(res[-1, s])
        assert int(out[s, tgraphs._SEED]) == 1 + emitted


def test_captured_bursts_through_a_stub_graph(weights, monkeypatch):
    """decode_burst and burst_stream with graphs on, through a CPU
    stand-in of a graph: one capture a tick count, a replay a burst, the
    stream's carry fed back into the graph's input, and the tokens of the
    direct run."""
    class StubGraph:
        def __init__(self, fn, out):
            self.fn, self.out = fn, out

        def replay(self):
            for o, n in zip(self.out, self.fn()):
                o.copy_(n)

    class HostInts:                          # StagedInts without pinned memory
        def __init__(self, shape, device):
            self.tensor = torch.zeros(shape, dtype=torch.int64)

        def load(self, values):
            self.tensor.view(-1).copy_(torch.tensor(values, dtype=torch.int64))
            return self.tensor

    def record(fn, pool, stream):
        out = fn()
        return StubGraph(fn, out), out

    monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
    monkeypatch.setattr(tgraphs, "_record", record)
    monkeypatch.setattr(tgraphs, "StagedInts", HostInts)
    monkeypatch.setattr(tgraphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraphs.torch.cuda, "Stream", lambda *a, **k: None)
    want, _, _ = t_bursty(weights, SAMPLED, 12, 4)
    _, _, tcfg, tp = weights
    ex = t_engine(tcfg, tp)
    ex.graphs.enabled = True
    sp = SamplingParams(*SAMPLED)
    firsts = {sid: t_first(ex, sid, p, sp, 0) for sid, p in PROMPTS.items()}
    got, _ = run_bursts(ex, firsts, SAMPLED, 0, 12, 4)
    assert got == want
    # Two keys: the prompts' prefill bucket and the burst.
    assert [key for key, _ in ex.graphs.entries()] == [("prefill", 8, torch.int64),
                                                       ("burst", 4)]
    assert ex.graphs.captures == 2
    assert ex.graphs.replays == len(PROMPTS) + ex.burst_dispatches
    for sid in PROMPTS:
        ex.end_session(sid)
    gen = {sid: [t_first(ex, sid, p, sp, 0)] for sid, p in PROMPTS.items()}
    for block in ex.burst_stream({sid: entry(g, SAMPLED, 0, 12, None)
                                  for sid, g in gen.items()}, 4):
        for sid, r in block.items():
            gen[sid].extend(r["tokens"])
    assert gen == want
    assert ex.graphs.captures == 2
    assert ex.graphs.replays == 2 * len(PROMPTS) + ex.burst_dispatches


# -- the client --------------------------------------------------------------------

def t_add_burst_peer(weights, client, transport, name="burst-peer"):
    _, _, tcfg, tp = weights
    adapter = tbatching.BatchingStageAdapter(t_engine(tcfg, tp), window_s=0.0, peer_id=name)
    adapter.warmup(burst=4)
    transport.add_peer(name, adapter)
    client.registry.register(make_server_record(name, t_full(tcfg), engine="batched"))
    return adapter


def t_cluster(weights):
    _, _, tcfg, tp = weights
    return build_port_cluster(tcfg, tp, "2,4")


@pytest.fixture(scope="module")
def jax_burst_client(weights):
    """The JAX package's cluster (tests/test_runtime_pipeline.py, splits
    2,4) with one full-span burst peer (tests/test_burst.py)."""
    jcfg = weights[0]
    jclient, jtransport, jregistry, jparams, _ = build_cluster(jcfg, splits="2,4")
    j_add_burst_peer(jcfg, jtransport, jregistry, jparams)
    return jclient


@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_burst_client_matches_jax_client_and_oracle(weights, oracle, jax_burst_client, kind):
    knobs = KNOBS[kind]
    want = jax_burst_client.generate(PROMPT, max_new_tokens=12, sampling=JSampling(*knobs),
                                     burst=4).tokens
    assert want == oracle(knobs, 12)
    client, transport = t_cluster(weights)
    adapter = t_add_burst_peer(weights, client, transport)
    got = client.generate(PROMPT, max_new_tokens=12, sampling=SamplingParams(*knobs),
                          burst=4)
    assert got.tokens == want
    assert adapter.inner.burst_dispatches == 1 + len(got.decode_times_s)   # + warm-up
    assert not adapter.inner._slot_of                 # the session ended


def test_one_step_call_a_burst(weights, oracle):
    """A 12-token generation at burst = 4 calls the burst step exactly
    ceil(11 / 4) = 3 times, one a burst and none elsewhere."""
    client, transport = t_cluster(weights)
    ex = t_add_burst_peer(weights, client, transport).inner
    calls = []
    step = ex._burst_step
    ex._burst_step = lambda *a: calls.append(1) or step(*a)
    before = ex.burst_dispatches
    got = client.generate(PROMPT, max_new_tokens=12, sampling=SamplingParams(*SAMPLED),
                          burst=4).tokens
    assert got == oracle(SAMPLED, 12)
    assert len(calls) == ex.burst_dispatches - before == math.ceil((12 - 1) / 4)


def test_burst_client_eos_mid_burst(weights, oracle):
    ref = oracle(SAMPLED, 12)
    client, transport = t_cluster(weights)
    t_add_burst_peer(weights, client, transport)
    res = client.generate(PROMPT, max_new_tokens=12, sampling=SamplingParams(*SAMPLED),
                          eos_token_id=ref[5], burst=4)
    assert res.tokens == ref[:6] and res.stopped_by == "eos"


def test_burst_client_falls_back_without_full_span_peer(weights, oracle):
    """No full-span batched peer is live: the per-step loop's tokens, and
    one ``burst_fallback`` event naming why."""
    client, _ = t_cluster(weights)
    rec = ttel.get_recorder()
    rec.enable()
    rec.clear()
    try:
        got = client.generate(PROMPT, max_new_tokens=8, sampling=SamplingParams(*GREEDY),
                              burst=4).tokens
        events = [e for e in rec.events() if e.name == "burst_fallback"]
    finally:
        rec.disable()
        rec.clear()
    assert got == oracle(GREEDY, 8)
    assert len(events) == 1
    assert events[0].fields["reason"] == "no full-span batched peer is live"


def test_burst_client_failover_replays_across_burst_boundary(weights, oracle):
    """The pinned burst peer fails after the first burst (and the replica's
    next call too): the journal, one entry a burst, replays onto the
    replica (a prefill, then multi-token chunks) and the tokens stay the
    fault-free ones."""
    ref = oracle(SAMPLED, 12)
    client, transport = t_cluster(weights)
    for name in ("burst-peer", "burst-peer-2"):
        t_add_burst_peer(weights, client, transport, name)
    got, result, killed = [], None, False
    for step in client.generate_stepwise(PROMPT, max_new_tokens=12,
                                         sampling=SamplingParams(*SAMPLED), burst=4):
        got.extend(step.new_tokens)
        if step.done:
            result = step.result
        if not killed and len(got) > 1:
            for peer in ("burst-peer", "burst-peer-2"):
                transport.fail_next(peer, 1)
            killed = True
    assert result is not None and result.tokens == ref
    assert client.recoveries >= 1


@pytest.mark.parametrize("combo", [{"speculative_k": 3}, {"deep_prompts": np.zeros((8, 1, 64))}],
                         ids=["speculative", "deep-prompts"])
def test_burst_rejects_speculative_and_deep_prompt_combos(weights, combo):
    client, transport = t_cluster(weights)
    t_add_burst_peer(weights, client, transport)
    with pytest.raises(ValueError, match="burst"):
        list(client.generate_stepwise(PROMPT, max_new_tokens=8,
                                      sampling=SamplingParams(*GREEDY), burst=4, **combo))


# -- telemetry ---------------------------------------------------------------------

def _burst_round(adapter, mk, reqs):
    """Every request of `reqs` enters forward at once."""
    barrier = threading.Barrier(len(reqs))
    out, errors = {}, {}

    def run(sid, req):
        barrier.wait(timeout=60)
        try:
            out[sid] = adapter.forward(req)
        except Exception as exc:        # surfaced by the caller
            errors[sid] = exc

    threads = [threading.Thread(target=run, args=(sid, mk(sid, *v))) for sid, v in reqs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


def test_burst_telemetry_and_events_equal_jax_adapter(weights):
    """Two coalesced burst rounds (3 sessions, then the 2 still going) on
    both packages' full-span adapters: the replies, the burst and batching
    families (counts, and the sums of fills and ticks) and the
    ``burst_round`` events are equal."""
    jcfg, jp, tcfg, tp = weights
    names = {"server_burst_ticks", "server_burst_dispatches_total",
             "server_burst_tokens_total", "server_batch_fill_sessions",
             "server_decode_round_seconds", "server_queue_wait_seconds"}
    timed = {"server_decode_round_seconds", "server_queue_wait_seconds"}

    def mk_j(sid, tokens, cur, prefill, **kw):
        return JStageRequest(session_id=sid, hidden=np.asarray([tokens], np.int32),
                             seq_len=len(tokens), cur_len=cur, is_prefill=prefill,
                             max_length=MAX_LEN, sampling=JSampling(*SAMPLED), **kw)

    def mk_t(sid, tokens, cur, prefill, **kw):
        return StageRequest(session_id=sid, hidden=torch.tensor([tokens]),
                            seq_len=len(tokens), cur_len=cur, is_prefill=prefill,
                            max_length=MAX_LEN, sampling=SamplingParams(*SAMPLED), **kw)

    views = []
    for pkg, tel in (("jax", jtel), ("port", ttel)):
        tel.get_registry().reset()
        tel.enable()
        tel.get_recorder().enable()
        tel.get_recorder().clear()
        try:
            # Handles are fetched at construction: build it enabled.
            inner = j_engine(jcfg, jp) if pkg == "jax" else t_engine(tcfg, tp)
            adapter = (jbatching if pkg == "jax" else tbatching).BatchingStageAdapter(
                inner, window_s=1.0)
            mk = mk_j if pkg == "jax" else mk_t
            gen = {sid: [adapter.forward(mk(sid, p, 0, True, step_seed=0)).token_id]
                   for sid, p in PROMPTS.items()}
            replies = []
            for budget in ({"a": 4, "b": 4, "c": 4}, {"a": 3, "b": 2}):
                reqs = {sid: ([gen[sid][-1]], len(PROMPTS[sid]) + len(gen[sid]) - 1, False)
                        for sid in budget}
                out = _burst_round(adapter, lambda sid, t, c, f: mk(
                    sid, t, c, f, generated_tokens=tuple(gen[sid]),
                    step_seed=len(gen[sid]), burst_len=4, burst_budget=budget[sid],
                    eos_token_id=None), reqs)
                for sid, r in sorted(out.items()):
                    gen[sid].extend(r.burst_tokens)
                    replies.append((sid, r.burst_tokens, r.burst_stop, r.cache_len))
            series = {}
            for fam, children in tel.get_registry().collect():
                if fam.name in names:
                    for child in children:
                        series[(fam.name, child.labels)] = (
                            (child.count, None if fam.name in timed else child.sum)
                            if hasattr(child, "count") else child.value)
            events = [(e.name, json.dumps(e.fields, sort_keys=True))
                      for e in tel.get_recorder().events() if e.name == "burst_round"]
            views.append((replies, series, events))
        finally:
            tel.get_recorder().disable()
            tel.get_recorder().clear()
            tel.disable()
            tel.get_registry().reset()
    assert views[1] == views[0]
    replies, series, events = views[1]
    assert [json.loads(f)["sessions"] for _, f in events] == [3, 2]
    assert series[("server_burst_dispatches_total", ())] == 2
