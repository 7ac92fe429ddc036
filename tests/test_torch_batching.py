"""The port's batched stage engine and its adapter (``runtime/batching.py``)
against the JAX package's, on the same bridged weights and inputs.

Counterparts of ``tests/test_batching.py``: sessions of four families
through one engine, sessions joining and leaving, partial rounds, slot
admission, a multi-token (replay-width) step, a failed prefill, two
engines chained as stages; the adapter behind ``LocalTransport`` with
concurrent clients (greedy and seeded sampled), coalescing, refusals and
stale retries; the three batching telemetry families and the
``task_rejected`` events. Plus the port's own refusals (MoE, speculative
rows, push chains, ``--stage 0`` without ``--batched``), a burst served
by the full-span adapter as the JAX one serves it, and the captured steps
replayed through a CPU stub of a graph.

Tolerance: hidden rows and logits within ``assert_close``'s float32
tolerance (rtol = atol = 1e-5, scale-relative) for unquantized trees;
rtol 1e-5, atol 0 for the int8 and NF4 trees (``test_torch_int8.py``,
``test_torch_nf4.py``). Greedy and seeded sampled tokens are equal.

The JAX engine is built with int64 ``lengths`` (`jax_engine`): its
``decode_batch`` advances the host array right after it dispatches a step
that reads ``jnp.asarray(lengths)``, and on the CPU backend the transfer
can read the advanced values (its logits then lay 0.09-0.27 off its own
``full_forward`` in 6 of 14 runs of one script). An int64 array is
converted, hence copied, before the dispatch.
"""

import dataclasses
import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    jax_params,
    one_torch_thread,
    port_cfg,
    tiny_llama_j,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    telemetry as jtel,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    config as jconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StageSpec as JStageSpec,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
    PipelineClient as JPipelineClient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
    make_server_record as jrecord,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutionError as JStageExecutionError,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.messages import (
    StageRequest as JStageRequest,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    telemetry as ttel,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    ROLE_FULL,
    StagePlan,
    StageSpec,
    parse_splits,
    slice_stage_params,
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
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    LocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)

from test_runtime_pipeline import tiny_cfg

PROMPTS = {
    "a": [5, 9, 23, 7, 81],
    "b": [44, 2, 3],
    "c": [100, 11, 12, 13, 14, 15, 16],
    "d": [7, 7, 9],
}
SLOTS, MAX_LEN = 4, 64
GREEDY = (0.0, 0.9, 50, 1.5)
SAMPLED = (0.7, 0.9, 50, 1.5)
QUANT_TOL = dict(rtol=1e-5, atol=0.0)   # test_torch_int8 / test_torch_nf4


def mistral_j():
    """The reference's batched sliding-window config (test_batching.py:412)."""
    return jconfig.mistral_config(
        sliding_window=4, vocab_size=257, hidden_size=64, num_layers=4,
        num_heads=4, num_kv_heads=2, intermediate_size=128,
        max_position_embeddings=256)


FAMILIES = {"llama": lambda: tiny_cfg("llama"), "gpt2": lambda: tiny_cfg("gpt2"),
            "qwen2": lambda: tiny_cfg("qwen2"), "gemma2": lambda: tiny_cfg("gemma2"),
            "llama3_rope": tiny_llama_j, "mistral": mistral_j}


def weights(jcfg, seed=0, quant="none"):
    jp = (j_init_params(jax.random.PRNGKey(seed), jcfg) if quant == "none"
          else jax_params(jcfg, quant, seed))
    return jp, bridged(jp)


def jax_engine(jcfg, spec, params, slots=SLOTS, max_len=MAX_LEN):
    """The JAX package's engine with int64 lengths (module docstring)."""
    je = jbatching.BatchedStageExecutor(jcfg, spec, params, slots=slots,
                                        max_len=max_len)
    je.lengths = je.lengths.astype(np.int64)
    return je


def engines(jcfg, jp, tp, slots=SLOTS, max_len=MAX_LEN):
    """Both packages' full-span engines on the same weights."""
    je = jax_engine(jcfg, JStageSpec(0, "full", 0, jcfg.num_layers), jp, slots, max_len)
    te = tbatching.BatchedStageExecutor(
        port_cfg(jcfg), StageSpec(0, ROLE_FULL, 0, jcfg.num_layers), tp,
        slots=slots, max_len=max_len, device="cpu")
    return je, te


def greedy_req(sid):
    return StageRequest(session_id=sid, hidden=None, seq_len=1, cur_len=0,
                        is_prefill=False, max_length=MAX_LEN,
                        sampling=SamplingParams(*GREEDY))


class Lockstep:
    """Both engines driven with the same calls; every hidden row and every
    head row compared, greedy tokens taken from the JAX engine's head and
    required of the port's round sampler."""

    def __init__(self, je, te, **tol):
        self.je, self.te, self.tol = je, te, tol
        self.toks = {}

    def prefill(self, sid, prompt):
        hj = self.je.prefill(sid, np.asarray(prompt, np.int32)[None, :])
        ht = self.te.prefill(sid, torch.tensor([prompt]))
        assert_close(ht, hj, **self.tol)
        lj = self.je.logits(hj)[0, -1]
        assert_close(self.te.logits(ht)[0, -1], lj, **self.tol)
        self.toks[sid] = [int(jnp.argmax(lj))]
        assert self.te.slot(sid) == self.je.slot(sid)

    def step(self, inputs):
        """One batched step of {sid: [tokens]} (one width for all)."""
        oj = self.je.decode_batch({s: jnp.asarray([t], jnp.int32) for s, t in inputs.items()})
        ot = self.te.decode_batch({s: torch.tensor([t]) for s, t in inputs.items()})
        sampled = self.te.sample_round({s: greedy_req(s) for s in inputs})
        for sid in inputs:
            assert_close(ot[sid], oj[sid], **self.tol)
            lj = self.je.logits(oj[sid])[0, -1]
            # The head once a round (round_logits) against the per-row head.
            assert_close(self.te.round_logits[self.te.slot(sid)], lj, **self.tol)
            assert_close(self.te.logits(ot[sid])[0, -1], lj, **self.tol)
            self.toks[sid].append(int(jnp.argmax(lj)))
            assert sampled[sid] == self.toks[sid][-1]
        assert self.te.decode_steps == self.je.decode_steps
        assert list(self.te.lengths) == [int(n) for n in self.je.lengths]
        return oj, ot

    def decode(self, sids):
        return self.step({sid: [self.toks[sid][-1]] for sid in sids})


def generate(je, te, prompts, n_new, **tol):
    run = Lockstep(je, te, **tol)
    for sid, prompt in prompts.items():
        run.prefill(sid, prompt)
    for _ in range(n_new - 1):
        run.decode(list(prompts))
    return run


# -- the engine (tests/test_batching.py) --------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_sessions_match_jax_engine(family):
    jcfg = FAMILIES[family]()
    jp, tp = weights(jcfg)
    je, te = engines(jcfg, jp, tp)
    n_new = 6
    generate(je, te, PROMPTS, n_new)
    # n_new - 1 batched steps in all, not per session.
    assert te.decode_steps == n_new - 1


@pytest.mark.parametrize("quant", ["int8", "nf4"])
def test_quantized_batched_sessions_match_jax_engine(quant):
    jcfg = tiny_llama_j()
    jp, tp = weights(jcfg, quant=quant)
    je, te = engines(jcfg, jp, tp)
    generate(je, te, PROMPTS, 5, **QUANT_TOL)


def test_sessions_join_and_leave_mid_stream():
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=1)
    je, te = engines(jcfg, jp, tp, slots=2)
    run = Lockstep(je, te)
    run.prefill("a", PROMPTS["a"])
    run.prefill("b", PROMPTS["b"])
    for _ in range(2):
        run.decode(["a", "b"])
    # b leaves, c takes its slot (slots=2), a continues.
    slot_b = te.slot("b")
    je.end_session("b")
    te.end_session("b")
    run.prefill("c", PROMPTS["c"])
    assert te.slot("c") == slot_b
    for _ in range(3):
        run.decode(["a", "c"])
    assert len(run.toks["a"]) == 6 and len(run.toks["c"]) == 4


def test_partial_batches_and_stragglers():
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=2)
    je, te = engines(jcfg, jp, tp)
    run = Lockstep(je, te)
    run.prefill("a", PROMPTS["a"])
    run.prefill("b", PROMPTS["b"])
    run.decode(["a"])
    run.decode(["a", "b"])
    run.decode(["b"])
    assert te.decode_steps == 3


def test_slot_admission_and_reuse():
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=3)
    je, te = engines(jcfg, jp, tp, slots=2, max_len=32)
    for eng, mk, full in ((je, lambda p: np.asarray([p], np.int32), jbatching.SlotFull),
                          (te, lambda p: torch.tensor([p]), tbatching.SlotFull)):
        eng.prefill("s1", mk([1, 2, 3]))
        eng.prefill("s2", mk([4, 5]))
        with pytest.raises(full):
            eng.prefill("s3", mk([6]))
        eng.end_session("s1")
        eng.prefill("s3", mk([6]))          # reuses s1's slot
        eng.prefill("s3", mk([6, 7]))       # a re-prefill leaks no slot
        assert eng.slot("s3") is not None
    assert (te.slot("s2"), te.slot("s3")) == (je.slot("s2"), je.slot("s3"))
    assert te.tokens_left() == je.tokens_left() == 2 * 32 - 2 - 2


def test_multi_token_step_at_replay_width():
    """decode_batch with T = 3 (a replay chunk's width): a teacher-forced
    step predicts what single steps predict; the other slot is untouched."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=4)
    je, te = engines(jcfg, jp, tp, slots=2)
    ref = generate(*engines(jcfg, jp, tp, slots=2), {"a": PROMPTS["a"]}, 4).toks["a"]
    run = Lockstep(je, te)
    run.prefill("a", PROMPTS["a"])
    run.prefill("b", PROMPTS["b"])
    oj, ot = run.step({"a": ref[:3]})
    got = [int(torch.argmax(te.logits(ot["a"])[0, i])) for i in range(3)]
    assert got == ref[1:4]
    run.toks["a"] = ref[:4]
    for _ in range(2):
        run.decode(["b"])
    run.decode(["a", "b"])


def test_prefill_failure_frees_slot(monkeypatch):
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=12)
    je, te = engines(jcfg, jp, tp, slots=1, max_len=32)

    def boom(*a, **k):
        raise RuntimeError("synthetic dispatch failure")

    je._prefill_jit = boom
    monkeypatch.setattr(te, "_prefill_step", boom)
    for eng, mk in ((je, lambda p: np.asarray([p], np.int32)), (te, lambda p: torch.tensor([p]))):
        with pytest.raises(RuntimeError, match="synthetic"):
            eng.prefill("s1", mk([1, 2, 3]))
        assert eng.slot("s1") is None
    je._prefill_jit = None
    monkeypatch.undo()
    run = Lockstep(je, te)
    run.prefill("s2", [4, 5])                       # the slot is usable again
    run.decode(["s2"])


def test_batched_stage_pipeline_matches_jax():
    """Two batched engines chained as stages: hidden rows flow per session."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=5)
    tcfg = port_cfg(jcfg)
    jplan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits("4"))
    tplan = StagePlan.from_splits(tcfg.num_layers, parse_splits("4"))
    js = [jax_engine(jcfg, s, jslice(jcfg, jp, s)) for s in jplan.stages]
    ts = [tbatching.BatchedStageExecutor(tcfg, s, slice_stage_params(tcfg, tp, s),
                                         slots=SLOTS, max_len=MAX_LEN, device="cpu")
          for s in tplan.stages]
    prompts = {"a": PROMPTS["a"], "b": PROMPTS["b"]}
    toks = {}
    for sid, prompt in prompts.items():
        hj = js[1].prefill(sid, js[0].prefill(sid, np.asarray([prompt], np.int32)))
        ht = ts[1].prefill(sid, ts[0].prefill(sid, torch.tensor([prompt])))
        assert_close(ht, hj)
        toks[sid] = [int(jnp.argmax(js[1].logits(hj)[0, -1]))]
    for _ in range(4):
        oj = js[1].decode_batch(js[0].decode_batch(
            {sid: jnp.asarray([[toks[sid][-1]]], jnp.int32) for sid in prompts}))
        ot = ts[1].decode_batch(ts[0].decode_batch(
            {sid: torch.tensor([[toks[sid][-1]]]) for sid in prompts}))
        sampled = ts[1].sample_round({sid: greedy_req(sid) for sid in prompts})
        for sid in prompts:
            assert_close(ot[sid], oj[sid])
            toks[sid].append(int(jnp.argmax(js[1].logits(oj[sid])[0, -1])))
            assert sampled[sid] == toks[sid][-1]


def test_captured_steps_replay_through_a_stub_graph(monkeypatch):
    """The engine's SlotSteps and round sampler with graphs on, through a
    CPU stand-in of a graph: each key's first call runs its step twice
    more (the warm-up and the capture) before the replay, so the steps must
    be idempotent for fixed inputs; tokens and hidden rows equal the
    direct run, captures happen once per key, and every later call
    replays."""
    class StubGraph:
        def __init__(self, fn, out):
            self.fn, self.out = fn, out

        def replay(self):
            new = self.fn()
            for o, n in zip(*(x if isinstance(x, tuple) else (x,) for x in (self.out, new))):
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
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=6)
    je, te = engines(jcfg, jp, tp)
    te.graphs.enabled = te.sampler.enabled = True
    run = generate(je, te, PROMPTS, 5)
    assert te.graphs.captures == 2                 # prefill bucket 8; decode
    assert te.graphs.replays == len(PROMPTS) + 4
    sp = SamplingParams(*SAMPLED)
    reqs = {sid: StageRequest(session_id=sid, hidden=None, seq_len=1, cur_len=0,
                              is_prefill=False, max_length=MAX_LEN, sampling=sp,
                              generated_tokens=tuple(run.toks[sid]), step_seed=9)
            for sid in PROMPTS}
    graphed = te.sample_round(reqs)
    te.sampler.enabled = False
    assert te.sample_round(reqs) == graphed
    assert te.sampler.captures == 1 and te.sampler.replays == 1


def test_engine_refuses_moe():
    jcfg = jconfig.mixtral_config(
        vocab_size=257, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=96, num_experts=4,
        num_experts_per_tok=2, max_position_embeddings=256)
    tcfg = port_cfg(jcfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        tbatching.BatchedStageExecutor(tcfg, StageSpec(0, ROLE_FULL, 0, 2), {},
                                       device="cpu")


def test_stage0_serve_without_batched_exits():
    """``--stage 0`` serves the full span, with ``--batched`` only, as the
    reference's serve mode (its stage 0 otherwise runs in the client)."""
    with pytest.raises(SystemExit, match="requires --batched"):
        tmain.main(["--mode", "serve", "--stage", "0", "--device", "cpu",
                    "--registry_addr", "127.0.0.1:1"])


# -- the adapter ---------------------------------------------------------------

def _jreq(sid, tokens, cur, prefill, **kw):
    return JStageRequest(session_id=sid, hidden=jnp.asarray([tokens], jnp.int32),
                         seq_len=len(tokens), cur_len=cur, is_prefill=prefill,
                         max_length=MAX_LEN, **kw)


def _treq(sid, tokens, cur, prefill, **kw):
    return StageRequest(session_id=sid, hidden=torch.tensor([tokens]),
                        seq_len=len(tokens), cur_len=cur, is_prefill=prefill,
                        max_length=MAX_LEN, **kw)


def adapters(seed, slots=SLOTS, window_s=1.0):
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=seed)
    je, te = engines(jcfg, jp, tp, slots=slots)
    return (jbatching.BatchingStageAdapter(je, window_s=window_s),
            tbatching.BatchingStageAdapter(te, window_s=window_s))


def _barrier_round(adapter, mk, reqs):
    """Every request of `reqs` {sid: (tokens, cur)} enters forward at once."""
    barrier = threading.Barrier(len(reqs))
    out, errors = {}, {}

    def run(sid, tokens, cur):
        barrier.wait(timeout=60)
        try:
            out[sid] = adapter.forward(mk(sid, tokens, cur, False))
        except Exception as exc:        # surfaced by the caller
            errors[sid] = exc

    threads = [threading.Thread(target=run, args=(sid, *v)) for sid, v in reqs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out, errors


def test_adapter_coalesces_concurrent_decodes():
    """Three decodes released together share ONE round on both adapters,
    and each gets the JAX adapter's token."""
    ja, ta = adapters(21)
    prompts = {"a": [5, 9, 23], "b": [44, 2], "c": [100, 11, 12]}
    got = []
    for adapter, mk in ((ja, _jreq), (ta, _treq)):
        for sid, p in prompts.items():
            adapter.forward(mk(sid, p, 0, True))
        before = adapter.inner.decode_steps
        out, errors = _barrier_round(adapter, mk, {sid: ([7], len(p))
                                                   for sid, p in prompts.items()})
        assert not errors, errors
        assert adapter.inner.decode_steps == before + 1
        got.append({sid: r.token_id for sid, r in out.items()})
    assert got[1] == got[0]


def test_adapter_refuses_stale_cur_len_and_round_survives():
    ja, ta = adapters(9, slots=2, window_s=0.0)
    got = []
    for adapter, mk, err in ((ja, _jreq, JStageExecutionError),
                             (ta, _treq, StageExecutionError)):
        adapter.forward(mk("a", [5, 9, 23], 0, True))
        adapter.forward(mk("b", [44, 2], 0, True))
        with pytest.raises(err, match="cur_len"):
            adapter.forward(mk("a", [7], 1, False))
        r1 = adapter.forward(mk("b", [7], 2, False))
        r2 = adapter.forward(mk("a", [7], 3, False))
        got.append((r1.token_id, r2.token_id, r1.cache_len, r2.cache_len))
    assert got[1] == got[0]


# Requests both adapters refuse (of a session with no slot, as in
# tests/test_batching.py:339), then those only the port's refuses (their
# slices are not ported: speculative rows #3, push chains #2).
COMMON_REFUSALS = [dict(hypo_ids=(0,)), dict(num_logprobs=2), dict(is_replay=True),
                   dict(start_from_position=0, cur_len=3), dict(start_block=1), dict()]
PORT_REFUSALS = [dict(draft_tokens=(1,)), dict(draft_tokens=(1, 2), seq_len=3),
                 dict(next_servers=({"peer_id": "x"},))]


def _refusal_request(mk, sid, bad):
    kw = dict(bad)
    cur = kw.pop("cur_len", 3)
    seq_len = kw.pop("seq_len", 1)
    return dataclasses.replace(mk(sid, [1] * seq_len, cur, False), **kw)


@pytest.mark.parametrize("bad", COMMON_REFUSALS, ids=lambda b: "-".join(b) or "no-slot")
def test_adapter_refuses_what_the_reference_refuses(bad):
    """Refusals of tests/test_batching.py:339 (the last: a decode without
    a prefill), with the task_rejected events of the JAX adapter."""
    ja, ta = adapters(8, slots=2)
    events = []
    for adapter, mk, err, tel in ((ja, _jreq, JStageExecutionError, jtel),
                                  (ta, _treq, StageExecutionError, ttel)):
        tel.get_recorder().enable()
        tel.get_recorder().clear()
        try:
            with pytest.raises(err):
                adapter.forward(_refusal_request(mk, "ghost", bad))
            events.append([(e.name, json.dumps(e.fields, sort_keys=True))
                           for e in tel.get_recorder().events()])
        finally:
            tel.get_recorder().disable()
            tel.get_recorder().clear()
    assert events[1] == events[0]


def test_adapter_serves_a_burst():
    """A burst request to the full-span adapters of both packages: the same
    tokens, stop and cache length, and the session goes on with a plain
    decode."""
    ja, ta = adapters(8, slots=2, window_s=0.0)
    got = []
    for adapter, mk in ((ja, _jreq), (ta, _treq)):
        first = adapter.forward(mk("s", [5, 9, 23], 0, True)).token_id
        r = adapter.forward(mk("s", [first], 3, False, burst_len=4, burst_budget=3,
                               generated_tokens=(first,), step_seed=1))
        nxt = adapter.forward(mk("s", [r.burst_tokens[-1]], r.cache_len, False))
        got.append((first, r.burst_tokens, r.burst_stop, r.cache_len, nxt.token_id,
                    adapter.inner.burst_dispatches))
    assert got[1] == got[0]
    assert len(got[1][1]) == 3 and got[1][3] == 6


@pytest.mark.parametrize("bad", PORT_REFUSALS, ids=lambda b: "-".join(b))
def test_adapter_refuses_what_is_not_ported(bad):
    """Speculative rows and push chains are refused, retryably, with a
    task_rejected event, and the session stays usable."""
    _, ta = adapters(8, slots=2, window_s=0.0)
    ta.forward(_treq("s", [5, 9, 23], 0, True))
    ttel.get_recorder().enable()
    ttel.get_recorder().clear()
    try:
        with pytest.raises(StageExecutionError, match="not ported"):
            ta.forward(_refusal_request(_treq, "s", bad))
        assert [e.name for e in ttel.get_recorder().events()] == ["task_rejected"]
    finally:
        ttel.get_recorder().disable()
        ttel.get_recorder().clear()
    assert ta.forward(_treq("s", [7], 3, False)).token_id is not None
    with pytest.raises(StageExecutionError):           # decode without a slot
        ta.forward(_treq("ghost", [7], 0, False))


def _series(reg, names):
    out = {}
    for fam, children in reg.collect():
        if fam.name in names:
            for child in children:
                out[(fam.name, child.labels)] = (child.count, child.sum)
    return out


def test_batching_telemetry_equals_jax_adapter():
    """The three batching families after the same prefills, two barrier
    rounds (3 sessions, then 2) and a stale retry: fills observed with the
    same values, as many queue waits and rounds (times are measured, so
    only their counts compare)."""
    names = {"server_queue_wait_seconds", "server_batch_fill_sessions",
             "server_decode_round_seconds"}
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=10)
    views = []
    for inner, cls, mk, tel in zip(engines(jcfg, jp, tp),
                                   (jbatching.BatchingStageAdapter,
                                    tbatching.BatchingStageAdapter),
                                   (_jreq, _treq), (jtel, ttel)):
        tel.get_registry().reset()
        tel.enable()
        try:
            # Handles are fetched at construction: build it enabled.
            adapter = cls(inner, window_s=1.0)
            for sid, p in (("a", [5, 9, 23]), ("b", [44, 2]), ("c", [1, 2, 3])):
                adapter.forward(mk(sid, p, 0, True))
            out, errors = _barrier_round(adapter, mk, {"a": ([7], 3), "b": ([7], 2),
                                                       "c": ([7], 3)})
            assert not errors
            out, errors = _barrier_round(adapter, mk, {"a": ([8], 4), "b": ([8], 3),
                                                       "c": ([8], 1)})
            assert list(errors) == ["c"]
            series = _series(tel.get_registry(), names)
            views.append({k: (c, s if k[0] == "server_batch_fill_sessions" else None)
                          for k, (c, s) in series.items()})
        finally:
            tel.disable()
            tel.get_registry().reset()
    assert views[1] == views[0]
    assert views[1][("server_batch_fill_sessions", ())] == (2, 5.0)


def test_adapter_serves_concurrent_clients_through_transport():
    """Both packages' adapters as a batched final stage behind
    LocalTransport; clients generate concurrently, greedy and seeded
    sampled, joining late and leaving early; every client's tokens equal
    the JAX package's, and the engine ran fewer steps than per-session
    serving would."""
    jcfg = tiny_cfg()
    jp, tp = weights(jcfg, seed=7)
    tcfg = port_cfg(jcfg)
    jplan = JStagePlan.from_splits(jcfg.num_layers, jparse_splits("4"))
    tplan = StagePlan.from_splits(tcfg.num_layers, parse_splits("4"))
    runs = [([5, 9, 23, 7, 81], 8, GREEDY, 0.0), ([44, 2, 3], 4, SAMPLED, 0.0),
            ([100, 11, 12, 13], 6, GREEDY, 0.2), ([3, 1, 4, 1, 5], 7, SAMPLED, 0.3)]

    def serve(pkg):
        if pkg == "jax":
            inner = jax_engine(jcfg, jplan.stages[1], jslice(jcfg, jp, jplan.stages[1]))
            adapter = jbatching.BatchingStageAdapter(inner, window_s=0.05)
            transport, registry = JLocalTransport(), JPlacementRegistry(rng=random.Random(0))
            registry.register(jrecord("batched", jplan.stages[1], engine="batched"))
        else:
            inner = tbatching.BatchedStageExecutor(
                tcfg, tplan.stages[1], slice_stage_params(tcfg, tp, tplan.stages[1]),
                slots=SLOTS, max_len=MAX_LEN, device="cpu")
            adapter = tbatching.BatchingStageAdapter(inner, window_s=0.05)
            adapter.warmup()
            transport, registry = LocalTransport(), PlacementRegistry(rng=random.Random(0))
            registry.register(make_server_record("batched", tplan.stages[1],
                                                 engine="batched"))
        transport.add_peer("batched", adapter)
        results = [None] * len(runs)

        def run(i):
            prompt, n, knobs, delay = runs[i]
            threading.Event().wait(delay)
            if pkg == "jax":
                stage0 = JStageExecutor(jcfg, jplan.stages[0],
                                        jslice(jcfg, jp, jplan.stages[0]), peer_id=f"c{i}")
                client = JPipelineClient(jcfg, jplan, stage0, transport, registry,
                                         settle_seconds=0.0, seed=i)
                sp = JSamplingParams(*knobs)
            else:
                stage0 = StageExecutor(tcfg, tplan.stages[0],
                                       slice_stage_params(tcfg, tp, tplan.stages[0]),
                                       peer_id=f"c{i}", device="cpu")
                client = PipelineClient(tcfg, tplan, stage0, transport, registry,
                                        settle_seconds=0.0, seed=i)
                sp = SamplingParams(*knobs)
            results[i] = client.generate(prompt, max_new_tokens=n, sampling=sp).tokens

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(runs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert all(r is not None for r in results), "client thread(s) timed out"
        return results, inner

    want, _ = serve("jax")
    got, inner = serve("port")
    assert got == want
    assert inner.decode_steps <= 1 + sum(n - 1 for _, n, _, _ in runs)
    assert inner.slot("__warmup__") is None and not inner._slot_of

