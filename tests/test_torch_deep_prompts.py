"""Inference-time deep prompts on the port's session engines against the
JAX package's, on the same weights: counterparts of
``tests/test_deep_prompts.py``.

Covered: ``_apply_deep_prompt`` against the reference's at absolute
positions (an int and a device-style tensor ``cache_len``, float32 and
bf16 activations); ``full_forward(prompts=)`` logits; the pipeline's greedy
tokens against the reference's monolithic ``full_forward(prompts=)``
oracle with pre_seq longer than the prompt (so the first decode steps are
inside the region), and different tokens without prompts; a chunked
prefill at absolute positions; a failover replay that rebuilds with the
same injection; TCP at wire f32 (port client and JAX client against port
servers), where the steps past the region ride the persistent stream; a
span executor's hidden rows against the reference's
``stage_forward(prompts=)``; the prompts' shape check; the batched engine's
and the burst client's refusals; and the captured steps (a CPU stub of the
graph object): the prompt steps have their own keys, carrying pre_seq, the
steps past the region replay the plain key, and a second run captures
nothing.

Tolerance: tokens exactly (the prompts' scale of 0.5 changes the tokens,
so parity is not vacuous); hidden rows within 2e-4 absolute and relative,
the reference test's own; logits and injected rows within the float32
parity of ``_torch_port_helpers``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    build_port_cluster,
    one_torch_thread,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    full_forward as j_full_forward,
    init_kv_cache as j_init_kv_cache,
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    transformer as jtransformer,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StageSpec as JStageSpec,
    init_stage_kv as j_init_stage_kv,
    slice_stage_params as jslice_stage_params,
    stage_forward as j_stage_forward,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttransformer,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    ROLE_FULL,
    StageSpec,
    slice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.batching import (
    BatchedStageExecutor,
    BatchingStageAdapter,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)

from test_deep_prompts import make_prompts, oracle_with_prompts
from test_runtime_pipeline import tiny_cfg
from test_torch_graphs import stub_graphs  # noqa: F401 (a fixture)
from test_torch_tcp import Swarm

GREEDY = SamplingParams(temperature=0.0)
PROMPT = [5, 9, 23, 7]
PRE = 7          # > len(PROMPT): the first decode steps are inside the region
NEW = 8


def port_prompts(jprompts) -> torch.Tensor:
    return torch.from_numpy(np.array(jprompts))


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


@pytest.fixture(scope="module")
def oracle(weights):
    """The reference's monolithic greedy tokens of PROMPT with and without
    the prompts (cached: the eager JAX loop dominates this file)."""
    jcfg, jp, _, _ = weights
    jpr = make_prompts(jcfg, pre_seq=PRE)
    return {"prompts": jpr, "tokens": oracle_with_prompts(jcfg, jp, PROMPT, NEW, jpr)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [0, 3, 6, 9])
def test_apply_deep_prompt_matches_jax(cache_len, dtype):
    """Rows at absolute positions cache_len .. cache_len+T get pr[idx]
    while idx < pre_seq, cast to h's dtype before the add; a tensor
    cache_len (a captured step's) gives the same rows as an int."""
    rng = np.random.default_rng(cache_len)
    h = rng.standard_normal((2, 4, 16)).astype(np.float32)
    pr = rng.standard_normal((7, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jtransformer._apply_deep_prompt(
        jnp.asarray(h).astype(jdt), jnp.asarray(pr), jnp.int32(cache_len)
    ).astype(jnp.float32))
    th = torch.from_numpy(h).to(tdt)
    for cl in (cache_len, torch.tensor(cache_len)):
        got = ttransformer._apply_deep_prompt(th, torch.from_numpy(pr), cl)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_full_forward_with_prompts_matches_jax(weights, oracle):
    jcfg, jp, tcfg, tp = weights
    ids = np.asarray([PROMPT], np.int32)
    kc, vc = j_init_kv_cache(jcfg, jcfg.num_layers, 1, 32)
    want, _, _ = j_full_forward(jcfg, jp, jnp.asarray(ids), kc, vc, jnp.int32(0),
                                prompts=oracle["prompts"])
    tk, tv = ttransformer.init_kv_cache(tcfg, tcfg.num_layers, 1, 32)
    got, _, _ = ttransformer.full_forward(tcfg, tp, torch.from_numpy(ids).long(), tk, tv,
                                          0, prompts=port_prompts(oracle["prompts"]))
    assert_close(got.numpy(), np.asarray(want))


def test_pipeline_deep_prompts_match_monolithic_oracle(weights, oracle):
    """Chained spans and the client's per-span slices equal the monolithic
    injection; the prompts change the tokens; the session's prompts are
    dropped when it ends."""
    _, _, tcfg, tp = weights
    client, _ = build_port_cluster(tcfg, tp, "2,4,6")
    res = client.generate(PROMPT, NEW, sampling=GREEDY,
                          deep_prompts=port_prompts(oracle["prompts"]))
    assert res.tokens == oracle["tokens"]
    base = client.generate(PROMPT, NEW, sampling=GREEDY)
    assert base.tokens != oracle["tokens"]
    assert not client._session_prompts


def test_deep_prompts_chunked_prefill_absolute_positions(weights):
    """A 40-token prefill split into 16-token chunks injects at ABSOLUTE
    positions: chunk 2 gets prompt rows 16.., not a restarted slice."""
    jcfg, jp, tcfg, tp = weights
    spec = StageSpec(index=0, role=ROLE_FULL, start=0, end=tcfg.num_layers)
    # batch x hidden x 4 bytes x layers = 2048 bytes a token: 16-token chunks.
    ex = StageExecutor(tcfg, spec, tp, peer_id="chunky", max_chunk_bytes=32 * 1024,
                       device="cpu")
    assert ex._max_chunk_tokens(1) == 16
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, 40).astype(np.int32)
    jpr = make_prompts(jcfg, pre_seq=24)       # the region spans chunks 1 and 2
    resp = ex.forward(StageRequest(
        session_id="s", hidden=torch.from_numpy(prompt[None, :]).long(), seq_len=40,
        cur_len=0, is_prefill=True, max_length=64, sampling=GREEDY,
        prompts=port_prompts(jpr)))
    kc, vc = j_init_kv_cache(jcfg, jcfg.num_layers, 1, 64)
    logits, _, _ = j_full_forward(jcfg, jp, jnp.asarray(prompt[None, :]), kc, vc,
                                  jnp.int32(0), prompts=jpr)
    assert resp.token_id == int(jnp.argmax(logits[0, -1]))
    plain = ex.forward(StageRequest(
        session_id="p", hidden=torch.from_numpy(prompt[None, :]).long(), seq_len=40,
        cur_len=0, is_prefill=True, max_length=64, sampling=GREEDY))
    assert plain.token_id != resp.token_id


def test_deep_prompts_survive_failover_replay(weights):
    """The replacement peer rebuilds its KV with the same injection: every
    journal replay chunk carries the hop's prompt slice."""
    jcfg, jp, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, "4", replicas=2)
    prompt = [11, 3, 77]
    jpr = make_prompts(jcfg, pre_seq=6)
    want = oracle_with_prompts(jcfg, jp, prompt, NEW, jpr)
    killed = {"done": False}
    orig_call = transport.call

    def flaky_call(peer_id, req, timeout=None):
        if not killed["done"] and not req.is_prefill and req.cur_len >= 5:
            killed["done"] = True
            transport.kill(peer_id)
        return orig_call(peer_id, req, timeout)

    transport.call = flaky_call
    res = client.generate(prompt, NEW, sampling=GREEDY, deep_prompts=port_prompts(jpr))
    assert killed["done"] and client.recoveries >= 1
    assert res.tokens == want


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_deep_prompts_over_tcp(weights, oracle, client_pkg):
    """Prompts ride the classic frame as a second payload tensor (float32)
    to port servers, from a client of either package, and the tokens equal
    the monolithic oracle's; the steps past the region carry no prompts and
    ride the persistent stream."""
    swarm = Swarm(weights, {1: ["port"], 2: ["port"], 3: ["port"]}, "f32")
    try:
        client = swarm.client(client_pkg)
        pr = oracle["prompts"] if client_pkg == "jax" else port_prompts(oracle["prompts"])
        res = client.generate(PROMPT, NEW, sampling=GREEDY, deep_prompts=pr)
        assert res.tokens == oracle["tokens"]
        assert sum(s.stream_steps for s in swarm.servers.values()) > 0
    finally:
        swarm.stop()


def test_span_executor_hidden_parity(weights):
    """Prefill and three decode steps of a middle span with prompts: every
    hidden row equals the reference's ``stage_forward(prompts=)``."""
    jcfg, jp, tcfg, tp = weights
    jspec = JStageSpec(index=1, role="segment", start=2, end=6)
    spec = StageSpec(index=1, role="segment", start=2, end=6)
    ex = StageExecutor(tcfg, spec, slice_stage_params(tcfg, tp, spec), peer_id="span",
                       device="cpu")
    jpr = make_prompts(jcfg, pre_seq=6)[2:6]
    rng = np.random.default_rng(1)
    kc, vc = j_init_stage_kv(jcfg, jspec, 1, 64)
    full = jslice_stage_params(jcfg, jp, jspec)
    cur = 0
    for step in range(4):
        t = 4 if step == 0 else 1
        x = rng.standard_normal((1, t, jcfg.hidden_size)).astype(np.float32)
        resp = ex.forward(StageRequest(
            session_id="s", hidden=torch.from_numpy(x), seq_len=t, cur_len=cur,
            is_prefill=step == 0, max_length=32, prompts=port_prompts(jpr)))
        want, kc, vc = j_stage_forward(jcfg, jspec, full, jnp.asarray(x), kc, vc,
                                       jnp.int32(cur), prompts=jpr)
        np.testing.assert_allclose(resp.hidden.numpy(), np.asarray(want),
                                   atol=2e-4, rtol=2e-4)
        cur += t


@pytest.mark.parametrize("shape", [(3, 6, 64), (4, 6), (5, 6, 64)])
def test_prompts_that_miss_the_span_are_refused(weights, shape):
    _, _, tcfg, tp = weights
    spec = StageSpec(index=1, role="segment", start=2, end=6)
    ex = StageExecutor(tcfg, spec, slice_stage_params(tcfg, tp, spec), peer_id="span",
                       device="cpu")
    with pytest.raises(StageExecutionError, match="does not cover"):
        ex.forward(StageRequest(
            session_id="s", hidden=torch.zeros(1, 2, tcfg.hidden_size), seq_len=2,
            cur_len=0, is_prefill=True, max_length=8, prompts=torch.zeros(shape)))
    assert ex.arena.get("s") is None


def test_batched_engine_and_burst_client_refuse_prompts(weights, oracle):
    """Neither the batched engine nor a burst session serves deep prompts:
    silently ignoring them would give untuned tokens that look valid."""
    _, _, tcfg, tp = weights
    spec = StageSpec(index=0, role=ROLE_FULL, start=0, end=tcfg.num_layers)
    adapter = BatchingStageAdapter(
        BatchedStageExecutor(tcfg, spec, tp, device="cpu", slots=2, max_len=64),
        window_s=0.0)
    with pytest.raises(StageExecutionError, match="deep-prompt"):
        adapter.forward(StageRequest(
            session_id="s", hidden=torch.tensor([[1, 2, 3]]), seq_len=3, cur_len=0,
            is_prefill=True, max_length=32, prompts=port_prompts(oracle["prompts"])))
    client, _ = build_port_cluster(tcfg, tp, "2,4,6")
    with pytest.raises(ValueError, match="deep prompts"):
        client.generate(PROMPT, NEW, sampling=GREEDY, burst=4,
                        deep_prompts=port_prompts(oracle["prompts"]))


def test_prompt_steps_through_captured_graphs(weights, oracle, stub_graphs):
    """With every step captured (a CPU stub that replays the captured
    function over its static tensors), the tokens are the oracle's: the
    prompt steps' own graphs, keyed by pre_seq and the prompts' dtype, read
    the prompts copied in before each replay. Steps past the region run
    the plain key. A second run captures nothing."""
    _, _, tcfg, tp = weights
    client, transport = build_port_cluster(tcfg, tp, "2,4,6")
    executors = [client.stage0] + [transport.executor(p) for p in transport.peers()]
    for ex in executors:
        ex.graphs.enabled = ex.sampler.enabled = True
    pr = port_prompts(oracle["prompts"])
    for run in range(2):
        res = client.generate(PROMPT, NEW, sampling=GREEDY, deep_prompts=pr)
        assert res.tokens == oracle["tokens"]
        if run == 0:
            captures = [ex.graphs.captures for ex in executors]
    assert [ex.graphs.captures for ex in executors] == captures
    for ex in executors:
        keys = [key for key, _ in ex.graphs.entries()]
        prompt_keys = [k for k in keys if len(k) == 7]
        # The prefill and the decode steps at cur_len 4..6 carry prompts;
        # cur_len 7.. is past the region, on the plain decode key.
        assert {(k[1], k[5], k[6]) for k in prompt_keys} == {
            (8, PRE, torch.float32), (1, PRE, torch.float32)}
        assert any(len(k) == 5 and k[1] == 1 for k in keys)
        for key, entry in ex.graphs.entries():
            assert (entry.prompts is not None) == (len(key) == 7)
