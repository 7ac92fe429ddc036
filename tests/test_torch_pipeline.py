"""The port's --mode local pipeline against the JAX package's, each built
by its own main.run_local, on the same bridged weights: identical greedy
tokens. Also: the port's pipeline equals the port's --mode oracle, the
sampler's distribution equals JAX's over a sweep, seeded sampling is
reproducible, a dead or flaky stage is handled by failover, and the CLI
runs end to end on the CPU."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    jax_mode_generate,
    jax_params,
    one_torch_thread,
    port_args,
    port_cfg,
    tiny_llama_j,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    sampling as tsamp,
)

PROMPT = [72, 101, 108, 108, 111, 33]
STEPS = 16
SPLITS = {"even4": [], "splits2": ["--splits", "2"]}


@pytest.mark.parametrize("splits", sorted(SPLITS))
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_local_pipeline_greedy_tokens_match_jax_and_oracle(monkeypatch, quant, splits):
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    jp = jax_params(jcfg)
    argv = ["--mode", "local", "--quant", quant] + SPLITS[splits]
    greedy_j = jsamp.SamplingParams(temperature=0.0)
    greedy_t = tsamp.SamplingParams(temperature=0.0)
    want = jax_mode_generate(monkeypatch, argv, jcfg, jp)[0](
        PROMPT, STEPS, sampling=greedy_j).tokens
    assert len(want) == STEPS

    tp = bridged(jp)
    client = tmain.build_local_client(port_args(argv), tcfg, tp)
    assert client.plan.num_stages == (4 if splits == "even4" else 2)
    got = client.generate(PROMPT, STEPS, sampling=greedy_t)
    assert got.tokens == want
    assert got.stopped_by == "max_tokens"

    oracle = tmain.make_oracle_generate(port_args(argv), tcfg, tp)
    assert oracle(PROMPT, STEPS, greedy_t).tokens == want


def _sweep():
    windows = {
        "empty": [],
        "partial": [3, 9, 3, 100, 7, 3, 0],
        "full": list(range(60)),                    # wraps the 50-token window
        "triple": [11, 40, 40, 250, 250, 250],      # triple-repeat guard
    }
    for (wname, toks), temp, top_k, top_p, rp in itertools.product(
            windows.items(), [0.5, 1.0, 1.3], [0, 1, 20, 600], [1.0, 0.9, 0.3],
            [1.0, 1.5]):
        yield wname, toks, temp, top_k, top_p, rp


def test_sample_probs_match_jax_over_sweep():
    r = np.random.default_rng(3)
    jfn = jax.jit(jsamp.sample_probs)
    n_checked = 0
    for wname, toks, temp, top_k, top_p, rp in _sweep():
        logits = (r.standard_normal(512) * 3).astype(np.float32)
        logits[250] = abs(logits[250]) + 4.0      # the repeated token is a top logit
        recent = np.zeros(jsamp.RECENT_WINDOW, np.int32)
        window = toks[-jsamp.RECENT_WINDOW:]
        recent[:len(window)] = window
        want = jfn(jnp.asarray(logits), jnp.asarray(recent), jnp.int32(len(window)),
                   jnp.float32(temp), jnp.float32(top_p), jnp.int32(top_k),
                   jnp.float32(rp))
        got = tsamp.sample_probs(torch.from_numpy(logits), torch.from_numpy(recent),
                                 len(window), temp, top_p, top_k, rp)
        assert_close(got, want, rtol=0.0, atol=1e-6)
        n_checked += 1
    assert n_checked == 4 * 3 * 4 * 3 * 2


def test_push_recent_and_repetition_penalty_match_jax():
    rt, nv = tsamp.make_recent_buffer()
    jt, jn = jsamp.make_recent_buffer()
    for tok in list(range(55)) + [7, 7, 7]:
        rt, nv = tsamp.push_recent(rt, nv, tok)
        jt, jn = jsamp.push_recent(jt, jn, jnp.int32(tok))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(jt))
    assert nv == int(jn)
    logits = np.linspace(-4, 4, 64).astype(np.float32)
    assert_close(tsamp.apply_repetition_penalty(torch.from_numpy(logits), rt % 64, nv, 1.3),
                 jsamp.apply_repetition_penalty(jnp.asarray(logits), jt % 64, jn,
                                                jnp.float32(1.3)))


def test_seeded_sampling_is_reproducible():
    """Seeded draws come from threefry keys (PRNGKey(seed + step)): the same
    seed repeats its tokens, another seed draws others, and the port's
    oracle, keyed the same way, draws the pipeline's tokens."""
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    tp = bridged(jax_params(jcfg, "int8"))
    args = port_args(["--mode", "local", "--quant", "int8", "--seed", "11"])
    sampling = tsamp.SamplingParams(temperature=0.7, top_p=0.9, top_k=50,
                                    repetition_penalty=1.5)
    runs = [tmain.build_local_client(args, tcfg, tp).generate(
        PROMPT, 12, sampling=sampling).tokens for _ in range(2)]
    assert runs[0] == runs[1]
    assert len(runs[0]) >= 5
    other = tmain.build_local_client(
        port_args(["--mode", "local", "--quant", "int8", "--seed", "12"]),
        tcfg, tp).generate(PROMPT, 12, sampling=sampling).tokens
    assert other != runs[0]
    oracle = tmain.make_oracle_generate(args, tcfg, tp)
    assert oracle(PROMPT, 12, sampling).tokens == runs[0]


def test_main_local_runs_on_cpu(capsys):
    rc = tmain.main(["--mode", "local", "--device", "cpu", "--model", "gpt2",
                     "--quant", "int8", "--max_new_tokens", "4",
                     "--prompt", "hi"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "=== Generation (" in out and "TTFT:" in out


def test_kv_arena_buckets_and_accounting_match_jax():
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
        kv_cache as jkv,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
        kv_cache as tkv,
    )

    for n in (1, 128, 129, 5000):
        assert tkv.round_to_bucket(n, tkv.DEFAULT_BUCKETS) == \
            jkv.round_to_bucket(n, jkv.DEFAULT_BUCKETS)
    ja = jkv.KVArena(2, 2, 8, max_bytes=1 << 20, dtype=jnp.float32)
    ta = tkv.KVArena(2, 2, 8, max_bytes=1 << 20, device="cpu", dtype=torch.float32)
    for bucket, layers, batch in ((128, None, 1), (256, 1, 2)):
        assert ta.bytes_for(bucket, layers, batch) == ja.bytes_for(bucket, layers, batch)
    h = ta.allocate("s", 100, timeout=0.0)
    assert tuple(h.k.shape) == (2, 1, 128, 2, 8) and h.bucket_len == 128
    assert ta.used_bytes == ta.bytes_for(128)
    h.admit(100)
    with pytest.raises(tkv.AdmissionDenied):
        h.admit(101)
    with pytest.raises(tkv.AllocationFailed):
        ta.allocate("s", 100, timeout=0.0)          # duplicate session
    with pytest.raises(tkv.AllocationFailed):
        ta.allocate("big", 32768, timeout=0.0)      # can never fit
    ta.free("s")
    assert ta.used_bytes == 0 and ta.get("s") is None


@pytest.mark.parametrize("fault", ["kill", "flake"])
def test_dead_or_flaky_stage_fails_the_generation_and_frees_leases(fault):
    """With failover, a kill of the only replica of a stage raises after
    MAX_ATTEMPTS attempts and frees every lease and journal entry; a
    transient flake recovers onto the same peer with identical tokens.
    After the peer is revived it serves the same tokens again: at once
    after a flake, and after a kill only once the circuit breaker's
    backoff has run out (three failures opened it) and its half-open
    probe succeeds."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
        MAX_ATTEMPTS,
        CircuitBreaker,
    )

    jcfg = tiny_llama_j()
    client = tmain.build_local_client(
        port_args(["--mode", "local", "--quant", "int8", "--splits", "2"]),
        port_cfg(jcfg), bridged(jax_params(jcfg)))
    client.settle_seconds = 0.0
    clock = [0.0]
    client.breaker = CircuitBreaker(now=lambda: clock[0])
    greedy = tsamp.SamplingParams(temperature=0.0)
    want = client.generate(PROMPT, 6, sampling=greedy).tokens
    transport = client.transport
    server = transport.executor("server-stage1")

    def assert_released():
        # The session's leases and journal are released everywhere.
        assert client.stage0.arena.used_bytes == 0
        assert server.arena.used_bytes == 0
        assert all(not sessions for sessions in client.journal.values())

    if fault == "kill":
        transport.kill("server-stage1")
        with pytest.raises(RuntimeError, match=f"all {MAX_ATTEMPTS} attempts failed"):
            client.generate(PROMPT, 6, sampling=greedy)
        assert_released()
        assert client.breaker.state("server-stage1") == "open"
        transport.revive("server-stage1")
        # Revived, but the breaker's backoff has not run out: every attempt
        # is refused without a dial.
        served = server.requests_served
        with pytest.raises(RuntimeError, match=f"all {MAX_ATTEMPTS} attempts failed"):
            client.generate(PROMPT, 6, sampling=greedy)
        assert_released()
        assert server.requests_served == served
        assert client.breaker.state("server-stage1") == "open"
        # Past the backoff (at most base 0.5 s plus 10% jitter), the
        # half-open probe goes through and closes the breaker.
        clock[0] += 1.0
        assert client.generate(PROMPT, 6, sampling=greedy).tokens == want
        assert server.requests_served > served
        assert client.breaker.state("server-stage1") == "closed"
    else:
        transport.fail_next("server-stage1", 1)
        assert client.generate(PROMPT, 6, sampling=greedy).tokens == want
        assert client.recoveries == 1
        assert_released()
        transport.revive("server-stage1")
        assert client.generate(PROMPT, 6, sampling=greedy).tokens == want
        assert client.breaker.state("server-stage1") == "closed"
    assert_released()


def test_executor_subspans_replay_and_missing_session():
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
        StagePlan,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
        StageExecutionError,
        StageExecutor,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
        StageRequest,
    )

    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    full = StagePlan.from_splits(tcfg.num_layers, []).stages[0]      # [0, 4)
    ex = StageExecutor(tcfg, full, bridged(jax_params(jcfg, "int8")), device="cpu")
    greedy = tsamp.SamplingParams(temperature=0.0)
    ids = torch.tensor([PROMPT])

    def req(sid, hidden, **kw):
        kw.setdefault("is_prefill", True)
        return StageRequest(session_id=sid, hidden=hidden, seq_len=len(PROMPT),
                            cur_len=0, max_length=16, sampling=greedy, **kw)

    want = ex.forward(req("whole", ids)).token_id
    # The same span as two sub-range hops: [0, 2) returns hidden states,
    # [2, 4) takes them and samples.
    mid = ex.forward(req("head", ids, end_block=2)).hidden
    assert tuple(mid.shape) == (1, len(PROMPT), tcfg.hidden_size)
    assert ex.forward(req("tail", mid, start_block=2)).token_id == want
    # A replayed decode on a peer without the session rebuilds it.
    assert ex.forward(req("replayed", ids, is_prefill=False, is_replay=True)).token_id == want
    # A prefill longer than the chunk budget (16 tokens here) runs as
    # chunks over the same cache and samples what one pass samples.
    long_ids = torch.tensor([PROMPT * 7])
    long_req = lambda sid: StageRequest(session_id=sid, hidden=long_ids,  # noqa: E731
                                        seq_len=long_ids.shape[1], cur_len=0,
                                        is_prefill=True, max_length=64,
                                        sampling=greedy)
    chunked = StageExecutor(tcfg, full, ex.params, device="cpu", max_chunk_bytes=1)
    assert chunked._max_chunk_tokens(1) == 16 < long_ids.shape[1]
    assert chunked.forward(long_req("c")).token_id == ex.forward(long_req("c")).token_id
    with pytest.raises(StageExecutionError):
        ex.forward(req("unknown", ids, is_prefill=False))
    with pytest.raises(StageExecutionError):
        ex.forward(req("bad-range", ids, start_block=3, end_block=9))
