"""The port's threefry key schedule (ops/threefry.py) against jax.random,
and the seeded sampled tokens it gives: equal to JAX's on --mode local and
--mode oracle. Also: the port's oracle in bfloat16 (its KV cache now in the
weights' dtype, as the reference's) equals JAX's oracle on greedy tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    threefry as tf,
)

SEEDS = [0, 1, 42, 2 ** 31 + 5, -3]
SHAPES = [(1,), (7,), (3, 5), (512,), (32000,)]
PROMPT = [72, 101, 108, 108, 111, 33]
STEPS = 12
SAMPLING_SEEDS = [0, 3, 7, 11, 1234]
# The two frameworks' float32 log may round differently in the last ulp,
# so gumbel = -log(-log(u)) agrees to a few ulps of its scale (1 + |g|),
# not bit for bit (measured: at most 1 ulp over 200k draws).
GUMBEL_ULPS = 4


def _jkey(key):
    return tuple(int(v) for v in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    assert tf.prng_key(seed) == _jkey(jk)
    key = tf.prng_key(seed)
    for data in (0, 1, 2, 5, 77, 2 ** 32 - 1):
        jf = jax.random.fold_in(jk, data)
        assert tf.fold_in(key, data) == _jkey(jf)
        assert tf.fold_in(tf.fold_in(key, data), 3) == _jkey(jax.random.fold_in(jf, 3))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_random_bits_and_uniform_equal_jax(shape):
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        key = tf.prng_key(seed)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(tf.random_bits(key, shape).numpy(), want)
        ju = np.asarray(jax.random.uniform(jk, shape))
        tu = tf.uniform(key, shape).numpy()
        np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
        jr = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
        np.testing.assert_array_equal(tf.uniform(key, shape, -2.0, 3.0).numpy(), jr)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gumbel_equals_jax_to_float32_log_rounding(shape):
    eps = float(np.finfo(np.float32).eps)
    for seed in SEEDS:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape), np.float64)
        got = tf.gumbel(tf.prng_key(seed), shape).numpy().astype(np.float64)
        assert np.all(np.abs(got - want) <= GUMBEL_ULPS * eps * (1.0 + np.abs(want)))


@pytest.mark.parametrize("vocab", [512, 32000])
def test_categorical_draws_equal_jax(vocab):
    r = np.random.default_rng(vocab)
    jcat = jax.jit(jax.random.categorical)
    for seed in range(40):
        logits = (r.standard_normal(vocab) * 2).astype(np.float32)
        logits[r.integers(0, vocab, vocab // 2)] = np.log(1e-20)   # filtered tokens
        key = tf.fold_in(tf.prng_key(seed), seed % 3)
        want = int(jcat(jax.random.fold_in(jax.random.PRNGKey(seed), seed % 3),
                        jnp.asarray(logits)))
        assert int(tf.categorical(key, torch.from_numpy(logits))) == want


def test_sample_token_draws_equal_jax():
    r = np.random.default_rng(5)
    jfn = jax.jit(jsamp.sample_token)
    for seed in range(20):
        logits = (r.standard_normal(512) * 3).astype(np.float32)
        recent = np.zeros(jsamp.RECENT_WINDOW, np.int32)
        recent[:4] = [3, 9, 9, 100]
        temp, top_p, top_k, rp = 0.8, 0.9, 40, 1.3
        want = int(jfn(jax.random.PRNGKey(seed), jnp.asarray(logits), jnp.asarray(recent),
                       jnp.int32(4), jnp.float32(temp), jnp.float32(top_p),
                       jnp.int32(top_k), jnp.float32(rp)))
        got = tsamp.sample_token(tf.prng_key(seed), torch.from_numpy(logits),
                                 torch.from_numpy(recent), 4, temp, top_p, top_k, rp)
        assert got == want


@pytest.fixture(scope="module")
def sampled_runs():
    """One JAX --mode local client, one JAX oracle, and the port's
    counterparts on the same bridged weights; each generates per seed."""
    mp = pytest.MonkeyPatch()
    try:
        jcfg = tiny_llama_j()
        jp = jax_params(jcfg)
        jlocal, _ = jax_mode_generate(mp, ["--mode", "local", "--splits", "2"],
                                      jcfg, jp)
        joracle, jargs = jax_mode_generate(mp, ["--mode", "oracle"], jcfg, jp)
    finally:
        mp.undo()
    tcfg = port_cfg(jcfg)
    tp = bridged(jp)
    tlocal = tmain.build_local_client(port_args(["--mode", "local", "--splits", "2"]),
                                      tcfg, tp)
    targs = port_args(["--mode", "oracle"])
    toracle = tmain.make_oracle_generate(targs, tcfg, tp)
    return {"jlocal": jlocal, "joracle": joracle, "jargs": jargs,
            "tlocal": tlocal, "toracle": toracle, "targs": targs}


SAMPLING = dict(temperature=0.8, top_p=0.9, top_k=50, repetition_penalty=1.3)


@pytest.mark.parametrize("seed", SAMPLING_SEEDS)
def test_sampled_tokens_equal_jax_local(sampled_runs, seed):
    jlocal, tlocal = sampled_runs["jlocal"], sampled_runs["tlocal"]
    jlocal.__self__.seed = seed
    tlocal.seed = seed
    want = jlocal(PROMPT, STEPS, sampling=jsamp.SamplingParams(**SAMPLING)).tokens
    got = tlocal.generate(PROMPT, STEPS, sampling=tsamp.SamplingParams(**SAMPLING)).tokens
    assert len(want) == STEPS
    assert got == want


@pytest.mark.parametrize("seed", SAMPLING_SEEDS)
def test_sampled_tokens_equal_jax_oracle(sampled_runs, seed):
    sampled_runs["jargs"].seed = seed
    sampled_runs["targs"].seed = seed
    want = sampled_runs["joracle"](PROMPT, STEPS, jsamp.SamplingParams(**SAMPLING)).tokens
    got = sampled_runs["toracle"](PROMPT, STEPS, tsamp.SamplingParams(**SAMPLING)).tokens
    assert len(want) == STEPS
    assert got == want
    # The pipeline and the oracle draw with the same key schedule.
    tlocal = sampled_runs["tlocal"]
    tlocal.seed = seed
    assert tlocal.generate(PROMPT, STEPS,
                           sampling=tsamp.SamplingParams(**SAMPLING)).tokens == got


def test_bf16_oracle_greedy_tokens_equal_jax(monkeypatch):
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg, dtype=jnp.bfloat16)
    argv = ["--mode", "oracle", "--dtype", "bfloat16"]
    jgen, _ = jax_mode_generate(monkeypatch, argv, jcfg, jp)
    want = jgen(PROMPT, 16, jsamp.SamplingParams(temperature=0.0)).tokens
    tgen = tmain.make_oracle_generate(port_args(argv), port_cfg(jcfg), bridged(jp))
    assert tgen.params["embed"]["wte"].dtype == torch.bfloat16
    assert tgen(PROMPT, 16, tsamp.SamplingParams(temperature=0.0)).tokens == want


def test_batched_rows_draw_with_folded_keys():
    """Row 0 of a batch draws with PRNGKey(step_seed), row i with
    fold_in(base, i): a batch of identical rows draws what batch-1 requests
    keyed that way draw (reference executor.py:160-173)."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
        _sample_rows,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.graphs import (
        Sampler,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
        StageRequest,
    )

    r = np.random.default_rng(9)
    logits = torch.from_numpy((r.standard_normal((1, 1, 512)) * 2).astype(np.float32))
    sp = tsamp.SamplingParams(**SAMPLING)
    req = StageRequest(session_id="s", hidden=None, seq_len=1, cur_len=0,
                       is_prefill=False, max_length=8, sampling=sp,
                       generated_tokens=(4, 5), step_seed=17)
    rows = _sample_rows(logits.expand(4, 1, 512), 1, req, Sampler("cpu"))
    recent = torch.zeros(tsamp.RECENT_WINDOW, dtype=torch.int32)
    recent[:2] = torch.tensor([4, 5])
    base = tf.prng_key(17)
    for i, tok in enumerate(rows):
        key = base if i == 0 else tf.fold_in(base, i)
        assert tok == tsamp.sample_token(key, logits[0, 0], recent, 2, sp.temperature,
                                         sp.top_p, sp.top_k, sp.repetition_penalty)
    assert rows[0] == _sample_rows(logits, 1, req, Sampler("cpu"))[0]


def test_replicated_cluster_samples_like_the_plain_one():
    """Sampled tokens do not depend on which replica serves a stage."""
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    tp = bridged(jax_params(jcfg))
    sp = tsamp.SamplingParams(**SAMPLING)
    want = tmain.build_local_client(port_args(["--mode", "local", "--splits", "1,2,3"]),
                                    tcfg, tp).generate(PROMPT, 8, sampling=sp).tokens
    client, _ = build_port_cluster(tcfg, tp, "1,2,3", replicas=2)
    assert client.generate(PROMPT, 8, sampling=sp).tokens == want
