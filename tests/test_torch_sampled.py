"""Sampling as device work in the port, against the JAX package.

The keys as tensors (``ops/threefry.py``), the sampler with traced knobs
(``ops/sampling.py``), the final stage's rows through the sampler that the
card captures (``runtime/executor._sample_rows``, ``runtime/graphs.py``
`sample_packed`), the fused sampled engine (``runtime/fused_decode.py``)
and sampled ``--mode oracle``, each beside its JAX counterpart on the same
seeded numpy inputs or bridged weights. On the CPU the draw is the plain
version of the kernel (``ops/draw_kernel.py``); the kernel itself runs on
the card only, in ``chip_smoke.py``.

Tolerances: keys, bits and tokens are compared for equality; probabilities
within 1e-6 absolute (float32 sums in another order; the same bound as
``test_torch_pipeline.py``'s sweep).
"""

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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    full_forward as j_full_forward,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_kv_cache as j_init_kv_cache,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    executor as jexecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    fused_decode as jfused,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    messages as jmessages,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    draw_kernel as tdk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    sampling as tsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    threefry as tf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    executor as texecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    fused_decode as tfused,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    messages as tmessages,
)

SEEDS = [0, 1, 42, 2 ** 31 - 1, -3]
VOCAB = 512
PROMPT = [72, 101, 108, 108, 111, 33]
# The knob grid of chip_smoke.py's sampler phase: greedy, then every
# (top_k, top_p, rp) at temperature 0.7, over four windows.
WINDOWS = {"empty": [], "two": [9, 250], "triple": [40, 250, 250, 250],
           "sixty": [(7 * i) % VOCAB for i in range(60)]}
KNOBS = [(0.0, 0.9, 50, 1.5)] + [(0.7, p, k, rp) for k, p, rp in itertools.product(
    [0, 1, 50], [0.9, 1.0], [1.0, 1.5])]
SAMPLING = dict(temperature=0.8, top_p=0.9, top_k=50, repetition_penalty=1.3)


def _jkey(key):
    return np.asarray(key).astype(np.int64)


def _window(toks):
    """(recent [RECENT_WINDOW] int32 numpy, num_valid) of a token history."""
    w = toks[-jsamp.RECENT_WINDOW:]
    recent = np.zeros(jsamp.RECENT_WINDOW, np.int32)
    recent[:len(w)] = w
    return recent, len(w)


def _logits(r, shape=(VOCAB,)):
    logits = (r.standard_normal(shape) * 3).astype(np.float32)
    logits[..., 250] = np.abs(logits[..., 250]) + 4.0   # the repeated token is a top logit
    return logits


# -- keys as device tensors ---------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_keys_equal_jax(seed):
    """prng_key of a 0-d tensor, fold_in of tensor keys (int data, tensor
    data), random_bits and gumbel of one key and of a batch of keys."""
    jk = jax.random.PRNGKey(seed)
    key = tf.prng_key(torch.tensor(seed, dtype=torch.int64))
    assert key.dtype == torch.int64 and tuple(key.shape) == (2,)
    np.testing.assert_array_equal(key.numpy(), _jkey(jk))
    assert tuple(key.tolist()) == tf.prng_key(seed)
    for data in (0, 1, 77, 2 ** 32 - 1):
        np.testing.assert_array_equal(tf.fold_in(key, data).numpy(),
                                      _jkey(jax.random.fold_in(jk, data)))
    rows = tf.fold_in(key, torch.arange(5))
    want = np.stack([_jkey(jax.random.fold_in(jk, i)) for i in range(5)])
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(tf.fold_in(tf.prng_key(seed), torch.arange(5)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        tf.random_bits(key, (3, 7)).numpy(),
        np.asarray(jax.random.bits(jk, (3, 7), jnp.uint32)).astype(np.int64))
    bits = tf.random_bits(rows, (VOCAB,))
    for i in range(5):
        np.testing.assert_array_equal(bits[i].numpy(), np.asarray(jax.random.bits(
            jax.random.fold_in(jk, i), (VOCAB,), jnp.uint32)).astype(np.int64))
    u = tf.uniform(rows, (VOCAB,)).numpy()
    for i in range(5):
        ju = np.asarray(jax.random.uniform(jax.random.fold_in(jk, i), (VOCAB,)))
        np.testing.assert_array_equal(u[i].view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("vocab", [VOCAB, 32000])
def test_categorical_with_tensor_keys_equals_jax(vocab):
    """One tensor key draws what the pair of ints draws; a batch of keys
    [B, 2] draws each row as jax.random.categorical under vmap; the draw
    wrapper on the CPU is the plain version, noise included."""
    r = np.random.default_rng(vocab)
    jcat = jax.jit(jax.vmap(jax.random.categorical))
    for seed in range(6):
        logits = (r.standard_normal((3, vocab)) * 2).astype(np.float32)
        logits[:, r.integers(0, vocab, vocab // 2)] = np.log(1e-20)
        base = jax.random.PRNGKey(seed)
        jkeys = jnp.stack([base] + [jax.random.fold_in(base, i) for i in (1, 2)])
        want = np.asarray(jcat(jkeys, jnp.asarray(logits)))
        keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
        got = tf.categorical(keys, torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        noise = torch.empty(3, vocab)
        drawn = tdk.sample_draw(keys, torch.from_numpy(logits), noise_out=noise)
        assert drawn.dtype == torch.int32
        np.testing.assert_array_equal(drawn.numpy(), want)
        assert torch.equal(noise, tf.gumbel(keys, (vocab,)))
        assert int(tf.categorical(keys[0], torch.from_numpy(logits[0]))) == int(want[0])
        assert int(tf.categorical(tf.prng_key(seed), torch.from_numpy(logits[0]))) == \
            int(want[0])


def test_draw_grid_covers_every_element_once():
    """The kernel's launch shape (blocks a row, elements a block): every
    element of a row in exactly one block, a chunk a whole number of
    256-thread passes (what csrc/sample_draw.cu checks)."""
    for vocab in (1, 255, 256, 1000, 1024, 1025, 32000, 128256, 10 ** 6, 5 * 10 ** 6):
        blocks, chunk = tdk._grid(vocab)
        assert chunk % tdk.THREADS == 0 and blocks >= 1
        assert (blocks - 1) * chunk < vocab <= blocks * chunk


# -- the sampler with traced knobs ----------------------------------------------

def test_push_recent_over_sixty_pushes_equals_jax():
    """Tensor pushes (device token, device length) and int pushes alike."""
    rt, nv = tsamp.make_recent_buffer()
    it, inv = tsamp.make_recent_buffer()
    jt, jn = jsamp.make_recent_buffer()
    assert nv.dtype == torch.int32 and nv.ndim == 0
    for tok in [(13 * i) % 97 for i in range(57)] + [5, 5, 5]:
        rt, nv = tsamp.push_recent(rt, nv, torch.tensor(tok, dtype=torch.int32))
        it, inv = tsamp.push_recent(it, int(inv), tok)
        jt, jn = jsamp.push_recent(jt, jn, jnp.int32(tok))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(it.numpy(), np.asarray(jt))
        assert int(nv) == int(inv) == int(jn)
    assert int(nv) == jsamp.RECENT_WINDOW


@pytest.mark.parametrize("wname", list(WINDOWS))
def test_sampler_over_the_knob_grid_equals_jax(wname):
    """apply_repetition_penalty, sample_probs and sample_token with every
    knob of the grid, as Python numbers and as device tensors
    (sampling_scalars), beside JAX's jitted functions."""
    r = np.random.default_rng(len(wname))
    jpen = jax.jit(jsamp.apply_repetition_penalty)
    jprobs = jax.jit(jsamp.sample_probs)
    jtok = jax.jit(jsamp.sample_token)
    recent, n = _window(WINDOWS[wname])
    trecent = torch.from_numpy(recent)
    for i, knobs in enumerate(KNOBS):
        logits = _logits(r)
        jk = jsamp.sampling_scalars(*knobs)
        tk = tsamp.sampling_scalars(*knobs)
        assert [t.dtype for t in tk] == [torch.float32, torch.float32, torch.int32,
                                         torch.float32]
        args = (jnp.asarray(recent), jnp.int32(n))
        assert_close(tsamp.apply_repetition_penalty(torch.from_numpy(logits), trecent,
                                                    torch.tensor(n), tk[3]),
                     jpen(jnp.asarray(logits), *args, jk[3]))
        want = jprobs(jnp.asarray(logits), *args, *jk)
        for knob_form in (knobs, tk):
            got = tsamp.sample_probs(torch.from_numpy(logits), trecent, n, *knob_form)
            assert_close(got, want, rtol=0.0, atol=1e-6)
        key = jax.random.PRNGKey(i)
        jtoken = int(jtok(key, jnp.asarray(logits), *args, *jk))
        for tkey, knob_form in ((tf.prng_key(i), knobs),
                                (tf.prng_key(torch.tensor(i)), tk)):
            got = tsamp.sample_token(tkey, torch.from_numpy(logits), trecent,
                                     torch.tensor(n, dtype=torch.int32), *knob_form)
            assert got.dtype == torch.int32 and got.ndim == 0
            assert int(got) == jtoken, (wname, knobs)


def test_sample_token_batch_rows_draw_their_own_keys():
    """Logits [B, V] with keys [B, 2]: row b draws what a batch-1 call with
    key b draws; greedy rows take the argmax."""
    r = np.random.default_rng(11)
    logits = torch.from_numpy(_logits(r, (3, VOCAB)))
    recent, n = _window([3, 250, 250, 250])
    keys = tf.fold_in(tf.prng_key(9), torch.arange(3))
    for knobs in (KNOBS[0], KNOBS[-1], KNOBS[5]):
        rows = tsamp.sample_token(keys, logits, torch.from_numpy(recent), n, *knobs)
        assert tuple(rows.shape) == (3,)
        for b in range(3):
            assert int(rows[b]) == int(tsamp.sample_token(
                keys[b], logits[b], torch.from_numpy(recent), n, *knobs))


# -- the final stage's rows -----------------------------------------------------

def _requests(history, sampling, seed):
    kw = dict(session_id="s", hidden=None, seq_len=1, cur_len=4, is_prefill=False,
              max_length=64, generated_tokens=tuple(history), step_seed=seed)
    return (tmessages.StageRequest(sampling=tsamp.SamplingParams(**sampling), **kw),
            jmessages.StageRequest(sampling=jsamp.SamplingParams(**sampling), **kw))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("wname", ["empty", "triple", "sixty"])
def test_sample_rows_equal_jax(batch, wname):
    """_sample_rows (through the sampler the card captures: packed scalars,
    keys built from the step seed) against the JAX executor's, greedy and
    sampled, at B = 1 and 3."""
    r = np.random.default_rng(batch)
    sampler = tgraphs.Sampler("cpu")
    for i, knobs in enumerate([KNOBS[0], KNOBS[-1], KNOBS[4], KNOBS[7]]):
        logits = _logits(r, (batch, 3, VOCAB))
        sampling = dict(zip(("temperature", "top_p", "top_k", "repetition_penalty"), knobs))
        treq, jreq = _requests(WINDOWS[wname], sampling, seed=100 + i)
        want = [int(t) for t in jexecutor._sample_rows(jnp.asarray(logits), 2, jreq)]
        assert texecutor._sample_rows(torch.from_numpy(logits), 2, treq, sampler) == want
        fresh = tgraphs.Sampler("cpu")
        assert texecutor._sample_rows(torch.from_numpy(logits), 2, treq, fresh) == want


def test_packed_scalars_round_trip():
    """pack_sampler_inputs keeps the last 50 tokens, their count, top_k,
    the step seed and float32 knobs bit for bit."""
    sp = tsamp.SamplingParams(temperature=0.7, top_p=0.9, top_k=40, repetition_penalty=1.3)
    packed = torch.tensor(tgraphs.pack_sampler_inputs(range(60), sp, -5), dtype=torch.int64)
    assert len(packed) == tgraphs.PACKED_LEN == tsamp.RECENT_WINDOW + 6
    assert packed[:50].tolist() == list(range(10, 60))
    assert packed[50:53].tolist() == [50, 40, -5]
    floats = packed[53:].to(torch.int32).view(torch.float32)
    assert torch.equal(floats, torch.tensor([0.7, 0.9, 1.3], dtype=torch.float32))


# -- the fused sampled engine and sampled --mode oracle ---------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg, seed=4)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


def _port_per_token(tcfg, tp, prompt, steps, seed, sampling, max_len):
    """The per-token loop by hand: full_forward and sample_token a step,
    key PRNGKey(seed + step), window the tokens so far."""
    kc, vc = tfused.init_kv_cache(tcfg, tcfg.num_layers, 1, max_len)
    logits, _, _ = tfused.full_forward(tcfg, tp, torch.tensor([prompt]), kc, vc, 0)
    toks = []
    for step in range(steps):
        recent, n = _window(toks)
        toks.append(int(tsamp.sample_token(tf.prng_key(seed + step), logits[0, -1],
                                           torch.from_numpy(recent), n, *sampling)))
        logits, _, _ = tfused.full_forward(tcfg, tp, torch.tensor([[toks[-1]]]), kc, vc,
                                           len(prompt) + step)
    return toks


@pytest.mark.parametrize("graphed", [False, True])
def test_fused_sample_decode_equals_jax_engine_and_per_token(tiny, graphed, monkeypatch):
    """make_fused_sample_decode over two chunks (the window carried between
    them) gives the JAX engine's tokens and the port's own per-token loop's.
    `graphed` runs the capture bookkeeping through a CPU stub of the graph:
    the warm-up and the capture each run a real step, after which the
    engine's state, its window included, is set back."""
    jcfg, jp, tcfg, tp = tiny
    seed, steps, max_len, chunk = 77, 11, 32, 6
    knobs = (0.9, 0.95, 40, 1.4)
    sp = tsamp.SamplingParams(*knobs)
    jsp = jsamp.sampling_scalars(*knobs)

    kc, vc = j_init_kv_cache(jcfg, jcfg.num_layers, 1, max_len)
    ids = jnp.asarray(np.asarray(PROMPT, np.int32)[None, :])
    logits, kc, vc = j_full_forward(jcfg, jp, ids, kc, vc, jnp.int32(0))
    recent, nvalid = jsamp.make_recent_buffer()
    tok0 = jsamp.sample_token(jax.random.PRNGKey(seed), logits[0, -1], recent, nvalid, *jsp)
    recent, nvalid = jsamp.push_recent(recent, nvalid, tok0)
    fn = jfused.make_fused_sample_decode(jcfg, chunk)
    want, last, cur = [int(tok0)], tok0, len(PROMPT)
    while len(want) < steps:
        n = min(chunk, steps - len(want))
        toks, kc, vc, recent, nvalid = fn(jp, last, kc, vc, jnp.int32(cur), jnp.int32(n),
                                          jnp.int32(seed + len(want)), recent, nvalid, *jsp)
        want += [int(t) for t in np.asarray(toks[:n])]
        last, cur = toks[n - 1], cur + n

    if graphed:
        def record(fn, pool, stream):
            out = fn()
            graph = type("StubGraph", (), {"replay": lambda self: out.copy_(fn())})()
            return graph, out

        monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
        monkeypatch.setattr(tgraphs, "_record", record)
        monkeypatch.setattr(tfused.torch.cuda, "graph_pool_handle", lambda: None)
        monkeypatch.setattr(tfused.torch.cuda, "Stream", lambda *a, **k: None)
    engine = tfused.make_fused_sample_decode(tcfg, tp, chunk, max_len)
    engine.graphed = graphed
    engine.begin(sp)
    logits = engine.prefill(torch.tensor([PROMPT]))
    got = [engine.first_token(logits[0, -1:], seed)]
    while len(got) < steps:
        n = min(chunk, steps - len(got))
        out = engine(got[-1], len(PROMPT) + len(got) - 1, n, seed + len(got))
        assert not out[n:].any()
        got += out[:n].tolist()
    assert got == want
    assert got == _port_per_token(tcfg, tp, PROMPT, steps, seed, knobs, max_len)
    assert int(engine.nvalid) == steps
    assert engine.recent[:steps].tolist() == got
    if graphed:
        assert engine.captures == 1 and engine.replays == steps - 1


@pytest.mark.parametrize("seed", [0, 5])
def test_sampled_oracle_equals_jax_over_two_chunks(monkeypatch, tiny, seed):
    """Sampled --mode oracle runs the fused sampled engine in chunks of 32
    (40 tokens: two chunks, the window carried across): JAX's oracle
    tokens, and the port's own per-token loop's."""
    jcfg, jp, tcfg, tp = tiny
    argv = ["--mode", "oracle", "--seed", str(seed)]
    jgen, _ = jax_mode_generate(monkeypatch, argv, jcfg, jp)
    sampling = dict(temperature=1.3, top_p=0.95, top_k=0, repetition_penalty=1.1)
    want = jgen(PROMPT, 40, jsamp.SamplingParams(**sampling))
    gen = tmain.make_oracle_generate(port_args(argv), tcfg, tp)
    got = gen(PROMPT, 40, tsamp.SamplingParams(**sampling))
    assert len(want.tokens) > 32
    assert got.tokens == want.tokens and got.stopped_by == want.stopped_by
    assert gen.per_token(PROMPT, 40, tsamp.SamplingParams(**sampling)).tokens == got.tokens
    # A second generation reuses the engine with a fresh window.
    assert gen(PROMPT, 40, tsamp.SamplingParams(**sampling)).tokens == got.tokens
