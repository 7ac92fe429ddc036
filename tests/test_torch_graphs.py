"""The captured step of the port, on the CPU, against the JAX package.

A step that can be captured as a CUDA graph reads nothing back to the host:
``cache_len`` is a 0-d tensor, the cache write goes to device indices and
attention reads the whole cache bucket. Here, on the same inputs and
bridged weights:
  * ``cached_attention`` / ``update_kv_cache`` / ``full_forward`` with a
    tensor ``cache_len`` equal the int path bit for bit and JAX's within
    the float32 parity tolerance (``_torch_port_helpers.assert_close``),
    an alternating-window family (gemma2) included;
  * the executor, padding each chunk to its sequence bucket, gives JAX's
    executor's hidden states (same tolerance), ``cache_len`` and sampled
    tokens, a chunk that lands on the end-of-lease guard included;
  * the KV arena reuses a freed lease's buffers zeroed and releases them
    when another shape needs the room, with JAX's accounting;
  * the fused greedy engine gives JAX's ``make_fused_decode`` tokens and
    those of a per-step ``full_forward`` loop, and greedy ``--mode
    oracle`` gives JAX's ``run_oracle`` tokens, a chunk that overshoots a
    repeat stop included (tokens exactly equal);
  * the replay bookkeeping of launch counts, captures and replays runs
    through a CPU stub of the graph object, with another thread launching
    and replaying while one captures;
  * the repetition penalty, its triple-repeat guard now decided on the
    device, is bit-equal with the guard that read its tokens back.
"""

import functools
import threading
import types

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
    partition as jpart,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    transformer as jtf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    attention as jatt,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    executor as jexec,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    fused_decode as jfused,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    kv_cache as jkv,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    messages as jmsg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    partition as tpart,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    attention as tatt,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    draw_kernel as tdk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    int8_kernel as tik,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    launch_counts,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    nf4_kernel as tnk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    sampling as tsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    executor as texec,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    fused_decode as tfused,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    kv_cache as tkv,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    messages as tmsg,
)
from test_runtime_pipeline import tiny_cfg

PROMPT = [72, 101, 108, 108, 111, 33]
GREEDY_T = tsamp.SamplingParams(temperature=0.0)
GREEDY_J = jsamp.SamplingParams(temperature=0.0)


@pytest.fixture
def r():
    return np.random.default_rng(0)


# -- attention and the model with a tensor cache_len -------------------------

@pytest.mark.parametrize("cache_len,t,window", [
    (0, 6, None),     # prefill into an empty bucket
    (5, 1, None),     # decode over a partly filled bucket
    (4, 3, 4),        # a multi-token step with an int window
    (9, 1, "leaf4"),  # the per-layer window leaf, a window layer
    (9, 2, "leaf0"),  # the per-layer window leaf, a global layer
])
def test_cached_attention_tensor_cache_len_reads_the_whole_bucket(r, cache_len, t, window):
    b, s, h, hkv, dh = 2, 16, 4, 2, 8
    q = r.standard_normal((b, t, h, dh)).astype(np.float32)
    # Garbage past cache_len + t: the mask must hide it.
    kc = r.standard_normal((b, s, hkv, dh)).astype(np.float32)
    vc = r.standard_normal((b, s, hkv, dh)).astype(np.float32)
    w_int = None if window is None else (window if isinstance(window, int)
                                         else int(window[4:]))
    w_port = (torch.tensor(w_int, dtype=torch.int32) if isinstance(window, str)
              else window)
    want = jatt.cached_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.int32(cache_len), sliding_window=w_int)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc))
    got = tatt.cached_attention(*args, torch.tensor(cache_len),
                                sliding_window=w_port)
    assert torch.equal(got, tatt.cached_attention(*args, cache_len, sliding_window=w_int))
    assert_close(got, want)


def test_update_kv_cache_tensor_cache_len_writes_device_rows(r):
    kc = r.standard_normal((2, 16, 2, 8)).astype(np.float32)
    vc = r.standard_normal((2, 16, 2, 8)).astype(np.float32)
    kn = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    vn = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    jk, jv = jatt.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                  jnp.asarray(vn), jnp.int32(13))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tatt.update_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.tensor(13))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):     # an int length is checked here
        tatt.check_cache_write(14, 3, 16)


@functools.lru_cache(maxsize=None)
def _jax_forward():
    return jax.jit(jtf.full_forward, static_argnums=0)


@pytest.mark.parametrize("family", ["llama", "gpt2", "gemma2"])
def test_full_forward_tensor_cache_len_matches_int_path_and_jax(family):
    jcfg = tiny_cfg(family)
    tcfg = port_cfg(jcfg)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridged(jp)
    s = 32
    jk, jv = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, s)
    ik, iv = ttf.init_kv_cache(tcfg, tcfg.num_layers, 1, s)
    tk, tv = ttf.init_kv_cache(tcfg, tcfg.num_layers, 1, s)
    ids = [PROMPT] + [[t] for t in (5, 200, 17, 17, 3)]
    cur = 0
    for step in ids:
        x = np.asarray([step], np.int32)
        want, jk, jv = _jax_forward()(jcfg, jp, jnp.asarray(x), jk, jv, jnp.int32(cur))
        tx = torch.from_numpy(x).long()
        by_int, _, _ = ttf.full_forward(tcfg, tp, tx, ik, iv, cur)
        by_tensor, _, _ = ttf.full_forward(tcfg, tp, tx, tk, tv, torch.tensor(cur))
        assert torch.equal(by_tensor, by_int)
        assert torch.equal(tk, ik)
        assert_close(by_tensor, np.asarray(want))
        cur += len(step)


# -- the executor with bucket padding against JAX's ---------------------------

def _executors(quant="none"):
    """Stage 0 [0, 2) and the last stage [2, 4) of the tiny llama, in both
    packages, on the same weights."""
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    jp = jax_params(jcfg, quant)
    tp = bridged(jp)
    jplan = jpart.StagePlan.from_splits(jcfg.num_layers, [2])
    tplan = tpart.StagePlan.from_splits(tcfg.num_layers, [2])
    jex = [jexec.StageExecutor(jcfg, spec, jpart.slice_stage_params(jcfg, jp, spec))
           for spec in jplan.stages]
    tex = [texec.StageExecutor(tcfg, spec, tpart.slice_stage_params(tcfg, tp, spec),
                               device="cpu") for spec in tplan.stages]
    return jex, tex


def _step_both(jex, tex, ids, cur, *, prefill, generated=(), seed=0, sampled=False):
    """One pipeline step through both packages' two executors: stage 0's
    hidden states and the last stage's token and cache lengths."""
    t = len(ids)
    kw = dict(session_id="s", seq_len=t, cur_len=cur, is_prefill=prefill,
              max_length=128, generated_tokens=tuple(generated), step_seed=seed)
    jsp = (jsamp.SamplingParams(temperature=0.7, top_p=0.9, top_k=50,
                                repetition_penalty=1.5) if sampled else GREEDY_J)
    tsp = (tsamp.SamplingParams(temperature=0.7, top_p=0.9, top_k=50,
                                repetition_penalty=1.5) if sampled else GREEDY_T)
    jh = jex[0].forward(jmsg.StageRequest(hidden=jnp.asarray([ids], jnp.int32),
                                          sampling=jsp, **kw))
    th = tex[0].forward(tmsg.StageRequest(hidden=torch.tensor([ids]), sampling=tsp, **kw))
    assert th.cache_len == jh.cache_len == cur + t
    assert tuple(th.hidden.shape) == (1, t, 256)
    assert_close(th.hidden, np.asarray(jh.hidden))
    jt = jex[1].forward(jmsg.StageRequest(hidden=jh.hidden, sampling=jsp, **kw))
    tt = tex[1].forward(tmsg.StageRequest(hidden=th.hidden, sampling=tsp, **kw))
    assert tt.cache_len == jt.cache_len == cur + t
    assert tt.token_id == jt.token_id
    return tt.token_id


@pytest.mark.parametrize("sampled", [False, True])
def test_executor_bucket_padding_matches_jax(sampled):
    jex, tex = _executors()
    keys = []
    run = tex[0].graphs.run
    tex[0].graphs.run = lambda key, *a: keys.append(key[1]) or run(key, *a)
    toks = [_step_both(jex, tex, PROMPT[:5], 0, prefill=True, sampled=sampled)]
    cur = 5
    for i in range(6):
        # A window ending in a triple repeat exercises the penalty's guard.
        history = toks + [7, 7, 7] if sampled else toks
        toks.append(_step_both(jex, tex, [toks[-1]], cur, prefill=False,
                               generated=history, seed=i + 1, sampled=sampled))
        cur += 1
    assert keys == [8] + [1] * 6           # 5 tokens run in the 8 bucket


def test_executor_end_of_lease_guard_matches_jax():
    """A 100-token prefill pads to the 128 bucket; a 20-token step at
    cache_len 100 would pad to 32 and reach past the 128-row lease, so it
    runs at its exact length, as in the reference."""
    jex, tex = _executors("int8")
    keys = []
    run = tex[1].graphs.run
    tex[1].graphs.run = lambda key, *a: keys.append(key[1]) or run(key, *a)
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, 512, 100)]
    _step_both(jex, tex, prompt, 0, prefill=True)
    _step_both(jex, tex, [int(t) for t in rng.integers(0, 512, 20)], 100, prefill=False)
    assert keys == [128, 20]


# -- the KV arena's free list ------------------------------------------------

def _arenas(max_bytes):
    ja = jkv.KVArena(2, 2, 8, max_bytes=max_bytes, dtype=jnp.float32)
    ta = tkv.KVArena(2, 2, 8, max_bytes=max_bytes, device="cpu", dtype=torch.float32)
    return ja, ta


def _same_accounting(ja, ta):
    assert ta.used_bytes == ja.used_bytes
    assert ta.bytes_left == ja.bytes_left
    assert ta.tokens_left() == ja.tokens_left()


def test_arena_reuses_a_freed_lease_zeroed():
    ja, ta = _arenas(1 << 20)
    released = []
    ta.add_release_hook(released.append)
    for a in (ja, ta):
        a.allocate("a", 100, timeout=0.0)
    h = ta.get("a")
    h.k.fill_(3.0)
    h.v.fill_(4.0)
    k_ptr, slot = h.k.data_ptr(), h.slot
    _same_accounting(ja, ta)
    for a in (ja, ta):
        a.free("a")
    _same_accounting(ja, ta)
    assert h.k is None and ta.used_bytes == 0
    for a in (ja, ta):
        a.allocate("b", 90, timeout=0.0)           # the same 128 bucket
    hb = ta.get("b")
    assert hb.k.data_ptr() == k_ptr and hb.slot == slot
    assert not hb.k.any() and not hb.v.any()
    _same_accounting(ja, ta)
    for a in (ja, ta):
        a.allocate("c", 100, timeout=0.0)          # a new pair beside it
    assert ta.get("c").slot != slot and ta.get("c").k.data_ptr() != k_ptr
    _same_accounting(ja, ta)
    assert released == []


def test_arena_releases_free_listed_buffers_another_shape_needs():
    ta_bytes = tkv.KVArena(2, 2, 8, max_bytes=1, device="cpu",
                           dtype=torch.float32).bytes_for(128)
    ja, ta = _arenas(2 * ta_bytes)
    released = []
    ta.add_release_hook(released.append)
    for a in (ja, ta):
        a.allocate("a", 100, timeout=0.0)
        a.allocate("b", 100, timeout=0.0)
    slots = {ta.get("a").slot, ta.get("b").slot}
    for a in (ja, ta):
        a.free("a")
        a.free("b")
    _same_accounting(ja, ta)                       # free-listed bytes count as free
    for a in (ja, ta):
        a.allocate("big", 200, timeout=0.0)        # the 256 bucket: all the room
    assert set(released) == slots
    assert ta.get("big").slot not in slots
    _same_accounting(ja, ta)
    for a in (ja, ta):
        a.free("big")
        a.allocate("again", 100, timeout=0.0)      # releases "big" for a 128 pair
    assert len(released) == 3
    _same_accounting(ja, ta)


def test_executor_drops_the_graphs_of_released_buffers():
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    spec = tpart.StagePlan.from_splits(tcfg.num_layers, []).stages[0]
    arena = tkv.KVArena(4, 2, 64, max_bytes=1, device="cpu", dtype=torch.float32)
    arena.max_bytes = arena.bytes_for(256)
    ex = texec.StageExecutor(tcfg, spec, bridged(jax_params(jcfg)), arena, device="cpu")
    h = arena.allocate("a", 100, timeout=0.0)
    ex.graphs._steps = {"kept": types.SimpleNamespace(slot=-7),
                        "dropped": types.SimpleNamespace(slot=h.slot)}
    arena.free("a")
    assert set(ex.graphs._steps) == {"kept", "dropped"}      # free-listed only
    arena.allocate("b", 200, timeout=0.0)          # another shape needs the room
    assert set(ex.graphs._steps) == {"kept"}


# -- the fused greedy engine --------------------------------------------------

def _jax_per_step_greedy(jcfg, jp, prompts, steps, max_len):
    """test_fused_decode.py's oracle: per-step full_forward greedy, one row
    at a time."""
    want = []
    for b in range(prompts.shape[0]):
        kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, max_len)
        logits, kc, vc = _jax_forward()(jcfg, jp, jnp.asarray(prompts[b:b + 1]),
                                        kc, vc, jnp.int32(0))
        toks = [int(jnp.argmax(logits[0, -1]))]
        cur = prompts.shape[1]
        for _ in range(steps):
            logits, kc, vc = _jax_forward()(jcfg, jp, jnp.asarray([[toks[-1]]], jnp.int32),
                                            kc, vc, jnp.int32(cur))
            toks.append(int(jnp.argmax(logits[0, -1])))
            cur += 1
        want.append(toks)
    return want


@pytest.mark.parametrize("family", ["llama", "gpt2", "gemma2", "qwen2"])
def test_fused_decode_matches_jax_engine_and_oracle(family):
    jcfg = tiny_cfg(family)
    tcfg = port_cfg(jcfg)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridged(jp)
    prefill, steps, max_len = 5, 7, 32
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (1, prefill)).astype(np.int32)
    want = _jax_per_step_greedy(jcfg, jp, prompts, steps, max_len)

    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, max_len)
    logits, kc, vc = _jax_forward()(jcfg, jp, jnp.asarray(prompts), kc, vc, jnp.int32(0))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    fn = jfused.make_fused_decode(jcfg, steps + 1, 1, exact_head=True)
    jtoks, _, _ = fn(jp, tok, kc, vc, jnp.int32(prefill), jnp.int32(steps))

    engine = tfused.make_fused_decode(tcfg, tp, steps + 1, max_len)
    tlogits = engine.prefill(torch.from_numpy(prompts).long())
    ttok = int(torch.argmax(tlogits[0, -1]))
    got = engine(ttok, prefill, steps)
    assert tuple(got.shape) == (steps + 1,)
    assert not got[steps:].any()                   # entries at or past n are zero
    np.testing.assert_array_equal(got[:steps].numpy(), np.asarray(jtoks)[:steps, 0])
    assert [ttok] + got[:steps].tolist() == want[0]


def test_drive_chunks_trims_an_overshoot_and_spreads_the_chunk_time():
    seq = [4, 9, 9, 9, 9, 9, 2, 2]                  # a repeat stop mid-chunk
    chunks = []

    def run_chunk(last, cur, n, step):
        chunks.append((last, cur, n, step))
        return seq[1:1 + n]

    res = tmain._drive_chunks([1, 2, 3], 8, None, prefill_first_token=lambda ids: seq[0],
                              run_chunk=run_chunk, chunk=7)
    assert res.tokens == seq[:6] and res.stopped_by == "repeat"
    assert chunks == [(4, 3, 7, 1)]                 # step: the key schedule's index
    assert len(res.decode_times_s) == 5 and len(set(res.decode_times_s)) == 1
    res = tmain._drive_chunks([1], 8, 9, prefill_first_token=lambda ids: 4,
                              run_chunk=run_chunk, chunk=7)
    assert res.tokens == [4, 9] and res.stopped_by == "eos"


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_oracle_greedy_matches_jax_run_oracle(monkeypatch, quant):
    """Greedy --mode oracle on the fused engine (a chunk of 32 steps that
    overshoots the repeat stop at token 18 on this model and prompt)."""
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    jp = jax_params(jcfg)
    argv = ["--mode", "oracle", "--quant", quant]
    want = jax_mode_generate(monkeypatch, argv, jcfg, jp)[0](
        PROMPT, 40, sampling=GREEDY_J)
    gen = tmain.make_oracle_generate(port_args(argv), tcfg, bridged(jp))
    got = gen(PROMPT, 40, GREEDY_T)
    assert got.tokens == want.tokens
    assert got.stopped_by == want.stopped_by == "repeat"
    assert len(got.tokens) < 32
    assert gen.per_token(PROMPT, 40, GREEDY_T).tokens == got.tokens


# -- replay bookkeeping through a CPU stub of the graph object ----------------

class StubGraph:
    """A CPU stand-in for a CUDA graph: replay() runs the captured function
    again into the same static output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.out.copy_(self.fn())


@pytest.fixture
def stub_graphs(monkeypatch):
    """Graphs on the CPU: warm-up and capture through StubGraph, no pool or
    stream."""
    def record(fn, pool, stream):
        out = fn()
        return StubGraph(fn, out), out

    monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
    monkeypatch.setattr(tgraphs, "_record", record)
    monkeypatch.setattr(tgraphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraphs.torch.cuda, "Stream", lambda *a, **k: None)


def test_capture_counts_launches_per_replay(monkeypatch, stub_graphs):
    for mod in (tik, tnk):
        monkeypatch.setattr(mod, "_launches", 100)
        monkeypatch.setattr(mod, "_launches_mma", 10)
        monkeypatch.setattr(mod, "_launches_gemv", 20)
    monkeypatch.setattr(tik, "_launches_f32mma", 30)
    monkeypatch.setattr(tnk, "_launches_f32mma", 40)
    monkeypatch.setattr(tdk, "_launches", 50)
    out = torch.zeros(1)

    def fn():                                       # what a step's wrappers count
        for _ in range(2):
            launch_counts.count(tik, "_launches")
        launch_counts.count(tik, "_launches", "_launches_mma")
        launch_counts.count(tik, "_launches", "_launches_gemv")
        launch_counts.count(tik, "_launches", "_launches_f32mma")
        for _ in range(2):
            launch_counts.count(tnk, "_launches")
        launch_counts.count(tnk, "_launches", "_launches_gemv")
        launch_counts.count(tnk, "_launches", "_launches_f32mma")
        launch_counts.count(tdk, "_launches")       # the sampler's draw
        return out

    captured = tgraphs.capture(fn, None, None)
    # The warm-up ran (it counts); the capture ran nothing (taken off).
    assert (tik._launches, tik._launches_mma, tik._launches_gemv, tik._launches_f32mma,
            tnk._launches, tnk._launches_mma, tnk._launches_gemv, tnk._launches_f32mma,
            tdk._launches) == (105, 11, 21, 31, 104, 10, 21, 41, 51)
    assert captured.launches == (5, 1, 1, 1, 4, 0, 1, 1, 1, 0)
    captured.graph.fn = lambda: out                 # a replay runs no wrapper
    for _ in range(3):
        captured.replay()
    assert (tik._launches, tik._launches_mma, tik._launches_gemv, tik._launches_f32mma,
            tnk._launches, tnk._launches_mma, tnk._launches_gemv, tnk._launches_f32mma,
            tdk._launches) == (120, 14, 24, 34, 116, 10, 24, 44, 54)


@pytest.mark.parametrize("counter", ["_launches", "_launches_mma", "_launches_gemv",
                                     "_launches_f32mma"])
def test_graph_counters_hold_every_nf4_route(counter):
    """A replay adds the launches of each of nf4_dot's routes: its counters
    are all among the ones a capture tallies."""
    assert hasattr(tnk, counter) and (tnk, counter) in tgraphs._COUNTERS


def test_capture_runs_with_the_collector_off(monkeypatch):
    """_record turns Python's cyclic garbage collector off for the capture
    (a graph destroyed inside a capture invalidates it) and back on after,
    also when the captured function raises."""
    import contextlib
    import gc

    seen = []
    monkeypatch.setattr(tgraphs.torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(tgraphs.torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    graph, out = tgraphs._record(lambda: seen.append(gc.isenabled()) or 7, None, None)
    assert out == 7 and seen == [False] and gc.isenabled()

    def boom():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError):
        tgraphs._record(boom, None, None)
    assert gc.isenabled()


def test_collector_stays_off_until_the_last_capture_ends(monkeypatch):
    """Two captures that overlap (here a second begins and ends inside the
    first, as on another thread): the first to end leaves the collector off,
    and the last turns it back on."""
    import contextlib
    import gc

    monkeypatch.setattr(tgraphs.torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(tgraphs.torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    seen = []

    def outer():
        tgraphs._record(lambda: seen.append(gc.isenabled()), None, None)
        seen.append(gc.isenabled())

    tgraphs._record(outer, None, None)
    assert seen == [False, False] and gc.isenabled()
    gc.disable()
    try:
        tgraphs._record(lambda: None, None, None)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_capture_charges_no_launch_of_another_thread(monkeypatch, stub_graphs):
    """While one thread captures, another launches kernels eagerly and
    replays a graph: the capture records its own launches only, and the
    other thread's count once, as they ran."""
    for mod in (tik, tnk):
        monkeypatch.setattr(mod, "_launches", 0)
        monkeypatch.setattr(mod, "_launches_mma", 0)
    out = torch.zeros(1)
    first = tgraphs.capture(lambda: launch_counts.count(tik, "_launches") or out,
                            None, None)
    first.graph.fn = lambda: out
    assert first.launches == (1, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    recording, other_done = threading.Event(), threading.Event()
    calls = []

    def step():                                     # warm-up, then the capture
        calls.append(threading.get_ident())
        if len(calls) == 2:
            recording.set()
            assert other_done.wait(10.0)
        for _ in range(2):
            launch_counts.count(tnk, "_launches")
        return out

    def other():
        assert recording.wait(10.0)
        for _ in range(5):
            first.replay()
        for _ in range(3):
            launch_counts.count(tik, "_launches", "_launches_mma")
        other_done.set()

    thread = threading.Thread(target=other)
    thread.start()
    second = tgraphs.capture(step, None, None)
    thread.join(10.0)
    assert not thread.is_alive() and len(calls) == 2
    assert second.launches == (0, 0, 0, 0, 2, 0, 0, 0, 0, 0)
    # first's warm-up 1 + 5 replays + 3 eager; step's warm-up 2.
    assert (tik._launches, tik._launches_mma, tnk._launches, tnk._launches_mma) == \
        (9, 3, 2, 0)
    second.graph.fn = lambda: out
    second.replay()
    assert tnk._launches == 4


def test_executor_replays_captured_steps(stub_graphs):
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    tp = bridged(jax_params(jcfg, "int8"))
    argv = ["--mode", "local", "--quant", "int8", "--splits", "2"]
    want = tmain.build_local_client(port_args(argv), tcfg, tp).generate(
        PROMPT, 8, sampling=GREEDY_T).tokens
    client = tmain.build_local_client(port_args(argv), tcfg, tp)
    executors = [client.stage0] + [client.transport.executor(p)
                                   for p in client.transport.peers()]
    for ex in executors:
        ex.graphs.enabled = True
    for _ in range(2):                              # the second reuses the lease
        assert client.generate(PROMPT, 8, sampling=GREEDY_T).tokens == want
    for ex in executors:
        assert ex.graphs.captures == 2              # the 8 bucket, then 1
        assert ex.graphs.replays == 2 * 8
        slots = {key[3] for key, _ in ex.graphs.entries()}
        assert len(slots) == 1


def test_fused_engine_replays_one_captured_step(stub_graphs):
    jcfg = tiny_cfg("llama")
    tcfg = port_cfg(jcfg)
    tp = bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    engines = [tfused.make_fused_decode(tcfg, tp, 8, 32) for _ in range(2)]
    engines[1].graphed = True
    got = []
    for engine in engines:
        logits = engine.prefill(torch.tensor([PROMPT]))
        tok = int(torch.argmax(logits[0, -1]))
        got.append([engine(tok, len(PROMPT), 5), engine(tok, len(PROMPT), 8)])
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert engines[1].captures == 1 and engines[1].replays == 13


# -- the repetition penalty's triple-repeat guard on the device --------------

def _penalty_before(logits, recent_tokens, num_valid, repetition_penalty):
    """apply_repetition_penalty as it was before the guard moved to the
    device: the three newest tokens read back to the host."""
    vocab = logits.shape[-1]
    window = recent_tokens.shape[0]
    valid = torch.arange(window, device=logits.device) < num_valid
    safe = torch.where(valid, recent_tokens.long(), torch.zeros_like(recent_tokens.long()))
    counts = torch.zeros(vocab, dtype=torch.float32, device=logits.device)
    counts.index_add_(0, safe, valid.float())
    rp = torch.tensor(repetition_penalty, dtype=torch.float32, device=logits.device)
    penalty = rp ** counts
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    logits = torch.where(counts > 0, penalized, logits)
    n = num_valid
    t1, t2, t3 = (int(recent_tokens[min(max(n - i, 0), window - 1)]) for i in (1, 2, 3))
    if n >= 3 and t1 == t2 == t3:
        strong = rp ** 3
        cur = logits[t1]
        logits = logits.clone()
        logits[t1] = torch.where(cur > 0, cur / strong, cur * strong)
    return logits


@pytest.mark.parametrize("history", [
    [], [9], [9, 9], [9, 9, 9], [3, 9, 3, 100, 7, 3, 0],
    [11, 40, 40, 250, 250, 250], list(range(60)), [7] * 70])
def test_penalty_bit_equal_with_host_list(r, history):
    logits = torch.from_numpy(r.standard_normal(256).astype(np.float32))
    window = history[-tsamp.RECENT_WINDOW:]
    recent = torch.zeros(tsamp.RECENT_WINDOW, dtype=torch.int32)
    recent[:len(window)] = torch.tensor(window, dtype=torch.int32)
    before = _penalty_before(logits, recent, len(window), 1.5)
    assert torch.equal(tsamp.apply_repetition_penalty(
        logits, recent, len(window), 1.5), before)
