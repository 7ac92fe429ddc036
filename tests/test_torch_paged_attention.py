"""The port's paged decode attention (``ops/attention.paged_decode_attention``,
the wrapper ``ops/paged_attention_kernel.py`` and the layer's dispatch)
against the JAX package's on the same inputs and bridged weights.

  * the plain version against the reference's ``paged_decode_attention``
    at the boundary cases of ``tests/test_paged_attention.py`` (cache_len
    0 / 17 / 63 / 64 / 127, pages 32 / 64 / 128), G = 2 and 4 query heads
    a KV head, float32 and bf16 caches with float32 and bf16 q; against
    the port's own ``cached_attention``; a ragged bucket raises;
  * the wrapper on a CPU tensor takes the plain version, launches nothing
    and builds nothing;
  * the layer takes the paged path under the reference's exact condition
    and ``cached_attention`` otherwise;
  * the session executor with ``decode_kv_page = 32`` against the JAX
    package's ``StageExecutor`` with the same config (full span: greedy
    tokens equal; a segment: every step's hidden rows), once a layer per
    decode step, and bit-equal through a CPU stub of a graph;
  * the fused greedy oracle paged against unpaged and against the JAX
    package's paged fused engine; the batched engine with the field set
    giving the unpaged tokens (it has no paged call, as the reference's).

Tolerance: a float32 output within ``assert_close``'s scale-relative 1e-5
of the reference's (the two frameworks sum in other orders); a bf16 output
within one bf16 ulp of its scale, 2^-7 x max|reference| (the same float32
sums, rounded to bf16 once at the end, may round the other way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    one_torch_thread,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    full_forward as j_full_forward,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_kv_cache as j_init_kv_cache,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    llama_config,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StageSpec as JStageSpec,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    attention as jattn,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.fused_decode import (
    make_fused_decode as j_make_fused_decode,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.messages import (
    StageRequest as JStageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    array_to_torch,
    torch_to_array,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    ROLE_FULL,
    ROLE_SEGMENT,
    StageSpec,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    attention as tattn,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    launch_counts,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    paged_attention_kernel as tpk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    batching as tbatching,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    fused_decode as tfused,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)

BF16_TOL = 2.0 ** -7
CASES = [(0, 32), (17, 32), (63, 32), (64, 32), (127, 64), (127, 128)]
# (q dtype, cache dtype): the stages behind TCP (float32 x, float32 cache),
# stage 0 in process (bf16 x, float32 cache), a bf16 cache under float32 x,
# and the fused oracle under --dtype bfloat16 (bf16 throughout).
DTYPES = [("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16"),
          ("bfloat16", "bfloat16")]
PAGE = 32


def tiny_cfg(**kw):
    """The reference test's config (tests/test_paged_attention.py)."""
    cfg = llama_config(vocab_size=257, hidden_size=64, num_layers=4, num_heads=4,
                       num_kv_heads=2, intermediate_size=128,
                       max_position_embeddings=256)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _inputs(seed, b=2, s=128, h=8, hkv=4, dh=16, q_dtype="float32", kv_dtype="float32"):
    """q, k and v from a seed, as numpy in their dtype (bf16 from jnp)."""
    rng = np.random.default_rng(seed)

    def arr(shape, dtype):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(a, dtype))

    return (arr((b, 1, h, dh), q_dtype), arr((b, s, hkv, dh), kv_dtype),
            arr((b, s, hkv, dh), kv_dtype))


def _hold(got, want):
    """float32: scale-relative 1e-5; bf16: one bf16 ulp at the scale."""
    got = torch_to_array(got) if isinstance(got, torch.Tensor) else got
    if got.dtype == np.uint16:                       # bf16 bits from the bridge
        got = np.asarray(jnp.asarray(got.view(jnp.bfloat16), jnp.float32))
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert_close(got, want, rtol=BF16_TOL, atol=0.0)
    else:
        assert_close(got, np.asarray(want))


_j_paged = jax.jit(jattn.paged_decode_attention, static_argnums=4)


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("cache_len,page", CASES)
def test_plain_matches_jax_paged(cache_len, page, q_dtype, kv_dtype):
    """Every boundary case: an empty cache, mid-page, a page's edge, the
    last row; G = 2 query heads a KV head."""
    q, k, v = _inputs(cache_len + page, q_dtype=q_dtype, kv_dtype=kv_dtype)
    want = _j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.int32(cache_len), page)
    got = tattn.paged_decode_attention(array_to_torch(q), array_to_torch(k),
                                       array_to_torch(v), cache_len, page)
    assert got.dtype == array_to_torch(q).dtype and tuple(got.shape) == q.shape
    _hold(got, np.asarray(want))


@pytest.mark.parametrize("cache_len", [0, 63, 100])
def test_plain_matches_jax_paged_at_four_groups(cache_len):
    """G = 4 query heads a KV head (llama-3.1-8b's), a bf16 cache under
    float32 q, and a 0-d int64 tensor cache_len as a captured step holds it."""
    q, k, v = _inputs(7 + cache_len, b=1, h=8, hkv=2, dh=32, kv_dtype="bfloat16")
    want = _j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.int32(cache_len), 64)
    got = tattn.paged_decode_attention(array_to_torch(q), array_to_torch(k),
                                       array_to_torch(v),
                                       torch.tensor(cache_len, dtype=torch.int64), 64)
    _hold(got, np.asarray(want))


@pytest.mark.parametrize("cache_len,page", CASES)
def test_plain_matches_cached_attention(cache_len, page):
    """The paged accumulation against the port's one-pass attention over
    the whole bucket: the same math in another order of sums."""
    q, k, v = (array_to_torch(a) for a in _inputs(100 + cache_len + page))
    want = tattn.cached_attention(q, k, v, cache_len)
    got = tattn.paged_decode_attention(q, k, v, cache_len, page)
    assert_close(got, want)


def test_plain_refuses_a_ragged_bucket():
    q, k, v = (array_to_torch(a) for a in _inputs(1, s=96))
    with pytest.raises(ValueError, match="not divisible by page 64"):
        tattn.paged_decode_attention(q, k, v, 10, 64)
    with pytest.raises(ValueError, match="not divisible by page 64"):
        tpk.paged_decode_attention(q, k, v, 10, 64)


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor: the plain version's bits, no launch counted, no
    library built."""
    monkeypatch.setattr(tpk, "_launches", 0)
    q, k, v = (array_to_torch(a) for a in _inputs(3, kv_dtype="bfloat16"))
    got = tpk.paged_decode_attention(q, k, v, torch.tensor(40), 32)
    assert torch.equal(got, tattn.paged_decode_attention(q, k, v, 40, 32))
    assert tpk._launches == 0 and tpk._lib is None
    assert (tpk, "_launches") in tgraphs._COUNTERS


def test_chunk_plan_covers_the_bucket_in_whole_pages():
    """The kernel's grid: whole pages a chunk, about CHUNK_ROWS rows, every
    page of the bucket in exactly one chunk, at the pages the layer uses."""
    for s in (128, 2048, 8192):
        for page in (32, 64, 128):
            chunk_pages, chunks = tpk.chunk_plan(s, page)
            assert chunk_pages * page == max(page, tpk.CHUNK_ROWS)
            assert (chunks - 1) * chunk_pages < s // page <= chunks * chunk_pages
    assert tpk.chunk_plan(8192, 64) == (1, 128)


def _layer_calls(monkeypatch):
    calls = []
    plain = tpk.paged_decode_attention

    def record(q, k, v, cache_len, page):
        calls.append((q.shape[1], k.shape[1], page))
        return plain(q, k, v, cache_len, page)

    monkeypatch.setattr(ttf, "paged_decode_attention", record)
    return calls


@pytest.mark.parametrize("change,paged", [
    ({}, True), ({"t": 2}, False), ({"window": 4}, False),
    ({"attn_softcap": 2.0}, False), ({"query_scale": 0.25}, False),
    ({"bucket": 80}, False), ({"page": 0}, False)])
def test_layer_takes_the_paged_path_under_the_reference_condition(
        monkeypatch, change, paged):
    """decode_kv_page set, T == 1, no window, no softcap, no query scale and
    a bucket divisible by the page (models/transformer.py:436-440 of the
    JAX package); anything else is cached_attention, as there."""
    calls = _layer_calls(monkeypatch)
    cfg = port_cfg(tiny_cfg(decode_kv_page=change.get("page", PAGE),
                            attn_softcap=change.get("attn_softcap", 0.0),
                            query_scale=change.get("query_scale", 0.0)))
    tp = bridged(j_init_params(jax.random.PRNGKey(0), tiny_cfg()))
    lp = {key: val[0] for key, val in tp["layers"]["attn"].items()}
    t, s = change.get("t", 1), change.get("bucket", 128)
    x = array_to_torch(np.random.default_rng(2).standard_normal(
        (1, t, cfg.hidden_size)).astype(np.float32))
    kc = torch.zeros(1, s, cfg.num_kv_heads, cfg.head_dim)
    vc = torch.zeros_like(kc)
    rope = ttf.make_rope(cfg, torch.tensor([[5 + i for i in range(t)]]))
    ttf._attention(cfg, lp, x, rope, kc, vc, 5, window=change.get("window"))
    assert calls == ([(1, s, PAGE)] if paged else [])


def _serve(ex_cls, spec, params, cfg, prompt, steps, jax_side):
    """A session through an executor: the prefill, then `steps` decode
    steps; the tokens (a full span) or the hidden rows (a segment)."""
    req_cls = JStageRequest if jax_side else StageRequest
    sp = (JSamplingParams if jax_side else SamplingParams)(temperature=0.0)
    ex = ex_cls(cfg, spec, params, peer_id="pg", **({} if jax_side else {"device": "cpu"}))
    def conv(a):
        if jax_side:
            return jnp.asarray(a)
        return array_to_torch(a.astype(np.int64) if a.dtype.kind == "i" else a)

    out = []
    first = prompt if spec.role == ROLE_FULL else prompt["hidden"][:, :prompt["t"]]
    resp = ex.forward(req_cls(session_id="s", hidden=conv(first), seq_len=first.shape[1],
                              cur_len=0, is_prefill=True, max_length=64, sampling=sp))
    cur = first.shape[1]
    for i in range(steps):
        if spec.role == ROLE_FULL:
            out.append(int(resp.token_id))
            nxt = np.asarray([[out[-1]]], np.int32)
        else:
            h = resp.hidden
            out.append(np.asarray(h) if jax_side else h.numpy())
            nxt = prompt["hidden"][:, cur:cur + 1]
        resp = ex.forward(req_cls(session_id="s", hidden=conv(nxt), seq_len=1,
                                  cur_len=cur, is_prefill=False, max_length=64,
                                  sampling=sp))
        cur += 1
    out.append(int(resp.token_id) if spec.role == ROLE_FULL
               else (np.asarray(resp.hidden) if jax_side else resp.hidden.numpy()))
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    return jp, bridged(jp)


def test_session_executor_paged_matches_jax_executor(weights, monkeypatch):
    """The full span with decode_kv_page = 32: greedy tokens equal to the
    JAX executor's with the same config and to the unpaged run's; the
    paged path taken once a layer per decode step and never at prefill
    (tests/test_paged_attention.py:80-116)."""
    jp, tp = weights
    prompt = np.random.default_rng(7).integers(0, 257, (1, 5)).astype(np.int32)
    paged = tiny_cfg(decode_kv_page=PAGE)
    spec, jspec = StageSpec(0, ROLE_FULL, 0, 4), JStageSpec(0, "full", 0, 4)
    want = _serve(JStageExecutor, jspec, jp, paged, prompt, 6, True)
    assert want == _serve(JStageExecutor, jspec, jp, tiny_cfg(), prompt, 6, True)
    calls = _layer_calls(monkeypatch)
    assert _serve(StageExecutor, spec, tp, port_cfg(paged), prompt, 6, False) == want
    assert len(calls) == 4 * 6 and len(set(calls)) == 1
    assert calls[0][0] == 1 and calls[0][1] % PAGE == 0 and calls[0][2] == PAGE


def test_segment_hidden_rows_match_jax_executor(weights):
    """A segment (hidden rows in, hidden rows out) with decode_kv_page = 32
    through a prompt and 40 decode steps, across a page's edge: every
    step's rows within float32 tolerance of the JAX executor's."""
    jp, tp = weights
    rows = np.random.default_rng(11).standard_normal((1, 48, 64)).astype(np.float32)
    prompt = {"hidden": rows, "t": 6}
    paged = tiny_cfg(decode_kv_page=PAGE)
    spec, jspec = StageSpec(1, ROLE_SEGMENT, 0, 4), JStageSpec(1, "segment", 0, 4)
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
        slice_stage_params as jslice,
    )
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
        slice_stage_params,
    )
    want = _serve(JStageExecutor, jspec, jslice(paged, jp, jspec), paged, prompt, 40, True)
    got = _serve(StageExecutor, spec, slice_stage_params(port_cfg(paged), tp, spec),
                 port_cfg(paged), prompt, 40, False)
    for g, w in zip(got, want):
        assert_close(g, w)


class _StubGraph:
    """A CPU stand-in for a CUDA graph: replay() runs the captured function
    again into the same static output, its wrappers' counts set aside (a
    real replay runs no wrapper; the graph adds what its capture
    recorded)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        with launch_counts.capturing():
            out = self.fn()
        self.out.copy_(out)


@pytest.fixture
def stub_graphs(monkeypatch):
    def record(fn, pool, stream):
        out = fn()
        return _StubGraph(fn, out), out

    monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
    monkeypatch.setattr(tgraphs, "_record", record)
    monkeypatch.setattr(tgraphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraphs.torch.cuda, "Stream", lambda *a, **k: None)


def test_executor_replay_counts_one_paged_launch_a_layer(weights, monkeypatch, stub_graphs):
    """Through a stub graph: a decode step's capture records one paged
    launch a layer, each replay adds them, and the replayed tokens equal
    the eager executor's."""
    jp, tp = weights
    cfg = port_cfg(tiny_cfg(decode_kv_page=PAGE))
    plain = tpk.paged_decode_attention

    def counted(q, k, v, cache_len, page):          # what the card's wrapper counts
        launch_counts.count(tpk, "_launches")
        return plain(q, k, v, cache_len, page)

    monkeypatch.setattr(ttf, "paged_decode_attention", counted)
    monkeypatch.setattr(tpk, "_launches", 0)
    prompt = np.random.default_rng(5).integers(0, 257, (1, 5)).astype(np.int32)
    spec = StageSpec(0, ROLE_FULL, 0, 4)
    eager = _serve(StageExecutor, spec, tp, cfg, prompt, 6, False)
    assert tpk._launches == 4 * 6
    orig = StageExecutor.__init__

    def graphed(self, *a, **k):
        orig(self, *a, **k)
        self.graphs.enabled = True

    monkeypatch.setattr(StageExecutor, "__init__", graphed)
    monkeypatch.setattr(tpk, "_launches", 0)
    assert _serve(StageExecutor, spec, tp, cfg, prompt, 6, False) == eager
    # The decode step's warm-up ran (4 launches), its capture ran nothing,
    # and its 6 replays added 4 each.
    assert tpk._launches == 4 + 4 * 6


def test_fused_greedy_oracle_paged_equals_unpaged(weights):
    """The fused greedy engine with the paged config: its tokens equal the
    unpaged engine's and the JAX package's paged fused engine's."""
    jp, tp = weights
    prompt = np.random.default_rng(3).integers(0, 257, 9).astype(np.int64)

    def port(cfg):
        engine = tfused.make_fused_decode(port_cfg(cfg), tp, 12, 64)
        logits = engine.prefill(torch.tensor([prompt.tolist()]))
        tok = int(torch.argmax(logits[0, -1]))
        return [tok] + engine(tok, len(prompt), 12).tolist()

    def jax_paged(cfg):
        fn = j_make_fused_decode(cfg, 12, 1, exact_head=True)
        kc, vc = j_init_kv_cache(cfg, cfg.num_layers, 1, 64)
        logits, kc, vc = j_full_forward(cfg, jp, jnp.asarray(prompt[None].astype(np.int32)),
                                        kc, vc, jnp.int32(0))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        toks, _, _ = fn(jp, tok, kc, vc, jnp.int32(len(prompt)), jnp.int32(12))
        return [int(tok[0])] + np.asarray(toks[:, 0]).tolist()

    paged = tiny_cfg(decode_kv_page=PAGE)
    got = port(paged)
    assert got == port(tiny_cfg())
    assert got == jax_paged(paged)


def test_batched_engine_ignores_decode_kv_page(weights):
    """The batched engine takes the field (no refusal) and has no paged
    call, as the reference's runtime/batching.py: its tokens are the
    unpaged engine's."""
    _, tp = weights

    def run(cfg):
        eng = tbatching.BatchedStageExecutor(port_cfg(cfg), StageSpec(0, ROLE_FULL, 0, 4),
                                             tp, slots=2, max_len=64, device="cpu")
        toks = {}
        for sid, prompt in (("a", [3, 9, 27, 81]), ("b", [5, 25, 125])):
            toks[sid] = [int(torch.argmax(eng.logits(eng.prefill(
                sid, torch.tensor([prompt])))[0, -1]))]
        for _ in range(6):
            out = eng.decode_batch({s: torch.tensor([[t[-1]]]) for s, t in toks.items()})
            for sid, h in out.items():
                toks[sid].append(int(torch.argmax(eng.logits(h)[0, -1])))
        return toks

    assert run(tiny_cfg(decode_kv_page=PAGE)) == run(tiny_cfg())


def _kernel_order(q, k, v, cache_len, page):
    """The kernel's arithmetic in plain PyTorch (csrc/paged_decode_attention.cu):
    chunks of `chunk_plan` pages, each walking its pages as the reference's
    loop body from its own running max (a chunk past cache_len an empty
    partial), then the chunks merged in order against the max of their
    maxima."""
    b, _, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qs = (q * (dh ** -0.5)).reshape(b, hkv, g, dh).float()
    chunk_pages, chunks = tpk.chunk_plan(s, page)
    parts = []
    for c in range(chunks):
        first = c * chunk_pages * page
        if first > cache_len:
            parts.append((torch.full((b, hkv, g), float("-inf")), torch.zeros(b, hkv, g),
                          torch.zeros(b, hkv, g, dh)))
            continue
        m = torch.full((b, hkv, g), tattn.NEG_INF)
        l, acc = torch.zeros(b, hkv, g), torch.zeros(b, hkv, g, dh)
        for p in range(c * chunk_pages, min((c + 1) * chunk_pages, s // page)):
            if p * page > cache_len:
                break
            rows = min(page, cache_len - p * page + 1)
            kp, vp = k[:, p * page:p * page + rows], v[:, p * page:p * page + rows]
            sc = torch.einsum("bhgd,bphd->bhgp", qs, kp.float())
            m2 = torch.maximum(m, sc.amax(-1))
            w = torch.exp(sc - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + w.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgp,bphd->bhgd", w.to(v.dtype).float(), vp.float())
            m = m2
        parts.append((m, l, acc))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    scale = [torch.where(p[0] == float("-inf"), torch.zeros_like(mx), torch.exp(p[0] - mx))
             for p in parts]
    l = sum(p[1] * e for p, e in zip(parts, scale))
    acc = sum(p[2] * e[..., None] for p, e in zip(parts, scale))
    return (acc / torch.clamp(l, min=1e-20)[..., None]).reshape(b, 1, h, dh).to(q.dtype)


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("s,cache_len", [(128, 0), (128, 63), (128, 64), (2048, 1000),
                                         (2048, 2047), (8192, 8191)])
def test_kernel_order_of_sums_within_tolerance(s, cache_len, q_dtype, kv_dtype):
    """The kernel's split into chunks and their merge, emulated at
    llama-3.1-8b's head shapes (G = 4, Dh = 128, page 64, B = 1): within
    the stated tolerance of the plain version at every dtype pair, the
    bf16 cache's weights rounded against each chunk's own max included."""
    q, k, v = (array_to_torch(a) for a in _inputs(
        s + cache_len, b=1, s=s, h=8, hkv=2, dh=128, q_dtype=q_dtype, kv_dtype=kv_dtype))
    want = tattn.paged_decode_attention(q, k, v, cache_len, 64)
    got = _kernel_order(q, k, v, cache_len, 64)
    tol = BF16_TOL if torch.bfloat16 in (q.dtype, k.dtype) else 1e-5
    assert_close(got.float(), want.float(), rtol=tol, atol=0.0)
