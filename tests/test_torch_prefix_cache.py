"""The port's prompt-prefix KV store (``runtime/prefix_cache.py``) and every
path that uses it, against the JAX package's on the same bridged weights.

  * the store: digests equal the reference's for equal bytes and coords;
    the chain, need-out, LRU, root-last and position rules, one case each;
  * the session executor (intermediate and final stage) and the batched
    engine (intermediate, final and full span), request by request beside
    the JAX executor or engine with a store: cold, warm, a partial hit and
    the ``T - 1`` clamp; hidden rows (or the token), the store's ``stats()``
    after each request, the rows the final stage computed on a hit, and a
    decode step after it; a cold request equals the same request with no
    store exactly;
  * the batched adapter passing ``prefix_len``, and its warm-up capturing
    the tail step at every bucket (through a CPU stub of a graph);
  * the client: ``prefix_len`` on stage 0 and on every hop of a prefill
    (0 on a decode), each request's header equal to the JAX client's; the
    prompt-head affinity picking the JAX client's replicas, two clients
    warming the same replicas, and the route cache's LRU sparing the
    affinity-free routes;
  * the ``info`` verb's ``prefix_cache`` over TCP, session and batched;
  * ``--prefix_cache_mb`` reaching every executor of ``--mode local`` and
    ``--mode serve`` (session, batched, full-span burst server).

Tolerance: hidden rows within ``assert_close``'s float32 tolerance (rtol =
atol = 1e-5, scale-relative) of the JAX package's, and of the store-less
run for a warm request (its tail runs at another sequence bucket, which
moves the last float32 ulps); greedy tokens, store counters and request
headers equal. A grain of 8 tokens, as ``tests/test_prefix_cache.py``.
"""

import hashlib

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
    port_args,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    net as jnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    prefix_cache as jpc,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
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
    client as tclient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    graphs as tgraphs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    net as tnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    prefix_cache as tpc,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    server as tserver,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.task_pool import (
    StageRuntime,
)

from test_runtime_pipeline import build_cluster, tiny_cfg

GRAIN = 8
SPLITS = "2,6"          # 8 layers: stage 0 [0, 2), a segment [2, 6), the last [6, 8)
MB = 64 << 20
GREEDY = (0.0, 0.9, 50, 1.5)


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


def _rows(seed, t, d):
    return np.random.default_rng(seed).standard_normal((1, t, d)).astype(np.float32)


def _requests(d):
    """(prefix_len, rows) of the request order: A cold (40 rows, 4 grains
    registered), B = A warm (4 reused), C sharing A's first 16 rows (2
    reused, 2 registered), D = A's first 32 rows (the T - 1 clamp: 3
    grains, all A's)."""
    a = _rows(1, 40, d)
    c = np.concatenate([a[:, :16], _rows(2, 24, d)], axis=1)
    return {"A": (40, a), "B": (40, a), "C": (40, c), "D": (32, a[:, :32])}


# -- the store ----------------------------------------------------------------

def test_chain_digests_equal_the_reference_for_equal_bytes_and_coords():
    blocks = [b"grain-one", b"grain-two", b"\x00" * 64]
    coords = (2, 6, 1, "float32", "float32", "m")
    keys = tpc.chain_digests(blocks, coords)
    assert keys == jpc.chain_digests(blocks, coords)
    assert keys == tpc.chain_digests(list(blocks), tuple(coords))
    assert keys[:2] == tpc.chain_digests(blocks[:2], coords)


def _seg(val):
    k = torch.full((1, 1, GRAIN, 1, 2), float(val))
    return k, k.clone(), torch.full((1, GRAIN, 2), float(val))


def _jseg(val):
    k = jnp.full((1, 1, GRAIN, 1, 2), float(val), jnp.float32)
    return k, k, jnp.full((1, GRAIN, 2), float(val), jnp.float32)


def _case_chain_stops(st, seg):
    keys = st["digests"]([b"a", b"b", b"c"])
    st["put"](keys[0], *seg(1))
    st["put"](keys[2], *seg(3))
    return len(st["store"].lookup_chain(keys, need_out=True))


def _case_need_out(st, seg):
    keys = st["digests"]([b"a", b"b"])
    k, v, out = seg(1)
    st["put"](keys[0], k, v, None)
    st["put"](keys[1], k, v, out)
    return (len(st["store"].lookup_chain(keys, need_out=True)),
            len(st["store"].lookup_chain(keys, need_out=False)))


def _case_lru_bound(st, seg):
    store = st["store"]
    keys = st["digests"]([b"a", b"b", b"c", b"d"])
    puts = [st["put"](key, *seg(i)) for i, key in enumerate(keys)]
    oversized = st["new"](st["per"] - 1).put(keys[0], *seg(9))
    return (puts, len(store), store.evictions, store.used_bytes <= store.max_bytes,
            len(store.lookup_chain(keys, need_out=True)), oversized)


def _case_root_last(st, seg):
    store = st["store"]
    keys = st["digests"]([b"a", b"b", b"c"])
    for i, key in enumerate(keys):
        st["put"](key, *seg(i))
    store.lookup_chain(keys, need_out=True)
    order = [keys.index(k) for k in store._entries]
    st["put"]("other", *seg(7))                    # evicts the chain's coldest link
    return order, len(store.lookup_chain(keys, need_out=True))


def _case_position(st, seg):
    d1 = st["digests"]([b"aa", b"bb"])
    d2 = st["digests"]([b"bb", b"bb"])
    return d1[1] != d2[1], d1[0] != d2[0]


STORE_CASES = {"chain_stops_at_first_missing_link": _case_chain_stops,
               "need_out_breaks_on_a_kv_only_link": _case_need_out,
               "lru_stays_inside_its_bound": _case_lru_bound,
               "root_is_touched_last": _case_root_last,
               "digest_depends_on_position": _case_position}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_semantics_equal_the_reference(case):
    """Each case on the port's store and on the JAX package's, budgeted at
    three grains' entries: the same answers and counters."""
    per = sum(x.nbytes for x in _seg(0))
    answers = []
    for mod, seg in ((tpc, _seg), (jpc, _jseg)):
        store = mod.PrefixStore(3 * per, grain=GRAIN)
        st = {"store": store, "put": store.put, "per": per,
              "new": lambda budget, mod=mod: mod.PrefixStore(budget, grain=GRAIN),
              "digests": lambda b, mod=mod: mod.chain_digests(b, ("t",))}
        answers.append((STORE_CASES[case](st, seg), store.stats()))
    assert answers[0] == answers[1]
    want = {"chain_stops_at_first_missing_link": 1,
            "need_out_breaks_on_a_kv_only_link": (0, 2),
            # 4 puts in 3 grains' room: the root went first, so no chain;
            # a segment past the budget is refused.
            "lru_stays_inside_its_bound": ([True] * 4, 3, 1, True, 0, False),
            # The lookup left the root warmest: the leaf went, 2 links stay.
            "root_is_touched_last": ([2, 1, 0], 2),
            "digest_depends_on_position": (True, True)}[case]
    assert answers[0][0] == want


def test_grain_blocks_read_bf16_bits_and_device_rows_once():
    x = torch.randn(1, 20, 4).to(torch.bfloat16)
    blocks = tpc.grain_blocks(x, 2, GRAIN)
    bits = x.view(torch.int16).numpy()
    assert blocks == [bits[:, :8].tobytes(), bits[:, 8:16].tobytes()]
    ids = torch.arange(20)[None]
    assert tpc.grain_blocks(ids, 1, GRAIN) == [np.arange(8, dtype=np.int64)[None].tobytes()]


# -- the session executor --------------------------------------------------------

def _session_pair(weights, stage):
    jcfg, jp, tcfg, tp = weights
    jspec = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS)).stages[stage]
    tspec = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS)).stages[stage]
    je = JStageExecutor(jcfg, jspec, jslice(jcfg, jp, jspec), peer_id="j",
                        prefix_cache_bytes=MB)
    je.prefix_store.grain = GRAIN
    te = StageExecutor(tcfg, tspec, slice_stage_params(tcfg, tp, tspec), peer_id="t",
                       device="cpu", prefix_cache_bytes=MB)
    te.prefix_store.grain = GRAIN
    plain = StageExecutor(tcfg, tspec, slice_stage_params(tcfg, tp, tspec), peer_id="p",
                          device="cpu")
    return je, te, plain


def _sreq(mod, sid, x, prefix_len, cur=0, prefill=True):
    req = mod.StageRequest if hasattr(mod, "StageRequest") else mod
    return req(session_id=sid, hidden=x, seq_len=x.shape[1], cur_len=cur,
               is_prefill=prefill, max_length=64, prefix_len=prefix_len,
               sampling=(JSamplingParams if req is JStageRequest else SamplingParams)(*GREEDY))


@pytest.mark.parametrize("stage", [1, 2], ids=["segment", "last"])
def test_session_executor_store_matches_jax(weights, stage):
    je, te, plain = _session_pair(weights, stage)
    d = weights[0].hidden_size
    last = stage == 2
    computed = []
    dispatch = te._dispatch_chunk

    def counted(span, step, sub_params, x, handle, n):
        computed.append(n)
        return dispatch(span, step, sub_params, x, handle, n)

    te._dispatch_chunk = counted
    want_stats = {"A": (0, 1, 0, 4), "B": (1, 1, 4, 4), "C": (2, 1, 6, 6), "D": (3, 1, 9, 6)}
    for sid, (plen, rows) in _requests(d).items():
        rj = je.forward(_sreq(JStageRequest, sid, jnp.asarray(rows), plen))
        computed.clear()
        rt = te.forward(_sreq(StageRequest, sid, torch.from_numpy(rows), plen))
        rp = plain.forward(_sreq(StageRequest, sid, torch.from_numpy(rows), plen))
        st = te.prefix_store.stats()
        assert st == je.prefix_store.stats()
        assert (st["hits"], st["misses"], st["grains_reused"], st["entries"]) == want_stats[sid]
        reused = {"A": 0, "B": 32, "C": 16, "D": 24}[sid]
        assert sum(computed) == rows.shape[1] - reused      # the tail alone
        assert rt.cache_len == rj.cache_len == rows.shape[1]
        if last:
            assert rt.token_id == rj.token_id == rp.token_id
        else:
            assert_close(rt.hidden, np.asarray(rj.hidden))
            if sid == "A":
                assert torch.equal(rt.hidden, rp.hidden)    # cold: the no-store bits
            assert_close(rt.hidden, rp.hidden)
    # Decode continues from the copied KV as from the computed one.
    step = _rows(5, 1, d)
    for sid in ("A", "B"):
        rj = je.forward(_sreq(JStageRequest, sid, jnp.asarray(step), 0, 40, False))
        rt = te.forward(_sreq(StageRequest, sid, torch.from_numpy(step), 0, 40, False))
        if last:
            assert rt.token_id == rj.token_id
        else:
            assert_close(rt.hidden, np.asarray(rj.hidden))


def test_session_store_entries_own_their_memory(weights):
    """An entry is a clone: the lease that wrote it goes back to the arena's
    free list and the next session's zeroing leaves the entry whole."""
    _, te, _ = _session_pair(weights, 1)
    _, rows = _requests(weights[0].hidden_size)["A"]
    te.forward(_sreq(StageRequest, "s", torch.from_numpy(rows), 40))
    handle = te.arena.get("s")
    entries = list(te.prefix_store._entries.values())
    before = [e.k.clone() for e in entries]
    assert all(e.k.untyped_storage().data_ptr() != handle.k.untyped_storage().data_ptr()
               for e in entries)
    te.drop_session("s")
    te.forward(_sreq(StageRequest, "t", torch.from_numpy(_rows(9, 40, rows.shape[2])), 0))
    assert all(torch.equal(e.k, b) for e, b in zip(entries, before))
    assert all(e.out is not None and e.out.shape == (1, GRAIN, rows.shape[2]) for e in entries)


# -- the batched engine ------------------------------------------------------------

def _batched_pair(weights, stage):
    jcfg, jp, tcfg, tp = weights
    if stage == "full":
        jspec = JStagePlan.even(jcfg.num_layers, 1).stages[0]
        tspec = StagePlan.even(tcfg.num_layers, 1).stages[0]
    else:
        jspec = JStagePlan.from_splits(jcfg.num_layers, jparse_splits(SPLITS)).stages[stage]
        tspec = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS)).stages[stage]
    je = jbatching.BatchedStageExecutor(jcfg, jspec, jslice(jcfg, jp, jspec), slots=4,
                                        max_len=64, prefix_cache_bytes=MB, model="m")
    je.lengths = je.lengths.astype(np.int64)      # see tests/test_torch_batching.py
    je.prefix_store.grain = GRAIN
    te = tbatching.BatchedStageExecutor(tcfg, tspec, slice_stage_params(tcfg, tp, tspec),
                                        device="cpu", slots=4, max_len=64,
                                        prefix_cache_bytes=MB, model="m")
    te.prefix_store.grain = GRAIN
    plain = tbatching.BatchedStageExecutor(tcfg, tspec, slice_stage_params(tcfg, tp, tspec),
                                           device="cpu", slots=4, max_len=64)
    return je, te, plain


@pytest.mark.parametrize("stage", [1, 2, "full"], ids=["segment", "last", "full_span"])
def test_batched_engine_store_matches_jax(weights, stage):
    je, te, plain = _batched_pair(weights, stage)
    jcfg = weights[0]
    if stage == "full":
        ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 40))
        shared = np.concatenate([ids[:, :16], ids[:, 16:] % 7 + 1], axis=1)
        reqs = {"A": (40, ids), "B": (40, ids), "C": (40, shared), "D": (32, ids[:, :32])}
    else:
        reqs = _requests(jcfg.hidden_size)
    last = stage in (2, "full")
    want_stats = {"A": (0, 1, 0, 4), "B": (1, 1, 4, 4), "C": (2, 1, 6, 6), "D": (3, 1, 9, 6)}
    for sid, (plen, x) in reqs.items():
        xj = jnp.asarray(x.astype(np.int32) if stage == "full" else x)
        hj = je.prefill(sid, xj, prefix_len=plen)
        ht = te.prefill(sid, torch.from_numpy(x), prefix_len=plen)
        hp = plain.prefill(sid, torch.from_numpy(x), prefix_len=plen)
        st = te.prefix_store.stats()
        assert st == je.prefix_store.stats()
        assert (st["hits"], st["misses"], st["grains_reused"], st["entries"]) == want_stats[sid]
        assert int(te.lengths[te.slot(sid)]) == x.shape[1]
        assert ht.shape == tuple(hj.shape)       # the last stage: the tail's rows only
        assert_close(ht, np.asarray(hj))
        assert_close(ht[:, -1], hp[:, -1])
        if sid == "A":
            assert torch.equal(ht, hp)           # cold: the no-store bits
        if last:
            assert_close(te.logits(ht[:, -1:]), np.asarray(je.logits(hj[:, -1:])))
        te.end_session(sid) if sid == "D" else None
        je.end_session(sid) if sid == "D" else None
    # A batched step continues the cold and the warm session alike.
    if stage == "full":
        step_j = {s: jnp.asarray([[5]], jnp.int32) for s in ("A", "B")}
        step_t = {s: torch.tensor([[5]]) for s in ("A", "B")}
    else:
        step = _rows(5, 1, jcfg.hidden_size)
        step_j = {s: jnp.asarray(step) for s in ("A", "B")}
        step_t = {s: torch.from_numpy(step) for s in ("A", "B")}
    oj, ot = je.decode_batch(step_j), te.decode_batch(step_t)
    for sid in ("A", "B"):
        assert_close(ot[sid], np.asarray(oj[sid]))
    assert_close(ot["A"], ot["B"])


def test_failed_tail_prefill_recycles_the_slot(weights, monkeypatch):
    _, te, _ = _batched_pair(weights, 1)
    _, rows = _requests(weights[0].hidden_size)["A"]
    te.prefill("a", torch.from_numpy(rows), prefix_len=40)
    free = len(te._free)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(te, "_tail_step", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        te.prefill("b", torch.from_numpy(rows), prefix_len=40)
    assert te.slot("b") is None and len(te._free) == free
    assert te.prefix_store.stats()["hits"] == 1


def test_adapter_passes_prefix_len_as_jax(weights):
    je, te, _ = _batched_pair(weights, 1)
    ja = jbatching.BatchingStageAdapter(je, peer_id="j")
    ta = tbatching.BatchingStageAdapter(te, peer_id="t")
    _, rows = _requests(weights[0].hidden_size)["A"]
    for sid in ("s1", "s2"):
        rj = ja.forward(_sreq(JStageRequest, sid, jnp.asarray(rows), 40))
        rt = ta.forward(_sreq(StageRequest, sid, torch.from_numpy(rows), 40))
        assert_close(rt.hidden, np.asarray(rj.hidden))
        assert rt.cache_len == rj.cache_len == 40
    assert te.prefix_store.stats() == je.prefix_store.stats()
    assert te.prefix_store.stats()["hits"] == 1


def test_warmup_captures_the_tail_at_every_bucket(weights, monkeypatch):
    """With a store the adapter's warm-up also captures the tail step at
    every prefill bucket (through a CPU stub of a graph), so a prefix hit
    captures nothing while serving; the hit's rows equal the direct run."""
    class StubGraph:
        def __init__(self, fn, out):
            self.fn, self.out = fn, out

        def replay(self):
            new = self.fn()
            for o, n in zip(*(x if isinstance(x, tuple) else (x,) for x in (self.out, new))):
                o.copy_(n)

    class HostInts:
        def __init__(self, shape, device):
            self.tensor = torch.zeros(shape, dtype=torch.int64)

        def load(self, values):
            self.tensor.view(-1).copy_(torch.tensor(values, dtype=torch.int64))
            return self.tensor

    monkeypatch.setattr(tgraphs, "_warm_up", lambda fn, stream: fn())
    monkeypatch.setattr(tgraphs, "_record", lambda fn, pool, stream: _stub_record(StubGraph, fn))
    monkeypatch.setattr(tgraphs, "StagedInts", HostInts)
    monkeypatch.setattr(tgraphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraphs.torch.cuda, "Stream", lambda *a, **k: None)
    _, te, plain = _batched_pair(weights, 1)
    te.graphs.enabled = te.sampler.enabled = True
    tbatching.BatchingStageAdapter(te, peer_id="t").warmup()
    tails = sorted(k[1] for k, _ in te.graphs.entries() if k[0] == "tail")
    assert tails == sorted({min(b, te.max_len) for b in tbatching.PREFILL_BUCKETS})
    captures = te.graphs.captures
    _, rows = _requests(weights[0].hidden_size)["A"]
    te.prefill("a", torch.from_numpy(rows), prefix_len=40)
    hit = te.prefill("b", torch.from_numpy(rows), prefix_len=40)
    assert te.graphs.captures == captures
    assert_close(hit, plain.prefill("b", torch.from_numpy(rows)))


def _stub_record(stub_cls, fn):
    out = fn()
    return stub_cls(fn, out), out


# -- the client ----------------------------------------------------------------------

def _record_calls(transport, stage0):
    """Every request the client sends: stage 0's, then each hop's."""
    seen = []
    forward = stage0.forward

    def local(req):
        seen.append(("stage0", req))
        return forward(req)

    stage0.forward = local
    transport.on_call = lambda peer, req: seen.append((peer, req))
    return seen


def _header(net, req):
    hdr = net._request_header(req, {"dtype": "f32", "shape": list(req.hidden.shape)})
    return {k: v for k, v in hdr.items() if k not in ("session_id", "trace", "tensor")}


def test_client_marks_every_prefill_as_the_jax_client(weights):
    jcfg, _, tcfg, tp = weights
    jclient, jtransport, *_ = build_cluster(jcfg, splits=SPLITS)
    tclient_, ttransport = build_port_cluster(tcfg, tp, SPLITS)
    prompt = list(range(3, 43))
    runs = {}
    for pkg, client, transport, sp in (("jax", jclient, jtransport, JSamplingParams(*GREEDY)),
                                       ("port", tclient_, ttransport, SamplingParams(*GREEDY))):
        seen = _record_calls(transport, client.stage0)
        tokens = client.generate(prompt, max_new_tokens=3, sampling=sp).tokens
        runs[pkg] = (tokens, seen)
    (jt, jseen), (tt, tseen) = runs["jax"], runs["port"]
    assert tt == jt
    assert [p for p, _ in tseen] == [p for p, _ in jseen]
    for (peer, rt), (_, rj) in zip(tseen, jseen):
        want = 40 if rt.is_prefill else 0
        assert rt.prefix_len == rj.prefix_len == want, peer
        if peer != "stage0":
            assert _header(tnet, rt) == _header(jnet, rj), peer


def _replicas(weights, n=3, store=False):
    """The port's cluster with `n` replicas a remote stage, each with a
    store when asked."""
    tcfg, tp = weights[2], weights[3]
    client, transport = build_port_cluster(tcfg, tp, SPLITS, replicas=n)
    if store:
        for peer in transport.peers():
            ex = transport.executor(peer)
            ex.prefix_store = tpc.PrefixStore(MB, grain=GRAIN)
    return client, transport


def test_affinity_picks_the_jax_clients_replicas(weights):
    jclient, *_ = build_cluster(weights[0], splits=SPLITS, replicas=3)
    tclient_, _ = _replicas(weights)
    for head in ([5, 9, 23, 7], list(range(100)), [1] * 70):
        affinity = tclient.prompt_affinity(head)
        assert affinity == hashlib.sha1(np.asarray(head[:64], np.int32).tobytes()).hexdigest()
        got = [h.peer_id for h in tclient_.route(min_context=80, affinity=affinity)]
        want = [h.peer_id for h in jclient.route(kind="plain", min_context=80,
                                                 affinity=affinity)]
        assert got == want


def test_two_clients_warm_the_same_replicas(weights):
    """Two clients with the same prompt pick the same replica chain, so the
    second's prefill hits the stores the first warmed (the reference's
    test_cross_client_affinity_warms_the_same_replica)."""
    client_a, transport = _replicas(weights, store=True)
    client_b = tclient.PipelineClient(weights[2], client_a.plan, client_a.stage0, transport,
                                      client_a.registry, settle_seconds=0.0, seed=99)
    prompt = list(range(11, 51))
    ra = client_a.generate(prompt, max_new_tokens=3, sampling=SamplingParams(*GREEDY))
    rb = client_b.generate(prompt, max_new_tokens=3, sampling=SamplingParams(*GREEDY))
    assert ra.tokens == rb.tokens
    stats = {p: transport.executor(p).prefix_store.stats() for p in transport.peers()}
    hit = {p for p, s in stats.items() if s["hits"]}
    missed = {p for p, s in stats.items() if s["misses"]}
    assert hit == missed and len(hit) == 2
    assert all(stats[p]["grains_reused"] == 4 for p in hit)


def test_route_cache_evicts_only_affinity_routes(weights):
    client, _ = _replicas(weights)
    jclient, *_ = build_cluster(weights[0], splits=SPLITS, replicas=3)
    client.route_cache_capacity = jclient.route_cache_capacity = 2
    for c, kw in ((client, {}), (jclient, {"kind": "plain"})):
        c.route(**kw)
        for head in ("a", "b", "c"):
            c.route(affinity=head, **kw)
        c.route(**kw)                        # still cached: no new plan
    assert [k[1:] for k in client._routes] == [k[1:] for k in jclient._routes]
    assert (None, None) in [k[1:] for k in client._routes]
    evictions = tclient._tm.get("client_route_cache_evictions_total", client.metrics).value
    assert evictions == 2


# -- the info verb over TCP -------------------------------------------------------------

@pytest.mark.parametrize("engine", ["session", "batched"])
def test_info_reports_the_store_over_tcp(weights, engine):
    tcfg, tp = weights[2], weights[3]
    spec = StagePlan.from_splits(tcfg.num_layers, parse_splits(SPLITS)).stages[1]
    shard = slice_stage_params(tcfg, tp, spec)
    if engine == "session":
        ex = StageExecutor(tcfg, spec, shard, peer_id="p", device="cpu",
                           prefix_cache_bytes=MB)
        runtime = StageRuntime()
    else:
        ex = tbatching.BatchingStageAdapter(tbatching.BatchedStageExecutor(
            tcfg, spec, shard, device="cpu", slots=2, max_len=64, prefix_cache_bytes=MB),
            peer_id="p")
        runtime = None
    getattr(ex, "inner", ex).prefix_store.grain = GRAIN
    registry = tnet.RegistryServer(ttl=600.0)
    registry.start()
    srv = tnet.TcpStageServer(ex, runtime, wire_dtype="f32")
    srv.start()
    rec = tclient.make_server_record("p", spec)
    rec.address = srv.address
    registry.registry.register(rec)
    tx = tnet.TcpTransport(tnet.RemoteRegistry(registry.address), wire_dtype="f32")
    try:
        assert tx.info("p")["prefix_cache"]["entries"] == 0     # an empty store too
        _, rows = _requests(tcfg.hidden_size)["A"]
        for sid in ("a", "b"):
            tx.call("p", _sreq(StageRequest, sid, torch.from_numpy(rows), 40), 60.0)
        stats = tx.info("p")["prefix_cache"]
        assert (stats["hits"], stats["misses"], stats["grains_reused"]) == (1, 1, 4)
        jt = jnet.TcpTransport(jnet.RemoteRegistry(registry.address))
        try:
            assert jt.info("p")["prefix_cache"] == stats
        finally:
            jt.close()
    finally:
        tx.close()
        srv.stop()
        registry.stop()


# -- the CLI flag ---------------------------------------------------------------------

def test_prefix_cache_mb_reaches_every_local_executor(weights):
    tcfg, tp = weights[2], weights[3]
    args = port_args(["--prefix_cache_mb", "3", "--splits", SPLITS])
    tmain.refuse_unported_flags(args)
    client = tmain.build_local_client(args, tcfg, tp)
    executors = [client.stage0] + [client.transport.executor(p)
                                   for p in client.transport.peers()]
    assert len(executors) == 3
    assert all(ex.prefix_store.max_bytes == 3 << 20 for ex in executors)
    assert tmain.build_local_client(port_args([]), tcfg, tp).stage0.prefix_store is None


def test_local_cluster_routes_a_new_prompt_after_the_ttl(weights):
    """The route cache is keyed by the prompt head, so a later prompt
    discovers its route anew: the in-process peers of ``--mode local``,
    which send no heartbeat, must still be live then."""
    tcfg, tp = weights[2], weights[3]
    client = tmain.build_local_client(port_args(["--splits", SPLITS]), tcfg, tp)
    sp = SamplingParams(*GREEDY)
    client.generate([5, 9, 23], max_new_tokens=2, sampling=sp)
    client.registry.age_records(3600.0)
    assert len(client.generate([7, 7, 1, 4], max_new_tokens=2, sampling=sp).tokens) == 2
    assert len(client._routes) == 2


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv", [["--stage", "1"], ["--stage", "1", "--batched"],
                                  ["--stage", "0", "--batched", "--burst", "4"]],
                         ids=["session", "batched", "burst"])
def test_prefix_cache_mb_reaches_every_serve_executor(weights, monkeypatch, argv):
    """``run_serve`` up to the server's construction: the executor it would
    serve has a store of ``--prefix_cache_mb`` MiB (the batched engine's
    with the model tag)."""
    jcfg, _, tcfg, tp = weights
    seen = {}

    class Server:
        def __init__(self, peer_id, cfg, spec, params, registry, **kw):
            ex = kw["executor"] or StageExecutor(cfg, spec, params, peer_id=peer_id,
                                                 **kw["executor_kwargs"])
            seen["ex"] = ex
            raise _Stop

    def stage_model(args, spec):
        return tcfg, slice_stage_params(tcfg, tp, spec)

    monkeypatch.setattr(tmain, "get_config", lambda name: tcfg)
    monkeypatch.setattr(tmain, "load_stage_model", stage_model)
    monkeypatch.setattr(tnet, "RemoteRegistry", lambda *a, **k: None)
    monkeypatch.setattr(tnet, "TcpTransport", lambda *a, **k: None)
    monkeypatch.setattr(tserver, "FixedStageServer", Server)
    monkeypatch.setattr(tserver, "_pinger_from_transport", lambda tx: None)
    with pytest.raises(_Stop):
        tmain.main(["--mode", "serve", "--device", "cpu", "--registry_addr", "127.0.0.1:1",
                    "--model", "gpt2", "--prefix_cache_mb", "2", "--slots", "2",
                    "--max_session_len", "64", *argv])
    ex = seen["ex"]
    store = getattr(ex, "inner", ex).prefix_store
    assert store is not None and store.max_bytes == 2 << 20
    if "--batched" in argv:
        assert ex.inner.model == "gpt2"
