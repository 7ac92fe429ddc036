"""The port's MoE layers (``models/moe.py`` and the MoE paths of
``models/transformer.py``) against the JAX package's, on the same bridged
weights and inputs, at tiny widths (D 32-64, 4 or 8 experts, 2 layers).

Covered: ``sparse_moe_mlp`` at (E, K) = (4, 1), (4, 2), (8, 2), (8, 3) with
the expert ids of every row whose top-k margin is clear; ``moe_capacity``
over a grid; an overflow at ``MOE_CAPACITY_FACTOR=0.5`` (``dispatch_stats``
equal, outputs equal); all-zero rows choosing ``lax.top_k``'s experts; the
``MOE_SPARSE=0`` dense path; int8 and NF4 expert stacks kept packed by
``dequant_tree(keep_experts=True)``; ``full_forward`` and a greedy run;
the session pipeline over ``LocalTransport`` through a CPU stub of the
captured step at ``none``, int8 and NF4; the fused greedy oracle (the
batched engine's Mixtral rounds are held to JAX's engine in
tests/test_torch_batching.py::test_engine_refuses_moe); the
``moe_*`` telemetry families; and the refusals that stay (training, host
offload).

Tolerance: float32 within ``assert_close`` (1e-5 of the compared tensor's
scale); the quantized trees against the JAX quantized path at 3e-4, as
tests/test_moe.py holds its own; tokens exactly. Expert ids are compared
at every row whose gaps between its first K + 1 sorted router logits
exceed ``MARGIN`` x max|logit|, and each test requires most rows to.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    build_port_cluster,
    jax_mode_generate,
    jax_params,
    one_torch_thread,
    port_args,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.telemetry import (
    metrics as jmetrics,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    config as jconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    moe as jmoe,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    transformer as jtf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.quant import (
    dequant_tree as j_dequant_tree,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    metrics as tmetrics,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry.profiling import (
    _metric_sum,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    moe as tmoe,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.quant import (
    NF4Tensor,
    QuantizedTensor,
    dequant_tree,
    params_per_block,
    tree_map,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    sampling as tsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    fused_decode as tfused,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    StageRequest,
)

from test_torch_graphs import stub_graphs  # noqa: F401 (fixture)

MARGIN = 1e-5
QUANT_TOL = dict(rtol=3e-4, atol=3e-4)
GREEDY_J = jsamp.SamplingParams(temperature=0.0)
GREEDY_T = tsamp.SamplingParams(temperature=0.0)
PROMPT = [72, 101, 108, 108, 111, 33, 7, 19]
STEPS = 6


def moe_cfg(num_experts=8, top_k=2, num_layers=2, hidden=32, inter=64):
    return jconfig.mixtral_config(
        vocab_size=131, hidden_size=hidden, num_layers=num_layers, num_heads=4,
        num_kv_heads=2, intermediate_size=inter, num_experts=num_experts,
        num_experts_per_tok=top_k, max_position_embeddings=256)


def layer_mlp(jp, layer=0):
    """One layer's mlp subtree of a JAX tree, and its bridged twin."""
    mlp = jax.tree.map(lambda a: a[layer], jp["layers"]["mlp"])
    return mlp, bridged(mlp)


def hidden(cfg, b=2, t=9, seed=0, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((b, t, cfg.hidden_size)) * scale
    return x.astype(np.float32)


def clear_rows(router, x, k: int):
    """Rows whose first k + 1 sorted router logits (float64) are apart by
    more than MARGIN x max|logit|: their top-k ids and order are decided."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(router, np.float64)
    top = -np.sort(-logits, axis=-1)[:, :k + 1]
    gaps = top[:, :-1] - top[:, 1:]
    return (gaps > MARGIN * np.abs(logits).max()).all(axis=-1)


def assert_ids_match(jcfg, jrouter, trouter, x, need=0.9):
    k = jcfg.num_experts_per_tok
    n = x.shape[0] * x.shape[1]
    je, _, _ = jmoe._route(jrouter, jnp.asarray(x.reshape(n, -1)), k)
    te, _ = tmoe._route(trouter, torch.from_numpy(x.reshape(n, -1)), k)
    je = np.asarray(je).reshape(n, k)
    te = te.numpy().reshape(n, k)
    clear = clear_rows(jrouter, x, k)
    assert clear.mean() >= need, f"only {clear.sum()} of {n} rows clear of a near-tie"
    np.testing.assert_array_equal(te[clear], je[clear])


# -- the dispatch ---------------------------------------------------------------

@pytest.mark.parametrize("experts,top_k", [(4, 1), (4, 2), (8, 2), (8, 3)])
def test_sparse_moe_mlp_matches_jax(experts, top_k):
    jcfg = moe_cfg(experts, top_k)
    jmlp, tmlp = layer_mlp(jax_params(jcfg, seed=experts + top_k))
    x = hidden(jcfg, seed=top_k)
    want = jmoe.sparse_moe_mlp(jcfg, jmlp, jnp.asarray(x), None)
    got = tmoe.sparse_moe_mlp(port_cfg(jcfg), tmlp, torch.from_numpy(x))
    assert_close(got, np.asarray(want))
    assert_ids_match(jcfg, jmlp["router"], tmlp["router"], x)


@pytest.mark.parametrize("cf", ["0", "-1", "0.5", "1.25", "2.0"])
def test_moe_capacity_matches_jax(monkeypatch, cf):
    monkeypatch.setenv("MOE_CAPACITY_FACTOR", cf)
    for n in (1, 2, 7, 8, 30, 32, 33, 100, 2048):
        for e in (4, 8):
            for k in (1, 2, 3):
                assert tmoe.moe_capacity(n, e, k) == jmoe.moe_capacity(n, e, k), (n, e, k)
    jcfg = moe_cfg()
    assert tmoe.sparse_mlp_flops(32, port_cfg(jcfg)) == jmoe.sparse_mlp_flops(32, jcfg)
    assert tmoe.dense_mlp_flops(32, port_cfg(jcfg)) == jmoe.dense_mlp_flops(32, jcfg)


def test_overflow_drops_the_slots_jax_drops(monkeypatch):
    monkeypatch.setenv("MOE_CAPACITY_FACTOR", "0.5")
    jcfg = moe_cfg(8, 2)
    jmlp, tmlp = layer_mlp(jax_params(jcfg, seed=11))
    x = hidden(jcfg, b=2, t=16, seed=11)
    jcounts, jkept, jcap = jmoe.dispatch_stats(jcfg, jmlp["router"], jnp.asarray(x))
    tcounts, tkept, tcap = tmoe.dispatch_stats(port_cfg(jcfg), tmlp["router"],
                                               torch.from_numpy(x))
    assert (tcounts.tolist(), tkept, tcap) == (np.asarray(jcounts).tolist(), jkept, jcap)
    assert tkept < x.shape[0] * x.shape[1] * 2          # something was dropped
    want = jmoe.sparse_moe_mlp(jcfg, jmlp, jnp.asarray(x), None)
    got = tmoe.sparse_moe_mlp(port_cfg(jcfg), tmlp, torch.from_numpy(x))
    assert_close(got, np.asarray(want))


def test_all_zero_rows_choose_lax_top_k_experts():
    """A zero row's router logits are all equal: the lower experts win, in
    order, as with ``lax.top_k``; such rows take capacity from later rows."""
    jcfg = moe_cfg(8, 3)
    jmlp, tmlp = layer_mlp(jax_params(jcfg, seed=4))
    x = hidden(jcfg, b=1, t=12, seed=4)
    x[0, ::3] = 0.0
    n, k = 12, 3
    je, _, _ = jmoe._route(jmlp["router"], jnp.asarray(x.reshape(n, -1)), k)
    te, _ = tmoe._route(tmlp["router"], torch.from_numpy(x.reshape(n, -1)), k)
    je, te = np.asarray(je).reshape(n, k), te.numpy().reshape(n, k)
    zero = (x.reshape(n, -1) == 0).all(axis=-1)
    assert (te[zero] == [0, 1, 2]).all() and (je[zero] == [0, 1, 2]).all()
    clear = clear_rows(jmlp["router"], x, k) | zero
    assert clear.mean() >= 0.9
    np.testing.assert_array_equal(te[clear], je[clear])
    want = jmoe.sparse_moe_mlp(jcfg, jmlp, jnp.asarray(x), None)
    assert_close(tmoe.sparse_moe_mlp(port_cfg(jcfg), tmlp, torch.from_numpy(x)),
                 np.asarray(want))


def test_dense_switch_matches_jax_dense(monkeypatch):
    monkeypatch.setenv("MOE_SPARSE", "0")
    jcfg = moe_cfg(8, 2)
    tcfg = port_cfg(jcfg)
    jmlp, tmlp = layer_mlp(jax_params(jcfg, seed=5))
    x = hidden(jcfg, seed=5)
    want = np.asarray(jtf._moe_mlp_dense(jcfg, jmlp, jnp.asarray(x), None))
    assert_close(ttf._moe_mlp(tcfg, tmlp, torch.from_numpy(x)), want)
    # Drop-free, the sparse path computes the dense one's function.
    monkeypatch.setenv("MOE_SPARSE", "1")
    monkeypatch.setenv("MOE_CAPACITY_FACTOR", "0")
    assert_close(ttf._moe_mlp(tcfg, tmlp, torch.from_numpy(x)), want)


@pytest.mark.parametrize("quant,nf4_kernel", [("int8", "0"), ("nf4", "0"), ("nf4", "1")])
def test_quantized_experts_stay_packed_and_match_jax(monkeypatch, quant, nf4_kernel):
    """dequant_tree(keep_experts=True) keeps the [E, in, out] stacks packed
    (and materializes them under MOE_SPARSE=0); the packed products match
    the JAX package's quantized sparse path (NF4_KERNEL=1: one nf4_dot a
    expert where JAX dequantizes, ROADMAP Queue 3 #50)."""
    monkeypatch.setenv("NF4_KERNEL", nf4_kernel)
    jcfg = moe_cfg(4, 2)
    tcfg = port_cfg(jcfg)
    jq = jax_params(jcfg, quant, seed=6)
    tq = bridged(jq)
    cls = QuantizedTensor if quant == "int8" else NF4Tensor
    layer = tree_map(lambda a: a[0], tq["layers"])
    kept = dequant_tree(layer, keep_experts=True)["mlp"]
    assert all(isinstance(kept[w], cls) for w in ("wg", "wu", "wd"))
    monkeypatch.setenv("MOE_SPARSE", "0")
    assert all(isinstance(v, torch.Tensor)
               for v in dequant_tree(layer, keep_experts=True)["mlp"].values())
    monkeypatch.setenv("MOE_SPARSE", "1")
    x = hidden(jcfg, seed=6)
    jmlp = j_dequant_tree(jax.tree.map(lambda a: a[0], jq["layers"]), keep_experts=True)["mlp"]
    want = jmoe.sparse_moe_mlp(jcfg, jmlp, jnp.asarray(x), None)
    assert_close(tmoe.sparse_moe_mlp(tcfg, kept, torch.from_numpy(x)), np.asarray(want),
                 **QUANT_TOL)
    ids = np.asarray([PROMPT], np.int32)
    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, 16)
    jl, _, _ = jtf.full_forward(jcfg, jq, jnp.asarray(ids), kc, vc, jnp.int32(0))
    kc, vc = ttf.init_kv_cache(tcfg, tcfg.num_layers, 1, 16)
    tl, _, _ = ttf.full_forward(tcfg, tq, torch.from_numpy(ids).long(), kc, vc, 0)
    assert_close(tl, np.asarray(jl), **QUANT_TOL)


# -- the model ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(seed: int):
    """The model of the whole-model cases (8 experts, top 2, D 64): its
    JAX config, JAX weights and JAX's greedy tokens after PROMPT."""
    jcfg = moe_cfg(8, 2, hidden=64, inter=96)
    jp = jax_params(jcfg, seed=seed)
    return jcfg, jp, _jax_greedy(jcfg, jp, PROMPT, STEPS)


def _jax_greedy(jcfg, jp, prompt, steps, max_len=32):
    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, max_len)
    logits, kc, vc = jtf.full_forward(jcfg, jp, jnp.asarray([prompt], jnp.int32), kc, vc,
                                      jnp.int32(0))
    toks, cur = [int(jnp.argmax(logits[0, -1]))], len(prompt)
    for _ in range(steps - 1):
        logits, kc, vc = jtf.full_forward(jcfg, jp, jnp.asarray([[toks[-1]]], jnp.int32),
                                          kc, vc, jnp.int32(cur))
        toks.append(int(jnp.argmax(logits[0, -1])))
        cur += 1
    return toks


def test_full_forward_and_greedy_match_jax():
    jcfg, jp, want = _model(7)
    tcfg = port_cfg(jcfg)
    tp = bridged(jp)
    # init_params' tree is the JAX package's: keys, shapes, dtypes.
    init = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    assert [(k, tuple(v.shape)) for k, v in _leaves(init)] == \
        [(k, tuple(v.shape)) for k, v in _leaves(tp)]
    ids = np.asarray([PROMPT, PROMPT[::-1]], np.int32)
    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 2, 16)
    want_logits, _, _ = jtf.full_forward(jcfg, jp, jnp.asarray(ids), kc, vc, jnp.int32(0))
    kc, vc = ttf.init_kv_cache(tcfg, tcfg.num_layers, 2, 16)
    got, _, _ = ttf.full_forward(tcfg, tp, torch.from_numpy(ids).long(), kc, vc, 0)
    assert_close(got, np.asarray(want_logits))
    kc, vc = ttf.init_kv_cache(tcfg, tcfg.num_layers, 1, 32)
    x, cur, toks = torch.tensor([PROMPT]), 0, []
    for _ in range(STEPS):
        logits, kc, vc = ttf.full_forward(tcfg, tp, x, kc, vc, cur)
        cur += x.shape[1]
        toks.append(int(torch.argmax(logits[0, -1])))
        x = torch.tensor([[toks[-1]]])
    assert toks == want


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("quant", ["none", "int8", "nf4"])
def test_session_pipeline_matches_jax(monkeypatch, stub_graphs, quant):
    """--mode local over 2 stages (LocalTransport), every executor's step
    through the CPU stub of a captured graph: JAX's --mode local tokens
    (its prefill padded to the same bucket)."""
    if quant == "nf4":
        monkeypatch.setenv("NF4_KERNEL", "1")
    jcfg, jp, _ = _model(7)
    argv = ["--mode", "local", "--quant", quant, "--splits", "1"]
    want = jax_mode_generate(monkeypatch, argv, jcfg, jp)[0](
        PROMPT, STEPS, sampling=GREEDY_J).tokens
    client, transport = build_port_cluster(port_cfg(jcfg), bridged(jp), "1", quant=quant)
    executors = [client.stage0] + [transport.executor(p) for p in transport.peers()]
    for ex in executors:
        ex.graphs.enabled = True
    got = client.generate(PROMPT, STEPS, sampling=GREEDY_T)
    assert client.plan.num_stages == 2
    assert got.tokens == want
    assert sum(ex.graphs.replays for ex in executors) >= len(executors) * (STEPS - 1)


def test_fused_oracle_matches_its_loop_and_jax(monkeypatch):
    jcfg, jp, greedy = _model(7)
    tcfg = port_cfg(jcfg)
    argv = ["--mode", "oracle", "--quant", "int8"]
    want = jax_mode_generate(monkeypatch, argv, jcfg, jp)[0](
        PROMPT, STEPS, sampling=GREEDY_J).tokens
    gen = tmain.make_oracle_generate(port_args(argv), tcfg, bridged(jp))
    got = gen(PROMPT, STEPS, GREEDY_T)
    assert got.tokens == want
    assert gen.per_token(PROMPT, STEPS, GREEDY_T).tokens == got.tokens
    engine = tfused.make_fused_decode(tcfg, bridged(jp), STEPS, 32)
    first = int(torch.argmax(engine.prefill(torch.tensor([PROMPT]))[0, -1]))
    toks = engine(first, len(PROMPT), STEPS - 1)
    assert [first] + toks[:STEPS - 1].tolist() == greedy


# -- telemetry --------------------------------------------------------------------

def _families(reg):
    """(observations and sum of moe_expert_load, then the three other
    families' values)."""
    fam = reg.get("moe_expert_load")
    series = [] if fam is None else (fam.children() if hasattr(fam, "children") else [fam])
    hist = (sum(h.count for h in series), round(sum(h.sum for h in series), 9))
    return (hist, *(_metric_sum(reg, n) for n in
                    ("moe_tokens_total", "moe_dropped_total", "moe_max_expert_share")))


@pytest.mark.parametrize("cf", ["2.0", "0.5"])
def test_dispatch_telemetry_equals_jax(monkeypatch, cf):
    """The moe_* families after one eager dispatch on the host, equal to
    what JAX's ``_record_load`` records on the same input (at 0.5 some
    slots are dropped)."""
    monkeypatch.setenv("MOE_CAPACITY_FACTOR", cf)
    jcfg = moe_cfg(4, 2)
    jmlp, tmlp = layer_mlp(jax_params(jcfg, seed=10))
    x = hidden(jcfg, b=1, t=6, seed=10)
    jreg, treg = jmetrics.get_registry(), tmetrics.get_registry()
    for reg in (jreg, treg):
        reg.reset()
        reg.enable()
    try:
        jax.block_until_ready(jmoe.sparse_moe_mlp(jcfg, jmlp, jnp.asarray(x), None))
        jax.effects_barrier()
        tmoe.sparse_moe_mlp(port_cfg(jcfg), tmlp, torch.from_numpy(x))
        got = _families(treg)
        assert got[1] == 12.0 and got[0][0] == 4
        assert got == _families(jreg)
        assert (got[2] > 0) == (cf == "0.5")
    finally:
        for reg in (jreg, treg):
            reg.disable()
            reg.reset()


def test_dispatch_telemetry_dark_by_default():
    jcfg = moe_cfg(4, 2)
    _, tmlp = layer_mlp(jax_params(jcfg, seed=12))
    reg = tmetrics.get_registry()
    reg.reset()
    assert not reg.enabled
    tmoe.sparse_moe_mlp(port_cfg(jcfg), tmlp, torch.from_numpy(hidden(jcfg, seed=12)))
    assert _families(reg) == ((0, 0.0), 0.0, 0.0, 0.0)


# -- what stays refused -------------------------------------------------------------

def test_training_an_moe_span_is_refused_naming_the_roadmap_item():
    jcfg = moe_cfg(4, 2)
    tcfg = port_cfg(jcfg)
    tp = bridged(jax_params(jcfg, seed=13))
    with pytest.raises(NotImplementedError, match="#4a-ii"):
        ttf.stack_forward_train(tcfg, tp["layers"], torch.zeros(1, 4, tcfg.hidden_size),
                                torch.arange(4)[None])
    spec = StagePlan.even(tcfg.num_layers, 2).stages[1]
    ex = StageExecutor(tcfg, spec, tmain._stage_params(port_args([]), tcfg, tp, spec),
                       device="cpu")
    req = StageRequest(session_id="t", hidden=torch.zeros(1, 4, tcfg.hidden_size),
                       seq_len=4, cur_len=0, is_prefill=True, max_length=16)
    with pytest.raises(StageExecutionError, match="#4a-ii"):
        ex.train_forward(req)


@pytest.mark.parametrize("mode", ["local", "serve"])
def test_cpu_offload_of_an_moe_model_exits_naming_the_roadmap_item(mode, monkeypatch):
    """The executor that owns the offload refuses an MoE span, and the CLI
    exits with its message (a tiny MoE config stands for the preset)."""
    tcfg = port_cfg(moe_cfg(4, 2))
    monkeypatch.setattr(tmain, "get_config", lambda name: tcfg)
    argv = ["--mode", mode, "--device", "cpu", "--model", "mixtral-8x7b", "--splits", "1",
            "--stage", "1", "--use_cpu_offload", "--registry_addr", "127.0.0.1:1"]
    with pytest.raises(SystemExit, match="#4a-ii"):
        tmain.main(argv)
    with pytest.raises(NotImplementedError, match="#4a-ii"):
        StageExecutor(tcfg, StagePlan.even(tcfg.num_layers, 1).stages[0], {}, device="cpu",
                      offload=True)


def test_local_mode_draws_an_moe_preset_a_span_at_a_time(monkeypatch):
    """``--mode local`` on a preset whose whole tree would take more than
    WHOLE_INIT_SHARE of the device's memory (mixtral-8x7b on an 80 GB
    card; here a tiny MoE on a host made small) loads no full tree: each
    stage draws its own span (every layer drawn in order), which equals
    the full init's slice."""
    jcfg = moe_cfg(4, 2, num_layers=3)
    tcfg = dataclasses.replace(port_cfg(jcfg))
    monkeypatch.setattr(tmain, "get_config", lambda name: tcfg)
    monkeypatch.setattr(tmain, "device_memory_bytes", lambda device: 1 << 16)
    args = port_args(["--mode", "local", "--splits", "1,2"])
    cfg, params = tmain.load_model(args)
    assert cfg is tcfg and params is None
    gen = torch.Generator().manual_seed(args.seed)
    full = ttf.init_params(tcfg, gen, dtype=torch.float32)
    for spec in tmain.stage_plan(args, tcfg).stages:
        got = dict(_leaves(tmain._stage_params(args, tcfg, None, spec)))
        want = dict(_leaves(tmain._stage_params(args, tcfg, full, spec)))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_local_mode_draws_a_preset_that_fits_whole(moe, monkeypatch):
    """The choice is the tree's size, not the family: a preset within
    WHOLE_INIT_SHARE of the device's memory is drawn whole, the tree
    `init_params` gives from the seed; the same preset past it is not."""
    jcfg = moe_cfg(4, 2) if moe else jconfig.llama_config(
        vocab_size=131, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
        intermediate_size=64, max_position_embeddings=256)
    tcfg = port_cfg(jcfg)
    monkeypatch.setattr(tmain, "get_config", lambda name: tcfg)
    args = port_args(["--mode", "local", "--splits", "1"])
    size = (tcfg.num_layers * params_per_block(tcfg) + 2 * tcfg.vocab_size * tcfg.hidden_size) * 4
    monkeypatch.setattr(tmain, "device_memory_bytes", lambda device: 2 * size)
    _, params = tmain.load_model(args)
    want = ttf.init_params(tcfg, torch.Generator().manual_seed(args.seed), dtype=torch.float32)
    got, want = dict(_leaves(params)), dict(_leaves(want))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    monkeypatch.setattr(tmain, "device_memory_bytes", lambda device: 2 * size - 1)
    assert tmain.load_model(args)[1] is None
