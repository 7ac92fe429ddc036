"""Port vs JAX on the whole model: the weight bridge round trip, then
full_forward logits through a prefill and 8 cached decode steps for a tiny
llama (with the llama3 RoPE remap) and a tiny gpt2, at --quant none and
int8; and the port's 2-stage stage_forward chain equals its full_forward."""

import functools

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
    tiny_gpt2_j,
    tiny_llama_j,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    transformer as jtf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    partition as tpart,
    quant as tquant,
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    array_to_torch,
    torch_to_array,
)

FAMILIES = {"llama": tiny_llama_j, "gpt2": tiny_gpt2_j}
PROMPT = np.array([[72, 101, 108, 108, 111, 33]], np.int32)
DECODE = [5, 400, 17, 17, 256, 3, 99, 511]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trip_is_bit_exact(dtype):
    jcfg = tiny_llama_j()
    jp = jax.tree.map(lambda a: a.astype(dtype), jax_params(jcfg))
    jq = jax.tree.map(np.asarray, jax_params(jcfg, "int8"))
    tp, tq = bridged(jp), bridged(jq)
    assert tp["layers"]["attn"]["wq"].dtype == getattr(torch, jnp.dtype(dtype).name)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for p in path:
            node = node[p.key]
        got = torch_to_array(node)
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(got, want)
    wq_t, wq_j = tq["layers"]["attn"]["wq"], jq["layers"]["attn"]["wq"]
    assert isinstance(wq_t, tquant.QuantizedTensor)
    np.testing.assert_array_equal(wq_t.q.numpy(), wq_j.q)
    np.testing.assert_array_equal(wq_t.s.numpy(), wq_j.s)
    # bf16 back through the bit view.
    x = jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16)
    np.testing.assert_array_equal(torch_to_array(array_to_torch(np.asarray(x))),
                                  np.asarray(x).view(np.uint16))


@functools.lru_cache(maxsize=None)
def _jax_forward():
    return jax.jit(jtf.full_forward, static_argnums=0)


def _run_jax(jcfg, jp, max_len=32):
    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, max_len)
    fwd = _jax_forward()
    logits, kc, vc = fwd(jcfg, jp, jnp.asarray(PROMPT), kc, vc, jnp.int32(0))
    out = [np.asarray(logits)]
    cur = PROMPT.shape[1]
    for tok in DECODE:
        logits, kc, vc = fwd(jcfg, jp, jnp.asarray([[tok]], jnp.int32), kc, vc,
                             jnp.int32(cur))
        out.append(np.asarray(logits))
        cur += 1
    return out


def _run_port(tcfg, tp, max_len=32):
    kc, vc = ttf.init_kv_cache(tcfg, tcfg.num_layers, 1, max_len)
    logits, kc, vc = ttf.full_forward(tcfg, tp, torch.from_numpy(PROMPT).long(), kc, vc, 0)
    out = [logits.numpy()]
    cur = PROMPT.shape[1]
    for tok in DECODE:
        logits, kc, vc = ttf.full_forward(tcfg, tp, torch.tensor([[tok]]), kc, vc, cur)
        out.append(logits.numpy())
        cur += 1
    return out


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_forward_logits_match_jax(family, quant):
    jcfg = FAMILIES[family]()
    jp = jax_params(jcfg, quant)
    want = _run_jax(jcfg, jp)
    got = _run_port(port_cfg(jcfg), bridged(jp))
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, step
        assert_close(g, w)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_two_stage_chain_equals_full_forward(quant):
    jcfg = tiny_llama_j()
    tcfg = port_cfg(jcfg)
    tp = bridged(jax_params(jcfg, quant))
    plan = tpart.StagePlan.from_splits(tcfg.num_layers, [2])
    want = _run_port(tcfg, tp)
    stage_params = [tpart.slice_stage_params(tcfg, tp, s) for s in plan.stages]
    caches = [ttf.init_kv_cache(tcfg, s.num_layers, 1, 32) for s in plan.stages]
    cur = 0
    for step, ids in enumerate([PROMPT] + [np.array([[t]], np.int32) for t in DECODE]):
        x = torch.from_numpy(ids).long()
        for spec, sp, (kc, vc) in zip(plan.stages, stage_params, caches):
            x, _, _ = tpart.stage_forward(tcfg, spec, sp, x, kc, vc, cur)
        cur += ids.shape[1]
        np.testing.assert_array_equal(x.numpy(), want[step])
