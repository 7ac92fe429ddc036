"""NF4 in the port against the JAX package: the quantizer is byte-identical
(packed codes and scale bits), the dequant bit-equal, ``nf4_dot``'s plain
version matches both the reference's Pallas kernel (run interpreted) and its
dequant-then-matmul fallback, the fusions concatenate NF4 leaves exactly,
``dequant_tree`` keeps NF4 packed only under ``NF4_KERNEL=1``, and the
port's ``--mode local --quant nf4`` gives JAX's greedy tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.nf4_kernel as jnk
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
    quant as jquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    array_to_torch,
    from_jax_tree,
    torch_to_array,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    nf4_kernel as tnk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    sampling as tsamp,
)

PROMPT = [72, 101, 108, 108, 111, 33]
STEPS = 10
# (name, weight shape): in_dim a multiple of 64 or not, 2-D or stacked.
SHAPES = {"2d": (256, 384), "2d_ragged": (100, 96), "stacked": (3, 128, 256),
          "stacked_ragged": (2, 72, 40)}


def _bits(a):
    """numpy view for a bitwise comparison (bfloat16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _weight(shape, dtype, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.02
    w[..., :3, 0] = 0.0            # an all-zero corner is a block's edge case
    return jnp.asarray(w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_quantizer_byte_identical_and_dequant_bit_equal(shape, dtype):
    w = _weight(SHAPES[shape], jnp.dtype(dtype))
    jt = jquant._quantize_leaf_nf4(w)
    tt = tquant._quantize_leaf_nf4(array_to_torch(np.asarray(w)))
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(torch_to_array(tt.scales), _bits(jt.scales))
    assert (tt.in_dim, tt.dtype, tt.shape) == (jt.in_dim, jt.dtype, jt.shape)
    np.testing.assert_array_equal(torch_to_array(tt.dequant()), _bits(jt.dequant()))
    # The bridge carries the reference's leaf across unchanged.
    bt = from_jax_tree(jax.tree.map(np.asarray, {"w": jt}))["w"]
    assert isinstance(bt, tquant.NF4Tensor)
    assert torch.equal(bt.packed, tt.packed) and torch.equal(bt.scales, tt.scales)


def _ulp_bf16(scale):
    return scale * 2.0 ** -7    # one bf16 ulp at the output's scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_nf4_dot_reference_matches_pallas_kernel_and_fallback(monkeypatch, m, dtype):
    """Against the reference's Pallas kernel run by the interpreter, and its
    dequant-then-matmul fallback. float32: relative 1e-5 (sums in another
    order); bfloat16: within one bf16 ulp at the output's scale (the
    outputs round to bf16 after sums in another order)."""
    monkeypatch.setattr(jnk, "_INTERPRET", True)
    jdt = jnp.dtype(dtype)
    w = _weight((256, 384), jdt, seed=m)
    jt = jquant._quantize_leaf_nf4(w)
    x = jnp.asarray(np.random.default_rng(100 + m).standard_normal((m, 256))
                    .astype(np.float32), jdt)
    launches = jnk._launches
    want_kernel = np.asarray(jnk.nf4_dot(x, jt), np.float32)
    assert jnk._launches == launches + 1            # the Pallas path ran
    want_fallback = np.asarray(x @ jt.dequant().astype(jdt), np.float32)
    tt = from_jax_tree(jax.tree.map(np.asarray, {"w": jt}))["w"]
    got = tnk.nf4_dot(array_to_torch(np.asarray(x)), tt)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, 384)
    got = got.float().numpy()
    for want in (want_kernel, want_fallback):
        if dtype == "float32":
            assert_close(got, want, rtol=1e-5, atol=0.0)
        else:
            assert_close(got, want, rtol=0.0, atol=_ulp_bf16(float(np.abs(want).max())))


def test_nf4_dot_ragged_shape_matches_fallback():
    """in_dim 100 (padded to 128), N 96, leading dims: the shape the
    reference's kernel refuses, against its dequant-then-matmul fallback."""
    w = _weight((100, 96), jnp.float32, seed=3)
    jt = jquant._quantize_leaf_nf4(w)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((2, 3, 100))
                    .astype(np.float32))
    want = np.asarray(jnk.nf4_dot(x, jt))               # CPU: the fallback
    tt = from_jax_tree(jax.tree.map(np.asarray, {"w": jt}))["w"]
    got = tnk.nf4_dot(array_to_torch(np.asarray(x)), tt)
    assert tuple(got.shape) == (2, 3, 96)
    assert_close(got.numpy(), want, rtol=1e-5, atol=0.0)


def test_nf4_dot_refuses_other_devices_and_counts_no_cpu_launch():
    tt = tquant._quantize_leaf_nf4(torch.randn(64, 32))
    before = tnk._launches
    tnk.nf4_dot(torch.randn(2, 64), tt)
    assert tnk._launches == before                  # the plain version ran
    with pytest.raises(ValueError):
        tnk.nf4_dot(torch.randn(2, 64, device="meta"), tt)


def test_concat_out_axis_is_exact_for_nf4():
    ws = [tquant._quantize_leaf_nf4(torch.randn(2, 128, n) * 0.02) for n in (64, 32, 32)]
    fused = ttf._concat_out_axis(ws)
    assert isinstance(fused, tquant.NF4Tensor) and fused.shape == (2, 128, 128)
    assert torch.equal(fused.dequant(), torch.cat([w.dequant() for w in ws], dim=-1))
    x = torch.randn(3, 128)
    layer = tquant.tree_map(lambda a: a[1], fused)
    assert torch.equal(tnk.nf4_dot(x, layer),
                       torch.cat([tnk.nf4_dot(x, tquant.tree_map(lambda a: a[1], w))
                                  for w in ws], dim=-1))
    # Mismatched in_dim or dtype refuse to fuse (the fusion then no-ops).
    other_in = tquant._quantize_leaf_nf4(torch.randn(2, 100, 32))
    other_dtype = tquant._quantize_leaf_nf4(torch.randn(2, 128, 32).to(torch.bfloat16))
    assert ttf._concat_out_axis([ws[0], other_in]) is None
    assert ttf._concat_out_axis([ws[0], other_dtype]) is None
    assert ttf._concat_out_axis([ws[0], torch.randn(2, 128, 32)]) is None


@pytest.mark.parametrize("flag", ["0", "1"])
def test_dequant_tree_keeps_2d_nf4_only_under_flag(monkeypatch, flag):
    monkeypatch.setenv("NF4_KERNEL", flag)
    stacked = tquant._quantize_leaf_nf4(torch.randn(2, 128, 64))
    layer = tquant.tree_map(lambda a: a[0], stacked)
    out = tquant.dequant_tree({"a": layer, "b": stacked, "c": torch.ones(3)})
    assert isinstance(out["a"], tquant.NF4Tensor) == (flag == "1")
    assert torch.is_tensor(out["b"]) and tuple(out["b"].shape) == (2, 128, 64)
    assert torch.equal(out["c"], torch.ones(3))
    # The reference agrees on which leaves stay packed.
    jl = jquant._quantize_leaf_nf4(jnp.asarray(layer.dequant().numpy()))
    jout = jquant.dequant_tree({"a": jl})
    assert isinstance(jout["a"], jquant.NF4Tensor) == (flag == "1")


SPLITS = {"even4": [], "splits2": ["--splits", "2"]}


@pytest.fixture(scope="module")
def nf4_jax_tokens():
    """The weights, and JAX's --mode local --quant nf4 greedy tokens per
    split (at JAX's default NF4_KERNEL=0: on the CPU its NF4_KERNEL=1 path
    is the same dequant-then-matmul, so one run per split serves both)."""
    jcfg = tiny_llama_j()
    jp = jax_params(jcfg)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NF4_KERNEL", "0")
        want = {}
        for name, extra in SPLITS.items():
            jgen, _ = jax_mode_generate(mp, ["--mode", "local", "--quant", "nf4"] + extra,
                                        jcfg, jp)
            want[name] = jgen(PROMPT, STEPS,
                              sampling=jsamp.SamplingParams(temperature=0.0)).tokens
    finally:
        mp.undo()
    return jcfg, bridged(jp), want


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("splits", sorted(SPLITS))
def test_local_nf4_greedy_tokens_match_jax(monkeypatch, nf4_jax_tokens, splits, flag):
    monkeypatch.setenv("NF4_KERNEL", flag)
    jcfg, tp, want = nf4_jax_tokens
    assert len(want[splits]) == STEPS
    argv = ["--mode", "local", "--quant", "nf4"] + SPLITS[splits]
    client = tmain.build_local_client(port_args(argv), port_cfg(jcfg), tp)
    stage1 = client.transport.executor("server-stage1").params["layers"]
    assert isinstance(stage1["attn"]["wqkv"], tquant.NF4Tensor)      # fused NF4
    assert isinstance(stage1["mlp"]["wgu"], tquant.NF4Tensor)
    calls = []
    monkeypatch.setattr(tnk, "nf4_dot_reference",
                        lambda x, w, _f=tnk.nf4_dot_reference: calls.append(1) or _f(x, w))
    got = client.generate(PROMPT, STEPS, sampling=tsamp.SamplingParams(temperature=0.0))
    assert got.tokens == want[splits]
    # NF4_KERNEL=1: 4 nf4_dot sites per layer per step (plain version on
    # the CPU); NF4_KERNEL=0: the weights are dequantized, nf4_dot unused.
    assert len(calls) == (4 * jcfg.num_layers * STEPS if flag == "1" else 0)
