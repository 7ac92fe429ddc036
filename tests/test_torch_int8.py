"""Port vs JAX: int8 quantization, the int8_dot plain version (what the
port runs on the CPU) against both reference paths — the XLA mixed-dtype
dot and the Pallas kernel in interpret mode — the exact quantized output-
axis concat, and dequant_tree's INT8_FOLD rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    one_torch_thread,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    quant as jquant,
    transformer as jtf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    int8_kernel as jk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    array_to_torch,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    int8_kernel as tk,
)


@pytest.fixture
def r():
    return np.random.default_rng(7)


def _weight(r, shape, dtype=np.float32):
    w = (0.02 * r.standard_normal(shape)).astype(np.float32)
    w[..., 3] = 0.0                       # an all-zero output channel (s = 1)
    return jnp.asarray(w, dtype)


@pytest.mark.parametrize("shape,dtype", [((256, 512), jnp.float32),
                                         ((3, 256, 384), jnp.float32),
                                         ((2, 128, 256), jnp.bfloat16)])
def test_quantize_leaf_bytes_identical(r, shape, dtype):
    w = _weight(r, shape, dtype)
    jq = jquant._quantize_leaf(w)
    tq = tquant._quantize_leaf(array_to_torch(np.asarray(w)))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
    assert tq.dtype == jq.dtype


def _quantized(r, k, n):
    jw = jquant._quantize_leaf(_weight(r, (k, n)))
    tw = tquant.QuantizedTensor(array_to_torch(np.asarray(jw.q)),
                                array_to_torch(np.asarray(jw.s)), jw.dtype)
    return jw, tw


@pytest.mark.parametrize("m", [1, 5, 16])
def test_int8_dot_plain_matches_xla_and_pallas_interpret(r, m, monkeypatch):
    jw, tw = _quantized(r, 256, 512)
    x = r.standard_normal((m, 256)).astype(np.float32)
    got = tk.int8_dot(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 512)
    assert tk._launches == 0               # the CPU takes the plain version
    assert_close(got, jk.int8_dot(jnp.asarray(x), jw))        # XLA path
    monkeypatch.setattr(jk, "_INTERPRET", True)
    before = jk._launches
    pallas = jk.int8_dot(jnp.asarray(x), jw)
    assert jk._launches == before + 1      # really took the Pallas kernel
    assert_close(got, pallas)


def test_int8_dot_ragged_shape_matches_xla(r):
    jw, tw = _quantized(r, 200, 300)
    x = r.standard_normal((3, 2, 200)).astype(np.float32)
    got = tk.int8_dot(torch.from_numpy(x), tw)
    assert tuple(got.shape) == (3, 2, 300)
    assert_close(got, jk.int8_dot(jnp.asarray(x), jw))


def test_int8_dot_bfloat16_activations_match_xla(r):
    jw, tw = _quantized(r, 256, 384)
    x = jnp.asarray(r.standard_normal((4, 256)), jnp.bfloat16)
    got = tk.int8_dot(array_to_torch(np.asarray(x)), tw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jk.int8_dot(x, jw).astype(jnp.float32))
    # Both accumulate in float32 and round once to bfloat16: at most one
    # bf16 ulp (2^-8 relative) apart where the sums straddle a rounding
    # boundary.
    assert_close(got.float(), want, rtol=2.0 ** -7, atol=0.0)


def test_concat_out_axis_quantized_is_exact(r):
    leaves_j = [jquant._quantize_leaf(_weight(r, (2, 256, n))) for n in (256, 128, 128)]
    leaves_t = [tquant.QuantizedTensor(array_to_torch(np.asarray(w.q)),
                                       array_to_torch(np.asarray(w.s)), w.dtype)
                for w in leaves_j]
    fj = jtf._concat_out_axis(leaves_j)
    ft = ttf._concat_out_axis(leaves_t)
    np.testing.assert_array_equal(ft.q.numpy(), np.asarray(fj.q))
    np.testing.assert_array_equal(ft.s.numpy(), np.asarray(fj.s))
    # Mixed leaf types do not fuse.
    assert ttf._concat_out_axis([leaves_t[0], torch.zeros(2, 256, 8)]) is None


@pytest.mark.parametrize("fold", ["1", "0"])
def test_dequant_tree_keeps_2d_int8_packed_only_under_fold(r, fold, monkeypatch):
    monkeypatch.setenv("INT8_FOLD", fold)
    j2d = jquant._quantize_leaf(_weight(r, (256, 128)))
    j3d = jquant._quantize_leaf(_weight(r, (2, 128, 128)))
    t2d, t3d = (tquant.QuantizedTensor(array_to_torch(np.asarray(w.q)),
                                       array_to_torch(np.asarray(w.s)), w.dtype)
                for w in (j2d, j3d))
    jout = jquant.dequant_tree({"a": j2d, "b": j3d, "n": jnp.ones(3)})
    tout = tquant.dequant_tree({"a": t2d, "b": t3d, "n": torch.ones(3)})
    assert isinstance(tout["a"], tquant.QuantizedTensor) == (fold == "1")
    assert isinstance(jout["a"], jquant.QuantizedTensor) == (fold == "1")
    assert isinstance(tout["b"], torch.Tensor)        # stacks always materialize
    np.testing.assert_array_equal(tout["b"].numpy(), np.asarray(jout["b"]))
    if fold == "0":
        np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
