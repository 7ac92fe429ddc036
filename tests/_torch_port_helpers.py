"""Shared fixtures of the tests/test_torch_*.py files: tiny configs built
identically in both packages, and JAX weights bridged to the port.

The port runs on the CPU here, where every kernel wrapper takes its plain
PyTorch version. Tolerances are float32 against the conftest's
``jax_default_matmul_precision=highest``: the two frameworks sum in other
orders, so values agree to a few float32 ulps of the largest magnitude
involved, not bit for bit.
"""

import dataclasses

import jax
import numpy as np

from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    config as jconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.transformer import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.quant import (
    quantize_params as j_quantize_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    config as tconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    from_jax_tree,
)

# float32 parity: relative to the compared tensor's scale (see docstring).
RTOL = 1e-5
ATOL = 1e-5


def tiny_llama_j():
    """hidden 256, 4 layers, 4 heads / 2 kv heads, ffn 512, vocab 512, with
    the llama3 RoPE remap; every projection's K and N are multiples of 128
    so the reference's Pallas int8 kernel can run in interpret mode."""
    return dataclasses.replace(jconfig.llama_config(
        vocab_size=512, hidden_size=256, num_layers=4, num_heads=4,
        num_kv_heads=2, intermediate_size=512, max_position_embeddings=131072,
        rope_theta=500000.0), rope_scaling=(8.0, 1.0, 4.0, 8192))


def tiny_gpt2_j():
    return jconfig.gpt2_config(vocab_size=512, hidden_size=256, num_layers=4,
                               num_heads=4, max_position_embeddings=128)


def port_cfg(jcfg):
    """The port's ModelConfig with the same field values."""
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def jax_params(jcfg, quant="none", seed=0):
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    if quant != "none":
        params = j_quantize_params(params, quant)
    return params


def bridged(jparams):
    """JAX param tree -> the port's tree on the CPU (same weights)."""
    return from_jax_tree(jax.tree.map(np.asarray, jparams), "cpu")


def assert_close(actual, expected, rtol=RTOL, atol=ATOL):
    """max|a - e| <= atol + rtol * max|e| (scale-relative float32 parity)."""
    a = np.asarray(actual, np.float64)
    e = np.asarray(expected, np.float64)
    assert a.shape == e.shape, (a.shape, e.shape)
    err = float(np.max(np.abs(a - e))) if a.size else 0.0
    bound = atol + rtol * float(np.max(np.abs(e))) if e.size else atol
    assert err <= bound, f"max abs err {err:.3e} > {bound:.3e}"
