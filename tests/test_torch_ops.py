"""Port vs JAX: norms, rotary (with and without the llama3 remap), the KV
cache write and cached attention. Same numpy inputs through both; float32
tolerance from _torch_port_helpers (a few ulps of the output's scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    one_torch_thread,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    attention as jatt,
    norms as jnorms,
    rotary as jrot,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    attention as tatt,
    norms as tnorms,
    rotary as trot,
)

LLAMA3 = (8.0, 1.0, 4.0, 8192)


@pytest.fixture
def r():
    return np.random.default_rng(1234)


def test_rms_and_layer_norm_match(r):
    x = r.standard_normal((2, 5, 256)).astype(np.float32) * 3
    w = r.standard_normal(256).astype(np.float32)
    b = r.standard_normal(256).astype(np.float32)
    assert_close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
                 jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    assert_close(tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b)),
                 jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("scaling", [None, LLAMA3])
def test_rope_tables_and_rotation_match(r, scaling):
    hd, theta = 64, 500000.0
    assert_close(trot.rope_frequencies(hd, theta, scaling),
                 jrot.rope_frequencies(hd, theta, scaling))
    pos = r.integers(0, 20000, size=(2, 7)).astype(np.int32)
    tc, ts = trot.rope_cos_sin(torch.from_numpy(pos), hd, theta, scaling)
    jc, js = jrot.rope_cos_sin(jnp.asarray(pos), hd, theta, scaling)
    assert_close(tc, jc)
    assert_close(ts, js)
    x = r.standard_normal((2, 7, 4, hd)).astype(np.float32)
    assert_close(trot.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                                 torch.from_numpy(np.array(js))),
                 jrot.apply_rope(jnp.asarray(x), jc, js))


def test_update_kv_cache_matches(r):
    kc = r.standard_normal((2, 16, 2, 8)).astype(np.float32)
    vc = r.standard_normal((2, 16, 2, 8)).astype(np.float32)
    kn = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    vn = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    jk, jv = jatt.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                  jnp.asarray(vn), jnp.int32(5))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tatt.update_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        tatt.update_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), 14)


@pytest.mark.parametrize("cache_len,t,window", [
    (0, 6, None),     # prefill into an empty cache
    (5, 1, None),     # decode over a partly filled cache
    (4, 3, None),     # a multi-token step after a prefix
    (9, 1, 4),        # decode with a sliding window
])
def test_cached_attention_matches(r, cache_len, t, window):
    b, s, h, hkv, dh = 2, 16, 4, 2, 8
    q = r.standard_normal((b, t, h, dh)).astype(np.float32)
    # Garbage past cache_len + t: both must mask it.
    kc = r.standard_normal((b, s, hkv, dh)).astype(np.float32)
    vc = r.standard_normal((b, s, hkv, dh)).astype(np.float32)
    want = jatt.cached_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.int32(cache_len), sliding_window=window)
    got = tatt.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), cache_len,
                                sliding_window=window)
    assert_close(got, want)
