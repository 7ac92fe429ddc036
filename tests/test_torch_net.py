"""The port's wire bytes equal the JAX package's.

The native codec (``csrc/codec.cpp``, a copy of the reference's) and its
plain numpy versions against the reference's on the same float32 input,
RNE ties, infinities, signalling and quiet NaNs and denormals among it;
CRC-32C on random payloads; whole frames captured off a socket pair;
chunked frames across the two packages; corrupted checksums; and the
request header of the same request in both packages.

Tolerance: none. Every comparison is of bytes.
"""

import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    native as jnative,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    messages as jmessages,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    net as jnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    native as tnative,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams as TSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    messages as tmessages,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    net as tnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.utils import (
    cuda_build,
)

SOCKET_TIMEOUT_S = 10.0
NETS = {"jax": jnet, "port": tnet}


def _special_floats() -> np.ndarray:
    """float32 values that exercise every branch of the RNE rule: exact
    ties to even and odd, values just either side of a tie, infinities,
    signalling and quiet NaNs with payloads, denormals, signed zeros and
    the largest finites (which round to infinity), then 64k random bit
    patterns."""
    bits = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000,   # +-0, +-inf
            0x7FC00000, 0xFFC00000, 0x7FC12345,               # quiet NaNs
            0x7F800001, 0x7FA00000, 0xFF800001, 0x7FBFFFFF,   # signalling NaNs
            0x00000001, 0x00008000, 0x00018000, 0x007FFFFF,   # denormals
            0x80000001, 0x807F8000,
            0x3F808000, 0x3F818000,                           # ties: even / odd
            0x3F807FFF, 0x3F808001, 0x3F817FFF, 0x3F818001,   # around ties
            0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7FFFFF]   # largest finites
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2 ** 32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([np.array(bits, np.uint32), rand]).view(np.float32)


def _jax_plain(monkeypatch):
    """The reference's numpy fallbacks: its loader answers 'no library'."""
    monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.mark.parametrize("impl", ["native", "plain"])
def test_fp32_to_bf16_bit_equal(monkeypatch, impl):
    x = _special_floats()
    want = jnative.fp32_to_bf16_bytes(x)          # the reference's library
    if impl == "native":
        got = tnative.fp32_to_bf16_bytes(x)
        assert tnative.have_native()
    else:
        got = tnative.fp32_to_bf16_bytes_reference(x)
        _jax_plain(monkeypatch)
        assert jnative.fp32_to_bf16_bytes(x) == want
    assert got == want
    out = np.frombuffer(got, np.uint16)
    assert out[2] == 0x7F80 and out[4] == 0x7FC0 and out[7] == 0x7FC0  # inf, qNaN, sNaN quieted
    assert out[17] == 0x3F80 and out[18] == 0x3F82                      # ties to even


@pytest.mark.parametrize("impl", ["native", "plain"])
def test_bf16_to_fp32_bit_equal_on_every_pattern(monkeypatch, impl):
    data = np.arange(1 << 16, dtype=np.uint16).tobytes()
    want = jnative.bf16_bytes_to_fp32(data, (256, 256)).view(np.uint32)
    if impl == "native":
        got = tnative.bf16_bytes_to_fp32(data, (256, 256))
    else:
        got = tnative.bf16_bytes_to_fp32_reference(data, (256, 256))
        _jax_plain(monkeypatch)
        np.testing.assert_array_equal(
            jnative.bf16_bytes_to_fp32(data, (256, 256)).view(np.uint32), want)
    assert got.shape == (256, 256) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_crc32c_equal_on_random_payloads():
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 64, 1000, 4099):
        data = rng.bytes(n)
        want = jnative.crc32c(data)
        assert tnative.crc32c(data) == want
        assert tnative.crc32c(bytearray(data)) == want
        assert tnative.crc32c_reference(data) == want
    assert tnative.crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value


def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    """No quiet fallback: a failed host build raises with the compiler's
    message."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        cuda_build.load_host_library("broken.cpp")


def _captured(send) -> bytes:
    """Every byte `send(sock)` writes, read off the other end of a pair."""
    a, b = socket.socketpair()
    a.settimeout(SOCKET_TIMEOUT_S)
    b.settimeout(SOCKET_TIMEOUT_S)
    chunks = []

    def reader():
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return
            chunks.append(chunk)

    t = threading.Thread(target=reader)
    t.start()
    try:
        send(a)
    finally:
        a.close()
        t.join(SOCKET_TIMEOUT_S)
        b.close()
    assert not t.is_alive()
    return b"".join(chunks)


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16", "int32"])
def test_send_frame_bytes_equal(wire_dtype):
    rng = np.random.default_rng(2)
    if wire_dtype == "int32":
        arr = rng.integers(0, 512, (1, 7), dtype=np.int64).astype(np.int32)
    else:
        arr = _special_floats()[:3 * 5 * 16].reshape(3, 5, 16)
    header = {"verb": "hidden", "session_id": "s-1", "cache_len": 12}
    frames = {}
    for pkg, net in NETS.items():
        meta, body = net._encode_tensor(arr, wire_dtype)
        frames[pkg] = _captured(
            lambda s, net=net, meta=meta, body=body: net._send_frame(
                s, dict(header, tensor=meta), body))
    assert frames["port"] == frames["jax"]
    assert frames["port"].startswith(b"MPT1")


@pytest.mark.parametrize("sender,receiver", [("port", "port"), ("port", "jax"),
                                             ("jax", "port"), ("jax", "jax")])
def test_chunked_frames_round_trip_across_packages(monkeypatch, sender, receiver):
    """Payloads above CHUNK_SIZE stream as per-chunk-CRC'd segments; the
    receiver of either package reassembles what the sender of either
    package chunked (with the preallocation threshold crossed midway)."""
    for net in NETS.values():
        monkeypatch.setattr(net, "CHUNK_SIZE", 64)
        monkeypatch.setattr(net, "PREALLOC_COMMIT", 256)
    payload = np.random.default_rng(3).bytes(64 * 20 + 17)
    raw = _captured(lambda s: NETS[sender]._send_frame(s, {"verb": "x", "n": 1}, payload))
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(SOCKET_TIMEOUT_S)
        a.sendall(raw)
        header, got = NETS[receiver]._recv_frame(b)
    assert header == {"verb": "x", "n": 1}
    assert bytes(got) == payload


@pytest.mark.parametrize("where", ["payload", "chunk"])
def test_corrupted_checksum_raises_wire_error(monkeypatch, where):
    payload = bytes(range(256)) * 3
    if where == "chunk":
        monkeypatch.setattr(tnet, "CHUNK_SIZE", 100)
    raw = bytearray(_captured(lambda s: tnet._send_frame(s, {"verb": "x"}, payload)))
    raw[-1] ^= 0xFF        # the trailing CRC of the frame or of its last chunk
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(SOCKET_TIMEOUT_S)
        a.sendall(bytes(raw))
        with pytest.raises(tnet.WireError, match="checksum mismatch"):
            tnet._recv_frame(b)
    assert issubclass(tnet.WireError, ConnectionError)


REQUESTS = {
    "plain": {},
    "replay": {"is_replay": True, "generated_tokens": (5, 9, 9)},
    "traced": {"trace": {"trace_id": "ab" * 8, "parent": "cd" * 4, "hop": 1},
               "deadline_budget_s": 2.5, "priority": 0.25, "prefix_len": 6},
    "exotic": {"hypo_ids": (0, 0), "num_logprobs": 3, "draft_tokens": (1, 2),
               "start_from_position": 4, "burst_len": 4, "burst_budget": 3,
               "eos_token_id": 2, "next_servers": ({"peer_id": "p", "start_block": 2,
                                                     "end_block": 3},)},
}


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_request_header_json_equal(kind):
    fields = dict(session_id="sess-7", seq_len=6, cur_len=0, is_prefill=True,
                  max_length=32, step_seed=11, start_block=1, end_block=3,
                  **REQUESTS[kind])
    hidden = np.random.default_rng(4).standard_normal((1, 6, 8)).astype(np.float32)
    jreq = jmessages.StageRequest(hidden=jnp.asarray(hidden),
                                  sampling=JSamplingParams(0.7, 0.9, 50, 1.5), **fields)
    treq = tmessages.StageRequest(hidden=torch.from_numpy(hidden),
                                  sampling=TSamplingParams(0.7, 0.9, 50, 1.5), **fields)
    jmeta, jbody = jnet._encode_tensor(np.asarray(jreq.hidden), "bf16")
    tmeta, tbody = tnet._encode_tensor(tnet._host_array(treq.hidden), "bf16")
    assert tbody == jbody
    jhdr = json.dumps(jnet._request_header(jreq, jmeta, model="m"))
    thdr = json.dumps(tnet._request_header(treq, tmeta, model="m"))
    assert thdr == jhdr
    # The port parses the reference's header back into the same request.
    back = tnet._header_to_request(json.loads(jhdr), jbody)
    for name, value in fields.items():
        assert getattr(back, name) == value, name
    assert back.model == "m" and back.sampling == treq.sampling
    np.testing.assert_array_equal(back.hidden.numpy(),
                                  tnative.bf16_bytes_to_fp32(tbody, (1, 6, 8)))
