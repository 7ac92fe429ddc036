"""Failover in the port, ported from the reference's tests
(tests/test_runtime_pipeline.py:168-228 and tests/test_faults.py:222-256):
a stage server killed mid-generation is replaced by a replica that replays
the journal, with tokens identical to the port's oracle; a total outage
raises; a transient flake recovers; and the circuit breaker opens, probes
and readmits on an injected clock.

Tolerance: none. Greedy tokens must be equal: the replica holds the same
weights, and the replay rebuilds its KV cache from the same activations."""

import pytest

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    jax_params,
    one_torch_thread,
    port_args,
    port_cfg,
    tiny_llama_j,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    nf4_kernel as tnk,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    MAX_ATTEMPTS,
    CircuitBreaker,
)

GREEDY = SamplingParams(temperature=0.0)
# 4 layers: stage 0 [0,1) in the client, remote stages 1-3 of one layer each.
SPLITS = "1,2,3"


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_llama_j()
    return port_cfg(jcfg), bridged(jax_params(jcfg))


def _oracle(tcfg, params, quant, prompt, n):
    return tmain.make_oracle_generate(port_args(["--quant", quant]), tcfg, params)(
        prompt, n, GREEDY).tokens


@pytest.mark.parametrize("quant", ["int8", "nf4"])
def test_failover_mid_generation_preserves_tokens(monkeypatch, weights, quant):
    """Kill the pinned stage-2 server after its 3rd decode step; the client
    must fail over to the replica, replay the journal, and produce the
    oracle's tokens."""
    monkeypatch.setenv("NF4_KERNEL", "1")     # NF4: packed leaves, nf4_dot
    tcfg, params = weights
    client, transport = build_port_cluster(tcfg, params, SPLITS, replicas=2,
                                           quant=quant)
    prompt = [5, 9, 23, 7, 81]
    seen_decode_steps = [0]
    pinned = {}

    def on_call(peer_id, req):
        if not req.is_prefill and not req.is_replay and "s2" in peer_id:
            seen_decode_steps[0] += 1
            pinned.setdefault("peer", peer_id)
            if seen_decode_steps[0] == 3:
                transport.kill(peer_id)

    transport.on_call = on_call
    res = client.generate(prompt, max_new_tokens=8, sampling=GREEDY)
    assert res.tokens == _oracle(tcfg, params, quant, prompt, 8)
    assert client.recoveries >= 1
    killed = pinned["peer"]
    others = [p for p in transport.peers() if "s2" in p and p != killed]
    assert any(transport.executor(p).requests_served > 0 for p in others)
    assert killed in client.failed_peers["stage2"]
    # Every lease is released at the end, on the replica too.
    assert all(transport.executor(p).arena.used_bytes == 0
               for p in transport.peers() if p != killed)


def test_failover_total_outage_raises(weights):
    tcfg, params = weights
    client, transport = build_port_cluster(tcfg, params, SPLITS, replicas=1)
    for p in transport.peers():
        if "s3" in p:
            transport.kill(p)
    with pytest.raises(RuntimeError, match=f"all {MAX_ATTEMPTS} attempts failed"):
        client.generate([1, 2, 3], max_new_tokens=4, sampling=GREEDY)
    assert all(not sessions for sessions in client.journal.values())


def test_transient_flake_recovers_without_replacement_pool(weights):
    """fail_next models a transient network partition: same peer pool, the
    retry loop must eventually succeed via the replica."""
    tcfg, params = weights
    client, transport = build_port_cluster(tcfg, params, SPLITS, replicas=2)
    for p in transport.peers():
        if "s1" in p:
            transport.fail_next(p, 1)
    res = client.generate([5, 9, 23], max_new_tokens=6, sampling=GREEDY)
    assert res.tokens == _oracle(tcfg, params, "none", [5, 9, 23], 6)
    assert client.recoveries >= 1


def test_nf4_failover_replay_runs_the_kernel_path(monkeypatch, weights):
    """Under NF4_KERNEL=1 a replica's replay goes through nf4_dot at M > 1
    (here its plain version: the tensors are on the CPU)."""
    monkeypatch.setenv("NF4_KERNEL", "1")
    tcfg, params = weights
    client, transport = build_port_cluster(tcfg, params, SPLITS, replicas=2,
                                           quant="nf4")
    calls = []
    monkeypatch.setattr(tnk, "nf4_dot_reference",
                        lambda x, w, _f=tnk.nf4_dot_reference: calls.append(x.shape[0])
                        or _f(x, w))
    # Kill the stage-3 peer that served the prefill: the next decode step
    # fails over, and the replica replays the 4-token prompt chunk. The
    # executors pad each chunk to its sequence bucket, as the reference's
    # do: 4 tokens run at M = 8.
    transport.on_call = lambda peer, req: (
        transport.kill(peer) if req.is_prefill and not req.is_replay and "s3" in peer
        else None)
    client.generate([5, 9, 23, 7], max_new_tokens=3, sampling=GREEDY)
    assert client.recoveries == 1
    assert calls.count(8) >= 2 * 4             # prefill + replay, 4 sites


# -- circuit breaker state machine (injected clock, no sleeps) ----------------

def test_breaker_opens_probes_and_readmits():
    t = [0.0]
    br = CircuitBreaker(threshold=3, base_backoff_s=1.0, jitter=0.0,
                        now=lambda: t[0])
    for _ in range(2):
        br.record_failure("p")
    assert br.state("p") == "closed" and br.allow("p")
    br.record_failure("p")
    assert br.state("p") == "open"
    assert not br.allow("p")                 # backoff pending: dial skipped
    t[0] = 1.01
    assert br.allow("p")                     # the half-open single probe
    assert br.state("p") == "half_open"
    assert not br.allow("p")                 # no probe stampede
    br.record_success("p")                   # probe succeeded
    assert br.state("p") == "closed"         # full readmission, no
    assert br.allow("p")                     # blacklist clear needed


def test_breaker_failed_probe_doubles_backoff():
    t = [0.0]
    br = CircuitBreaker(threshold=3, base_backoff_s=1.0, jitter=0.0,
                        now=lambda: t[0])
    for _ in range(3):
        br.record_failure("p")
    t[0] = 1.01
    assert br.allow("p")
    br.record_failure("p")                   # probe failed -> re-open
    assert br.state("p") == "open"
    t[0] = 1.01 + 1.5
    assert not br.allow("p")                 # 2nd backoff is 2.0 s
    t[0] = 1.01 + 2.01
    assert br.allow("p")
