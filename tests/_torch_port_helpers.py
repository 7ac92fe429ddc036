"""Shared fixtures of the tests/test_torch_*.py files: tiny configs built
identically in both packages, and JAX weights bridged to the port.

The port runs on the CPU here, where every kernel wrapper takes its plain
PyTorch version. Tolerances are float32 against the conftest's
``jax_default_matmul_precision=highest``: the two frameworks sum in other
orders, so values agree to a few float32 ulps of the largest magnitude
involved, not bit for bit.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    main as jmain,
)
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    from_jax_tree,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
    parse_splits,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    PipelineClient,
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    LocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a port test module on one torch thread, then restore the count.

    The suite runs in several worker processes at once; torch's intra-op
    threads in each oversubscribe the cores and made the port's tests (and
    the workers beside them) several times slower, while the tiny models
    here gain nothing from them. Each port test module imports this
    fixture, which is what makes it apply there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def jax_params(jcfg, quant="none", seed=0, dtype=None):
    params = (j_init_params(jax.random.PRNGKey(seed), jcfg) if dtype is None
              else j_init_params(jax.random.PRNGKey(seed), jcfg, dtype))
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


def jax_mode_generate(monkeypatch, argv, jcfg, jparams):
    """The generate function that the JAX package's ``main`` builds for
    ``--mode local`` or ``--mode oracle`` (per `argv`), with its report
    swapped for a capture of the function. Returns (generate, args)."""
    captured = []
    monkeypatch.setattr(jmain, "_generate_and_report",
                        lambda args, fn, cfg, **kw: captured.append(fn) or 0)
    args = jmain.build_parser().parse_args(argv)
    {"local": jmain.run_local, "oracle": jmain.run_oracle}[args.mode](args, jcfg, jparams)
    return captured[0], args


def port_args(argv):
    """The port's CLI namespace for `argv`, on the CPU."""
    return tmain.build_parser().parse_args(argv + ["--device", "cpu"])


def build_port_cluster(tcfg, params, splits, replicas=1, quant="none", seed=0):
    """The port's in-process cluster with `replicas` executors per remote
    stage (peer ids ``peer-s{stage}-r{replica}``), as the reference's
    tests/test_runtime_pipeline.py builds it; no settle pause after replay."""
    args = port_args(["--quant", quant, "--seed", str(seed)])
    plan = StagePlan.from_splits(tcfg.num_layers, parse_splits(splits))
    transport = LocalTransport()
    registry = PlacementRegistry(rng=random.Random(seed))
    for spec in plan.stages[1:]:
        for r in range(replicas):
            peer = f"peer-s{spec.index}-r{r}"
            transport.add_peer(peer, StageExecutor(
                tcfg, spec, tmain._stage_params(args, tcfg, params, spec),
                peer_id=peer, device="cpu"))
            registry.register(make_server_record(peer, spec))
    stage0 = StageExecutor(tcfg, plan.stages[0],
                           tmain._stage_params(args, tcfg, params, plan.stages[0]),
                           peer_id="client-local", device="cpu")
    client = PipelineClient(tcfg, plan, stage0, transport, registry,
                            settle_seconds=0.0, seed=seed)
    return client, transport
