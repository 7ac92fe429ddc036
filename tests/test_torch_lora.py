"""LoRA adapters (``models/lora.py``) and ``--lora`` in the port against the
JAX package's, on the same weights and the same adapter files.

Covered: `merge_lora` on the canonical ``wq/wk/wv/wo`` layout and on the
engine-fused ``wqkv`` one against the reference's, float32 bit for bit
and bfloat16 within one bf16 ulp; `slice_lora`, `lora_to_list` /
`lora_from_list` and `target_out_dim` against the reference's;
`init_lora`'s shapes and its zero delta; an adapter ``.npz`` written by
either package loaded by the other; `_maybe_lora`'s full-depth check;
``load_stage_model`` with ``--lora`` equal to the full init's merged
slice; ``--mode local --lora`` (``--quant none`` and ``int8``) printing
the ``TOKENS=`` of the reference's ``--mode local --lora`` and other
tokens than without the adapter, ``--mode oracle --lora`` the same
tokens; and a ``registry`` / ``serve`` / ``client`` swarm over TCP, every
process with ``--lora``, printing ``--mode local --lora``'s tokens.

Tolerance: merged weights exactly in float32 (both packages take one
float32 product a layer and add it in the weight's dtype); in bfloat16
within one bf16 ulp of the weight (a product summed in another order may
round the other way once cast); tokens exactly.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    jax_mode_generate,
    jax_params,
    one_torch_thread,
    port_args,
    port_cfg,
    tiny_llama_j,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    lora as jlora,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    transformer as jtransformer,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    lora as tlora,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttransformer,
)

from test_torch_tcp import _handshake, _port_cli

TARGETS = ("wo", "wq", "wv")
RANK = 8
SCALE = 2.0
STEPS = 8
PROMPT = [72, 101, 108, 108, 111, 33]
GREEDY = jsamp.SamplingParams(temperature=0.0)


def np_adapter(cfg, num_layers, targets=TARGETS, rank=RANK, seed=0, std=0.05):
    """A trained-looking adapter: a and b both non-zero, from a seed."""
    rng = np.random.default_rng(seed)
    return {t: {"a": (std * rng.standard_normal((num_layers, cfg.hidden_size, rank))
                      ).astype(np.float32),
                "b": (std * rng.standard_normal((num_layers, rank,
                                                 jlora.target_out_dim(cfg, t)))
                      ).astype(np.float32)}
            for t in targets}


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_port(tree):
    return {t: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()}
            for t, ab in tree.items()}


def np_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def cfgs():
    jcfg = tiny_llama_j()
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize("layout", ["canonical", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(cfgs, layout, dtype):
    jcfg, tcfg = cfgs
    jp = jax_params(jcfg, dtype=getattr(jnp, dtype))
    tp = bridged(jp)
    jl, tl = jp["layers"], tp["layers"]
    targets = TARGETS
    if layout == "fused":
        jl, tl = jtransformer.fuse_qkv_layers(jl), ttransformer.fuse_qkv_layers(tl)
        targets = ("wk", "wq", "wv")
    tree = np_adapter(jcfg, jcfg.num_layers, targets)
    want = jlora.merge_lora(jcfg, jl, as_jax(tree), SCALE)["attn"]
    got = tlora.merge_lora(tcfg, tl, as_port(tree), SCALE)["attn"]
    assert sorted(got) == sorted(want)
    for name in want:
        w, g = np_f32(want[name]), got[name].float().numpy()
        assert got[name].dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            # One bf16 ulp of the weight: 2^(exponent - 7).
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert np.all(np.abs(g - w) <= ulp), name
    # Leaves the merge does not touch stay the caller's tensors.
    untouched = [k for k in tl["attn"] if k not in targets and k != "wqkv"]
    assert all(got[k] is tl["attn"][k] for k in untouched)


def test_merge_refuses_a_missing_target_and_quantized_weights(cfgs):
    jcfg, tcfg = cfgs
    tl = bridged(jax_params(jcfg))["layers"]
    with pytest.raises(ValueError, match="not present"):
        tlora.merge_lora(tcfg, tl, as_port(np_adapter(jcfg, 4, ("wk",))) | {
            "wz": {"a": torch.zeros(4, 256, 2), "b": torch.zeros(4, 2, 256)}}, 1.0)
    with pytest.raises(ValueError, match="unsupported LoRA target"):
        tlora.target_out_dim(tcfg, "wg")
    q = tmain.quantize_params({"layers": tl}, "int8")["layers"]
    with pytest.raises(ValueError, match="merge before --quant"):
        tlora.merge_lora(tcfg, q, as_port(np_adapter(jcfg, 4, ("wq",))), 1.0)


def test_slice_wire_helpers_and_init_match_jax(cfgs):
    jcfg, tcfg = cfgs
    tree = np_adapter(jcfg, jcfg.num_layers)
    jslice = jlora.slice_lora(as_jax(tree), 1, 3)
    tslice = tlora.slice_lora(as_port(tree), 1, 3)
    for t in tree:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(tslice[t][leaf].numpy(), np.asarray(jslice[t][leaf]))
    jman, jarr = jlora.lora_to_list(as_jax(tree))
    tman, tarr = tlora.lora_to_list(as_port(tree))
    assert tman == jman
    for a, b in zip(tarr, jarr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tlora.lora_from_list(tman, [np.asarray(a) for a in jarr])
    assert sorted(back) == sorted(tree)
    for t in tree:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(back[t][leaf].numpy(), tree[t][leaf])
    with pytest.raises(ValueError, match="missing a/b"):
        tlora.lora_from_list(["wq/a"], [np.zeros(1)])
    with pytest.raises(ValueError, match="bad lora manifest"):
        tlora.lora_from_list(["wq/c"], [np.zeros(1)])
    for t in ("wq", "wk", "wv", "wo"):
        assert tlora.target_out_dim(tcfg, t) == jlora.target_out_dim(jcfg, t)
    init = tlora.init_lora(torch.Generator().manual_seed(0), tcfg, 4, RANK,
                           targets=("wv", "wq"))
    jinit = jlora.init_lora(jax.random.PRNGKey(0), jcfg, 4, RANK, targets=("wv", "wq"))
    assert list(init) == list(jinit) == ["wq", "wv"]
    for t in init:
        for leaf in ("a", "b"):
            assert tuple(init[t][leaf].shape) == tuple(jinit[t][leaf].shape)
        assert not torch.any(init[t]["b"]) and torch.any(init[t]["a"])
    tl = bridged(jax_params(jcfg))["layers"]
    merged = tlora.merge_lora(tcfg, tl, init, SCALE)
    assert torch.equal(merged["attn"]["wq"], tl["attn"]["wq"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_crosses_packages(cfgs, tmp_path, writer):
    jcfg, _ = cfgs
    tree = np_adapter(jcfg, jcfg.num_layers)
    path = str(tmp_path / "adapter")
    if writer == "jax":
        jlora.save_lora(path, as_jax(tree), 0.75)
        got, scale = tlora.load_lora(path)
        got = {t: {k: v.numpy() for k, v in ab.items()} for t, ab in got.items()}
    else:
        tlora.save_lora(path, as_port(tree), 0.75)
        got, scale = jlora.load_lora(path + ".npz")
        got = jax.tree.map(np.asarray, got)
    assert scale == 0.75 and sorted(got) == sorted(tree)
    for t in tree:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(got[t][leaf], tree[t][leaf])


def test_maybe_lora_checks_the_full_depth(cfgs, tmp_path):
    """An adapter of another depth is refused before it is sliced: three
    layers would slice to a span of three and merge silently."""
    jcfg, tcfg = cfgs
    path = str(tmp_path / "short.npz")
    tlora.save_lora(path, as_port(np_adapter(jcfg, 3)), 1.0)
    args = port_args(["--lora", path])
    params = bridged(jax_params(jcfg))
    with pytest.raises(SystemExit, match="covers 3 layers, the model has 4"):
        tmain._maybe_lora(args, tcfg, params, 0, 3)
    assert tmain._maybe_lora(port_args([]), tcfg, params) is params


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_local_lora_prints_the_jax_tokens(monkeypatch, capsys, cfgs, tmp_path, quant):
    """``--mode local --lora`` prints the tokens of the JAX package's
    ``--mode local --lora`` on the same adapter file, other tokens than
    without it, and ``--mode oracle --lora`` agrees."""
    jcfg, tcfg = cfgs
    jp = jax_params(jcfg)
    tp = bridged(jp)
    path = str(tmp_path / f"adapter-{quant}.npz")
    tlora.save_lora(path, as_port(np_adapter(jcfg, jcfg.num_layers)), SCALE)
    base = ["--mode", "local", "--quant", quant, "--splits", "1,3", "--temperature", "0",
            "--max_new_tokens", str(STEPS), "--prompt", "Hello!"]
    lines = []
    for extra in (["--lora", path], []):
        assert tmain.run_local(port_args(base + extra), tcfg, tp) == 0
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("TOKENS=")])
    assert len(lines[0]) == 1 and lines[0] != lines[1]
    jgen, jargs = jax_mode_generate(monkeypatch, base + ["--lora", path], jcfg, jp)
    ids = [i % tcfg.vocab_size for i in tmain.load_tokenizer().encode(jargs.prompt)]
    want = jgen(ids, STEPS, sampling=GREEDY).tokens
    assert lines[0][0] == f"TOKENS={want}"
    oracle = tmain.make_oracle_generate(
        port_args(["--mode", "oracle", "--quant", quant, "--lora", path]), tcfg, tp)
    tsp = tmain.SamplingParams(temperature=0.0)
    assert oracle(ids, STEPS, tsp).tokens == want


@pytest.mark.parametrize("stage", [0, 2])
def test_load_stage_model_merges_the_spans_slice(tmp_path, stage):
    """``serve`` and ``client`` initialize their span only and merge the
    adapter's slice into it before ``--quant``: the shard equals the
    merged, quantized slice of the full init."""
    args = port_args(["--model", "gpt2", "--seed", "3", "--splits", "6,9",
                      "--quant", "int8"])
    cfg = tmain.get_config("gpt2")
    path = str(tmp_path / "gpt2.npz")
    tlora.save_lora(path, as_port(np_adapter(cfg, cfg.num_layers, ("wq", "wv"))), SCALE)
    args.lora = path
    _, full = tmain.load_model(args)
    spec = tmain.stage_plan(args, cfg).stages[stage]
    _, shard = tmain.load_stage_model(args, spec)
    want = tmain._stage_params(args, cfg, full, spec)
    for t in ("wq", "wv", "wk"):
        got, ref = shard["layers"]["attn"][t], want["layers"]["attn"][t]
        assert torch.equal(got.q, ref.q) and torch.equal(got.s, ref.s), t
    plain = tmain._stage_params(port_args(["--quant", "int8"]), cfg, full, spec)
    assert not torch.equal(shard["layers"]["attn"]["wq"].q, plain["layers"]["attn"]["wq"].q)


def test_cli_swarm_with_lora_matches_mode_local(tmp_path):
    """``--mode registry``, two ``--mode serve`` processes and ``--mode
    client``, every one with ``--lora`` (gpt2, int8, splits 6,9): the
    client prints ``--mode local --lora``'s token ids."""
    cfg = tmain.get_config("gpt2")
    path = str(tmp_path / "gpt2.npz")
    tlora.save_lora(path, as_port(np_adapter(cfg, cfg.num_layers, ("wq", "wv"))), SCALE)
    common = ["--model", "gpt2", "--quant", "int8", "--seed", "1", "--splits", "6,9",
              "--lora", path]
    gen = ["--max_new_tokens", "5", "--temperature", "0", "--prompt", "Hi there"]
    procs = []
    try:
        procs.append(_port_cli("--mode", "registry", "--registry_port", "0"))
        addr = _handshake(procs[0], "REGISTRY_ADDR=").split("=", 1)[1]
        for k in (1, 2):
            procs.append(_port_cli("--mode", "serve", "--stage", str(k),
                                   "--registry_addr", addr, *common))
        lines = [_handshake(p, "SERVING ") for p in procs[1:]]
        assert [ln.split()[1:3] for ln in lines] == [["stage=1", "span=[6,9)"],
                                                      ["stage=2", "span=[9,12)"]]
        client = _port_cli("--mode", "client", "--registry_addr", addr, *common, *gen)
        local = _port_cli("--mode", "local", *common, *gen)
        procs += [client, local]
        outs = [p.communicate(timeout=180)[0].decode("utf-8", errors="replace")
                for p in (local, client)]
        assert client.returncode == 0 and local.returncode == 0
        ids = [re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M) for out in outs]
        assert len(ids[0]) == 1 and ids[0] == ids[1] and json.loads(ids[0][0])
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
