"""Checkpoint loading in the port (``models/hf_import.py``, ``--checkpoint``
and the checkpoint's tokenizer) against the JAX package's, on the same
checkpoint directories.

Every checkpoint is written here with the installed ``transformers``
(``save_pretrained``), at the sizes of tests/test_models_oracle.py's
factories (llama with the llama3 RoPE remap). Covered:
(a) ``config_from_checkpoint`` equal to JAX's field for field for every
    family, the port's table of config defaults equal to each transformers
    config class's, and the refusals raising in both packages;
(b) ``load_stage_checkpoint`` for every stage of a 3-stage plan equal to
    JAX's bit for bit, at float32 and at bfloat16 from a bf16 save (the
    window leaf int32), and a full load shaped as ``init_params``' tree
    (Mixtral's experts included, and its converted tree's forward);
(c) the port's safetensors reader against ``safetensors.safe_open``; a
    middle stage opening a strict subset of the shards; an unprefixed
    ``GPT2Model`` save; a sharded ``.bin`` save giving the safetensors
    save's tree; ``chip_smoke.write_checkpoint``'s files read by
    ``safe_open``, by transformers' ``AutoConfig`` and by the port;
(d) the port's ``full_forward`` on imported llama, gemma2 and gpt2 weights
    against JAX's on the JAX import (RTOL / ATOL at float32);
(e) ``main --mode local / oracle --checkpoint`` printing the JAX CLI's
    greedy tokens at ``--quant none`` and ``int8``, on llama and on
    Mixtral; ``load_stage_model``
    with ``--lora`` equal to JAX's ``_stage_params`` for every stage; an
    elastic server's re-span reading only its new span's shards; the
    registry / serve / client / gateway / submit processes with
    ``--checkpoint`` printing ``--mode local``'s tokens;
(f) a checkpoint's tokenizer giving the same ids in both packages, and the
    byte fallback with its warning where there is none;
(g) ``load_tokenizer`` and ``load_stage_checkpoint`` in a subprocess with
    ``jax`` blocked;
(h) an ``http(s)://`` checkpoint served by a local store: ``local`` prints
    the local directory's tokens, ``serve`` loads only its span's shards,
    ``submit`` reads the store's tokenizer (tests/test_torch_remote_store.py
    holds the store itself to the JAX package's).

Tolerance: trees bit for bit; logits within RTOL / ATOL of the compared
tensor's scale; tokens exactly.
"""

import dataclasses
import json
import logging
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import CONFIG_MAPPING

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    jax_mode_generate,
    one_torch_thread,
    port_args,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    main as jmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    hf_import as jh,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    transformer as jtf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops import (
    sampling as jsamp,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    hf_import as th,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    lora as tlora,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    from_jax_tree,
    torch_to_array,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
)

from test_models_oracle import FACTORIES
from test_torch_lora import SCALE, as_port, np_adapter
from test_torch_tcp import _handshake, _port_cli

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", jmain.__name__.rsplit(".", 1)[0])
GREEDY = jsamp.SamplingParams(temperature=0.0)
STEPS = 6
PROMPT = "Hello!"
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 32}


def tiny_llama3(num_layers=4):
    torch.manual_seed(0)
    from transformers import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig(
        vocab_size=320, hidden_size=64, num_hidden_layers=num_layers,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        max_position_embeddings=256, rope_theta=10000.0, tie_word_embeddings=False,
        rope_scaling=dict(LLAMA3))).eval()


FAMILIES = dict(FACTORIES, llama=tiny_llama3)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each family saved in float32 (sharded: an index and several files)
    and in bfloat16 (one file); family -> {dtype: path, "hf": model}."""
    out = {}
    for family, make in FAMILIES.items():
        hf = make()
        f32 = tmp_path_factory.mktemp(f"{family}-f32")
        hf.save_pretrained(f32, max_shard_size="100KB", safe_serialization=True)
        bf16 = tmp_path_factory.mktemp(f"{family}-bf16")
        hf.to(torch.bfloat16).save_pretrained(bf16, safe_serialization=True)
        out[family] = {"float32": str(f32), "bfloat16": str(bf16),
                       "hf": make()}
    return out


@pytest.fixture(scope="module")
def llama6(tmp_path_factory):
    """A 6-layer llama3-scaled checkpoint in many shards (--splits 2,4)."""
    path = tmp_path_factory.mktemp("llama6")
    tiny_llama3(6).save_pretrained(path, max_shard_size="200KB", safe_serialization=True)
    return str(path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _jax_leaves(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_bit_equal(port_tree, jax_tree):
    """The same key paths, and each leaf's bits (bf16 as its uint16 bits)."""
    want = _jax_leaves(jax_tree)
    got = dict(_leaves(port_tree))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        w = want[path]
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        g = torch_to_array(t)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        assert np.array_equal(g, w), path


# ---------------------------------------------------------------------------
# (a) configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_from_checkpoint_matches_jax(saved, family):
    path = saved[family]["float32"]
    port = dataclasses.asdict(th.config_from_checkpoint(path))
    assert port == dataclasses.asdict(jh.config_from_checkpoint(path))
    hf_cfg = saved[family]["hf"].config
    assert dataclasses.asdict(th.config_from_hf(hf_cfg)) == \
        dataclasses.asdict(jh.config_from_hf(hf_cfg)) == port
    if family == "llama":
        assert port["rope_scaling"] == (8.0, 1.0, 4.0, 32)
    if family in ("gemma", "gemma2"):
        # save_pretrained left out the default: the table supplies it.
        raw = json.loads((pathlib.Path(path) / "config.json").read_text())
        assert "tie_word_embeddings" not in raw and port["tie_word_embeddings"]


# The attributes config_from_hf reads, per model type.
COMMON = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
          "num_key_value_heads", "intermediate_size", "max_position_embeddings",
          "rope_theta", "tie_word_embeddings", "rms_norm_eps", "rope_scaling")
READ = {"gpt2": ("vocab_size", "n_embd", "n_layer", "n_head", "n_positions", "n_inner",
                 "layer_norm_epsilon"),
        "llama": COMMON, "mistral": COMMON + ("sliding_window",),
        "qwen2": COMMON + ("use_sliding_window", "max_window_layers", "sliding_window"),
        "gemma": COMMON + ("head_dim",),
        "gemma2": COMMON + ("head_dim", "query_pre_attn_scalar", "attn_logit_softcapping",
                            "final_logit_softcapping", "sliding_window"),
        "mixtral": COMMON + ("num_local_experts", "num_experts_per_tok", "sliding_window")}


@pytest.mark.parametrize("model_type", sorted(READ))
def test_defaults_table_is_the_config_classes(model_type):
    """Each entry of HF_DEFAULTS is the value of that type's config class
    built with no arguments; an attribute the class lacks is absent."""
    default = CONFIG_MAPPING[model_type]()
    missing = object()
    want = {a: getattr(default, a, missing) for a in READ[model_type]}
    assert th.HF_DEFAULTS[model_type] == {a: v for a, v in want.items() if v is not missing}


def _refusals():
    from transformers import BertConfig, LlamaConfig, Qwen2Config

    small = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, num_key_value_heads=2, intermediate_size=64)
    return {
        "llama_linear_rope": (LlamaConfig(**small, rope_scaling={"rope_type": "linear",
                                                                  "factor": 2.0}),
                              "rope_scaling"),
        "qwen2_yarn_rope": (Qwen2Config(**small, rope_scaling={"rope_type": "yarn",
                                                                "factor": 4.0}),
                            "rope_scaling"),
        "qwen2_mixed_windows": (Qwen2Config(**small, use_sliding_window=True,
                                            sliding_window=8, max_window_layers=1),
                                "per-layer sliding windows"),
        "bert": (BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=64),
                 "unsupported model_type"),
    }


@pytest.mark.parametrize("case", ["llama_linear_rope", "qwen2_yarn_rope",
                                  "qwen2_mixed_windows", "bert"])
def test_refusals_raise_in_both_packages(tmp_path, case):
    hf_cfg, match = _refusals()[case]
    hf_cfg.save_pretrained(tmp_path)
    for mod in (jh, th):
        with pytest.raises(ValueError, match=match):
            mod.config_from_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# (b) stage loads
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stage_loads_equal_jax_bit_for_bit(saved, family, dtype):
    path = saved[family][dtype]
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = jh.config_from_checkpoint(path), th.config_from_checkpoint(path)
    jplan, tplan = JStagePlan.even(jcfg.num_layers, 3), StagePlan.even(tcfg.num_layers, 3)
    for jspec, tspec in zip(jplan.stages, tplan.stages):
        got = th.load_stage_checkpoint(path, tcfg, tspec, dtype=tdt, device="cpu")
        assert_trees_bit_equal(got, jh.load_stage_checkpoint(path, jcfg, jspec, dtype=jdt))
        if tcfg.altern_window and "layers" in got:
            assert got["layers"]["window"].dtype == torch.int32
    # The full tree is init_params' tree: keys, shapes, dtypes, stacking.
    full = th.load_stage_checkpoint(path, tcfg, StagePlan.even(tcfg.num_layers, 1)
                                    .stages[0], dtype=tdt, device="cpu")
    init = ttf.init_params(tcfg, torch.Generator().manual_seed(0), dtype=tdt)
    assert [(p, t.shape, t.dtype) for p, t in _leaves(full)] == \
        [(p, t.shape, t.dtype) for p, t in _leaves(init)]


def test_mixtral_expert_layout_matches_jax(saved):
    """Mixtral's router and stacked experts convert as JAX's, and the
    converted tree's forward (the sparse dispatch) gives the logits of
    JAX's forward over JAX's import of the same checkpoint."""
    path = saved["mixtral"]["float32"]
    cfg = th.config_from_checkpoint(path)
    got = th.load_stage_checkpoint(path, cfg, StagePlan.even(cfg.num_layers, 1).stages[0],
                                   device="cpu")
    mlp = got["layers"]["mlp"]
    assert mlp["router"].shape == (cfg.num_layers, cfg.hidden_size, cfg.num_experts)
    assert mlp["wg"].shape == (cfg.num_layers, cfg.num_experts, cfg.hidden_size,
                               cfg.intermediate_size)
    jcfg = jh.config_from_checkpoint(path)
    jparams = jh.load_stage_checkpoint(path, jcfg, JStagePlan.even(jcfg.num_layers, 1)
                                       .stages[0])
    ids = (np.arange(20, dtype=np.int32)[None, :] * 7) % cfg.vocab_size
    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, 32)
    want, _, _ = jtf.full_forward(jcfg, jparams, jnp.asarray(ids), kc, vc, jnp.int32(0))
    kc, vc = ttf.init_kv_cache(cfg, cfg.num_layers, 1, 32)
    logits, _, _ = ttf.full_forward(cfg, got, torch.from_numpy(ids).long(), kc, vc, 0)
    assert_close(logits, np.asarray(want))


# ---------------------------------------------------------------------------
# (c) the reader
# ---------------------------------------------------------------------------

def test_safetensors_reader_matches_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(5, 7, generator=g),
               "bf16": torch.randn(3, 64, generator=g).to(torch.bfloat16),
               "f16": torch.randn(9, generator=g).to(torch.float16),
               "i64": torch.arange(-6, 6, dtype=torch.int64).reshape(3, 4),
               "i32": torch.tensor([7, -1, 2**31 - 1], dtype=torch.int32),
               "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
               "u8": torch.tensor([0, 255], dtype=torch.uint8),
               "i16": torch.tensor([-300, 300], dtype=torch.int16),
               "f64": torch.randn(2, 2, generator=g, dtype=torch.float64),
               "bool": torch.tensor([True, False, True]),
               "scalar": torch.tensor(3.5), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path)
    ours = th.SafetensorsFile(path)
    assert sorted(ours.keys()) == sorted(tensors)
    with safe_open(path, framework="pt") as f:
        for k in tensors:
            got, want = ours.get_tensor(k), f.get_tensor(k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert torch.equal(got, want), k


def test_middle_stage_opens_a_strict_subset_of_the_shards(llama6):
    cfg = th.config_from_checkpoint(llama6)
    mid = StagePlan.from_splits(cfg.num_layers, [2, 4]).stages[1]
    sd = th.LazyCheckpoint(llama6)
    shards = set(sd._weight_map.values())
    assert len(shards) > 2
    th.convert_state_dict(cfg, sd, layer_range=(mid.start, mid.end), include_embed=False,
                          include_head=False, device="cpu")
    edge = {sd._weight_map[k] for k in ("model.embed_tokens.weight", "lm_head.weight")}
    assert sd.opened and sd.opened < shards and not sd.opened & edge
    # The JAX loader opens the same shards.
    jsd = jh.LazyCheckpoint(llama6)
    jh.convert_state_dict(jh.config_from_checkpoint(llama6), jsd, layer_range=(2, 4),
                          include_embed=False, include_head=False)
    assert jsd.opened == sd.opened


def test_unprefixed_base_model_checkpoint(tmp_path):
    """A GPT2Model (base) save stores 'h.0...', 'wte...': aliased."""
    from transformers import GPT2Config, GPT2Model

    torch.manual_seed(0)
    base = GPT2Model(GPT2Config(vocab_size=97, n_embd=32, n_layer=4, n_head=4,
                                n_positions=64)).eval()
    base.save_pretrained(tmp_path, safe_serialization=True)
    sd = th.LazyCheckpoint(str(tmp_path))
    assert any(k.startswith("transformer.") for k in sd._alias)
    cfg = th.config_from_hf(base.config)
    jcfg = jh.config_from_hf(base.config)
    for spec, jspec in zip(StagePlan.from_splits(4, [2]).stages,
                           JStagePlan.from_splits(4, [2]).stages):
        got = th.load_stage_checkpoint(str(tmp_path), cfg, spec, device="cpu")
        assert_trees_bit_equal(got, jh.load_stage_checkpoint(str(tmp_path), jcfg, jspec))
    assert torch.equal(got["layers"]["ln1"]["w"][0], base.h[2].ln_1.weight.detach())


def test_bin_checkpoint_gives_the_safetensors_tree(tmp_path):
    """A sharded pytorch_model.bin save (safe_serialization=False) loads,
    through torch.load, into the safetensors save's tree."""
    hf = tiny_llama3()
    hf.save_pretrained(tmp_path / "bin", max_shard_size="100KB", safe_serialization=False)
    hf.save_pretrained(tmp_path / "st", safe_serialization=True)
    assert (tmp_path / "bin" / "pytorch_model.bin.index.json").exists()
    cfg = th.config_from_checkpoint(str(tmp_path / "bin"))
    plan = StagePlan.from_splits(cfg.num_layers, [1, 3])
    for spec in plan.stages:
        got = dict(_leaves(th.load_stage_checkpoint(str(tmp_path / "bin"), cfg, spec,
                                                    device="cpu")))
        want = dict(_leaves(th.load_stage_checkpoint(str(tmp_path / "st"), cfg, spec,
                                                     device="cpu")))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)


def test_chip_smoke_writer_reads_back(tmp_path):
    """chip_smoke's writer (the card has no safetensors package): its files
    read by safe_open hold `checkpoint_tensors`' bytes, AutoConfig reads its
    config as the port does, and the port loads the tree it wrote."""
    from safetensors import safe_open

    cfg = dataclasses.replace(tmain.get_config("llama-3.1-8b"), vocab_size=320,
                              hidden_size=64, num_layers=4, num_heads=4, num_kv_heads=2,
                              intermediate_size=128)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    weight_map = chip_smoke.write_checkpoint(torch, str(tmp_path), cfg, params,
                                             shard_bytes=100_000)
    assert len(set(weight_map.values())) > 2
    for name, want in chip_smoke.checkpoint_tensors(cfg, params):
        with safe_open(str(tmp_path / weight_map[name]), framework="pt") as f:
            assert torch.equal(f.get_tensor(name), want.contiguous()), name
    assert th.config_from_checkpoint(str(tmp_path)) == cfg
    assert dataclasses.asdict(jh.config_from_checkpoint(str(tmp_path))) == \
        dataclasses.asdict(cfg)
    got = th.load_stage_checkpoint(str(tmp_path), cfg, StagePlan.even(4, 1).stages[0],
                                   dtype=torch.bfloat16, device="cpu")
    want = dict(_leaves(params))
    assert all(torch.equal(t, want[p]) for p, t in _leaves(got))


# ---------------------------------------------------------------------------
# (d) forward on imported weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["llama", "gemma2", "gpt2"])
def test_full_forward_on_imported_weights_matches_jax(saved, family):
    hf = saved[family]["hf"]
    jcfg, jparams = jh.import_hf_model(hf)
    tcfg, tparams = th.import_hf_model(hf, device="cpu")
    ids = (np.arange(20, dtype=np.int32)[None, :] * 7) % tcfg.vocab_size
    kc, vc = jtf.init_kv_cache(jcfg, jcfg.num_layers, 1, 32)
    want, _, _ = jtf.full_forward(jcfg, jparams, jnp.asarray(ids), kc, vc, jnp.int32(0))
    kc, vc = ttf.init_kv_cache(tcfg, tcfg.num_layers, 1, 32)
    got, _, _ = ttf.full_forward(tcfg, tparams, torch.from_numpy(ids).long(), kc, vc, 0)
    assert_close(got, np.asarray(want))


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

def _tokens(out: str):
    return re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_local_and_oracle_print_the_jax_tokens(monkeypatch, capsys, llama6, quant):
    base = ["--splits", "2,4", "--checkpoint", llama6, "--prompt", PROMPT,
            "--max_new_tokens", str(STEPS), "--temperature", "0", "--quant", quant]
    outs = {}
    for mode in ("local", "oracle"):
        assert tmain.main(["--mode", mode, *base, "--device", "cpu"]) == 0
        outs[mode] = capsys.readouterr().out
        assert "TTFT" in outs[mode]
    jgen, _ = jax_mode_generate(monkeypatch, ["--mode", "local", *base],
                                jh.config_from_checkpoint(llama6), None)
    cfg = th.config_from_checkpoint(llama6)
    ids = [i % cfg.vocab_size for i in tmain.load_tokenizer().encode(PROMPT)]
    want = jgen(ids, STEPS, sampling=GREEDY).tokens
    assert _tokens(outs["local"]) == _tokens(outs["oracle"]) == [json.dumps(want)]


@pytest.fixture(scope="module")
def mixtral2(tmp_path_factory):
    """A 2-layer Mixtral checkpoint (4 experts, top 2) in several shards."""
    path = tmp_path_factory.mktemp("mixtral2")
    FAMILIES["mixtral"]().save_pretrained(path, max_shard_size="100KB",
                                          safe_serialization=True)
    return str(path)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_mixtral_local_and_oracle_print_the_jax_tokens(monkeypatch, capsys, mixtral2,
                                                           quant):
    """A Mixtral checkpoint through --mode local (2 stages) and --mode
    oracle: the JAX CLI's greedy tokens."""
    base = ["--splits", "1", "--checkpoint", mixtral2, "--prompt", PROMPT,
            "--max_new_tokens", str(STEPS), "--temperature", "0", "--quant", quant]
    outs = {}
    for mode in ("local", "oracle"):
        assert tmain.main(["--mode", mode, *base, "--device", "cpu"]) == 0
        outs[mode] = capsys.readouterr().out
    jgen, _ = jax_mode_generate(monkeypatch, ["--mode", "local", *base],
                                jh.config_from_checkpoint(mixtral2), None)
    cfg = th.config_from_checkpoint(mixtral2)
    ids = [i % cfg.vocab_size for i in tmain.load_tokenizer().encode(PROMPT)]
    want = jgen(ids, STEPS, sampling=GREEDY).tokens
    assert _tokens(outs["local"]) == _tokens(outs["oracle"]) == [json.dumps(want)]


def test_load_stage_model_streams_and_merges_like_jax(llama6, tmp_path):
    """--checkpoint, --lora and --quant int8 on every stage: the port's
    load_stage_model equals, bit for bit, the port's merge and quantization
    of JAX's load of the same span; and JAX's own _stage_params up to the
    merge's float32 sums (ROADMAP Queue 3 #31): the same int8 codes, and
    scales within two float32 ulps (a merged weight one ulp off, then the
    scale's division by 127)."""
    jcfg = jh.config_from_checkpoint(llama6)
    path = str(tmp_path / "adapter.npz")
    tlora.save_lora(path, as_port(np_adapter(jcfg, jcfg.num_layers)), SCALE)
    argv = ["--checkpoint", llama6, "--splits", "2,4", "--lora", path, "--quant", "int8"]
    jargs = jmain.build_parser().parse_args(argv)
    targs = port_args(argv)
    tcfg = tmain.model_config(targs)
    jplan = JStagePlan.from_splits(jcfg.num_layers, [2, 4])
    for spec in tmain.stage_plan(targs, tcfg).stages:
        jspec = jplan.stages[spec.index]
        _, shard = tmain.load_stage_model(targs, spec)
        got = dict(_leaves(shard))
        bridged = from_jax_tree(jax.tree.map(np.asarray, jh.load_stage_checkpoint(
            llama6, jcfg, jspec)))
        ours = dict(_leaves(tmain._stage_params(targs, tcfg, None, spec)))
        theirs = dict(_leaves(jmain._stage_params(jargs, jcfg, None, jspec)))
        same = dict(_leaves(tmain._maybe_quantize(targs, tmain._maybe_lora(
            targs, tcfg, bridged, spec.start, spec.end))))
        assert got.keys() == ours.keys() == theirs.keys() == same.keys()
        for p, t in got.items():
            if hasattr(t, "q"):
                for want in (ours[p], same[p]):
                    assert torch.equal(t.q, want.q) and torch.equal(t.s, want.s), p
                assert np.array_equal(t.q.numpy(), np.asarray(theirs[p].q)), p
                want = np.asarray(theirs[p].s)
                assert np.all(np.abs(t.s.numpy() - want) <= 2 * np.spacing(np.abs(want))), p
            else:
                assert torch.equal(t, ours[p]) and torch.equal(t, same[p]), p
                assert np.array_equal(torch_to_array(t), np.asarray(theirs[p])), p


def test_elastic_respan_reads_only_the_new_spans_shards(llama6, monkeypatch):
    """--mode local --use_load_balancing --checkpoint: each elastic server
    streams its span; a re-span onto [4, 6) reads only the shards holding
    those layers, and the swarm still gives the fixed split's tokens."""
    loads = []

    class Recording(th.LazyCheckpoint):
        def __init__(self, path):
            super().__init__(path)
            loads.append(self)

    monkeypatch.setattr(th, "LazyCheckpoint", Recording)
    argv = ["--mode", "local", "--checkpoint", llama6, "--splits", "2"]
    fixed = tmain.build_local_client(port_args(argv), *tmain.load_model(port_args(argv)))
    sp = tmain.SamplingParams(temperature=0.0)
    want = fixed.generate([72, 105], STEPS, sampling=sp).tokens
    args = port_args(argv + ["--use_load_balancing", "--num_servers", "2",
                             "--num_blocks", "4"])
    cfg, params = tmain.load_model(args)
    assert params is None
    client, servers = tmain.build_local_swarm(args, cfg, params)
    assert [(s.spec.start, s.spec.end) for s in servers] == [(2, 6), (2, 6)]
    weight_map = loads[0]._weight_map
    span_shards = {weight_map[k] for k in weight_map if re.match(r"model\.layers\.[45]\.", k)}
    del loads[:]
    servers[1].shutdown()
    servers[1].load_span(servers[1]._spec_for(4, 6))
    assert len(loads) == 1 and loads[0].opened == span_shards
    assert client.generate([72, 105], STEPS, sampling=sp).tokens == want


def test_cli_swarm_with_checkpoint_matches_mode_local(llama6):
    """registry, then serve --stage 1 and a gateway, then a client and a
    submit, every process with --checkpoint (wire f32): the client and the
    submit print --mode local's token ids."""
    common = ["--checkpoint", llama6, "--splits", "2", "--wire_dtype", "f32"]
    gen = ["--max_new_tokens", str(STEPS), "--temperature", "0", "--prompt", PROMPT]
    args = port_args(["--mode", "local", *common, *gen])
    local = tmain.build_local_client(args, *tmain.load_model(args))
    ids = [i % 320 for i in tmain.load_tokenizer().encode(PROMPT)]
    want = local.generate(ids, STEPS, sampling=tmain.SamplingParams(temperature=0.0)).tokens
    procs = []
    try:
        procs.append(_port_cli("--mode", "registry", "--registry_port", "0"))
        addr = _handshake(procs[0], "REGISTRY_ADDR=").split("=", 1)[1]
        # The server and the gateway start together, then the client and
        # the submit (each of those two imports transformers for the
        # checkpoint's tokenizer).
        procs.append(_port_cli("--mode", "serve", "--stage", "1", "--registry_addr", addr,
                               *common))
        procs.append(_port_cli("--mode", "gateway", "--registry_addr", addr, *common))
        assert _handshake(procs[1], "SERVING ").split()[1:3] == ["stage=1", "span=[2,6)"]
        gw = re.search(r"addr=(\S+)", _handshake(procs[2], "GATEWAY ")).group(1)
        client = _port_cli("--mode", "client", "--registry_addr", addr, *common, *gen)
        submit = _port_cli("--mode", "submit", "--gateway_addr", gw, "--checkpoint", llama6,
                           *gen)
        procs += [client, submit]
        outs = [p.communicate(timeout=180)[0].decode("utf-8", errors="replace")
                for p in (client, submit)]
        assert client.returncode == 0 and submit.returncode == 0
        assert [_tokens(out) for out in outs] == [[json.dumps(want)]] * 2
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


# ---------------------------------------------------------------------------
# (f) tokenizers, (g) with jax blocked, (h) remote checkpoints
# ---------------------------------------------------------------------------

TEXTS = ("Hello, world!", "the quick brown fox", "")


@pytest.fixture(scope="module")
def tokenizer_ckpt(tmp_path_factory):
    """A gpt2 checkpoint with a byte-level BPE tokenizer saved beside it."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    path = tmp_path_factory.mktemp("tok")
    FAMILIES["gpt2"]().save_pretrained(path, safe_serialization=True)
    tk = Tokenizer(models.BPE())
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.train_from_iterator(["hello world, the quick brown fox"] * 20, trainers.BpeTrainer(
        vocab_size=200, special_tokens=["<eos>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=tk, eos_token="<eos>").save_pretrained(path)
    return str(path)


def test_checkpoint_tokenizer_ids_match_jax(tokenizer_ckpt):
    tok, jtok = tmain.load_tokenizer(tokenizer_ckpt), jmain.load_tokenizer(tokenizer_ckpt)
    assert not isinstance(tok, tmain.ByteTokenizer)
    assert tok.eos_token_id == jtok.eos_token_id is not None
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert tok.decode(ids) == jtok.decode(ids)


def test_no_tokenizer_falls_back_to_bytes_with_the_warning(llama6):
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    keep = Keep(logging.WARNING)
    tmain.logger.addHandler(keep)
    try:
        assert isinstance(tmain.load_tokenizer(None), tmain.ByteTokenizer) and not seen
        tok = tmain.load_tokenizer(llama6)
    finally:
        tmain.logger.removeHandler(keep)
    assert isinstance(tok, tmain.ByteTokenizer)
    assert type(jmain.load_tokenizer(llama6)).__name__ == "ByteTokenizer"
    assert len(seen) == 1 and "using byte fallback" in seen[0]


def test_no_tokenizer_file_is_not_asked(llama6, monkeypatch):
    """A directory with no tokenizer file falls back to bytes without asking
    transformers, which from version 5 answers it with a tokenizer of a
    few special tokens (a divergence: the reference asks it anyway)."""
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **kw: "a tokenizer of no files"))
    assert isinstance(tmain.load_tokenizer(llama6), tmain.ByteTokenizer)
    assert jmain.load_tokenizer(llama6) == "a tokenizer of no files"


def test_tokenizer_and_stage_load_run_with_jax_blocked(tokenizer_ckpt, llama6):
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"from {tmain.__name__} import load_tokenizer, ByteTokenizer\n"
        f"from {th.__name__} import config_from_checkpoint, load_stage_checkpoint\n"
        f"from {StagePlan.__module__} import StagePlan\n"
        f"tok = load_tokenizer({tokenizer_ckpt!r})\n"
        "assert not isinstance(tok, ByteTokenizer), type(tok)\n"
        f"cfg = config_from_checkpoint({llama6!r})\n"
        "for spec in StagePlan.from_splits(cfg.num_layers, [2, 4]).stages:\n"
        f"    load_stage_checkpoint({llama6!r}, cfg, spec, device='cpu')\n"
        f"assert not any(k.split('.')[0] in {FORBIDDEN!r} "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', tok.encode('hello world'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
    assert proc.stdout.split(" ", 1)[1].strip() == str(
        jmain.load_tokenizer(tokenizer_ckpt).encode("hello world"))


@pytest.fixture(scope="module")
def http_store():
    """`url(directory)`: a checkpoint directory behind a local static file
    server (one a directory, stopped at the module's end)."""
    import functools
    import http.server
    import threading

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    servers = {}

    def url(directory):
        if directory not in servers:
            httpd = http.server.ThreadingHTTPServer(
                ("127.0.0.1", 0), functools.partial(Quiet, directory=directory))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers[directory] = httpd
        return f"http://127.0.0.1:{servers[directory].server_address[1]}"

    yield url
    for httpd in servers.values():
        httpd.shutdown()


class _Loaded(Exception):
    """Stops a serving mode once it has loaded what the test reads."""


@pytest.mark.parametrize("mode", ["local", "serve", "submit"])
def test_remote_checkpoint_exits_naming_queue_1_3f(mode, monkeypatch, capsys, tmp_path,
                                                   llama6, tokenizer_ckpt, http_store):
    """An ``http(s)://`` checkpoint is a remote weight store (no longer
    refused): ``local`` prints the local directory's tokens, ``serve``
    fetches and loads only its stage's shards, and ``submit`` reads the
    checkpoint's tokenizer from the store's cache."""
    cache = str(tmp_path / "cache")
    if mode == "local":
        base = ["--mode", "local", "--splits", "2,4", "--prompt", PROMPT, "--max_new_tokens",
                str(STEPS), "--temperature", "0", "--quant", "int8", "--device", "cpu"]
        outs = []
        for where in (["--checkpoint", llama6],
                      ["--checkpoint", http_store(llama6), "--weight_cache_dir", cache]):
            assert tmain.main(base + where) == 0
            outs.append(_tokens(capsys.readouterr().out))
        assert outs[1] == outs[0] and len(outs[0]) == 1
        return
    if mode == "serve":
        loads = []
        real = tmain.load_stage_model

        def load_then_stop(args, spec, **kw):
            loads.append((spec, real(args, spec, **kw)[1]))
            raise _Loaded

        monkeypatch.setattr(tmain, "load_stage_model", load_then_stop)
        url = http_store(llama6)
        with pytest.raises(_Loaded):
            tmain.main(["--mode", "serve", "--stage", "1", "--splits", "2,4", "--checkpoint",
                        url, "--weight_cache_dir", cache, "--registry_addr", "127.0.0.1:1",
                        "--device", "cpu"])
        (spec, shard), = loads
        store = tmain._STORES[(url, cache)]
        fetched = {n for n in store.fetches if n.endswith(".safetensors")}
        assert (spec.start, spec.end) == (2, 4)
        assert fetched == set(store.shards_for_span(2, 4, is_first=False, is_last=False))
        assert fetched < set(json.load(open(f"{llama6}/model.safetensors.index.json"))
                             ["weight_map"].values())
        assert_trees_bit_equal(shard, jh.load_stage_checkpoint(
            llama6, jh.config_from_checkpoint(llama6),
            JStagePlan.from_splits(6, [2, 4]).stages[1]))
        return
    read = []
    real_tok = tmain.load_tokenizer

    def tokenizer_then_stop(path=None):
        read.append((path, real_tok(path)))
        raise _Loaded

    monkeypatch.setattr(tmain, "load_tokenizer", tokenizer_then_stop)
    with pytest.raises(_Loaded):
        tmain.main(["--mode", "submit", "--checkpoint", http_store(tokenizer_ckpt),
                    "--weight_cache_dir", cache, "--gateway_addr", "127.0.0.1:1"])
    (path, tok), = read
    assert path == cache and os.path.exists(os.path.join(cache, "tokenizer.json"))
    assert not isinstance(tok, tmain.ByteTokenizer)
    want = jmain.load_tokenizer(tokenizer_ckpt)
    assert [tok.encode(t) for t in TEXTS] == [want.encode(t) for t in TEXTS]


def test_chip_smoke_writer_reads_back_mixtral(tmp_path):
    """chip_smoke's writer on a Mixtral tree (the router and each expert's
    w1 / w2 / w3): AutoConfig and the port read its config, and the port
    loads the tree it wrote."""
    from transformers import AutoConfig

    cfg = dataclasses.replace(tmain.get_config("mixtral-8x7b"), vocab_size=320,
                              hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                              intermediate_size=96, num_experts=4)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    chip_smoke.write_checkpoint(torch, str(tmp_path), cfg, params, shard_bytes=100_000)
    assert AutoConfig.from_pretrained(str(tmp_path)).model_type == "mixtral"
    assert th.config_from_checkpoint(str(tmp_path)) == cfg
    got = th.load_stage_checkpoint(str(tmp_path), cfg, StagePlan.even(2, 1).stages[0],
                                   dtype=torch.bfloat16, device="cpu")
    want = dict(_leaves(params))
    assert all(torch.equal(t, want[p]) for p, t in _leaves(got))
