"""The remote weight store in the port (``models/remote_store.py``, an
``http(s)://`` ``--checkpoint`` with ``--weight_cache_dir`` /
``--weight_cache_bytes``) against the JAX package's, over one local store.

The fixture is the reference test's (tests/test_remote_store.py): a
multi-shard tiny llama written with ``save_pretrained(max_shard_size=
"100KB")``, a ``digests.json``, and ``http.server`` over the directory on
127.0.0.1. Covered:
(a) the reference's five tests on the port's store: a span fetches only
    its shards, a re-span only new ones, the LRU keeps the cache under its
    budget, a digest mismatch raises ``DigestMismatch``, the LRU survives a
    restart;
(b) ``shards_for_span`` equal to the JAX store's for every stage role of a
    plan; a cache directory filled by one package's store serving the
    other's with no shard or index fetched (the same layout and
    ``.lru_state.json``);
(c) ``load_stage`` equal to the JAX store's tree bit for bit (through
    ``models/bridge.py``) at float32 and bfloat16; the single-file layout
    read with the port's own header reader; the digest file's 404 / 403 /
    500 answers;
(d) ``--mode local --checkpoint http://...`` printing the JAX CLI's tokens,
    and a host-offloaded stage streamed through the store.
"""

import functools
import hashlib
import http.server
import json
import os
import re
import shutil
import threading

import jax
import numpy as np
import pytest
import torch
from transformers import LlamaConfig, LlamaForCausalLM

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_mode_generate,
    one_torch_thread,
    port_args,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    remote_store as jrs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.hf_import import (
    config_from_checkpoint as j_config_from_checkpoint,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    remote_store as trs,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    from_jax_tree,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.hf_import import (
    config_from_checkpoint,
    load_stage_checkpoint,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    ROLE_FULL,
    StagePlan,
    StageSpec,
    parse_splits,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    offload as toff,
)

STEPS = 6


class QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


def _serve(directory, handler_cls=QuietHandler):
    """(server, its base URL) over `directory`, serving in a thread."""
    handler = functools.partial(handler_cls, directory=str(directory))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _digests(path) -> None:
    digests = {}
    for fname in os.listdir(path):
        if fname.endswith(".safetensors"):
            with open(os.path.join(path, fname), "rb") as f:
                digests[fname] = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(path, "digests.json"), "w") as f:
        json.dump(digests, f)


def _tiny_llama():
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)).eval()


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A MULTI-shard tiny checkpoint and its digests.json."""
    path = tmp_path_factory.mktemp("weight_store")
    _tiny_llama().save_pretrained(path, max_shard_size="100KB", safe_serialization=True)
    _digests(path)
    assert len(json.loads((path / "digests.json").read_text())) >= 3
    return str(path)


@pytest.fixture(scope="module")
def store_url(store_dir):
    httpd, url = _serve(store_dir)
    yield url
    httpd.shutdown()


def _plan(cfg):
    return StagePlan.from_splits(cfg.num_layers, parse_splits("2,4"))


def _shards(fetches):
    return [n for n in fetches if n.endswith(".safetensors")]


def _equal_trees(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (a) the reference's five tests
# ---------------------------------------------------------------------------

def test_span_fetches_only_its_shards(store_url, store_dir, tmp_path):
    store = trs.RemoteShardStore(store_url, str(tmp_path / "cache"))
    cfg = config_from_checkpoint(store.fetch_config())
    spec = _plan(cfg).stages[1]          # the middle span [2, 4): no embed, no head
    params = store.load_stage(cfg, spec, device="cpu")
    every = {f for f in os.listdir(store_dir) if f.endswith(".safetensors")}
    fetched = set(_shards(store.fetches))
    assert fetched and fetched < every, sorted(fetched)
    assert fetched == set(store.shards_for_span(2, 4, is_first=False, is_last=False))
    # The local streaming path over the whole checkpoint gives the same tree.
    _equal_trees(params, load_stage_checkpoint(store_dir, cfg, spec, device="cpu"))


def test_respan_fetches_only_new_shards(store_url, tmp_path):
    store = trs.RemoteShardStore(store_url, str(tmp_path / "cache"))
    cfg = config_from_checkpoint(store.fetch_config())
    plan = _plan(cfg)
    store.load_stage(cfg, plan.stages[1], device="cpu")
    before = len(_shards(store.fetches))
    first_span = set(store.shards_for_span(2, 4, is_first=False, is_last=False))
    store.load_stage(cfg, plan.stages[2], device="cpu")     # re-span to [4, 6) + head
    new = _shards(store.fetches)[before:]
    assert new and not set(new) & first_span


def test_cache_stays_under_budget_lru(store_url, store_dir, tmp_path):
    store = trs.RemoteShardStore(store_url, str(tmp_path / "cache"))
    cfg = config_from_checkpoint(store.fetch_config())
    plan = _plan(cfg)
    final = store.shards_for_span(4, 6, is_first=False, is_last=True)
    budget = sum(os.path.getsize(os.path.join(store_dir, f)) for f in final) + 4096
    total = sum(os.path.getsize(os.path.join(store_dir, f))
                for f in os.listdir(store_dir) if f.endswith(".safetensors"))
    assert total > budget
    store.max_cache_bytes = budget
    store.evict_grace_s = 0.0   # the cross-process grace would keep these new shards
    store.load_stage(cfg, plan.stages[1], device="cpu")
    store.load_stage(cfg, plan.stages[2], device="cpu")
    assert store.cache_bytes() <= budget
    for name in final:
        assert os.path.exists(os.path.join(store.cache_dir, name)), name


def test_digest_mismatch_detected(store_dir, tmp_path):
    bad = tmp_path / "bad_store"
    shutil.copytree(store_dir, bad)
    digests = json.loads((bad / "digests.json").read_text())
    digests[sorted(digests)[0]] = "0" * 64
    (bad / "digests.json").write_text(json.dumps(digests))
    httpd, url = _serve(bad)
    try:
        store = trs.RemoteShardStore(url, str(tmp_path / "cache2"))
        cfg = config_from_checkpoint(store.fetch_config())
        with pytest.raises(trs.DigestMismatch):
            store.ensure_span(0, cfg.num_layers, is_first=True, is_last=True)
    finally:
        httpd.shutdown()


def test_lru_state_survives_restart(store_url, tmp_path):
    cache = str(tmp_path / "cache")
    store = trs.RemoteShardStore(store_url, cache)
    cfg = config_from_checkpoint(store.fetch_config())
    store.load_stage(cfg, _plan(cfg).stages[1], device="cpu")
    reopened = trs.RemoteShardStore(store_url, cache)
    assert reopened._lru and set(store.shards_for_span(2, 4, is_first=False, is_last=False)) \
        <= set(reopened._lru)


# ---------------------------------------------------------------------------
# (b) against the JAX store
# ---------------------------------------------------------------------------

def test_shards_for_span_equals_the_jax_store(store_url, tmp_path):
    port = trs.RemoteShardStore(store_url, str(tmp_path / "p"))
    jax_store = jrs.RemoteShardStore(store_url, str(tmp_path / "j"))
    cfg = config_from_checkpoint(port.fetch_config())
    specs = list(_plan(cfg).stages) + [StageSpec(0, ROLE_FULL, 0, cfg.num_layers),
                                       StageSpec(1, "segment", 1, 5)]
    for spec in specs:
        kw = {"is_first": spec.is_first, "is_last": spec.is_last}
        got = port.shards_for_span(spec.start, spec.end, **kw)
        assert got and got == jax_store.shards_for_span(spec.start, spec.end, **kw), spec
    assert port.weight_map() == jax_store.weight_map()


@pytest.mark.parametrize("filled_by", ["jax", "port"])
def test_one_packages_cache_serves_the_other(store_url, tmp_path, filled_by):
    """Both packages' stores keep one cache layout: a cache filled by one
    serves every stage of the other with no shard or index fetched, and
    each reads the other's LRU stamps."""
    cache = str(tmp_path / "cache")
    first_cls, second_cls = ((jrs.RemoteShardStore, trs.RemoteShardStore)
                             if filled_by == "jax" else
                             (trs.RemoteShardStore, jrs.RemoteShardStore))
    first = first_cls(store_url, cache)
    cfg = config_from_checkpoint(first.fetch_config())
    first.ensure_span(0, cfg.num_layers, is_first=True, is_last=True)
    assert _shards(first.fetches)
    second = second_cls(store_url, cache)
    assert second._lru == first._lru
    for spec in _plan(cfg).stages:
        if second_cls is trs.RemoteShardStore:
            second.load_stage(cfg, spec, device="cpu")
        else:
            second.load_stage(j_config_from_checkpoint(cache), spec)
    assert not [n for n in second.fetches
                if n.endswith(".safetensors") or n == trs.INDEX or n == trs.DIGESTS]
    with open(os.path.join(cache, ".lru_state.json")) as f:
        assert set(json.load(f)) >= set(_shards(first.fetches))


# ---------------------------------------------------------------------------
# (c) trees, the single-file layout, the digest file's answers
# ---------------------------------------------------------------------------

DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jax.numpy.bfloat16,
                                                               torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_load_stage_equals_the_jax_store_bit_for_bit(store_url, tmp_path, dtype):
    jdt, tdt = DTYPES[dtype]
    port = trs.RemoteShardStore(store_url, str(tmp_path / "p"))
    jax_store = jrs.RemoteShardStore(store_url, str(tmp_path / "j"))
    cfg = config_from_checkpoint(port.fetch_config())
    jcfg = j_config_from_checkpoint(jax_store.fetch_config())
    jplan = JStagePlan.from_splits(jcfg.num_layers, [2, 4])
    for spec in _plan(cfg).stages:
        got = port.load_stage(cfg, spec, dtype=tdt, device="cpu")
        want = jax_store.load_stage(jcfg, jplan.stages[spec.index], dtype=jdt)
        _equal_trees(got, from_jax_tree(jax.tree.map(np.asarray, want)))


def test_single_file_checkpoint_keys_read_by_the_port(tmp_path):
    """A single model.safetensors (no index): the weight map comes from the
    port's own header reader and equals the JAX store's (safe_open); a
    malformed index in front of it is dropped from the cache."""
    path = tmp_path / "single"
    _tiny_llama().save_pretrained(path, safe_serialization=True)
    assert not (path / trs.INDEX).exists()
    cfg = config_from_checkpoint(str(path))
    want = load_stage_checkpoint(str(path), cfg, _plan(cfg).stages[2], device="cpu")
    (path / trs.INDEX).write_text("<html>not an index</html>")
    httpd, url = _serve(path)
    try:
        port = trs.RemoteShardStore(url, str(tmp_path / "p"))
        jax_store = jrs.RemoteShardStore(url, str(tmp_path / "j"))
        wm = port.weight_map()
        assert wm == jax_store.weight_map() and set(wm.values()) == {trs.SINGLE}
        assert not os.path.exists(os.path.join(port.cache_dir, trs.INDEX))
        _equal_trees(port.load_stage(cfg, _plan(cfg).stages[2], device="cpu"), want)
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("code", [404, 403, 500])
def test_digest_file_answers(store_dir, tmp_path, code):
    """404: no digests, cached (shards unverified); 403: absent for
    DIGEST_403_TTL_S only, then probed again; any other error raises."""
    class Handler(QuietHandler):
        def do_GET(self):
            if self.path.endswith(trs.DIGESTS):
                self.send_error(code)
            else:
                super().do_GET()

    httpd, url = _serve(store_dir, Handler)
    try:
        store = trs.RemoteShardStore(url, str(tmp_path / "c"))
        if code == 500:
            with pytest.raises(OSError):
                store.digests()
            return
        assert store.digests() == {} and store.digests() == {}
        assert store.fetches.count(trs.DIGESTS) == 1
        store._digests_403_until = 0.0
        store.digests()
        assert store.fetches.count(trs.DIGESTS) == (1 if code == 404 else 2)
    finally:
        httpd.shutdown()


# ---------------------------------------------------------------------------
# (d) the CLI and an offloaded stage
# ---------------------------------------------------------------------------

def _tokens(out: str):
    return re.findall(r"^TOKENS=(\[[0-9, ]*\])$", out, re.M)


def test_cli_local_remote_checkpoint_prints_the_jax_tokens(monkeypatch, capsys, store_url,
                                                           tmp_path):
    argv = ["--mode", "local", "--splits", "2,4", "--checkpoint", store_url,
            "--weight_cache_dir", str(tmp_path / "port"), "--prompt", "Hi",
            "--max_new_tokens", str(STEPS), "--temperature", "0", "--quant", "int8"]
    assert tmain.main(argv + ["--device", "cpu"]) == 0
    got = _tokens(capsys.readouterr().out)
    jargv = argv[:argv.index("--weight_cache_dir") + 1] + [str(tmp_path / "jax")] + \
        argv[argv.index("--weight_cache_dir") + 2:]
    jcfg = j_config_from_checkpoint(jrs.RemoteShardStore(store_url, str(tmp_path / "jax"))
                                    .fetch_config())
    jgen, _ = jax_mode_generate(monkeypatch, jargv, jcfg, None)
    ids = [i % jcfg.vocab_size for i in tmain.load_tokenizer().encode("Hi")]
    assert got == [json.dumps(jgen(ids, STEPS, sampling=JSamplingParams(temperature=0.0))
                              .tokens)]
    store = tmain._STORES[(store_url, str(tmp_path / "port"))]
    assert set(_shards(store.fetches)) == {
        f for f in os.listdir(store.cache_dir) if f.endswith(".safetensors")}


def test_offloaded_stage_streams_through_the_store(store_url, tmp_path):
    """``_stage_params(offload=True)`` over a remote checkpoint: the span's
    shards fetched alone, each streamed layer built and packed a layer at
    a time, the values the resident load's."""
    args = port_args(["--checkpoint", store_url, "--weight_cache_dir", str(tmp_path / "c"),
                      "--splits", "2,4", "--keep_layers_on_gpu", "1", "--quant", "int8"])
    cfg = tmain.model_config(args)
    spec = tmain.stage_plan(args, cfg).stages[1]
    streamed = tmain._stage_params(args, cfg, None, spec, offload=True)
    store = tmain._remote_store(args)
    assert set(_shards(store.fetches)) == set(
        store.shards_for_span(2, 4, is_first=False, is_last=False))
    resident = tmain._stage_params(args, cfg, None, spec)
    a = toff.offload_layers(streamed["layers"], 1, "cpu")
    b = toff.offload_layers(resident["layers"], 1, "cpu")
    assert (a.keep, len(a.host)) == (b.keep, len(b.host)) == (1, 1)
    assert torch.equal(a.host[0].flat, b.host[0].flat)
