"""Host offload in the port (``runtime/offload.py``, ``StageExecutor(offload=,
keep_layers_resident=)``, ``--use_cpu_offload`` / ``--keep_layers_on_gpu``)
against the JAX package's offloaded executor, on the same bridged weights.

Port counterparts of tests/test_offload.py (a segment at keep 0, 2 and 99,
prefill then decode; the first and last roles on gpt2; an offloaded
pipeline against the oracle), of tests/test_quant.py's
``test_quantized_offload_combo`` and of tests/test_deep_prompts.py's
``test_deep_prompts_on_offload_engine``. Also: the executor keeps no device
copy of its streamed layers; an unpinned host layer is refused for a CUDA
device; the training verbs are refused with an error naming offload; the
layer-by-layer load (``main._stage_params(offload=True)``) gives the
resident load's values; the captured step through a stub graph; and
``--mode local --use_cpu_offload`` printing the resident run's tokens.

On the CPU the runner's copies are plain ``copy_`` (no stream, no pinned
memory). Tolerance: the reference's atol = rtol = 1e-5 at float32
(scale-relative, ``assert_close``) against JAX; the port's offloaded span
against its resident one bit for bit.
"""

import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    bridged,
    one_torch_thread,
    port_args,
    port_cfg,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StagePlan as JStagePlan,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    StageSpec as JStageSpec,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    slice_stage_params as j_slice,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.quant import (
    quantize_params as j_quantize,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.messages import (
    StageRequest as JStageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.partition import (
    StagePlan,
    StageSpec,
    parse_splits,
    slice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.quant import (
    tree_map,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    offload as toff,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.client import (
    PipelineClient,
    make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.executor import (
    StageExecutionError,
    StageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.messages import (
    BackwardRequest,
    StageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime.transport import (
    LocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)
from test_deep_prompts import make_prompts
from test_runtime_pipeline import oracle_generate, tiny_cfg
from test_torch_graphs import stub_graphs  # noqa: F401 (a fixture)

ROLES = {"first": 0, "mid": 1, "last": 2}


@pytest.fixture(scope="module")
def llama():
    """The reference test's tiny llama (8 layers), JAX's and bridged."""
    jcfg = tiny_cfg()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), bridged(jp)


def _spec(num_layers, role, splits="2,6"):
    return StagePlan.from_splits(num_layers, parse_splits(splits)).stages[ROLES[role]]


def _jspec(num_layers, role, splits="2,6"):
    return JStagePlan.from_splits(num_layers, [int(s) for s in splits.split(",")]).stages[
        ROLES[role]]


def _trio(weights, role="mid", keep=0, jtree=None, ttree=None):
    """(JAX offloaded, port resident, port offloaded) executors of one span
    on the same weights (`jtree` / `ttree` override the stage trees)."""
    jcfg, jp, tcfg, tp = weights
    jspec, spec = _jspec(jcfg.num_layers, role), _spec(tcfg.num_layers, role)
    jtree = j_slice(jcfg, jp, jspec) if jtree is None else jtree
    ttree = slice_stage_params(tcfg, tp, spec) if ttree is None else ttree
    j_off = JStageExecutor(jcfg, jspec, jtree, peer_id="j-off", offload=True,
                           keep_layers_resident=keep)
    res = StageExecutor(tcfg, spec, ttree, peer_id="res", device="cpu")
    off = StageExecutor(tcfg, spec, ttree, peer_id="off", device="cpu", offload=True,
                        keep_layers_resident=keep)
    return j_off, res, off


def _run(ex, hid, seq_len, cur_len, prefill, prompts=None):
    if isinstance(ex, JStageExecutor):
        return ex.forward(JStageRequest(
            session_id="s", hidden=jnp.asarray(hid), seq_len=seq_len, cur_len=cur_len,
            is_prefill=prefill, max_length=64,
            prompts=None if prompts is None else jnp.asarray(prompts)))
    return ex.forward(StageRequest(
        session_id="s", hidden=torch.from_numpy(np.asarray(hid)), seq_len=seq_len,
        cur_len=cur_len, is_prefill=prefill, max_length=64,
        prompts=None if prompts is None else torch.from_numpy(np.asarray(prompts))))


def _hold(j_out, res_out, off_out):
    """The port's offloaded hidden: within 1e-5 of JAX's offloaded one and
    bit-equal to the port's resident one."""
    assert_close(off_out.hidden.numpy(), np.asarray(j_out.hidden))
    assert torch.equal(off_out.hidden, res_out.hidden)


@pytest.mark.parametrize("keep", [0, 2, 99])   # 99: every layer resident
def test_offloaded_segment_matches_jax_offload(llama, keep):
    rng = np.random.default_rng(0)
    hid = rng.standard_normal((1, 10, llama[0].hidden_size)).astype(np.float32)
    step = rng.standard_normal((1, 1, llama[0].hidden_size)).astype(np.float32)
    trio = _trio(llama, "mid", keep)
    streamed = trio[2]._get_subspan(0, 4)[2].layers
    assert (streamed.keep, len(streamed.host)) == (min(keep, 4), 4 - min(keep, 4))
    _hold(*(_run(ex, hid, 10, 0, True) for ex in trio))
    _hold(*(_run(ex, step, 1, 10, False) for ex in trio))


def test_offloaded_first_and_last_roles():
    """The embedding entry (stage 0) and the head exit (last) offloaded, on
    gpt2 (learned positions: no rope)."""
    jcfg = tiny_cfg("gpt2")
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    weights = (jcfg, jp, port_cfg(jcfg), bridged(jp))
    ids = np.asarray([[5, 9, 23, 7]], np.int64)
    _hold(*(_run(ex, ids, 4, 0, True) for ex in _trio(weights, "first", keep=1)))
    hid = np.random.default_rng(1).standard_normal((1, 4, jcfg.hidden_size)).astype(
        np.float32)
    j_out, r_out, o_out = (_run(ex, hid, 4, 0, True) for ex in _trio(weights, "last"))
    assert o_out.token_id == r_out.token_id == j_out.token_id


def test_offloaded_pipeline_matches_oracle(llama):
    """Every server streams its layers from the host (keep 1); the greedy
    tokens equal the reference's unpartitioned oracle's."""
    jcfg, jp, tcfg, tp = llama
    plan = StagePlan.from_splits(tcfg.num_layers, parse_splits("2,4,6"))
    transport = LocalTransport()
    registry = PlacementRegistry(rng=random.Random(0))
    for spec in plan.stages[1:]:
        peer = f"off-s{spec.index}"
        transport.add_peer(peer, StageExecutor(
            tcfg, spec, slice_stage_params(tcfg, tp, spec), peer_id=peer, device="cpu",
            offload=True, keep_layers_resident=1))
        registry.register(make_server_record(peer, spec))
    stage0 = StageExecutor(tcfg, plan.stages[0], slice_stage_params(tcfg, tp, plan.stages[0]),
                           peer_id="client-local", device="cpu")
    client = PipelineClient(tcfg, plan, stage0, transport, registry, settle_seconds=0.0)
    prompt = [5, 9, 23, 7, 81]
    res = client.generate(prompt, max_new_tokens=6, sampling=SamplingParams(temperature=0.0))
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )

    assert res.tokens == oracle_generate(jcfg, jp, prompt, 6, JSamplingParams(temperature=0.0))


@pytest.mark.parametrize("quant", ["int8", "nf4"])
def test_quantized_offload_combo(llama, quant):
    """QuantizedTensor and NF4Tensor leaves survive the host packing and the
    per-layer streaming (keep 1)."""
    jcfg, jp, tcfg, _ = llama
    jspec = _jspec(jcfg.num_layers, "mid")
    jtree = j_quantize(j_slice(jcfg, jp, jspec), quant)
    trio = _trio(llama, "mid", keep=1, jtree=jtree, ttree=bridged(jtree))
    kinds = {type(w).__name__ for w in trio[2]._get_subspan(0, 4)[2].layers.host[0]
             .tree["attn"].values()}
    assert kinds == {"QuantizedTensor" if quant == "int8" else "NF4Tensor"}
    hid = np.random.default_rng(0).standard_normal((1, 6, jcfg.hidden_size)).astype(np.float32)
    _hold(*(_run(ex, hid, 6, 0, True) for ex in trio))


def test_deep_prompts_on_offload_engine(llama):
    """An offloaded span [2, 6) with keep 1 adds each layer's prompt at its
    entry, resident or streamed: prefill and three decode steps."""
    jcfg = llama[0]
    trio = _trio(llama, "mid", keep=1)
    prompts = np.asarray(make_prompts(jcfg, pre_seq=6))[2:6]
    rng = np.random.default_rng(1)
    cur = 0
    for step in range(4):
        t = 4 if step == 0 else 1
        x = rng.standard_normal((1, t, jcfg.hidden_size)).astype(np.float32)
        _hold(*(_run(ex, x, t, cur, step == 0, prompts) for ex in trio))
        cur += t


def _tensors(obj, seen=None):
    """Every tensor reachable from `obj` through dicts, lists, tuples and the
    port's param objects (QuantizedTensor, NF4Tensor, the offload classes),
    skipping host layers."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, toff.PackedLayer):
        return []          # host memory
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif isinstance(obj, toff.OffloadedLayers):
        items = [obj.resident]
    elif isinstance(obj, toff.OffloadedSpanRunner):
        items = [obj.layers, obj.aux, [s.flat for s in obj.slots]]
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(toff.__package__[:-8]):
        items = vars(obj).values()
    else:
        return []
    return [t for item in items for t in _tensors(item, seen)]


def test_offloaded_executor_keeps_no_device_copy_of_streamed_layers(llama):
    """The weights the executor holds outside its host layers (its params
    and every sub-span runner's layers, aux and slots, after a step) are
    the resident layers' storage and the runners' two slots each: no
    stacked span, no per-layer copy of a streamed layer. A sub-span shares
    the host buffers."""
    _, _, tcfg, tp = llama
    spec = _spec(tcfg.num_layers, "mid")
    ex = StageExecutor(tcfg, spec, slice_stage_params(tcfg, tp, spec), peer_id="off",
                       device="cpu", offload=True, keep_layers_resident=1)
    ex._get_subspan(1, 3)
    hid = np.random.default_rng(0).standard_normal((1, 3, tcfg.hidden_size)).astype(np.float32)
    _run(ex, hid, 3, 0, True)
    runners = [entry[2] for entry in ex._subspans.values()]
    assert len(runners) == 2 and all(isinstance(r, toff.OffloadedSpanRunner) for r in runners)
    held = {t.untyped_storage().data_ptr() for t in _tensors([ex.params, ex._subspans])
            if t.numel()}
    resident = {t.untyped_storage().data_ptr()
                for t in toff._leaves(ex.params["layers"].resident)}
    slots = {s.flat.untyped_storage().data_ptr() for r in runners for s in r.slots}
    assert len(slots) == 4 and held == resident | slots
    hosts = {id(h) for r in runners for h in r.layers.host}
    assert hosts == {id(h) for h in ex.params["layers"].host} and len(hosts) == 3


def test_unpinned_host_layer_is_refused_for_a_cuda_device(llama):
    """The copy engine streams from pinned memory only: on a CUDA device an
    unpinned host layer raises (nothing runs on the device before that)."""
    _, _, tcfg, tp = llama
    spec = _spec(tcfg.num_layers, "mid")
    layers = slice_stage_params(tcfg, tp, spec)["layers"]
    host = [toff.host_layer(tree_map(lambda a: a[0], layers), "cpu")]
    assert not host[0].flat.is_pinned()
    with pytest.raises(ValueError, match="not in pinned host memory"):
        toff.OffloadedSpanRunner(tcfg, StageSpec(1, "segment", 2, 3),
                                 {"layers": toff.OffloadedLayers({}, host)}, device="cuda")


@pytest.mark.parametrize("verb", ["train_forward", "backward"])
def test_training_verbs_are_refused_on_an_offloaded_span(llama, verb):
    _, _, tcfg, tp = llama
    spec = _spec(tcfg.num_layers, "mid")
    ex = StageExecutor(tcfg, spec, slice_stage_params(tcfg, tp, spec), peer_id="off",
                       device="cpu", offload=True, keep_layers_resident=1)
    x = torch.zeros(1, 4, tcfg.hidden_size)
    req = (StageRequest(session_id="t", hidden=x, seq_len=4, cur_len=0, is_prefill=True,
                        max_length=8) if verb == "train_forward" else
           BackwardRequest(session_id="t", hidden=x, seq_len=4, grad_output=x))
    with pytest.raises(StageExecutionError, match="host-offloaded span .*--use_cpu_offload"):
        getattr(ex, verb)(req)


def _packed_equal(a: toff.OffloadedLayers, b: toff.OffloadedLayers) -> None:
    assert a.keep == b.keep and len(a.host) == len(b.host)
    for x, y in zip(toff._leaves(a.resident), toff._leaves(b.resident)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(a.host, b.host):
        assert x.layout == y.layout and torch.equal(x.flat, y.flat)


@pytest.mark.parametrize("source", ["random", "loaded"])
@pytest.mark.parametrize("quant", ["none", "int8", "nf4"])
def test_layer_by_layer_load_gives_the_resident_values(monkeypatch, llama, source, quant):
    """``_stage_params(offload=True)`` builds each streamed layer alone
    (drawn by the random init, or sliced from a loaded tree), quantizes it
    and packs it into host memory: the executor's split equals the one it
    makes of the resident load's stacked tree, bit for bit. The stacked
    tree the loader returns holds the resident layers only."""
    tcfg = llama[2]
    monkeypatch.setattr(tmain, "get_config", lambda name: tcfg)
    args = port_args(["--quant", quant, "--keep_layers_on_gpu", "1", "--splits", "2,6"])
    spec = tmain.stage_plan(args, tcfg).stages[2]          # [6, 8) and the head
    full = None if source == "random" else tmain.load_model(args)[1]
    streamed = tmain._stage_params(args, tcfg, full, spec, offload=True)
    assert isinstance(streamed["layers"], toff.OffloadedLayers)
    assert streamed["layers"].keep == 1 and len(streamed["layers"].host) == 1
    resident = tmain._stage_params(args, tcfg, full, spec)
    assert streamed.keys() == resident.keys()
    _packed_equal(toff.offload_layers(streamed["layers"], 1, "cpu"),
                  toff.offload_layers(resident["layers"], 1, "cpu"))
    for k in set(resident) - {"layers"}:
        for x, y in zip(toff._leaves(streamed[k]), toff._leaves(resident[k])):
            assert torch.equal(x, y)


def test_layer_by_layer_load_merges_lora_before_quant(monkeypatch, llama, tmp_path):
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
        lora as tlora,
    )

    tcfg = llama[2]
    monkeypatch.setattr(tmain, "get_config", lambda name: tcfg)
    gen = torch.Generator().manual_seed(3)
    d, hd = tcfg.hidden_size, tcfg.num_heads * tcfg.head_dim
    adapter = {"wq": {"a": torch.randn(tcfg.num_layers, d, 4, generator=gen),
                      "b": torch.randn(tcfg.num_layers, 4, hd, generator=gen)}}
    path = str(tmp_path / "adapter.npz")
    tlora.save_lora(path, adapter, 0.5)
    args = port_args(["--quant", "int8", "--keep_layers_on_gpu", "2", "--lora", path])
    spec = StageSpec(1, "segment", 2, 6)
    streamed = tmain._stage_params(args, tcfg, None, spec, offload=True)
    plain = tmain._stage_params(port_args(["--quant", "int8", "--keep_layers_on_gpu", "2"]),
                                tcfg, None, spec, offload=True)
    resident = tmain._stage_params(args, tcfg, None, spec)
    _packed_equal(toff.offload_layers(streamed["layers"], 2, "cpu"),
                  toff.offload_layers(resident["layers"], 2, "cpu"))
    assert not torch.equal(streamed["layers"].host[0].flat, plain["layers"].host[0].flat)


def test_offloaded_steps_through_captured_graphs(llama, stub_graphs):
    """The runner's call captured as the executor's step (a stub graph on
    the CPU): each replay streams the layers again and gives the eager
    step's bits; the decode steps replay and capture no more."""
    _, _, tcfg, tp = llama
    spec = _spec(tcfg.num_layers, "mid")
    tree = slice_stage_params(tcfg, tp, spec)
    eager = StageExecutor(tcfg, spec, tree, peer_id="e", device="cpu", offload=True,
                          keep_layers_resident=2)
    ex = StageExecutor(tcfg, spec, tree, peer_id="g", device="cpu", offload=True,
                       keep_layers_resident=2)
    ex.graphs.enabled = True
    rng = np.random.default_rng(2)
    cur, captures = 0, []
    for step in range(5):
        t = 5 if step == 0 else 1
        x = rng.standard_normal((1, t, tcfg.hidden_size)).astype(np.float32)
        got, want = (_run(e, x, t, cur, step == 0) for e in (ex, eager))
        assert torch.equal(got.hidden, want.hidden)
        captures.append(ex.graphs.captures)
        cur += t
    assert captures == [1, 2, 2, 2, 2] and ex.graphs.replays == 5


def test_cli_local_offload_prints_the_resident_tokens(monkeypatch, capsys, llama):
    """``--mode local --use_cpu_offload --keep_layers_on_gpu 1`` on random
    weights: each server draws its span, streams it, and the greedy tokens
    are the resident run's."""
    monkeypatch.setattr(tmain, "get_config", lambda name: llama[2])
    base = ["--mode", "local", "--device", "cpu", "--splits", "2,4,6", "--quant", "int8",
            "--temperature", "0", "--max_new_tokens", "6", "--prompt", "Hi"]
    built = []
    real = toff.OffloadedSpanRunner.__init__

    def record(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(toff.OffloadedSpanRunner, "__init__", record)
    outs = []
    for extra in ([], ["--use_cpu_offload", "--keep_layers_on_gpu", "1"]):
        assert tmain.main(base + extra) == 0
        outs.append(re.findall(r"^TOKENS=(\[.*\])$", capsys.readouterr().out, re.M))
    assert outs[0] == outs[1] and len(outs[0]) == 1
    assert [(r.spec.start, r.keep_resident, len(r.layers.host)) for r in built] == [
        (2, 1, 1), (4, 1, 1), (6, 1, 1)]
