"""Distributed fine-tuning in the port (``runtime/finetune.py``, the
executor's training verbs, their wire form) against the JAX package's
``DistributedFineTuner`` on the same weights.

The reference's own test (``tests/test_finetune.py``) holds its tuner to
an unpartitioned ``jax.grad``; here the port's tuner is held to the
reference's tuner, started from the same trainables
(``models/bridge.tuner_state_from_jax``), on bridged weights: tiny llama,
8 layers, splits ``2,4,6``. Covered: deep-prompt and embedding gradients,
LoRA gradients (adapters with both factors non-zero), a sequence shorter
than pre_seq, a step re-routed past a killed peer, a prompt step on int8
spans, LoRA refused on a quantized span, checkpoints written by one package
and restored by the other, ``export_lora`` served through ``--lora``, steps
over TCP both ways (a JAX tuner with port servers, a port tuner with JAX
servers), the pre-LoRA peer guard and the server's frame-arity check. The
gradient of each kernel wrapper's ``autograd.Function`` (the card's path)
is checked on the CPU with its launch swapped for the plain version.

Tolerance: the loss within rtol 1e-4 of the reference tuner's, gradients
(read from the first AdamW moment at lr 0, ``mu / 0.1``) within rtol 2e-3
and atol 1e-6 (2e-6 for the embedding): the reference's own bounds against
its oracle. Over TCP at wire f32 the gradients equal the local transport's
within float32 rounding (rtol 1e-5).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_close,
    build_port_cluster,
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
    parse_splits as jparse_splits,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.partition import (
    slice_stage_params as jslice_stage_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models.quant import (
    quantize_params as j_quantize_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    finetune as jfinetune,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    net as jnet,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
    PipelineClient as JPipelineClient,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.client import (
    make_server_record as j_make_server_record,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.executor import (
    StageExecutor as JStageExecutor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime.transport import (
    LocalTransport as JLocalTransport,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling.registry import (
    PlacementRegistry as JPlacementRegistry,
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
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.bridge import (
    from_jax_tree,
    tuner_state_from_jax,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops import (
    int8_kernel,
    nf4_kernel,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.parallel.trainer import (
    softmax_xent,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    finetune as tfinetune,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    net as tnet,
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
    StageRequest,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling.registry import (
    PlacementRegistry,
)

from test_finetune import oracle_ptune_loss
from test_runtime_pipeline import tiny_cfg

SPLITS = "2,4,6"
TCP_SPLITS = "3,6"
RTOL_LOSS = 1e-4
RTOL_GRAD = 2e-3
ATOL_GRAD = 1e-6
ATOL_EMBED = 2e-6


def make_batch(cfg, b, t, seed=0):
    """The reference test's batch: random ids, targets the next id, the
    last position ignored."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    targets = np.concatenate([ids[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
    return ids, targets


def jax_head(cfg, params):
    head = {"final_norm": params["final_norm"]}
    if not cfg.tie_word_embeddings:
        head["lm_head"] = params["lm_head"]
    return head


def port_head(tcfg, tparams):
    head = {"final_norm": tparams["final_norm"]}
    if not tcfg.tie_word_embeddings:
        head["lm_head"] = tparams["lm_head"]
    return head


def jax_cluster(cfg, params, splits, replicas=1):
    """The reference test's cluster (``test_runtime_pipeline.build_cluster``)
    over the given `params`, quantized or not."""
    plan = JStagePlan.from_splits(cfg.num_layers, jparse_splits(splits))
    transport = JLocalTransport()
    registry = JPlacementRegistry(rng=random.Random(0))
    for spec in plan.stages[1:]:
        for r in range(replicas):
            peer = f"peer-s{spec.index}-r{r}"
            transport.add_peer(peer, JStageExecutor(
                cfg, spec, jslice_stage_params(cfg, params, spec), peer_id=peer))
            registry.register(j_make_server_record(peer, spec))
    stage0 = JStageExecutor(cfg, plan.stages[0],
                            jslice_stage_params(cfg, params, plan.stages[0]),
                            peer_id="client-local")
    return JPipelineClient(cfg, plan, stage0, transport, registry, settle_seconds=0.0,
                           seed=0), transport


def randomize_b(lora, seed=7, scale=0.02):
    """A zero b makes a's gradient zero: perturb b (the reference test's)."""
    return {t: {"a": ab["a"],
                "b": scale * jax.random.normal(jax.random.PRNGKey(seed + i), ab["b"].shape)}
            for i, (t, ab) in enumerate(sorted(lora.items()))}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_tuner_like(jft, tcfg, client, tparams, **kw):
    """A port tuner built as `jft` was, started from its trainables and
    optimizer state."""
    ft = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tparams), **kw)
    ft.trainables, ft.opt_state = tuner_state_from_jax(
        np_tree(jft.trainables), np_tree(jft.opt_state))
    return ft


def grads_of(opt_state):
    """The step's gradients at lr 0: the first moment over 0.1."""
    return jax.tree.map(lambda m: np.asarray(m) / 0.1, opt_state["mu"])


def port_grads_of(opt_state):
    return tfinetune.tree_map(lambda m: m.detach().cpu().numpy() / 0.1, opt_state["mu"])


def assert_grads(port, ref, *, atol=ATOL_GRAD, rtol=RTOL_GRAD):
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_cfg()                     # llama, 8 layers, hidden 64
    params = j_init_params(jax.random.PRNGKey(0), cfg)
    tcfg = port_cfg(cfg)
    return cfg, params, tcfg, from_jax_tree(np_tree(params))


@pytest.fixture(scope="module")
def joint_step(weights):
    """One step at lr 0 of both packages' tuners on the same cluster
    weights, trainables and batch: deep prompts, the embedding and LoRA
    adapters (rank 4, b perturbed) at once, B = 2, T = 12, pre_seq 4."""
    cfg, params, tcfg, tparams = weights
    ids, targets = make_batch(cfg, 2, 12)
    jclient, _ = jax_cluster(cfg, params, SPLITS)
    jft = jfinetune.DistributedFineTuner(cfg, jclient, jax_head(cfg, params), pre_seq=4,
                                         lr=0.0, tune_embed=True, lora_rank=4)
    jft.trainables["lora"] = randomize_b(jft.trainables["lora"])
    tclient, ttransport = build_port_cluster(tcfg, tparams, SPLITS)
    tft = port_tuner_like(jft, tcfg, tclient, tparams, pre_seq=4, lr=0.0, tune_embed=True,
                          lora_rank=4)
    jloss = jft.step(jnp.asarray(ids), jnp.asarray(targets))
    tloss = tft.step(ids, targets)
    return {"jloss": jloss, "tloss": tloss, "jgrads": grads_of(jft.opt_state),
            "tgrads": port_grads_of(tft.opt_state), "transport": ttransport,
            "jft": jft, "tft": tft}


def test_prompt_and_embedding_grads_match_jax(joint_step):
    np.testing.assert_allclose(joint_step["tloss"], joint_step["jloss"], rtol=RTOL_LOSS)
    j, t = joint_step["jgrads"], joint_step["tgrads"]
    assert np.any(t["prompts"] != 0.0)
    assert_grads(t["prompts"], j["prompts"])
    assert_grads(t["embed"]["wte"], j["embed"]["wte"], atol=ATOL_EMBED)


def test_lora_grads_match_jax(joint_step):
    j, t = joint_step["jgrads"]["lora"], joint_step["tgrads"]["lora"]
    assert sorted(t) == sorted(j) == ["wq", "wv"]
    for name in j:
        for leaf in ("a", "b"):
            assert np.any(t[name][leaf] != 0.0), (name, leaf)
            assert_grads(t[name][leaf], j[name][leaf])


def test_every_hop_served_a_training_forward_and_backward(joint_step):
    """Three remote stages: each served one train_forward and one backward
    (``requests_served`` counts both)."""
    transport = joint_step["transport"]
    assert [transport.executor(p).requests_served for p in transport.peers()] == [2, 2, 2]


def oracle_grad(cfg, params, prompts, ids, targets):
    """The reference's unpartitioned loss and its gradient in the prompts
    (``tests/test_finetune.py``'s oracle: all blocks, prompts at each)."""
    loss, g = jax.value_and_grad(
        lambda pr: oracle_ptune_loss(cfg, params, pr, jnp.asarray(ids), jnp.asarray(targets))
    )(jnp.asarray(prompts.cpu().numpy()))
    return float(loss), np.asarray(g)


def test_short_sequence_uses_the_first_prompt_rows(weights):
    """T = 4 < pre_seq = 8: the reference's loss and prompt gradients (its
    oracle's), the unused prompt rows' gradients exactly zero."""
    cfg, params, tcfg, tparams = weights
    ids, targets = make_batch(cfg, 1, 4)
    client, _ = build_port_cluster(tcfg, tparams, SPLITS)
    ft = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tparams), pre_seq=8,
                                        lr=0.0)
    want_loss, want = oracle_grad(cfg, params, ft.trainables["prompts"], ids, targets)
    np.testing.assert_allclose(ft.step(ids, targets), want_loss, rtol=RTOL_LOSS)
    t = port_grads_of(ft.opt_state)["prompts"]
    assert np.all(t[:, 4:] == 0.0) and np.any(t[:, :4] != 0.0)
    assert_grads(t, want)


def test_step_reroutes_past_a_killed_peer(weights):
    """Servers keep nothing between training calls: with the routed
    stage-2 peer killed, the next step re-routes to its replica and
    continues."""
    cfg, params, tcfg, tparams = weights
    ids, targets = make_batch(cfg, 1, 8)
    client, transport = build_port_cluster(tcfg, tparams, SPLITS, replicas=2)
    ft = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tparams), pre_seq=2,
                                        lr=1e-2)
    first = ft.step(ids, targets)
    victim = client.route(kind="exotic")[1].peer_id
    transport.kill(victim)
    second = ft.step(ids, targets)
    assert np.isfinite(second) and second != first and ft.steps == 2
    assert client.route(kind="exotic")[1].peer_id != victim
    assert victim in client.failed_peers[client.route(kind="exotic")[1].key]


def test_prompt_step_on_int8_spans_matches_jax(weights):
    """Every span int8 (the reference's quantizer, bridged): a prompt step's
    loss and gradients through the int8 projections equal the reference's
    (its oracle's) on the same quantized weights."""
    cfg, params, tcfg, _ = weights
    qparams = j_quantize_params(params, "int8")
    tq = from_jax_tree(np_tree(qparams))
    ids, targets = make_batch(cfg, 2, 12, seed=1)
    client, transport = build_port_cluster(tcfg, tq, SPLITS)
    assert isinstance(transport.executor("peer-s1-r0").params["layers"]["attn"]["wqkv"],
                      int8_kernel.QuantizedTensor)
    ft = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tq), pre_seq=4, lr=0.0)
    want_loss, want = oracle_grad(cfg, qparams, ft.trainables["prompts"], ids, targets)
    np.testing.assert_allclose(ft.step(ids, targets), want_loss, rtol=RTOL_LOSS)
    assert_grads(port_grads_of(ft.opt_state)["prompts"], want)


def test_lora_refused_on_a_quantized_span(weights):
    cfg, params, tcfg, tparams = weights
    client, transport = build_port_cluster(tcfg, tparams, SPLITS, quant="int8")
    lora = tlora.init_lora(torch.Generator().manual_seed(0), tcfg, 2, 2)
    req = StageRequest(session_id="q", hidden=torch.zeros(1, 4, cfg.hidden_size), seq_len=4,
                       cur_len=0, is_prefill=False, max_length=0, train=True, lora=lora,
                       lora_scale=1.0)
    with pytest.raises(StageExecutionError,
                       match="LoRA training is unsupported on a quantized span"):
        transport.executor("peer-s1-r0").train_forward(req)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_in_the_other_package(joint_step, tmp_path, writer):
    """`save` in one package, `restore` in the other (the tuners of the
    joint step, after it): the same keys, trainables, moments, count and
    steps."""
    jft, tft = joint_step["jft"], joint_step["tft"]
    path = str(tmp_path / "tune.npz")
    if writer == "jax":
        jft.save(path)
        tft.restore(path)
    else:
        tft.save(path)
        jft.restore(path)
    with np.load(path) as data:
        keys = set(data.files)
    assert {"['trainables']['lora']['wq']['a']", "['trainables']['embed']['wte']",
            "['opt']['mu']['prompts']", "['opt']['count']", "__steps__"} <= keys
    assert jft.steps == tft.steps == 1
    want = np_tree({"trainables": jft.trainables, "opt": jft.opt_state})
    got = tfinetune.tree_map(lambda t: t.cpu().numpy(),
                             {"trainables": tft.trainables, "opt": tft.opt_state})
    jax.tree.map(np.testing.assert_array_equal, got, want)


def test_export_lora_serves_through_lora_flag(weights, tmp_path):
    """A pure-LoRA tune (pre_seq 0) exported, then folded in by ``--lora``:
    the merged weights' loss equals the training forward's with the
    adapters; a tuner that also trains prompts is refused unless partial."""
    cfg, params, tcfg, tparams = weights
    ids, targets = make_batch(cfg, 1, 10, seed=6)
    client, _ = build_port_cluster(tcfg, tparams, SPLITS)
    ft = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tparams), pre_seq=0,
                                        lr=3e-2, lora_rank=2)
    for _ in range(2):
        ft.step(ids, targets)
    path = str(tmp_path / "adapters")
    ft.export_lora(path)
    args = port_args(["--lora", path + ".npz"])
    merged = tmain._maybe_lora(args, tcfg, tparams)
    tmain._maybe_lora._cache.clear()
    ids_t = torch.as_tensor(ids).long()
    tg = torch.as_tensor(targets).long()
    pos = torch.arange(ids.shape[1])[None, :]

    def loss(p, lora):
        x = ttransformer.embed_tokens(tcfg, p["embed"], ids_t, pos)
        x = ttransformer.stack_forward_train(tcfg, p["layers"], x, pos, remat=False, lora=lora,
                                             lora_scale=ft.lora_scale)
        return float(softmax_xent(ttransformer.lm_head(tcfg, p, x), tg))

    np.testing.assert_allclose(loss(merged, None), loss(tparams, ft.trainables["lora"]),
                               rtol=1e-5)
    mixed = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tparams), pre_seq=2,
                                           lora_rank=2)
    with pytest.raises(ValueError, match="pure-LoRA|prompts"):
        mixed.export_lora(str(tmp_path / "partial"))
    mixed.export_lora(str(tmp_path / "partial"), allow_partial=True)


def serve_tcp(pkg, cfg, params, tcfg, tparams):
    """Stages 1-2 of a ``3,6`` split behind TCP servers of package `pkg`
    at wire f32, in a registry of that package's client."""
    registry = (JPlacementRegistry if pkg == "jax" else PlacementRegistry)(
        rng=random.Random(0))
    servers = []
    if pkg == "jax":
        plan = JStagePlan.from_splits(cfg.num_layers, jparse_splits(TCP_SPLITS))
        for spec in plan.stages[1:]:
            ex = JStageExecutor(cfg, spec, jslice_stage_params(cfg, params, spec),
                                peer_id=f"jax-s{spec.index}")
            srv = jnet.TcpStageServer(ex, wire_dtype="f32")
            srv.start()
            servers.append((srv, j_make_server_record(ex.peer_id, spec)))
    else:
        plan = tmain.StagePlan.from_splits(tcfg.num_layers, tmain.parse_splits(TCP_SPLITS))
        args = port_args([])
        for spec in plan.stages[1:]:
            ex = StageExecutor(tcfg, spec, tmain._stage_params(args, tcfg, tparams, spec),
                               peer_id=f"port-s{spec.index}", device="cpu")
            srv = tnet.TcpStageServer(ex, None, wire_dtype="f32")
            srv.start()
            servers.append((srv, make_server_record(ex.peer_id, spec)))
    return registry, servers


def tcp_client(pkg, cfg, params, tcfg, tparams, server_pkg):
    """A client of package `pkg` over TCP to `server_pkg`'s servers, and
    the same client's servers in process (its LocalTransport cluster)."""
    registry, servers = serve_tcp(server_pkg, cfg, params, tcfg, tparams)
    # The client's registry holds the servers' records with their addresses.
    reg = (JPlacementRegistry if pkg == "jax" else PlacementRegistry)(rng=random.Random(0))
    for srv, rec in servers:
        rec = (j_make_server_record if pkg == "jax" else make_server_record)(
            rec.peer_id, _spec_of(pkg, cfg, tcfg, rec))
        rec.address = srv.address
        reg.register(rec)
    if pkg == "jax":
        plan = JStagePlan.from_splits(cfg.num_layers, jparse_splits(TCP_SPLITS))
        stage0 = JStageExecutor(cfg, plan.stages[0],
                                jslice_stage_params(cfg, params, plan.stages[0]),
                                peer_id="client-local")
        client = JPipelineClient(cfg, plan, stage0, jnet.TcpTransport(reg, wire_dtype="f32"),
                                 reg, settle_seconds=0.0)
    else:
        plan = tmain.StagePlan.from_splits(tcfg.num_layers, tmain.parse_splits(TCP_SPLITS))
        stage0 = StageExecutor(tcfg, plan.stages[0],
                               tmain._stage_params(port_args([]), tcfg, tparams, plan.stages[0]),
                               peer_id="client-local", device="cpu")
        client = PipelineClient(tcfg, plan, stage0, tnet.TcpTransport(reg, wire_dtype="f32"),
                                reg, settle_seconds=0.0)
    return client, [srv for srv, _ in servers]


def _spec_of(pkg, cfg, tcfg, rec):
    index = int(rec.peer_id.rsplit("s", 1)[1])
    if pkg == "jax":
        return JStagePlan.from_splits(cfg.num_layers, jparse_splits(TCP_SPLITS)).stages[index]
    return tmain.StagePlan.from_splits(tcfg.num_layers,
                                       tmain.parse_splits(TCP_SPLITS)).stages[index]


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_step_over_tcp_across_packages(weights, client_pkg, server_pkg):
    """A tuner of one package with the other package's TCP servers at wire
    f32 (prompts and LoRA, b perturbed): its loss and gradients equal the
    port tuner's over LocalTransport from the same trainables, within
    float32 rounding of each tensor's scale."""
    cfg, params, tcfg, tparams = weights
    ids, targets = make_batch(cfg, 1, 8)
    client, servers = tcp_client(client_pkg, cfg, params, tcfg, tparams, server_pkg)
    try:
        if client_pkg == "jax":
            ft = jfinetune.DistributedFineTuner(cfg, client, jax_head(cfg, params), pre_seq=2,
                                                lr=0.0, lora_rank=2)
            ft.trainables["lora"] = randomize_b(ft.trainables["lora"])
            start = ft
            loss = ft.step(jnp.asarray(ids), jnp.asarray(targets))
            got = grads_of(ft.opt_state)
        else:
            jlocal, _ = jax_cluster(cfg, params, TCP_SPLITS)
            start = jfinetune.DistributedFineTuner(cfg, jlocal, jax_head(cfg, params),
                                                   pre_seq=2, lr=0.0, lora_rank=2)
            start.trainables["lora"] = randomize_b(start.trainables["lora"])
            ft = port_tuner_like(start, tcfg, client, tparams, pre_seq=2, lr=0.0, lora_rank=2)
            loss = ft.step(ids, targets)
            got = port_grads_of(ft.opt_state)
        assert all(srv.executor.requests_served == 2 for srv in servers)
    finally:
        client.transport.close()
        for srv in servers:
            srv.stop()
    tlocal, _ = build_port_cluster(tcfg, tparams, TCP_SPLITS)
    ref = port_tuner_like(start, tcfg, tlocal, tparams, pre_seq=2, lr=0.0, lora_rank=2)
    if client_pkg == "jax":
        # The JAX tuner's opt_state after its step: start from zeros.
        ref.opt_state = tfinetune.adamw_init(ref.trainables)
    np.testing.assert_allclose(loss, ref.step(ids, targets), rtol=1e-5)
    jax.tree.map(assert_close, got, port_grads_of(ref.opt_state))


def test_lora_not_shipped_to_a_peer_without_lora(weights):
    """The reference's fix of a pre-LoRA server that would read adapters as
    prompts: a port client asks the peer's ``info`` first, and a peer that
    does not advertise LoRA gets a stage error naming it and no frame."""
    cfg, params, tcfg, tparams = weights
    client, servers = tcp_client("port", cfg, params, tcfg, tparams, "port")
    old = servers[0]
    old._info = lambda ex, _info=old._info: {**_info(ex), "lora": False, "version": 0}
    try:
        ft = tfinetune.DistributedFineTuner(tcfg, client, port_head(tcfg, tparams), pre_seq=2,
                                            lr=0.0, lora_rank=2)
        peer = old.executor.peer_id
        with pytest.raises(StageExecutionError, match=f"peer {peer} .*does not advertise LoRA"):
            client.transport.call(peer, StageRequest(
                session_id="old", hidden=torch.zeros(1, 4, cfg.hidden_size), seq_len=4,
                cur_len=0, is_prefill=False, max_length=0, train=True,
                lora=tlora.slice_lora(ft.trainables["lora"], 3, 6), lora_scale=1.0,
                start_block=3, end_block=6))
        assert old.executor.requests_served == 0
        with pytest.raises(RuntimeError, match="failed after 3 attempts"):
            ft.step(*make_batch(cfg, 1, 4))
        assert old.executor.requests_served == 0
    finally:
        client.transport.close()
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("kernel", ["int8", "nf4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_function_gradient_is_the_plain_versions(monkeypatch, kernel, dtype):
    """The card's path in each wrapper (an ``autograd.Function`` around the
    launch), run here with the launch swapped for the plain version: its
    output has a grad_fn and its gradient equals autograd's through the
    plain version, with the column blocks of a small GRAD_CHUNK_BYTES."""
    from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models.quant import (
        quantize_layers,
    )

    gen = torch.Generator().manual_seed(0)
    w = 0.05 * torch.randn((256, 96), generator=gen)
    leaf = quantize_layers({"wo": w}, kernel)["wo"]
    x = torch.randn((6, 256), generator=gen).to(dtype).requires_grad_()
    g = torch.randn((6, 96), generator=gen).to(dtype)
    monkeypatch.setattr(int8_kernel, "GRAD_CHUNK_BYTES", 256 * 16 * 32)
    if kernel == "int8":
        monkeypatch.setattr(int8_kernel, "_launch", lambda x, q, s: int8_kernel.int8_dot_reference(x, q, s))
        y = int8_kernel._Int8Dot.apply(x, leaf.q, leaf.s)
        y_ref = int8_kernel.int8_dot_reference(x, leaf.q, leaf.s)
    else:
        monkeypatch.setattr(nf4_kernel, "_launch", lambda x, w: nf4_kernel.nf4_dot_reference(x, w))
        y = nf4_kernel._NF4Dot.apply(x, leaf.packed, leaf.scales, leaf)
        y_ref = nf4_kernel.nf4_dot_reference(x, leaf)
    assert y.grad_fn is not None and y.dtype == dtype
    (gx,) = torch.autograd.grad(y, x, g)
    (gx_ref,) = torch.autograd.grad(y_ref, x, g)
    assert gx.dtype == dtype
    torch.testing.assert_close(gx.float(), gx_ref.float(), rtol=1e-5 if dtype == torch.float32
                               else 1e-2, atol=1e-6 if dtype == torch.float32 else 1e-2)
