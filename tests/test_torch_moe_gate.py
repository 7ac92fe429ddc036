"""The MoE token gate of ``chip_smoke.py`` on the CPU, at tiny widths.

The card holds an MoE run's tokens to a reference teacher-forced on them
(`hold_forced`, `judge_steps`), and a lockstep batched run at the default
capacity to a reference that puts each round's rows through one dispatch
(`slot_round_reference`). These tests show, on a 4-layer Mixtral of 8
experts split into 4 stages, that the references model the port's engines
exactly (every step the run's token is the reference's choice), that the
default capacity drops slots there, and that the gate refuses runs with a
planted fault.
"""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

from _torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    config as tconfig,
    transformer as ttf,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

NEW_TOKENS = 6
GREEDY = SamplingParams(temperature=0.0)
SAMPLED = SamplingParams(temperature=0.7, top_p=0.9, top_k=50, repetition_penalty=1.5)


@pytest.fixture(scope="module")
def cluster():
    """A 4-stage int8 cluster of a tiny Mixtral on the CPU, and its
    references over the stages' own weights."""
    cfg = tconfig.mixtral_config(
        vocab_size=131, hidden_size=64, num_layers=4, num_heads=4, num_kv_heads=2,
        intermediate_size=96, num_experts=8, num_experts_per_tok=2,
        max_position_embeddings=256)
    args = tmain.build_parser().parse_args(
        ["--mode", "local", "--device", "cpu", "--splits", "1,2,3", "--quant", "int8"])
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    client = tmain.build_local_client(args, cfg, params)
    return cfg, client, chip_smoke.staged_params(client)


@pytest.mark.parametrize("factor", ["2", "0"])
def test_slot_round_reference_models_the_lockstep_engines(cluster, factor, monkeypatch):
    """`lockstep_run`'s batched engines against `slot_round_reference` fed
    the same stage-0 rows: every step's token is the reference's argmax,
    at the default capacity (whose rounds drop slots) and drop-free (which
    drops none)."""
    cfg, client, staged = cluster
    monkeypatch.setenv("MOE_CAPACITY_FACTOR", factor)
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(11)]
               for i in range(chip_smoke.SLOTS)]
    tokens, slots, prefills, rounds, _ = chip_smoke.lockstep_run(
        torch, cfg, client, prompts, NEW_TOKENS, "cpu")
    by_slot = sorted(range(chip_smoke.SLOTS), key=lambda i: slots[i])
    ref = chip_smoke.StagedParams(staged, stages=staged["stages"][1:],
                                  acts=[torch.float32] * 3, cache_dtypes=[torch.float32] * 3)
    steps, dropped = chip_smoke.slot_round_reference(
        torch, cfg, ref, [prefills[i] for i in by_slot], rounds, [tokens[i] for i in by_slot])
    for b, i in enumerate(by_slot):
        assert [s["want"] for s in steps[b]] == tokens[i]
        assert chip_smoke.judge_steps(tokens[i], steps[b], f"slot {b}")["differing"] == []
    assert (dropped > 0) == (factor == "2")


@pytest.mark.parametrize("sp", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_forced_reference_on_its_own_tokens_chooses_them(cluster, sp):
    """Teacher-forced on the free reference's own tokens, the reference
    chooses each of them again, with no shortfall."""
    cfg, _, ref = cluster
    ids = [5, 17, 33, 2, 9, 44, 81, 3]
    free = chip_smoke.references(torch, cfg, ref, [ids], [(None, sp)], 0,
                                 max_new_tokens=NEW_TOKENS)[0]
    steps = chip_smoke.forced_reference(torch, cfg, ref, ids, free["tokens"], sp, 0)
    assert [s["want"] for s in steps] == free["tokens"]
    assert all(s["short"] == 0 for s in steps)


def test_token_gate_refuses_planted_faults(cluster):
    """A sound run passes; runs with every router reversed or every wd
    scale doubled on stage 1 are refused, and the weights come back."""
    cfg, client, ref = cluster
    ids = [5, 17, 33, 2, 9, 44, 81, 3]
    refs = chip_smoke.references(torch, cfg, ref, [ids], [(None, GREEDY)], 0,
                                 max_new_tokens=12)
    run = client.generate(ids, 12, sampling=GREEDY)
    assert chip_smoke.hold_requests(torch, cfg, ref, refs, [run], "sound") == \
        [{"steps": len(run.tokens), "differing": [], "departures": []}]
    state = {"client": client, "references": refs, "ref_params": ref}
    faults = chip_smoke.planted_faults(torch, cfg, state, "cpu")
    assert {"wrong_experts", "doubled_scales"} <= faults.keys()
    assert all(faults[f]["departures"] >= 1 for f in ("wrong_experts", "doubled_scales"))
    again = client.generate(ids, 12, sampling=GREEDY)
    assert again.tokens == run.tokens


def _step(want, short=1.0, tol=0.1, router=0.5):
    return {"want": want, "short": short, "tol": tol, "router": router}


@pytest.mark.parametrize("case", ["near_tie", "flip", "no_flip", "too_many"])
def test_judge_steps_rule(case):
    """A logit near-tie passes; departures pass only when the first holds a
    router near-tie on its own rows and they number at most
    ROUTER_STEPS_MAX."""
    tie = chip_smoke.ROUTER_GAP_TOL / 2
    cap = chip_smoke.ROUTER_STEPS_MAX
    got = list(range(cap + 3))
    steps = [_step(t) for t in got]
    if case == "near_tie":
        steps[1] = _step(99, short=0.05)
    elif case == "flip":
        steps[1] = _step(99, router=tie)
        for i in range(2, cap + 1):
            steps[i] = _step(99)
    elif case == "no_flip":
        steps[1] = _step(99)
    else:
        for i in range(1, cap + 2):
            steps[i] = _step(99, router=tie)
    if case in ("near_tie", "flip"):
        out = chip_smoke.judge_steps(got, steps, case)
        assert len(out["departures"]) == (0 if case == "near_tie" else cap)
    else:
        with pytest.raises(chip_smoke.TokenGateFailed):
            chip_smoke.judge_steps(got, steps, case)
