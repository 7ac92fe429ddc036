"""The port's flight recorder on its served path, read by ``--mode doctor``.

  * The counterpart of tests/test_events.py:360 for the port: splits 2,4,6
    with 2 replicas per remote stage, the pinned stage-2 peer killed after
    its 3rd decode step. The recorder holds the session's error -> retry ->
    failover -> replay story, the doctor reconstructs it as one chain keyed
    to the session, and the same scenario through the JAX package gives the
    same chain apart from ids and times. (The reference's story also ends in
    a rebalance, which its test injects as a second server's stream;
    rebalancing is not ported, so it is not expected here.)
  * The CLI: ``main.py --device cpu --mode local --telemetry --events-dump F``
    (with ``--profile_phases`` and ``--log-json``) in a process of its own,
    then ``--mode doctor --dumps F,G --critical_path`` (G: the failover
    run's dump) prints the chain and the critical path; ``--mode doctor``
    without ``--dumps`` fails loudly.
"""

import json
import pathlib
import subprocess
import sys

import jax
import pytest

from _torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    bridged,
    build_port_cluster,
    one_torch_thread,
    port_cfg,
)
from test_runtime_pipeline import build_cluster, tiny_cfg

from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu import (
    telemetry as jtelemetry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    init_params as j_init_params,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.ops.sampling import (
    SamplingParams as JSampling,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.telemetry import (
    doctor as jdoctor,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    main as tmain,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch import (
    telemetry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.ops.sampling import (
    SamplingParams,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.telemetry import (
    doctor,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_PKG = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch"
PROMPT = [5, 9, 23, 7, 81]
STORY = ("session_start", "transport_error", "hop_retry", "peer_failed",
         "failover", "replay_start", "replay_done", "session_end")
CLI_TIMEOUT_S = 300


def _kill_pinned_stage2(tel, doc, client, transport, sampling_cls, path):
    """Generate 8 greedy tokens while the stage-2 peer in use dies after its
    3rd decode step, with `tel`'s telemetry on; dump the recorder to `path`.
    Returns (tokens, recoveries, killed peer, event names, session id,
    retry trace id, recorded trace ids, failure chains, replay costs)."""
    tel.enable()
    rec, tracer = tel.get_recorder(), tel.get_tracer()
    rec.clear()
    tracer.clear()
    try:
        seen, killed = [0], []

        def on_call(peer_id, req):
            if not req.is_prefill and not req.is_replay and "s2" in peer_id:
                seen[0] += 1
                if seen[0] == 3:
                    killed.append(peer_id)
                    transport.kill(peer_id)

        transport.on_call = on_call
        res = client.generate(PROMPT, max_new_tokens=8,
                              sampling=sampling_cls(temperature=0.0))
        evs = rec.events()
        sid = next(e.session_id for e in evs if e.name == "session_start")
        retry = next(e for e in evs if e.name == "hop_retry")
        traces = {s.trace_id for s in tracer.spans()}
        rec.dump(str(path), registry=tel.get_registry())
        timeline = doc.merge_timeline(doc.load_dumps([str(path)]))
        return (res.tokens, client.recoveries, killed[0], [e.name for e in evs],
                sid, retry.trace_id, traces, doc.failure_chains(timeline),
                doc.replay_costs(timeline))
    finally:
        tel.disable()
        rec.clear()
        tracer.clear()
        tel.get_registry().reset()


@pytest.fixture(scope="module")
def failover_runs(tmp_path_factory):
    """The scenario through the JAX package and through the port, on the
    same weights."""
    out = tmp_path_factory.mktemp("failover")
    jcfg = tiny_cfg()
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    jclient, jtransport, _, _, _ = build_cluster(jcfg, splits="2,4,6", replicas=2)
    ref = _kill_pinned_stage2(jtelemetry, jdoctor, jclient, jtransport, JSampling,
                              out / "jax.jsonl")
    tclient, ttransport = build_port_cluster(port_cfg(jcfg), bridged(jparams),
                                             "2,4,6", replicas=2)
    port = _kill_pinned_stage2(telemetry, doctor, tclient, ttransport,
                               SamplingParams, out / "port.jsonl")
    return ref, port, out / "port.jsonl"


def _anonymous(chain, killed):
    """A chain with its peer ids replaced by their roles: the replicas of a
    stage are interchangeable, and the two packages pin different ones."""
    other = killed[:-1] + ("0" if killed.endswith("1") else "1")
    return chain.replace(killed, "<killed>").replace(other, "<replacement>")


def test_doctor_reconstructs_kill_failover_replay(failover_runs):
    _, port, path = failover_runs
    tokens, recoveries, killed, names, sid, retry_trace, traces, chains, costs = port
    assert recoveries == 1
    for must in STORY:
        assert must in names, f"missing {must} in {sorted(set(names))}"
    # The retry's trace id is a recorded trace's.
    assert retry_trace and retry_trace in traces
    story = [c for c in chains if sid in c["sessions"]]
    assert len(story) == 1, chains
    chain = story[0]["chain"]
    for step in (f"{killed} transport error", "retry stage2 attempt 1",
                 f"failover stage2: {killed} ->", f"replay of {costs[sid]} tokens"):
        assert step in chain, f"{step!r} missing from chain: {chain}"
    assert retry_trace in story[0]["traces"]
    # The replay rebuilt the prompt and the 3 decode steps the killed peer
    # served; the step whose call failed is retried, not replayed.
    assert costs == {sid: len(PROMPT) + 3}
    report = doctor.diagnose([str(path)])
    assert "failure chains (1):" in report
    assert f"{sid}: {costs[sid]} tokens" in report


def test_failover_chain_equals_the_jax_packages(failover_runs):
    ref, port, _ = failover_runs
    assert port[0] == ref[0], "both packages must generate the same tokens"
    assert port[1] == ref[1] == 1
    assert port[3] == ref[3], "the event sequences differ"
    assert [_anonymous(c["chain"], port[2]) for c in port[7]] == \
        [_anonymous(c["chain"], ref[2]) for c in ref[7]]
    assert list(port[8].values()) == list(ref[8].values())


def _port_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", f"{PORT_PKG}.main", *argv], cwd=str(REPO),
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S)


def test_cli_events_dump_then_doctor(failover_runs, tmp_path):
    dump = tmp_path / "local.jsonl"
    proc = _port_cli("--device", "cpu", "--mode", "local", "--telemetry",
                     "--profile_phases", "--log-json", "--events-dump", str(dump),
                     "--max_new_tokens", "4", "--temperature", "0")
    assert proc.returncode == 0, proc.stderr
    assert "=== Generation (4 tokens" in proc.stdout
    # --log-json: every log record is one JSON object.
    records = [json.loads(line) for line in proc.stderr.splitlines() if line.strip()]
    assert any("random-initializing" in r["msg"] for r in records)
    # --profile_phases: the serving boundary's phase, once per remote call
    # (gpt2 in 4 stages: 3 remote hops, 4 steps), in the dump's metrics.
    loaded = doctor.load_dumps([str(dump)])[0]
    assert 'server_phase_seconds_count{phase="server"} 12' in \
        loaded["metrics"]["exposition"]
    proc = _port_cli("--mode", "doctor", "--dumps",
                     f"{dump},{failover_runs[2]}", "--critical_path")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "doctor: 2 dump(s)" in out
    assert "failure chains (1):" in out
    assert "transport error -> retry stage2 attempt 1" in out
    assert "critical path (" in out
    # The local run's 4 steps and the failover run's 8, each one request.
    assert "critical path (12 request(s) with span trees)" in out
    for part in ("compute", "network", "queue", "replay", "client"):
        assert part in out


def test_doctor_without_dumps_fails_loudly(capsys):
    assert tmain.main(["--mode", "doctor"]) == 2
    captured = capsys.readouterr()
    assert "needs --dumps" in captured.err and "TCP swarm" in captured.err
    assert captured.out == ""


def test_doctor_over_a_missing_dump_fails(tmp_path, capsys):
    assert tmain.main(["--mode", "doctor", "--dumps", str(tmp_path / "nope.jsonl")]) == 1
    assert "not found" in capsys.readouterr().err
