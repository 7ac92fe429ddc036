"""Stage server lifecycle: fixed-split and elastic (load-balancing) modes.

Port of the JAX package's ``runtime/server.py``:

  * fixed mode: a server for a statically assigned span registers on the
    placement registry and refreshes its heartbeat every TTL/3,
    re-registering when the registry forgot it; between beats it pings the
    servers of its likely next hops and publishes the RTTs with its record.
    In an in-process swarm the server joins a `LocalTransport`; ``--mode
    serve`` (``main.run_serve``) passes none, serves the executor through a
    `TcpStageServer` and advertises its address in the record.
  * elastic mode (`ElasticStageServer`, the Petals load-balancing server):
    scan the swarm's coverage, pick a span by rule 1
    (``scheduling/load_balancing.choose_best_blocks``), announce it
    ``JOINING``, build the stage executor for it, probe its throughput,
    flip ``ONLINE`` and serve; every randomized delay in [0, 2 x the mean
    period) run rule 2 (``should_choose_other_blocks``) and re-span when the
    swarm would gain past ``balance_quality``.

State transitions are synchronous tick methods (`heartbeat_once`,
`maybe_rebalance`) that tests drive one at a time; `start` / `stop` run
them on a daemon thread for deployments.

On the card the throughput probe times the captured step that serving
replays: each probe step is a one-token prefill in a fresh session whose
lease takes the freed buffers of the one before (the arena's free list),
so every step after the first replays the same CUDA graph, and each ends
in a device sync before the clock stops. A re-span lets go of the old
executor, then collects the cycles that hold its graphs and lease buffers
outside any capture (``graphs.collect_garbage``) and returns the cached
blocks to the device before the new span loads.

Deliberate differences: `derive_num_blocks` reads
``torch.cuda.mem_get_info`` (free and total bytes of the card; the
allocator's cached blocks count as free) where the reference reads
``device.memory_stats()``, and has no counterpart of the reference's
table of TPU memory sizes (``_tpu_hbm_bytes``): a CUDA device always
reports its memory. It returns None on the CPU.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.partition import ROLE_LAST, ROLE_SEGMENT, StageSpec
from ..scheduling import load_balancing as lb
from ..scheduling.registry import PlacementRegistry, ServerRecord, ServerState
from ..scheduling.throughput import WARMUP_STEPS, get_server_throughput
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .executor import StageExecutor
from .graphs import collect_garbage
from .messages import StageRequest
from .transport import LocalTransport, Transport

logger = logging.getLogger(__name__)

Params = Dict[str, Any]
ParamsProvider = Callable[[StageSpec], Params]

# How many likely next-hop peers a server pings per heartbeat.
MAX_PINGED_NEXT_SERVERS = 5


def measure_next_server_rtts(
    registry: PlacementRegistry,
    ping: Callable[[ServerRecord], Optional[float]],
    peer_id: str,
    end_block: int,
    budget_s: Optional[float] = None,
    model: Optional[str] = None,
) -> Dict[str, float]:
    """Ping the live servers able to serve ``end_block`` (this server's
    likely next hops), newest first, and return {peer_id: rtt_seconds}.
    Unreachable peers are left out (absence, not infinity). ``budget_s``
    caps the whole sweep, checked between pings, so a pile-up of timeouts
    cannot stretch a heartbeat past the registry's TTL."""
    cands = [
        r for r in registry.live_servers(model=model)
        if r.peer_id != peer_id
        and r.start_block <= end_block < r.end_block
    ]
    cands.sort(key=lambda r: r.timestamp, reverse=True)
    deadline = None if budget_s is None else time.monotonic() + budget_s
    rtts: Dict[str, float] = {}
    for rec in cands[:MAX_PINGED_NEXT_SERVERS]:
        if deadline is not None and time.monotonic() >= deadline:
            break
        rtt = ping(rec)
        if rtt is not None:
            rtts[rec.peer_id] = rtt
    return rtts


def _pinger_from_transport(
    transport,
) -> Optional[Callable[[ServerRecord], Optional[float]]]:
    """A pinger on the transport's `ping`, or None when the transport does
    not override the base method (no RTT table is published then)."""
    tping = getattr(type(transport), "ping", None)
    if tping is None or tping is Transport.ping:
        return None
    return lambda rec: transport.ping(rec.peer_id)


def derive_num_blocks(cfg: ModelConfig, *, dtype_bytes: int = 2, quant: str = "none",
                      attn_cache_bytes: int = 1 << 30, device=None,
                      headroom_fraction: float = 0.15) -> Optional[int]:
    """Server auto-capacity: how many blocks fit the card's free memory
    after the KV arena and an activation-headroom reserve (the reference's
    ``derive_num_blocks``, its ``_choose_num_blocks``). The card's total
    memory is the limit; what it has free, plus the blocks this process's
    allocator caches, is the free part. Returns None when `device` (default:
    the current CUDA device, else the CPU) is not a CUDA device; raises when
    not even one block fits."""
    from ..models.quant import block_bytes, choose_num_blocks

    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free_now, limit = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    free = max(0, min(int(limit), int(free_now) + max(0, int(cached))))
    usable = int(free * (1.0 - headroom_fraction)) - attn_cache_bytes
    per = max(block_bytes(cfg, dtype_bytes, quant), 1)
    if usable < per:
        raise RuntimeError(
            f"device memory cannot fit one {quant or 'full'}-precision "
            f"block: free={free / 2**30:.2f} GiB, KV arena="
            f"{attn_cache_bytes / 2**30:.2f} GiB, block="
            f"{per / 2**30:.2f} GiB (pass --num_blocks to override, or "
            "shrink the arena / use --quant)")
    n = choose_num_blocks(cfg, free, dtype_bytes=dtype_bytes, quant=quant,
                          attn_cache_bytes=attn_cache_bytes,
                          reserve_fraction=headroom_fraction)
    logger.info("auto num_blocks=%d (free=%.2f GiB of %.2f GiB, arena=%.2f GiB, "
                "quant=%s, %.0f%% headroom)", n, free / 2**30, int(limit) / 2**30,
                attn_cache_bytes / 2**30, quant, headroom_fraction * 100)
    return n


class ElasticStageServer:
    """One elastic server: owns an executor for its current span and the
    registry record advertising it. `params_provider(spec)` returns the
    parameter shard of a span (``main`` slices in-memory weights, or draws
    the span's layers from the seed). `transport` is its membership: a
    `LocalTransport`, or under TCP an object whose `add_peer` /
    `remove_peer` swap the served executor in and out."""

    def __init__(self, peer_id: str, cfg: ModelConfig, params_provider: ParamsProvider,
                 registry: PlacementRegistry, transport, *, num_blocks: int,
                 total_blocks: Optional[int] = None, min_block: int = 0,
                 balance_quality: float = 0.75,
                 mean_balance_check_period: float = 120.0,
                 bandwidth_mbps: Optional[float] = None,
                 probe_throughput: bool = False,
                 rng: Optional[random.Random] = None,
                 executor_kwargs: Optional[dict] = None,
                 advertise_address: Optional[str] = None,
                 warmup: bool = False,
                 pinger: Optional[Callable[[ServerRecord], Optional[float]]] = None,
                 model: Optional[str] = None):
        self.peer_id = peer_id
        self.model = model
        self.cfg = cfg
        self.params_provider = params_provider
        self.registry = registry
        self.transport = transport
        self.num_blocks = num_blocks
        self.total_blocks = total_blocks or cfg.num_layers
        self.min_block = min_block
        self.balance_quality = balance_quality
        self.mean_balance_check_period = mean_balance_check_period
        self.bandwidth_mbps = bandwidth_mbps
        self.probe_throughput = probe_throughput
        # StageExecutor knobs (device, dtypes, prefix store) for every span
        # (re)load.
        self.executor_kwargs = dict(executor_kwargs or {})
        self.advertise_address = advertise_address
        self.warmup = warmup
        # Seeded default: an unseeded one would make the rebalance jitter,
        # and with it the span layout, differ from run to run.
        self._rng = rng or random.Random(0)
        self._np_rng = np.random.default_rng(self._rng.randrange(2**31))
        self._pinger = (pinger if pinger is not None
                        else _pinger_from_transport(transport))
        self.next_server_rtts: Dict[str, float] = {}
        self.executor: Optional[StageExecutor] = None
        self.spec: Optional[StageSpec] = None
        self.throughput: float = 1.0
        self.rebalances: int = 0
        # The last probe's steps: seconds and captures of each (the first
        # WARMUP_STEPS untimed), and its advertised value.
        self.probe_steps: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # Span lifecycle
    # ------------------------------------------------------------------

    def _spec_for(self, start: int, end: int) -> StageSpec:
        role = ROLE_LAST if end >= self.total_blocks else ROLE_SEGMENT
        return StageSpec(index=start, role=role, start=start, end=end)

    def choose_span(self) -> StageSpec:
        """Rule 1 over the current live swarm (excluding self)."""
        records = [r for r in self.registry.live_servers(model=self.model)
                   if r.peer_id != self.peer_id]
        blocks = lb.choose_best_blocks(
            self.num_blocks, records, total_blocks=self.total_blocks,
            min_block=self.min_block)
        return self._spec_for(blocks[0], blocks[-1] + 1)

    def load_span(self, spec: StageSpec) -> None:
        """(Re)build the executor for a span and advertise it: ``JOINING``
        first, so concurrent joiners see the claim, ``ONLINE`` once the
        executor is ready (warmed up and probed when asked)."""
        self.registry.register(ServerRecord(
            peer_id=self.peer_id, start_block=spec.start, end_block=spec.end,
            throughput=self.throughput, state=ServerState.JOINING,
            final_stage=spec.is_last, model=self.model))
        params = self.params_provider(spec)
        self.executor = StageExecutor(self.cfg, spec, params, peer_id=self.peer_id,
                                      **self.executor_kwargs)
        # The executor keeps fused copies: the shard's own leaves go now.
        del params
        if self.warmup:
            self.executor.warmup()
        self.spec = spec
        self.transport.add_peer(self.peer_id, self.executor)
        if self.probe_throughput:
            self.throughput = self._probe()
        self.registry.register(self._record())
        _ev.emit("server_join", peer=self.peer_id,
                 start_block=spec.start, end_block=spec.end)
        logger.info("%s serving blocks [%d, %d) throughput=%.2f",
                    self.peer_id, spec.start, spec.end, self.throughput)

    def _record(self) -> ServerRecord:
        assert self.spec is not None
        return ServerRecord(
            peer_id=self.peer_id, start_block=self.spec.start,
            end_block=self.spec.end, throughput=self.throughput,
            state=ServerState.ONLINE, final_stage=self.spec.is_last,
            cache_tokens_left=(self.executor.arena.tokens_left()
                               if self.executor else None),
            address=self.advertise_address,
            next_server_rtts=self._published_rtts(), model=self.model)

    def _probe(self) -> float:
        """Self-benchmark: timed batch-1 one-token forwards through the span,
        each in a session of its own that is dropped after it. The dropped
        lease's buffers go to the arena's free list and the next session
        takes them, slot and graphs with them: every step after the first
        replays one captured step (the one a 128-row decode step replays),
        and each ends in a device sync, so the clock times the work."""
        ex, spec = self.executor, self.spec
        assert ex is not None and spec is not None
        probe_session = f"__probe__{self.peer_id}"
        self.probe_steps = []

        def step():
            t0 = time.perf_counter()
            sid = f"{probe_session}-{len(self.probe_steps)}"
            captures = ex.graphs.captures + ex.sampler.captures
            try:
                ex.forward(StageRequest(
                    session_id=sid,
                    hidden=torch.zeros((1, 1, self.cfg.hidden_size), dtype=torch.float32),
                    seq_len=1, cur_len=0, is_prefill=True, max_length=8))
                if ex.device.type == "cuda":
                    torch.cuda.synchronize(ex.device)
            finally:
                ex.drop_session(sid)
                self.probe_steps.append({
                    "seconds": time.perf_counter() - t0,
                    "captures": ex.graphs.captures + ex.sampler.captures - captures,
                    "timed": len(self.probe_steps) >= WARMUP_STEPS})

        return get_server_throughput(step, self.cfg.hidden_size,
                                     bandwidth_mbps=self.bandwidth_mbps,
                                     num_blocks=spec.num_layers)

    # ------------------------------------------------------------------
    # Ticks (what tests drive one at a time)
    # ------------------------------------------------------------------

    def start_serving(self) -> None:
        self.load_span(self.choose_span())

    def heartbeat_once(self) -> None:
        """TTL refresh carrying the previous beat's RTTs (a slow ping sweep
        must not delay it past the TTL), then the sweep. A record that
        already expired is registered anew: the server heals itself back
        into the swarm."""
        if self.spec is None:
            return
        if not self.registry.heartbeat(
                self.peer_id, throughput=self.throughput,
                cache_tokens_left=(self.executor.arena.tokens_left()
                                   if self.executor else None),
                next_server_rtts=self._published_rtts()):
            self.registry.register(self._record())
            _ev.emit("server_rejoin", peer=self.peer_id)
        _tm.get("server_heartbeats_total").inc()
        self.ping_next_servers()

    def _published_rtts(self) -> Optional[Dict[str, float]]:
        """None when pinging is unsupported or there is no next hop (no
        update); otherwise the latest sweep as it is, an empty one too, so
        that stale RTTs are retracted."""
        if (self._pinger is None or self.spec is None or self.spec.is_last
                or self.spec.end >= self.total_blocks):
            return None
        return dict(self.next_server_rtts)

    def ping_next_servers(self) -> Dict[str, float]:
        if (self.spec is None or self.spec.is_last or self._pinger is None
                or self.spec.end >= self.total_blocks):
            self.next_server_rtts = {}
        else:
            self.next_server_rtts = measure_next_server_rtts(
                self.registry, self._pinger, self.peer_id, self.spec.end,
                budget_s=self.registry.ttl / 6.0, model=self.model)
        return self.next_server_rtts

    def maybe_rebalance(self) -> bool:
        """Rule 2; when it says move, tear down and re-span (restoring the
        old span if the new one fails to load). Returns whether a re-span
        happened."""
        if self.spec is None:
            return False
        records = self.registry.live_servers(model=self.model)
        if not lb.should_choose_other_blocks(
                self.peer_id, records, total_blocks=self.total_blocks,
                balance_quality=self.balance_quality, min_block=self.min_block,
                rng=self._np_rng):
            return False
        logger.info("%s rebalancing away from [%d, %d)",
                    self.peer_id, self.spec.start, self.spec.end)
        old_spec = self.spec
        _ev.emit("rebalance_decision", peer=self.peer_id,
                 from_start=old_spec.start, from_end=old_spec.end)
        t0 = time.monotonic()
        self.shutdown()
        try:
            self.start_serving()
        except Exception as exc:
            logger.exception("%s: re-span failed, restoring [%d, %d)",
                             self.peer_id, old_spec.start, old_spec.end)
            _ev.emit("rebalance_failed", peer=self.peer_id,
                     error=f"{type(exc).__name__}: {exc}"[:200])
            self._release()
            self.load_span(old_spec)
            return False
        self.rebalances += 1
        _tm.get("server_rebalances_total").inc()
        assert self.spec is not None
        _ev.emit("rebalance_done", peer=self.peer_id,
                 start_block=self.spec.start, end_block=self.spec.end,
                 seconds=round(time.monotonic() - t0, 4))
        return True

    def next_check_delay(self) -> float:
        """Randomized rebalance-check delay in [0, 2 x mean period)."""
        return self._rng.random() * 2.0 * self.mean_balance_check_period

    def shutdown(self) -> None:
        """Leave the swarm and let go of the executor. Its memory goes back
        to the device here, outside any capture: a request still running on
        it keeps what it references until it ends."""
        self.transport.remove_peer(self.peer_id)
        self.registry.unregister(self.peer_id)
        _ev.emit("server_leave", peer=self.peer_id)
        self._release()

    def _release(self) -> None:
        """Let go of the executor; on the card, collect the cycles that hold
        its graphs and buffers and return the cached blocks to the device."""
        device = self.executor.device if self.executor is not None else None
        self.executor = None
        self.spec = None
        if device is not None and device.type == "cuda":
            collect_garbage()
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Background loop (deployments)
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Serve, then heartbeat and randomized rebalance checks on a daemon
        thread."""
        self.start_serving()
        self._stop.clear()

        def loop():
            next_check = self.next_check_delay()
            elapsed = 0.0
            beat = self.registry.ttl / 3.0
            while not self._stop.wait(beat):
                # One transient failure must not end the loop.
                try:
                    self.heartbeat_once()
                    elapsed += beat
                    if elapsed >= next_check:
                        self.maybe_rebalance()
                        elapsed, next_check = 0.0, self.next_check_delay()
                except Exception:
                    logger.exception("%s: serve-loop tick failed; continuing",
                                     self.peer_id)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.shutdown()


class FixedStageServer:
    """Fixed-split server: a statically assigned span and its heartbeat.
    With `transport`, `start_serving` adds the executor to it; without,
    another front end serves `executor` at `address`. Given `executor`
    (a batched engine's adapter, say) it serves that one instead of
    building a `StageExecutor`; its record carries the executor's
    ``engine`` tag. ``--mode serve`` sets `throughput`, `relay_via` (the
    volunteer of a server that failed the dial-back vote) and
    `relay_capacity` (a volunteer's) before `start_serving`."""

    def __init__(
        self,
        peer_id: str,
        cfg: ModelConfig,
        spec: StageSpec,
        params: Params,
        registry: PlacementRegistry,
        transport: Optional[LocalTransport] = None,
        *,
        executor_kwargs: Optional[dict] = None,
        pinger: Optional[Callable[[ServerRecord], Optional[float]]] = None,
        model: Optional[str] = None,
        address: Optional[str] = None,
        executor=None,
    ):
        self.peer_id = peer_id
        self.address = address
        self.model = model
        self.spec = spec
        self.registry = registry
        self.transport = transport
        self._pinger = (pinger if pinger is not None
                        else _pinger_from_transport(transport))
        self.next_server_rtts: Dict[str, float] = {}
        self.throughput = 1.0
        self.relay_via: Optional[str] = None
        self.relay_capacity: Optional[int] = None
        self.executor = executor or StageExecutor(
            cfg, spec, params, peer_id=peer_id, **(executor_kwargs or {}))

    def _record(self) -> ServerRecord:
        return ServerRecord(
            peer_id=self.peer_id, start_block=self.spec.start,
            end_block=self.spec.end, throughput=self.throughput,
            state=ServerState.ONLINE, final_stage=self.spec.is_last,
            stage_index=self.spec.index,
            next_server_rtts=self._published_rtts(),
            model=self.model, address=self.address,
            engine=getattr(self.executor, "engine", "session"),
            relay_via=self.relay_via, relay_capacity=self.relay_capacity,
        )

    def start_serving(self) -> None:
        if self.transport is not None:
            self.transport.add_peer(self.peer_id, self.executor)
        self.registry.register(self._record())
        _ev.emit("server_join", peer=self.peer_id,
                 start_block=self.spec.start, end_block=self.spec.end)

    def _published_rtts(self) -> Optional[Dict[str, float]]:
        # None = nothing to say (last span, or no pinger); {} retracts
        # stale measurements.
        if self._pinger is None or self.spec.is_last:
            return None
        return dict(self.next_server_rtts)

    def ping_next_servers(self) -> Dict[str, float]:
        if self.spec.is_last or self._pinger is None:
            self.next_server_rtts = {}
        else:
            self.next_server_rtts = measure_next_server_rtts(
                self.registry, self._pinger, self.peer_id, self.spec.end,
                budget_s=self.registry.ttl / 6.0, model=self.model)
        return self.next_server_rtts

    def heartbeat_once(self) -> None:
        # Refresh first, measure after: a slow ping sweep must not delay
        # the refresh past the TTL.
        if not self.registry.heartbeat(
            self.peer_id,
            cache_tokens_left=self.executor.arena.tokens_left(),
            next_server_rtts=self._published_rtts(),
        ):
            self.registry.register(self._record())  # self-heal after expiry
            _ev.emit("server_rejoin", peer=self.peer_id)
        _tm.get("server_heartbeats_total").inc()
        self.ping_next_servers()

    def shutdown(self) -> None:
        if self.transport is not None:
            self.transport.remove_peer(self.peer_id)
        self.registry.unregister(self.peer_id)
        _ev.emit("server_leave", peer=self.peer_id)
