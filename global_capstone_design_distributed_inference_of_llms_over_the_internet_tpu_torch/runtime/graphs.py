"""Captured steps: CUDA graphs, the counterpart of jit's executable cache.

The reference compiles each stage step once per (seq bucket, cache bucket)
and replays the executable (``runtime/executor.py:16-24``, ``:353``). Eager
PyTorch instead pays ~2000 kernel launches of host time a forward. Here a
step is captured as a CUDA graph the first time its shape is seen and
replayed from then on: one launch of host time a step.

`capture` turns a function of fixed tensors into a `Captured` graph;
`StepGraphs` is one executor's set of them, each keyed by (span, seq
bucket, cache bucket, lease slot, input dtype), with a static input buffer
and a 0-d ``cache_len`` tensor that the host fills before each replay.

  * Warm up first: every new key runs once eagerly on a side stream before
    its capture. Each kernel library (``csrc/*.cu``) links its own static
    CUDA runtime and loads its kernel variants lazily, so a variant's first
    launch must not happen inside a capture.
  * Captures are thread-local (``capture_error_mode="thread_local"``): the
    TCP server runs a compute thread per stage beside handler threads that
    do CUDA work of their own.
  * One memory pool per owner, shared by its graphs.
  * Outputs are cloned: the client journals activations on the promise
    that a tensor is never modified after it is sent, and the next replay
    overwrites a graph's static output.
  * Launch counts stay right: a replay runs none of the kernel wrappers
    (``ops/int8_kernel.py``, ``ops/nf4_kernel.py``), so the launches the
    capturing thread records go to its own tally
    (``ops/launch_counts.capturing``), not to the counts (nothing ran), and
    are added on every replay. Other threads' launches and replays during
    a capture are never charged to it.
  * No fallback: on a CUDA tensor a capture or replay that fails raises. On
    the CPU there is no graph, and the same step function runs directly.

`Sampler` is the final stage's sampler captured the same way, once per
(batch rows, vocabulary) of its owner: the reference jits ``sample_token``
once (``ops/sampling.py:317``) and vmaps it over rows with the key
schedule of its ``_sample_rows`` (``runtime/executor.py:160-178``). Its
graph reads logits ``[B, V]`` and one int64 vector of the request's
scalars (`pack_sampler_inputs`: the window, its length, top_k, the step
seed and the float32 bits of the three float knobs); the keys are built
inside it, ``PRNGKey(step_seed)`` for row 0 and ``fold_in(base, i)`` for
row i. A call copies the vector to the device from pinned memory without
blocking (`StagedInts`), replays, and reads the tokens back: the one host
sync.
"""

from __future__ import annotations

import dataclasses
import gc
import struct
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from ..ops import draw_kernel, int8_kernel, launch_counts, nf4_kernel, paged_attention_kernel
from ..ops.sampling import RECENT_WINDOW, SamplingParams, sample_token
from ..ops.threefry import fold_in, prng_key

# The kernel wrappers' launch counters (module, attribute).
_COUNTERS = ((int8_kernel, "_launches"), (int8_kernel, "_launches_mma"),
             (int8_kernel, "_launches_gemv"), (int8_kernel, "_launches_f32mma"),
             (nf4_kernel, "_launches"), (nf4_kernel, "_launches_mma"),
             (nf4_kernel, "_launches_gemv"), (nf4_kernel, "_launches_f32mma"),
             (draw_kernel, "_launches"), (paged_attention_kernel, "_launches"))


def _add_counts(delta: Tuple[int, ...]) -> None:
    for (mod, name), d in zip(_COUNTERS, delta):
        if d:
            launch_counts.add(mod, name, d)


def _warm_up(fn: Callable[[], torch.Tensor], stream: torch.cuda.Stream) -> None:
    """Run `fn` once eagerly on `stream`, ordered after the current
    stream's work and before its next."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        fn()
    current.wait_stream(stream)


# Captures in flight, over all threads, and whether the collector was on
# when the first of them began.
_gc_lock = threading.Lock()
_gc_state = {"captures": 0, "was_enabled": False}


def _collector_off() -> None:
    with _gc_lock:
        if _gc_state["captures"] == 0:
            _gc_state["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_state["captures"] += 1


def _collector_back() -> None:
    """Turn the collector back on when the last capture in flight ends."""
    with _gc_lock:
        _gc_state["captures"] -= 1
        if _gc_state["captures"] == 0 and _gc_state["was_enabled"]:
            gc.enable()


def collect_garbage() -> None:
    """Run the cyclic garbage collector outside every capture: wait until
    no capture is in flight on any thread, and hold off new ones while it
    runs (a graph it destroys must not die inside a capture). An executor
    that is let go of (an elastic server's old span) holds its graphs and
    lease buffers in reference cycles until such a collection."""
    while True:
        with _gc_lock:
            if _gc_state["captures"] == 0:
                gc.collect()
                return
        time.sleep(0.001)


def _record(fn: Callable[[], torch.Tensor], pool, stream: torch.cuda.Stream):
    """Capture `fn` on `stream` into a new graph over `pool`. The cyclic
    garbage collector is off meanwhile, until every capture in flight on
    any thread has ended: run inside a capture, it would destroy
    unreachable graphs (another executor's, a stopped server's) on that
    thread, and a graph's destruction invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    _collector_off()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
    finally:
        _collector_back()
    return graph, out


class Captured:
    """One captured call. `out` is its static output; `replay()` runs it
    again on the current stream and adds the kernel launches it holds
    (`launches`, one per counter of `_COUNTERS`) to the wrappers' counts."""

    def __init__(self, graph, out: torch.Tensor, launches: Tuple[int, ...]):
        self.graph = graph
        self.out = out
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.launches)


def capture(fn: Callable[[], torch.Tensor], pool, stream: torch.cuda.Stream) -> Captured:
    """Warm `fn` up eagerly, then capture it. `fn` reads and writes fixed
    tensors only; its warm-up run is a real run (its kernel launches
    count), its capture runs nothing (the launches this thread records
    count on each replay instead)."""
    _warm_up(fn, stream)
    with launch_counts.capturing() as tally:
        graph, out = _record(fn, pool, stream)
    launches = tuple(tally.get(counter, 0) for counter in _COUNTERS)
    return Captured(graph, out, launches)


@dataclasses.dataclass
class CapturedStep:
    """A captured stage step and the fixed tensors it reads: the static
    input `x`, the lease buffers `k`/`v` (kept alive with the graph) and
    the 0-d `cache_len`. ``step(x, k, v, cache_len)`` is the function it
    captured."""

    step: Callable
    x: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    cache_len: torch.Tensor
    slot: int
    graph: Captured


class StepGraphs:
    """One executor's captured steps, with its memory pool and counters of
    captures and replays."""

    def __init__(self, device):
        self.device = torch.device(device)
        # Graphs exist on the card only; elsewhere the step runs directly.
        self.enabled = self.device.type == "cuda"
        self.captures = 0
        self.replays = 0
        self._steps: Dict[Hashable, CapturedStep] = {}
        self._lock = threading.Lock()
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def run(self, key: Hashable, slot: int, step: Callable, x: torch.Tensor,
            k: torch.Tensor, v: torch.Tensor, cache_len: int, n: int) -> torch.Tensor:
        """``step(x, k, v, cache_len)[:, :n]`` for a step that writes the
        lease buffers `k`/`v` (slot `slot`) in place. On the card: the
        graph of `key` (captured now if new) replayed with `x` and
        `cache_len` filled in, its output's first n rows cloned. On the
        CPU: the direct call."""
        if not self.enabled:
            return step(x, k, v, cache_len)[:, :n]
        with self._lock:
            entry = self._steps.get(key)
            if entry is None:
                entry = self._capture(key, slot, step, x, k, v, cache_len)
            entry.x.copy_(x)
            entry.cache_len.fill_(cache_len)
            entry.graph.replay()
            self.replays += 1
            return entry.graph.out[:, :n].clone()

    def _capture(self, key, slot, step, x, k, v, cache_len: int) -> CapturedStep:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        static_x = x.clone()
        static_len = torch.full((), cache_len, dtype=torch.int64, device=self.device)
        graph = capture(lambda: step(static_x, k, v, static_len), self._pool,
                        self._stream)
        entry = CapturedStep(step, static_x, k, v, static_len, slot, graph)
        self._steps[key] = entry
        self.captures += 1
        return entry

    def entries(self) -> List[Tuple[Hashable, CapturedStep]]:
        with self._lock:
            return list(self._steps.items())

    def drop_slot(self, slot: int) -> None:
        """Forget the graphs that read lease slot `slot` (the arena
        released its buffers)."""
        with self._lock:
            for key in [key for key, e in self._steps.items() if e.slot == slot]:
                del self._steps[key]


# ---------------------------------------------------------------------------
# The captured sampler
# ---------------------------------------------------------------------------

# Entries of the packed sampler scalars after the window.
_NVALID, _TOP_K, _SEED, _FLOATS = range(RECENT_WINDOW, RECENT_WINDOW + 4)
PACKED_LEN = _FLOATS + 3


def _f32_bits(x: float) -> int:
    """The bits of float32(x) as a signed 32-bit int."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def pack_sampler_inputs(window: Sequence[int], sampling: SamplingParams,
                        step_seed: int) -> List[int]:
    """The host scalars of one sampling call as PACKED_LEN ints: the last
    RECENT_WINDOW tokens of `window` zero-padded, their count, top_k, the
    step seed, and float32 temperature, top_p and repetition penalty as
    their bits."""
    w = [int(t) for t in window][-RECENT_WINDOW:]
    return (w + [0] * (RECENT_WINDOW - len(w))
            + [len(w), int(sampling.top_k), int(step_seed)]
            + [_f32_bits(x) for x in (sampling.temperature, sampling.top_p,
                                      sampling.repetition_penalty)])


def sample_packed(logits: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The sampled tokens int32 [B] of float32 logits [B, V] under the
    packed scalars (int64 [PACKED_LEN] on the logits' device), row 0 keyed
    ``PRNGKey(step_seed)`` and row i ``fold_in(base, i)``. Device work
    only: this is what `Sampler` captures."""
    recent = packed[:RECENT_WINDOW].to(torch.int32)
    temperature, top_p, rp = packed[_FLOATS:].to(torch.int32).view(torch.float32)
    base = prng_key(packed[_SEED])
    if logits.shape[0] == 1:
        # The hot path, as the reference's: row 0's key is the base itself,
        # and no fold_in (~150 small integer kernels) runs.
        keys = base[None]
    else:
        rows = torch.arange(logits.shape[0], device=logits.device)
        keys = torch.where((rows == 0)[:, None], base, fold_in(base, rows))
    return sample_token(keys, logits, recent, packed[_NVALID].to(torch.int32),
                        temperature, top_p, packed[_TOP_K].to(torch.int32), rp)


class StagedInts:
    """An int64 device tensor of `shape` filled from host ints without
    blocking the host: each load writes the values into a fresh block of
    pinned memory from torch's caching host allocator and copies it on
    the current stream. The allocator records the copy and reuses the
    block only once the copy has read it, so a load never waits for the
    device, however far behind the host it runs (one buffer guarded by an
    event made a load wait whenever the device had not reached the last
    copy yet: a batched round's leader then held its lock that long)."""

    def __init__(self, shape, device: torch.device):
        self.tensor = torch.zeros(shape, dtype=torch.int64, device=device)

    def load(self, values: Sequence[int]) -> torch.Tensor:
        host = torch.tensor(values, dtype=torch.int64).reshape(self.tensor.shape)
        self.tensor.copy_(host.pin_memory(), non_blocking=True)
        return self.tensor


def sample_rows_packed(logits: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The tokens int32 [B] of float32 logits [B, V], row i sampled under
    its own packed scalars ``packed[i]`` (int64 [B, PACKED_LEN]): its own
    knobs, window and key ``PRNGKey(step_seed_i)``, so each row draws what
    its request draws alone (a batch-1 `sample_packed`). A greedy row
    (temperature <= 0) takes the argmax."""
    return torch.cat([sample_packed(logits[i:i + 1], packed[i])
                      for i in range(logits.shape[0])])


class _SamplerGraph:
    """One captured sampler: its static logits, its packed scalars staged
    from the host (`StagedInts`) and its graph."""

    def __init__(self, batch: int, vocab: int, packed_shape, device: torch.device):
        self.logits = torch.zeros((batch, vocab), dtype=torch.float32, device=device)
        self.packed = StagedInts(packed_shape, device)
        self.graph: Optional[Captured] = None

    def load(self, values: List[int], logits: torch.Tensor) -> None:
        self.packed.load(values)
        self.logits.copy_(logits)


class Sampler:
    """An owner's sampler for logits [B, V] on one device (the final
    stage's executor; the fused sampled oracle's first token; a batched
    engine's rounds). On the card, one graph per (form, B, V), captured at
    first use and replayed; elsewhere the function runs directly.
    `captures` and `replays` count them.

    Two forms: a call samples every row with one request's scalars (row i
    keyed ``fold_in(base, i)``); `rows` samples row i with request i's
    own (`sample_rows_packed`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.enabled = self.device.type == "cuda"
        self.captures = 0
        self.replays = 0
        self._graphs: Dict[Tuple[bool, int, int], _SamplerGraph] = {}
        self._lock = threading.Lock()
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __call__(self, logits: torch.Tensor, window: Sequence[int],
                 sampling: SamplingParams, step_seed: int) -> List[int]:
        """The B sampled token ids of logits [B, V] (float32, on this
        device), read back to the host at once: the call's one sync."""
        return self._run(False, logits, pack_sampler_inputs(window, sampling, step_seed))

    def rows(self, logits: torch.Tensor,
             requests: Sequence[Tuple[Sequence[int], SamplingParams, int]]) -> List[int]:
        """Row i of logits [B, V] sampled with request i's (window,
        sampling, step_seed), all B tokens read back at once: one sync."""
        values = [v for req in requests for v in pack_sampler_inputs(*req)]
        return self._run(True, logits, values)

    def _run(self, per_row: bool, logits: torch.Tensor, values: List[int]) -> List[int]:
        fn = sample_rows_packed if per_row else sample_packed
        shape = (logits.shape[0], PACKED_LEN) if per_row else (PACKED_LEN,)
        if not self.enabled:
            packed = torch.tensor(values, dtype=torch.int64, device=self.device)
            return fn(logits.float(), packed.reshape(shape)).tolist()
        with self._lock:
            key = (per_row, *logits.shape)
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(key, fn, shape)
            entry.load(values, logits)
            entry.graph.replay()
            self.replays += 1
            return entry.graph.out.tolist()

    def _capture(self, key, fn, shape) -> _SamplerGraph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        entry = _SamplerGraph(key[1], key[2], shape, self.device)
        entry.graph = capture(lambda: fn(entry.logits, entry.packed.tensor),
                              self._pool, self._stream)
        self._graphs[key] = entry
        self.captures += 1
        return entry


# ---------------------------------------------------------------------------
# The batched engine's captured steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SlotStep:
    x: torch.Tensor
    scalars: StagedInts
    graph: Captured


class SlotSteps:
    """A batched engine's captured steps (``runtime/batching.py``), the
    counterpart of its reference's jit cache: one graph per key (a decode
    step width, or a prefill bucket and input dtype) over a static input
    `x` and a static int64 vector of the call's host scalars (the slots'
    lengths and active mask; or the slot and the prompt's real length),
    staged from pinned memory before each replay: no host value goes
    inside a capture. The engine's slot caches are fixed tensors that the
    step reads and writes in place.

    A new key runs once eagerly on the capture stream (with the call's own
    inputs, so the run is the call: the step is idempotent for fixed
    inputs) and is captured; each call then copies its inputs in and
    replays. `run` returns the graph's static output: the caller reads or
    clones it before the next call of that key (the engine's callers hold
    its lock). On the CPU the step runs directly.

    `run_carry` serves a step whose one input is state it hands on (a
    burst's carry): staged from host ints like the scalars, or copied on
    the device from the carry an earlier replay returned."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.enabled = self.device.type == "cuda"
        self.captures = 0
        self.replays = 0
        self._steps: Dict[Hashable, _SlotStep] = {}
        self._lock = threading.Lock()
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def run(self, key: Hashable, step: Callable, x: torch.Tensor,
            scalars: Sequence[int]):
        """``step(x, s)`` with s the int64 tensor of `scalars`."""
        if not self.enabled:
            return step(x, torch.tensor(scalars, dtype=torch.int64, device=x.device))
        with self._lock:
            entry = self._steps.get(key)
            if entry is None:
                entry = self._capture(key, step, x, scalars)
            entry.x.copy_(x, non_blocking=True)
            entry.scalars.load(scalars)
            entry.graph.replay()
            self.replays += 1
            return entry.graph.out

    def _capture(self, key, step, x, scalars) -> _SlotStep:
        static_x = x.to(self.device, copy=True)
        staged = StagedInts((len(scalars),), self.device)
        staged.load(scalars)
        return self._add(key, static_x, staged, lambda: step(static_x, staged.tensor))

    def run_carry(self, key: Hashable, step: Callable, carry, shape):
        """``step(c)`` for the int64 tensor c of `shape`: `carry` is c's
        host ints (rows of ints), staged from pinned memory, or a device
        tensor, copied on the device. Returns the graph's static output."""
        if not self.enabled:
            if not isinstance(carry, torch.Tensor):
                carry = torch.tensor(carry, dtype=torch.int64, device=self.device)
            return step(carry.reshape(shape))
        with self._lock:
            entry = self._steps.get(key)
            if entry is None:
                staged = StagedInts(shape, self.device)
                self._load(staged, carry)
                entry = self._add(key, staged.tensor, staged, lambda: step(staged.tensor))
            else:
                self._load(entry.scalars, carry)
            entry.graph.replay()
            self.replays += 1
            return entry.graph.out

    @staticmethod
    def _load(staged: "StagedInts", carry) -> None:
        if isinstance(carry, torch.Tensor):
            staged.tensor.copy_(carry)
        else:
            staged.load([v for row in carry for v in row])

    def _add(self, key, x, staged, fn) -> _SlotStep:
        """Capture `fn` as the graph of `key`."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        entry = _SlotStep(x, staged, capture(fn, self._pool, self._stream))
        self._steps[key] = entry
        self.captures += 1
        return entry

    def entries(self) -> List[Tuple[Hashable, "_SlotStep"]]:
        with self._lock:
            return list(self._steps.items())
