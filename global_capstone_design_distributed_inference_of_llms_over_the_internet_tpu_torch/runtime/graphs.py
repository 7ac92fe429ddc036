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
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from ..ops import int8_kernel, launch_counts, nf4_kernel

# The kernel wrappers' launch counters (module, attribute).
_COUNTERS = ((int8_kernel, "_launches"), (int8_kernel, "_launches_mma"),
             (nf4_kernel, "_launches"), (nf4_kernel, "_launches_mma"))


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


def _record(fn: Callable[[], torch.Tensor], pool, stream: torch.cuda.Stream):
    """Capture `fn` on `stream` into a new graph over `pool`."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
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
