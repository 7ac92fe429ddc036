"""Prioritized task scheduling for a stage server.

TPU-native counterpart of the vendored Petals scheduling pieces:

  * ``petals/server/task_pool.py:17-167`` — ``Task`` (priority, submit time,
    future, args) and ``PrioritizedTaskPool`` (handlers submit, a runtime
    drains in priority order, with a max-batch-size admission guard);
  * ``petals/server/task_prioritizer.py:6-20`` — the pluggable QoS policy
    (``DummyTaskPrioritizer``: inference outranks forward/backward);
  * the hivemind ``Runtime`` loop the reference's ``ModuleContainer`` runs
    (``petals/server/server.py:557-671``): ONE compute thread owns the
    accelerator and repeatedly executes the most urgent task across all pools.

The reference spreads this machinery across processes (mp.SimpleQueue from
handler processes into a runtime process); here handler threads and the
compute thread share one process per stage host, so the cross-process future
plumbing collapses to ``concurrent.futures.Future`` + one ``heapq`` per pool —
same semantics, no pipes. Keeping a SINGLE compute thread is not incidental:
executor steps donate their KV buffers (``executor.py`` ``donate_argnums``),
so two threads stepping the same session concurrently would race on donated
buffers; the runtime serializes all device work per stage host the way the
reference's Runtime serializes all CUDA work per GPU.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from .errors import register as _catalog

logger = logging.getLogger(__name__)

# Task kinds, mirroring the three pools each backend owns
# (petals/server/backend.py:53-63).
KIND_INFERENCE = "inference"
KIND_FORWARD = "forward"
KIND_BACKWARD = "backward"
KINDS = (KIND_INFERENCE, KIND_FORWARD, KIND_BACKWARD)


@_catalog
class TaskRejected(RuntimeError):
    """The pool refused the task (oversized, or the runtime is stopped).

    ``permanent=True`` marks rejections that can NEVER succeed on any
    retry or replacement peer (an oversized task stays oversized), so the
    wire layer can surface them as typed non-retryable errors instead of
    burning the client's retry budget. Transient rejections (runtime
    stopping during shutdown) stay retryable — failover to a replacement
    server is exactly the right response to those."""

    def __init__(self, message: str, permanent: bool = False):
        super().__init__(message)
        self.permanent = permanent


class TaskPrioritizerBase:
    """QoS policy hook (``petals/server/task_prioritizer.py:6-13``). Lower
    values are MORE urgent."""

    def prioritize(self, kind: str, size: int, **kwargs: Any) -> float:
        raise NotImplementedError


class DummyTaskPrioritizer(TaskPrioritizerBase):
    """Default policy (``task_prioritizer.py:15-20``): interactive inference
    steps outrank fine-tuning forward/backward batches."""

    def prioritize(self, kind: str, size: int, **kwargs: Any) -> float:
        if kind == KIND_INFERENCE:
            # The serving gateway stamps a per-tenant priority on inference
            # steps (StageRequest.priority, lower = more urgent); without a
            # gateway the reference's constant applies.
            priority = kwargs.get("priority")
            return float(priority) if priority is not None else 1.0
        return 2.0


@dataclasses.dataclass(order=True)
class Task:
    """One unit of device work. Orders by (priority, seq): FIFO within a
    priority level — `seq` is a monotonic submission counter, which both
    breaks ties deterministically and spares comparing the payload."""

    priority: float
    seq: int
    size: int = dataclasses.field(compare=False)
    fn: Callable[..., Any] = dataclasses.field(compare=False)
    args: Tuple[Any, ...] = dataclasses.field(compare=False)
    future: Future = dataclasses.field(compare=False)


class PrioritizedTaskPool:
    """One kind's submission queue (``task_pool.py:29-167``).

    `max_batch_size` bounds a single task's token count — oversized work must
    be chunked by the caller (the size guard of ``task_pool.py:103-106``;
    chunking itself lives in ``StageExecutor`` chunked prefill).
    """

    # Pressure hysteresis: `queue_pressure level=high` fires when the queue
    # depth reaches the high water mark, `level=normal` once it drains back
    # below the low mark — the flight-recorder signal that a stage fell
    # behind. Class attrs are the defaults; operators override per server
    # via --queue_high_water/--queue_low_water.
    HIGH_WATER = 16
    LOW_WATER = 8

    def __init__(self, name: str, max_batch_size: int = 8192,
                 high_water: Optional[int] = None,
                 low_water: Optional[int] = None):
        self.name = name
        self.max_batch_size = max_batch_size
        self.high_water = self.HIGH_WATER if high_water is None else high_water
        self.low_water = self.LOW_WATER if low_water is None else low_water
        if self.low_water > self.high_water:
            raise ValueError(
                f"pool {name}: low_water {self.low_water} must not exceed "
                f"high_water {self.high_water}")
        self._heap: list[Task] = []
        self._lock = threading.Lock()
        self._pressured = False

    def submit(self, task: Task) -> None:
        if task.size > self.max_batch_size:
            _ev.emit("task_rejected", pool=self.name,
                     reason=f"size {task.size} > max_batch_size "
                            f"{self.max_batch_size}")
            raise TaskRejected(
                f"pool {self.name}: task of size {task.size} exceeds "
                f"max_batch_size {self.max_batch_size}",
                permanent=True,
            )
        with self._lock:
            heapq.heappush(self._heap, task)
            depth = len(self._heap)
            crossed = not self._pressured and depth >= self.high_water
            if crossed:
                self._pressured = True
        _tm.get("server_task_queue_depth").labels(pool=self.name).set(depth)
        if crossed:
            _ev.emit("queue_pressure", pool=self.name, level="high",
                     depth=depth)

    def pop(self) -> Optional[Task]:
        with self._lock:
            task = heapq.heappop(self._heap) if self._heap else None
            depth = len(self._heap)
            relaxed = self._pressured and depth < self.low_water
            if relaxed:
                self._pressured = False
        if task is not None:
            _tm.get("server_task_queue_depth").labels(
                pool=self.name).set(depth)
        if relaxed:
            _ev.emit("queue_pressure", pool=self.name, level="normal",
                     depth=depth)
        return task

    def peek_key(self) -> Optional[Tuple[float, int]]:
        """Pool priority = its most urgent task (``task_pool.py:159-167``)."""
        with self._lock:
            if not self._heap:
                return None
            t = self._heap[0]
            return (t.priority, t.seq)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


class StageRuntime:
    """The per-stage compute loop: drain all pools strictly most-urgent-first.

    Handlers call `submit(kind, fn, *args)` and block on the returned Future;
    the single runtime thread executes tasks one at a time. `run_once()` is
    the deterministic test surface (execute exactly one task, on the calling
    thread); `start()`/`stop()` run the background loop for real serving.
    """

    def __init__(
        self,
        prioritizer: Optional[TaskPrioritizerBase] = None,
        max_batch_size: int = 8192,
        high_water: Optional[int] = None,
        low_water: Optional[int] = None,
    ):
        self.prioritizer = prioritizer or DummyTaskPrioritizer()
        self.pools: Dict[str, PrioritizedTaskPool] = {
            kind: PrioritizedTaskPool(kind, max_batch_size,
                                      high_water=high_water,
                                      low_water=low_water)
            for kind in KINDS
        }
        self._seq = itertools.count()
        self._work = threading.Semaphore(0)
        self._stop = threading.Event()
        # Serializes submit's stopped-check+push against stop's
        # flag-set+drain: without it a task pushed in that window would never
        # be popped and its waiter would hang for its full timeout.
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.tasks_done = 0

    # -- submission ---------------------------------------------------------

    def submit(self, kind: str, fn: Callable[..., Any], *args: Any,
               size: int = 1, **priority_kwargs: Any) -> Future:
        if kind not in self.pools:
            _ev.emit("task_rejected", pool=kind, reason="unknown task kind")
            raise TaskRejected(f"unknown task kind {kind!r}")
        priority = self.prioritizer.prioritize(kind, size, **priority_kwargs)
        task = Task(priority=priority, seq=next(self._seq), size=size,
                    fn=fn, args=args, future=Future())
        with self._submit_lock:
            if self._stop.is_set():
                _ev.emit("task_rejected", pool=kind,
                         reason="runtime is stopped")
                raise TaskRejected("runtime is stopped")
            self.pools[kind].submit(task)
        self._work.release()
        return task.future

    def call(self, kind: str, fn: Callable[..., Any], *args: Any,
             size: int = 1, timeout: Optional[float] = None,
             **priority_kwargs: Any) -> Any:
        """Submit and wait — the handler-thread convenience path. On timeout
        the task is cancelled (a no-op if already running) so abandoned work
        does not keep occupying the compute thread."""
        fut = self.submit(kind, fn, *args, size=size, **priority_kwargs)
        try:
            return fut.result(timeout)
        except TimeoutError:
            fut.cancel()
            raise

    # -- execution ----------------------------------------------------------

    def _next_task(self) -> Optional[Task]:
        best_pool, best_key = None, None
        for pool in self.pools.values():
            key = pool.peek_key()
            if key is not None and (best_key is None or key < best_key):
                best_pool, best_key = pool, key
        return best_pool.pop() if best_pool is not None else None

    def run_once(self) -> bool:
        """Execute the single most urgent task. Returns False when idle."""
        task = self._next_task()
        if task is None:
            return False
        if not task.future.set_running_or_notify_cancel():
            return True  # cancelled while queued
        try:
            task.future.set_result(task.fn(*task.args))
        except BaseException as exc:  # noqa: BLE001 — deliver to the waiter
            task.future.set_exception(exc)
        self.tasks_done += 1
        return True

    def _loop(self) -> None:
        while True:
            self._work.acquire()
            if self._stop.is_set():
                return
            try:
                self.run_once()
            except Exception:  # pragma: no cover — run_once traps task errors
                logger.exception("runtime task crashed")

    def start(self) -> None:
        if self._thread is not None:
            if self._thread.is_alive():
                # A second compute thread would break the donation-safety
                # invariant (two threads stepping donated KV buffers).
                return
            self._thread = None  # exited after a timed-out stop(); restart
        with self._submit_lock:
            self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stage-runtime")
        self._thread.start()

    def stop(self) -> None:
        with self._submit_lock:
            self._stop.set()
        self._work.release()  # wake the loop
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            if thread.is_alive():
                # Wedged in a long task (e.g. a slow first compile). Keep the
                # handle so start() cannot spawn a second compute thread; the
                # loop exits at its next wakeup since the stop flag is set.
                logger.warning("runtime thread still busy after 5s; "
                               "it will exit after the current task")
            else:
                self._thread = None
        # Fail queued work rather than leaving waiters hanging forever.
        for pool in self.pools.values():
            while True:
                task = pool.pop()
                if task is None:
                    break
                if task.future.set_running_or_notify_cancel():
                    task.future.set_exception(TaskRejected("runtime stopped"))

    def queue_depths(self) -> Dict[str, int]:
        return {kind: len(pool) for kind, pool in self.pools.items()}
