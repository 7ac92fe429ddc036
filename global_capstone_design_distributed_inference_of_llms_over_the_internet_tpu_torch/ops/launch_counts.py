"""Kernel launch counts, kept right while CUDA graphs are captured.

Each kernel wrapper keeps counters in its own module (``_launches``, and
``_launches_mma`` for its tensor-core route) that a run sets to 0 and reads
back. A wrapper adds a launch with `count`. On a thread inside `capturing`
the launch is only recorded into a graph, not run: it goes to that
thread's tally instead, which ``runtime/graphs.py`` adds to the counters on
every replay of the graph. Launches and replays of other threads during a
capture therefore stay theirs and are never charged to the graph.
"""

from __future__ import annotations

import contextlib
import threading
from types import ModuleType
from typing import Dict, Iterator, Tuple

Tally = Dict[Tuple[ModuleType, str], int]

_lock = threading.Lock()
_local = threading.local()


def add(module: ModuleType, name: str, n: int) -> None:
    """Add n to counter `name` of `module`."""
    with _lock:
        setattr(module, name, getattr(module, name) + n)


def count(module: ModuleType, *names: str) -> None:
    """One launch of a kernel of `module`, counted on each counter `names`:
    on the counters themselves, or on this thread's tally while it
    captures."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        for name in names:
            add(module, name, 1)
        return
    for name in names:
        tally[(module, name)] = tally.get((module, name), 0) + 1


@contextlib.contextmanager
def capturing() -> Iterator[Tally]:
    """This thread's launches inside the block go to the tally it yields,
    keyed by (module, counter name), and not to the counters."""
    tally: Tally = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None
