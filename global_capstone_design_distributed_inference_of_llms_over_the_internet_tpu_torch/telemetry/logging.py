"""Structured logging: one formatter for every line the runtime prints.

Plain text by default (human-scannable, same shape main.py always used);
``--log-json`` switches to one JSON object per line carrying the same
trace/session fields the flight recorder and spans use — so a log
aggregator can join log lines, events, and spans on trace_id.

Context propagation is thread-local: a component entering traced work calls
``set_log_context(trace_id=..., session_id=...)`` (or uses the
``log_context`` context manager) and every log record emitted from that
thread carries the ids until cleared. Dependency-free, stdlib ``logging``
only.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from typing import Iterator, Optional

_ctx = threading.local()


def set_log_context(trace_id: Optional[str] = None,
                    session_id: Optional[str] = None) -> None:
    _ctx.trace_id = trace_id
    _ctx.session_id = session_id


def clear_log_context() -> None:
    _ctx.trace_id = None
    _ctx.session_id = None


def get_log_context() -> tuple:
    return (getattr(_ctx, "trace_id", None),
            getattr(_ctx, "session_id", None))


@contextlib.contextmanager
def log_context(trace_id: Optional[str] = None,
                session_id: Optional[str] = None) -> Iterator[None]:
    prev = get_log_context()
    set_log_context(trace_id, session_id)
    try:
        yield
    finally:
        set_log_context(*prev)


class StructuredFormatter(logging.Formatter):
    """Text or JSON lines, both carrying trace/session context when set.

    Text:  ``2026-08-05 12:00:00 name LEVEL [trace=ab12 session=s1] msg``
    JSON:  ``{"ts": ..., "level": ..., "logger": ..., "msg": ...,
    "trace_id": ..., "session_id": ...}`` (+ ``exc`` on exceptions).
    """

    def __init__(self, json_mode: bool = False):
        super().__init__(datefmt="%Y-%m-%d %H:%M:%S")
        self.json_mode = json_mode

    def format(self, record: logging.LogRecord) -> str:
        # Explicit record attributes (logger.info(..., extra={...})) win
        # over the ambient thread-local context.
        trace_id = getattr(record, "trace_id", None)
        session_id = getattr(record, "session_id", None)
        if trace_id is None and session_id is None:
            trace_id, session_id = get_log_context()
        msg = record.getMessage()
        if self.json_mode:
            d = {
                "ts": round(record.created, 6),
                "level": record.levelname.lower(),
                "logger": record.name,
                "msg": msg,
            }
            if trace_id:
                d["trace_id"] = trace_id
            if session_id:
                d["session_id"] = session_id
            if record.exc_info:
                d["exc"] = self.formatException(record.exc_info)
            return json.dumps(d, sort_keys=True, default=str)
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(record.created))
        ctx = ""
        if trace_id or session_id:
            parts = []
            if trace_id:
                parts.append(f"trace={trace_id}")
            if session_id:
                parts.append(f"session={session_id}")
            ctx = " [" + " ".join(parts) + "]"
        line = f"{ts} {record.name} {record.levelname}{ctx} {msg}"
        if record.exc_info:
            line += "\n" + self.formatException(record.exc_info)
        return line


def setup_logging(json_mode: bool = False,
                  level: int = logging.INFO) -> None:
    """Route the root logger through the structured formatter — the
    ``logging.basicConfig`` replacement main.py calls once at startup.
    Idempotent: reconfigures the existing handler on repeat calls."""
    root = logging.getLogger()
    root.setLevel(level)
    handler = None
    for h in root.handlers:
        if isinstance(getattr(h, "formatter", None), StructuredFormatter):
            handler = h
            break
    if handler is None:
        handler = logging.StreamHandler()
        root.addHandler(handler)
    handler.setFormatter(StructuredFormatter(json_mode=json_mode))
