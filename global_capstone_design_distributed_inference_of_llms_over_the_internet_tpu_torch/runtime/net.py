"""TCP data plane + registry service: the swarm across processes and hosts.

Port of the JAX package's ``runtime/net.py``. The wire is the reference's,
byte for byte, so clients and servers of the two packages talk to each
other:

  frame = MAGIC(4) | header_len(u32) | header JSON | payload_len(u32)
          | payload | crc32c(u32)

payloads above ``CHUNK_SIZE`` stream as per-chunk-CRC'd segments. The
header carries the verb and the request metadata; the payload is the raw
activation, float32 or wire-bf16, converted and checksummed by the native
codec (``native/``, ``csrc/codec.cpp``).

Tensors cross between the card and the wire as host numpy arrays, as in
the reference: ``tensor.float().cpu().numpy()`` on send (which waits for
the kernels that produce it) and ``torch.from_numpy`` on receive; the
executor moves an arriving activation to its device and to the model's
dtype.

Components:
  * `TcpStageServer` serves one `StageExecutor` with the verbs ``forward``,
    ``stream_open`` / ``step`` (persistent streams: session metadata once,
    deltas per step), ``end_session``, ``info``, ``metrics``,
    ``dump-events``, ``reach_check``, ``swarm-stats`` and the gated
    ``fault`` admin verb.
    Compute goes through a `StageRuntime` (one compute thread owns the
    card, handler threads own the sockets), or, for a batched engine
    (``runtime/batching.py``), runs inline on the handler threads; ``info``
    reports the executor's ``engine`` and a batched engine's
    ``decode_steps``. A forward answers with ``token``, ``hidden`` or, for
    a burst request to a full-span batched peer, ``burst`` (the tokens
    the burst emitted and why it stopped), or, for a speculative step on
    the final stage, ``spec`` (the verified run and its accepted count),
    or, for a beam step (``num_logprobs > 0``) on the final stage, ``beam``
    (each row's top-N tokens and log-probs).
    A forward that names ``next_servers`` is a push chain: the handler
    thread, once the compute thread has handed back the response, sends
    the output on to the next hop over a pooled connection and relays that
    hop's final answer back, a ``spec`` reply as it came.
    With a `GossipNode` (``scheduling/gossip.py``) the server is also a
    mirror of the placement records: it answers ``gossip`` anti-entropy
    rounds and the registry service's ``register`` / ``heartbeat`` /
    ``unregister`` / ``list``, so a client with every registry down still
    discovers the swarm. With ``relay_capacity`` > 0 it volunteers as a NAT
    relay: ``relay_attach`` opens a leased circuit, and a frame stamped
    ``relay_to`` is forwarded verbatim to the attached peer. These and the
    socket-only verbs need no executor.
  * `TcpTransport` is the client side of `Transport`: peer addresses from
    registry records (a record with ``relay_via`` is dialed at its
    volunteer, every frame stamped ``relay_to``), one persistent
    connection per peer, plain prefill and decode on streams (a burst
    request, a draft step and a beam step ride the classic frame), socket errors mapped onto the
    retryable taxonomy (``runtime/errors.py``; through a relay the breaker
    blames the volunteer).
  * `check_direct_reachability` (the dial-back vote), `attach_via_relay`
    and `gossip_exchange`: the serve process's side of the control plane.
  * `RegistryServer` / `RemoteRegistry`: the registry service, JSON over
    TCP with TTL expiry server-side, a comma-separated HA address list and
    an on-disk peers cache on the client side; with every registry down,
    reads fall back to a stage server's gossip mirror.

The training verbs (the reference's ``net.py:1440-1520``, ``:1763-1830``,
``:2044-2100``): ``train_forward`` carries the span's input at the
client's wire dtype, then, float32, the deep prompts (``has_prompts``) and
the LoRA adapters named by the header's ``lora_manifest`` (at
``lora_scale``), and is answered with ``hidden`` at the server's wire
dtype; ``backward`` carries the input, the output's gradient, the prompts
and the adapters, all float32, and is answered with ``grads`` (float32:
the input's, the prompts', then the adapters' under a manifest). They ride
the classic frame, never a stream. A server checks that a frame's tensor
count is the input (and gradient), the prompts if ``has_prompts`` and one a
manifest entry, and answers a stage error naming the mismatch otherwise.
``info`` says ``lora: true``, and the client asks a peer's ``info`` once
before it ships adapters to it: a peer that does not advertise LoRA gets a
stage error naming it, and no frame (the reference's fix of a pre-LoRA
server reading the adapters as prompts). A verb this server does not serve
gets the reference's ``unknown verb`` error frame.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import socket
import socketserver
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..models.lora import lora_from_list, lora_to_list
from ..ops.sampling import SamplingParams
from ..scheduling.gossip import GossipNode
from ..scheduling.registry import (
    PlacementRegistry,
    ServerRecord,
    dict_to_rec,
    rec_to_dict,
)
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from ..telemetry import exposition as _texp
from ..telemetry import get_registry as _get_metrics_registry
from ..telemetry import get_tracer
from ..telemetry.profiling import get_profiler as _get_profiler
from ..telemetry.profiling import stats_digest as _prof_digest
from . import errors as _errors
from .executor import StageExecutionError, StageExecutor
from .faults import SITE_KINDS, FaultPlan, FaultSocket
from .messages import BackwardRequest, BackwardResponse, StageRequest, StageResponse
from .task_pool import StageRuntime, TaskRejected
from .transport import PeerUnavailable, Transport

logger = logging.getLogger(__name__)

MAGIC = b"MPT1"
MAX_FRAME = 1 << 30
# Payloads beyond this stream as per-chunk-CRC'd segments.
CHUNK_SIZE = 64 * 1024 * 1024
MAX_PAYLOAD = 8 << 30          # 8 GiB sanity cap on a chunked payload
# CRC-valid bytes a chunked sender must commit before the receiver trusts
# the header-declared total enough to preallocate it (scaled by the total,
# so a hostile sender's memory amplification stays within PREALLOC_AMP).
PREALLOC_COMMIT = 128 * 1024 * 1024
PREALLOC_AMP = 8
# A server's cap on one compute call (a client's step timeout or deadline
# can only shorten it), and a client's TCP connect timeout.
COMPUTE_TIMEOUT_S = 120.0
CONNECT_TIMEOUT_S = 5.0


@_errors.register
class WireError(ConnectionError):
    """Malformed or corrupted frame (retryable via its ConnectionError
    ancestor's catalog row: corruption fails closed and replays)."""


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    if len(payload) > CHUNK_SIZE:
        # Chunked transfer: the base frame carries an empty payload and a
        # "chunked" descriptor; the chunks follow as [len | bytes | crc32c].
        header = dict(header,
                      chunked={"total": len(payload), "chunk": CHUNK_SIZE})
        hdr = json.dumps(header).encode()
        sock.sendall(MAGIC + struct.pack("<I", len(hdr)) + hdr
                     + struct.pack("<I", 0) + struct.pack("<I", native.crc32c(b"")))
        mv = memoryview(payload)
        for off in range(0, len(payload), CHUNK_SIZE):
            chunk = bytes(mv[off:off + CHUNK_SIZE])
            sock.sendall(struct.pack("<I", len(chunk)))
            sock.sendall(chunk)
            sock.sendall(struct.pack("<I", native.crc32c(chunk)))
        return
    hdr = json.dumps(header).encode()
    crc = native.crc32c(payload)
    sock.sendall(
        MAGIC + struct.pack("<I", len(hdr)) + hdr
        + struct.pack("<I", len(payload)) + payload + struct.pack("<I", crc)
    )


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    """One frame: (header, payload). A reassembled chunked payload may be
    a bytearray (bytes-like), which spares a copy of a large payload."""
    magic = _recv_exact(sock, 4)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    if hlen > MAX_FRAME:
        raise WireError(f"oversized header {hlen}")
    try:
        header = json.loads(_recv_exact(sock, hlen))
    except ValueError as exc:
        # A corrupted header is a wire fault: the caller drops the
        # connection and fails over, as for any other ConnectionError.
        raise WireError(f"undecodable header: {exc}") from exc
    (plen,) = struct.unpack("<I", _recv_exact(sock, 4))
    if plen > MAX_FRAME:
        raise WireError(f"oversized payload {plen}")
    payload = _recv_exact(sock, plen)
    (crc,) = struct.unpack("<I", _recv_exact(sock, 4))
    if crc != native.crc32c(payload):
        raise WireError("payload checksum mismatch")
    ch = header.get("chunked")
    if ch:
        total = int(ch["total"])
        if not 0 <= total <= MAX_PAYLOAD:
            raise WireError(f"oversized chunked payload {total}")
        # The full buffer is allocated only once the sender has committed
        # enough CRC-valid bytes; until then chunks accumulate in a list.
        chunks: list = []
        buf: Optional[bytearray] = None
        off = 0
        while off < total:
            (clen,) = struct.unpack("<I", _recv_exact(sock, 4))
            if clen == 0 or clen > MAX_FRAME or off + clen > total:
                raise WireError(f"bad chunk length {clen} at offset {off}")
            chunk = _recv_exact(sock, clen)
            (ccrc,) = struct.unpack("<I", _recv_exact(sock, 4))
            if ccrc != native.crc32c(chunk):
                raise WireError(f"chunk checksum mismatch at offset {off}")
            if buf is not None:
                buf[off:off + clen] = chunk
            else:
                chunks.append(chunk)
                if off + clen >= min(total, max(PREALLOC_COMMIT,
                                                total // PREALLOC_AMP)):
                    buf = bytearray(total)
                    pos = 0
                    for c in chunks:
                        buf[pos:pos + len(c)] = c
                        pos += len(c)
                    chunks = []
            off += clen
        payload = b"".join(chunks) if buf is None else buf
        # Drop the descriptor: the header now describes a whole payload.
        header.pop("chunked", None)
    return header, payload


# ---------------------------------------------------------------------------
# Tensor codec (host numpy arrays, as in the reference)
# ---------------------------------------------------------------------------

def _host_array(t) -> np.ndarray:
    """A tensor as the host numpy array the codec encodes: integer ids as
    int32, any float as float32. For a CUDA tensor this waits for the
    kernels that produce it."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.is_floating_point():
            return t.float().cpu().numpy()
        return t.to(torch.int32).cpu().numpy()
    return np.asarray(t)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A decoded array as a CPU tensor (copied when the buffer is
    read-only, as an array over the received bytes is)."""
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _encode_tensor(arr: np.ndarray, wire_dtype: str) -> Tuple[dict, bytes]:
    meta = {"shape": list(arr.shape)}
    if arr.dtype == np.int32:
        meta["dtype"] = "int32"
        return meta, np.ascontiguousarray(arr).tobytes()
    if wire_dtype == "bf16":
        meta["dtype"] = "bf16"
        return meta, native.fp32_to_bf16_bytes(np.asarray(arr, np.float32))
    meta["dtype"] = "f32"
    return meta, np.ascontiguousarray(arr, np.float32).tobytes()


def _decode_tensor(meta: dict, payload: bytes) -> np.ndarray:
    shape = tuple(meta["shape"])
    if meta["dtype"] == "int32":
        return np.frombuffer(payload, np.int32).reshape(shape)
    if meta["dtype"] == "bf16":
        return native.bf16_bytes_to_fp32(payload, shape)
    return np.frombuffer(payload, np.float32).reshape(shape).copy()


def _encode_tensors(arrs, wire_dtype) -> Tuple[list, bytes]:
    """Pack several tensors into one payload; each meta gains 'nbytes'.
    ``wire_dtype`` is one string or one per tensor."""
    if isinstance(wire_dtype, str):
        wire_dtype = [wire_dtype] * len(arrs)
    if len(wire_dtype) != len(arrs):
        raise WireError(
            f"{len(wire_dtype)} wire dtypes for {len(arrs)} tensors")
    metas, chunks = [], []
    for arr, wd in zip(arrs, wire_dtype):
        meta, body = _encode_tensor(np.asarray(arr), wd)
        meta["nbytes"] = len(body)
        metas.append(meta)
        chunks.append(body)
    return metas, b"".join(chunks)


def _decode_tensors(metas: list, payload: bytes) -> list:
    out, off = [], 0
    for meta in metas:
        n = meta["nbytes"]
        out.append(_decode_tensor(meta, payload[off:off + n]))
        off += n
    return out


def _request_header(req: StageRequest, tensor_meta: dict,
                    model: Optional[str] = None,
                    prompts_meta: Optional[dict] = None) -> dict:
    """The classic ``forward`` header, key for key the reference's: the
    optional fields are absent unless set, so peers see identical bytes."""
    hdr = {
        "verb": "forward",
        "session_id": req.session_id,
        "seq_len": req.seq_len,
        "cur_len": req.cur_len,
        "is_prefill": req.is_prefill,
        "is_replay": req.is_replay,
        "max_length": req.max_length,
        "temperature": req.sampling.temperature,
        "top_p": req.sampling.top_p,
        "top_k": req.sampling.top_k,
        "repetition_penalty": req.sampling.repetition_penalty,
        "generated_tokens": list(req.generated_tokens),
        "step_seed": req.step_seed,
        "start_block": req.start_block,
        "end_block": req.end_block,
        "next_servers": list(req.next_servers),
        "hypo_ids": None if req.hypo_ids is None else list(req.hypo_ids),
        "num_logprobs": req.num_logprobs,
        "start_from_position": req.start_from_position,
        "draft_tokens": (None if req.draft_tokens is None
                         else list(req.draft_tokens)),
        "tensor": tensor_meta,
    }
    if req.prefix_len:
        hdr["prefix_len"] = req.prefix_len
    if req.trace is not None:
        hdr["trace"] = req.trace
    if req.deadline_budget_s is not None:
        hdr["deadline_budget_s"] = req.deadline_budget_s
    if req.priority is not None:
        hdr["priority"] = req.priority
    if req.burst_len:
        hdr["burst_len"] = req.burst_len
        hdr["burst_budget"] = req.burst_budget
    if req.eos_token_id is not None:
        hdr["eos_token_id"] = req.eos_token_id
    if model is not None:
        hdr["model"] = model
    if prompts_meta is not None:
        hdr["prompts_tensor"] = prompts_meta
    return hdr


def _header_to_request(h: dict, payload: bytes) -> StageRequest:
    pr = None
    if h.get("prompts_tensor") is not None:
        arr, pr = _decode_tensors([h["tensor"], h["prompts_tensor"]], payload)
        pr = _to_tensor(pr)
    else:
        arr = _decode_tensor(h["tensor"], payload)
    return StageRequest(
        session_id=h["session_id"],
        hidden=_to_tensor(arr),
        seq_len=h["seq_len"],
        cur_len=h["cur_len"],
        is_prefill=h["is_prefill"],
        is_replay=h.get("is_replay", False),
        max_length=h["max_length"],
        sampling=SamplingParams(
            temperature=h["temperature"], top_p=h["top_p"], top_k=h["top_k"],
            repetition_penalty=h["repetition_penalty"],
        ),
        generated_tokens=tuple(h.get("generated_tokens", ())),
        step_seed=h.get("step_seed", 0),
        start_block=h.get("start_block"),
        end_block=h.get("end_block"),
        next_servers=tuple(h.get("next_servers", ())),
        hypo_ids=(None if h.get("hypo_ids") is None
                  else tuple(h["hypo_ids"])),
        num_logprobs=h.get("num_logprobs", 0),
        start_from_position=h.get("start_from_position"),
        draft_tokens=(None if h.get("draft_tokens") is None
                      else tuple(h["draft_tokens"])),
        model=h.get("model"),
        prompts=pr,
        prefix_len=h.get("prefix_len", 0),
        trace=h.get("trace"),
        deadline_budget_s=h.get("deadline_budget_s"),
        priority=h.get("priority"),
        burst_len=h.get("burst_len", 0),
        burst_budget=h.get("burst_budget", 0),
        eos_token_id=h.get("eos_token_id"),
    )


def _trace_id(req: StageRequest) -> Optional[str]:
    """The trace id riding the request's trace context, if any."""
    trace = getattr(req, "trace", None)
    if isinstance(trace, dict):
        tid = trace.get("trace_id")
        return str(tid) if tid is not None else None
    return None


# ---------------------------------------------------------------------------
# Framed-protocol server base
# ---------------------------------------------------------------------------

class _FramedTcpServer:
    """Threaded TCP server speaking the framed protocol; subclasses handle
    each frame in `_dispatch(sock, header, payload)`.

    `stop()` severs established connections, not just the listener: a
    stopped server must look dead to its clients, which fail over. The
    connections are tracked in `process_request`, on the accept thread, so
    every connection accepted before `shutdown()` returns is in the set."""

    def __init__(self, host: str, port: int):
        active_lock = threading.Lock()
        active: set = set()
        self._active_lock, self._active = active_lock, active
        # Chaos layer (runtime.faults): None keeps the raw socket; a plan is
        # armed in-process or over the gated `fault` admin verb.
        self.fault_plan: Optional[FaultPlan] = None
        self.fault_side = "server"
        self.allow_fault_injection = False
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while True:
                    try:
                        header, payload = _recv_frame(sock)
                    except (ConnectionError, OSError):
                        return
                    plan = outer.fault_plan
                    if plan is not None:
                        if not isinstance(sock, FaultSocket):
                            # Hashes and compares as the raw socket, so the
                            # per-connection stream state survives the wrap.
                            sock = FaultSocket(self.request, plan,
                                               side=outer.fault_side)
                        sock.ctx_verb = header.get("verb")
                        sock.ctx_session = header.get("session_id")
                        rule = plan.fire(
                            "dispatch", ("accept_hang", "delay"),
                            side=outer.fault_side, verb=sock.ctx_verb,
                            session=sock.ctx_session)
                        if rule is not None:
                            time.sleep(rule.delay_s)
                            if rule.kind == "accept_hang":
                                return
                    try:
                        outer._dispatch(sock, header, payload)
                    except (ConnectionError, OSError):
                        return
                    except Exception as exc:  # report, keep serving
                        logger.exception("request failed")
                        try:
                            _send_frame(sock,
                                        {"verb": "error", "message": str(exc)})
                        except OSError:
                            return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

            def process_request(self, request, client_address):
                with active_lock:
                    active.add(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                with active_lock:
                    active.discard(request)
                outer._on_connection_closed(request)
                super().shutdown_request(request)

        self._server = Server((host, port), Handler)
        self.address = "%s:%d" % self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._active_lock:
            active = list(self._active)
        for sock in active:
            # shutdown() only: the handler thread's exit closes the fd, and
            # closing it here too would race fd reuse with a blocked recv().
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _dispatch(self, sock, header: dict, payload: bytes) -> None:
        raise NotImplementedError

    def _on_connection_closed(self, sock) -> None:
        """Hook: a connection's handler finished (socket about to close)."""

    def _fault_admin(self, header: dict) -> dict:
        """The `fault` admin verb: install, clear or report this process's
        FaultPlan. Refused unless the process allows fault injection."""
        if not self.allow_fault_injection:
            return {"verb": "error",
                    "message": "fault injection disabled "
                               "(start with --allow_fault_injection)"}
        action = header.get("action", "install")
        if action == "clear":
            self.fault_plan = None
            return {"verb": "ok", "installed": False}
        if action == "report":
            plan = self.fault_plan
            return {"verb": "fault_report",
                    "installed": plan is not None,
                    "firings": [] if plan is None else plan.report()}
        self.fault_plan = FaultPlan.from_dict(header.get("plan") or {})
        return {"verb": "ok", "installed": True,
                "rules": len(self.fault_plan.rules)}


# ---------------------------------------------------------------------------
# Stage server
# ---------------------------------------------------------------------------

class RequestLog:
    """Structured per-request records: a greppable key=value line on the
    ``...request_log`` logger and a bounded ring the ``info`` verb returns."""

    def __init__(self, capacity: int = 256, name: str = "request_log"):
        self._ring = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._logger = logging.getLogger(f"{__name__}.{name}")

    def record(self, verb: str, *, session: Optional[str] = None,
               peer: str = "?", tokens: Optional[int] = None,
               cur: Optional[int] = None, dur_ms: Optional[float] = None,
               outcome: str = "ok", detail: Optional[str] = None,
               **fields) -> None:
        rec = {"t": time.time(), "verb": verb, "peer": peer,
               "outcome": outcome}
        if session is not None:
            rec["session"] = session
        if tokens is not None:
            rec["tokens"] = int(tokens)
        if cur is not None:
            rec["cur"] = int(cur)
        if dur_ms is not None:
            rec["dur_ms"] = round(float(dur_ms), 2)
        if detail:
            rec["detail"] = str(detail)[:200]
        rec.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._ring.append(rec)
        line = " ".join(f"{k}={v}" for k, v in rec.items() if k != "t")
        if outcome != "ok":
            self._logger.warning(line)
        elif verb == "forward":
            self._logger.debug(line)   # decode steps must not flood the log
        else:
            self._logger.info(line)

    def tail(self, n: int = 20) -> list:
        with self._lock:
            return list(self._ring)[-n:]


class TcpStageServer(_FramedTcpServer):
    """Serves one StageExecutor (or a ``BatchingStageAdapter``) over TCP.

    With a `runtime`, each connection's handler thread submits compute to
    its pools and blocks on the future: one compute thread owns the card
    while the handler threads own the sockets; the server starts and stops
    the runtime. With ``runtime=None`` compute runs inline on the handler
    threads, as a batched engine needs: concurrent calls are how its round
    window coalesces, and its own lock guards the card.

    An elastic server swaps `executor` at run time when it re-spans, and
    sets it to None in between: each request reads it once, and while it
    is None a request gets the retryable stage error "server is
    re-spanning". `peer_id` is fixed when the server is built (the
    executor's, when one is given and no `peer_id`), so error frames name
    this server whatever it serves.

    `gossip` (a `GossipNode`) makes the server a mirror of the placement
    records; `relay_capacity` > 0 makes it a relay volunteer for that many
    peers. Both, and the socket-only verbs, work with no executor, so a
    re-spanning server keeps gossiping and relaying."""

    # Relay circuit lease (seconds): an attached peer re-attaches on its
    # heartbeat cadence, or the volunteer frees the slot.
    RELAY_CIRCUIT_TTL = 90.0

    def __init__(self, executor: Optional[StageExecutor], runtime: Optional[StageRuntime],
                 host: str = "127.0.0.1",
                 port: int = 0, wire_dtype: str = "bf16",
                 model: Optional[str] = None,
                 allow_fault_injection: bool = False,
                 peer_id: Optional[str] = None,
                 gossip: Optional[GossipNode] = None,
                 relay_capacity: int = 0):
        self.executor = executor
        self.gossip = gossip
        self.peer_id = peer_id or (executor.peer_id if executor is not None else None)
        # Tagged requests for another model are refused before compute.
        self.model = model
        self.wire_dtype = wire_dtype
        self.runtime = runtime
        # Pooled connections to push-chain next hops and relayed peers:
        # address -> (socket, its send/receive lock).
        self._relay_conns: Dict[str, tuple] = {}
        self._relay_lock = threading.Lock()
        # Relay volunteering: attached peer_id -> (the address this server
        # dials it at, the circuit's expiry).
        self.relay_capacity = int(relay_capacity)
        self._relay_targets: Dict[str, tuple] = {}
        # Persistent inference streams: per CONNECTION, session_id -> stream
        # state (metadata shipped once at stream_open; steps carry deltas).
        # Dropped when the connection closes.
        self._streams: Dict[object, Dict[str, dict]] = {}
        self._streams_lock = threading.Lock()
        self.stream_opens = 0      # full-metadata (re)opens
        self.stream_steps = 0      # delta-only steps
        self.request_log = RequestLog()
        super().__init__(host, port)
        self.allow_fault_injection = allow_fault_injection

    def _compute(self, kind: str, fn, *args, size: int = 1,
                 timeout: Optional[float] = None,
                 priority: Optional[float] = None):
        budget = (COMPUTE_TIMEOUT_S if timeout is None
                  else min(timeout, COMPUTE_TIMEOUT_S))
        if self.runtime is None:
            return fn(*args)
        kwargs = {} if priority is None else {"priority": priority}
        return self.runtime.call(kind, fn, *args, size=size, timeout=budget,
                                 **kwargs)

    def start(self) -> None:
        super().start()
        if self.runtime is not None:
            self.runtime.start()
        ex = self.executor
        logger.info("stage server %s on %s (span %s)", self.peer_id, self.address,
                    f"[{ex.spec.start}, {ex.spec.end})" if ex is not None else "not chosen yet")

    def stop(self) -> None:
        super().stop()
        if self.runtime is not None:
            self.runtime.stop()
        with self._relay_lock:
            conns, self._relay_conns = dict(self._relay_conns), {}
        for sock, _ in conns.values():
            try:
                sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------------
    # Pooled connections: push-chain next hops and relayed peers
    # ------------------------------------------------------------------

    def _relay(self, nxt: dict, nreq: StageRequest,
               wire_dtype: str) -> Tuple[dict, bytes]:
        """Send a push-chain request to the next hop and return its raw
        response frame, relayed upstream verbatim. The activation is
        encoded at `wire_dtype`, the precision of this hop's own response,
        so the next hop computes on what a per-hop client would hand it. A
        stale pooled socket gets one reconnect."""
        addr = nxt.get("address")
        if not addr:
            raise ConnectionError(f"no address for push target {nxt}")
        meta, body = _encode_tensor(_host_array(nreq.hidden), wire_dtype)
        # The originating client's model tag, where it has one.
        hdr = _request_header(
            nreq, meta, model=(nreq.model if nreq.model is not None else self.model))
        hdr["wire_dtype"] = wire_dtype
        if nxt.get("relay_via"):
            # A NAT'd next hop: `addr` is its volunteer's, and relay_to
            # names the circuit.
            hdr["relay_to"] = nxt.get("peer_id")
        # The answer covers the rest of the chain's computes.
        timeout = COMPUTE_TIMEOUT_S * (1 + len(nreq.next_servers))
        for fresh in (False, True):
            sock, lock = self._relay_sock(addr)
            try:
                # Handler threads pushing to one hop share its socket.
                with lock:
                    sock.settimeout(timeout)
                    _send_frame(sock, hdr, body)
                    return _recv_frame(sock)
            except (ConnectionError, OSError):
                self._drop_relay(addr, sock)
                if fresh:
                    raise
        raise ConnectionError("unreachable")  # pragma: no cover

    def _relay_sock(self, addr: str):
        """The pooled (socket, lock) for `addr`, dialed outside the pool
        lock. A failed socket was dropped before a retry, so any entry
        found here is usable; a concurrent dial's winner is kept."""
        with self._relay_lock:
            entry = self._relay_conns.get(addr)
        if entry is not None:
            return entry
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=CONNECT_TIMEOUT_S)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        new_entry = (sock, threading.Lock())
        with self._relay_lock:
            winner = self._relay_conns.setdefault(addr, new_entry)
        if winner is not new_entry:
            try:
                sock.close()
            except OSError:
                pass
        return winner

    def _drop_relay(self, addr: str, sock: socket.socket) -> None:
        with self._relay_lock:
            entry = self._relay_conns.get(addr)
            if entry is not None and entry[0] is sock:
                del self._relay_conns[addr]
        try:
            sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    # NAT relay volunteering
    # ------------------------------------------------------------------

    def _prune_relay_targets_locked(self, now: float) -> None:
        for peer in [p for p, (_, exp) in self._relay_targets.items() if now >= exp]:
            del self._relay_targets[peer]

    def _relay_attach(self, sock, header: dict) -> None:
        """Open (or renew) a circuit for an unreachable peer, at the address
        this volunteer can dial it at (its bind address, not the advertised
        one that failed the vote). A saturated volunteer sheds with an
        error frame, so the attacher tries the next one."""
        peer = header.get("peer_id")
        addr = header.get("address")
        if not peer or not addr:
            _send_frame(sock, {"verb": "error",
                               "message": "relay_attach needs peer_id and address"})
            return
        now = time.monotonic()
        with self._relay_lock:
            self._prune_relay_targets_locked(now)
            saturated = (peer not in self._relay_targets
                         and len(self._relay_targets) >= self.relay_capacity)
            if not saturated:
                self._relay_targets[peer] = (addr, now + self.RELAY_CIRCUIT_TTL)
            active = len(self._relay_targets)
        _tm.get("relay_active_circuits").set(active)
        if saturated:
            _send_frame(sock, {"verb": "error", "relay_saturated": True,
                               "peer": self.peer_id or "?",
                               "message": f"relay at capacity "
                                          f"({active}/{self.relay_capacity})"})
            return
        _send_frame(sock, {"verb": "ok", "peer": self.peer_id or "?",
                           "active": active, "capacity": self.relay_capacity,
                           "ttl": self.RELAY_CIRCUIT_TTL})

    def _relay_forward(self, sock, target: str, header: dict,
                       payload: bytes) -> None:
        """Forward a frame verbatim to attached peer `target` and relay its
        answer back; no tensor is decoded. A failure answers with the push
        error shape: ``peer`` is the target (the client routes around it),
        ``breaker_peer`` set only where this volunteer is at fault."""
        verb = header.get("verb")
        session = header.get("session_id")
        m_fwd = _tm.get("relay_forwarded_total")
        plan = self.fault_plan
        if plan is not None:
            rule = plan.fire("relay", SITE_KINDS["relay"], side=self.fault_side,
                             peer=target, verb=verb, session=session)
            if rule is not None:
                if rule.kind == "relay_stall":
                    time.sleep(rule.delay_s)
                else:   # relay_drop: the volunteer eats the frame
                    m_fwd.labels(outcome="drop").inc()
                    _ev.emit("relay_forward_error", session_id=session,
                             relay=self.peer_id or "?", peer=target, verb=verb,
                             error="relay_drop (injected)")
                    _send_frame(sock, {
                        "verb": "error", "kind": "push", "peer": target,
                        "breaker_peer": self.peer_id or "?",
                        "message": f"relay dropped frame for {target} (injected)"})
                    return
        now = time.monotonic()
        with self._relay_lock:
            self._prune_relay_targets_locked(now)
            entry = self._relay_targets.get(target)
            active = len(self._relay_targets)
        _tm.get("relay_active_circuits").set(active)
        if entry is None:
            # Never attached here, or its lease lapsed: the target is at
            # fault, not this volunteer.
            m_fwd.labels(outcome="no_circuit").inc()
            _ev.emit("relay_forward_error", session_id=session,
                     relay=self.peer_id or "?", peer=target, verb=verb,
                     error="no circuit")
            _send_frame(sock, {"verb": "error", "kind": "push", "peer": target,
                               "message": f"no relay circuit for {target}"})
            return
        addr = entry[0]
        timeout = COMPUTE_TIMEOUT_S * (1 + len(header.get("next_servers") or ()))
        for fresh in (False, True):
            fsock = None
            try:
                fsock, lock = self._relay_sock(addr)
                with lock:
                    fsock.settimeout(timeout)
                    _send_frame(fsock, header, payload)
                    rh, rp = _recv_frame(fsock)
                break
            except (ConnectionError, OSError) as exc:
                if fsock is not None:
                    self._drop_relay(addr, fsock)
                if fresh:
                    m_fwd.labels(outcome="error").inc()
                    _ev.emit("relay_forward_error", session_id=session,
                             relay=self.peer_id or "?", peer=target, verb=verb,
                             error=str(exc)[:200])
                    _send_frame(sock, {"verb": "error", "kind": "push", "peer": target,
                                       "message": f"relay to {target} failed: {exc}"})
                    return
        m_fwd.labels(outcome="ok").inc()
        _send_frame(sock, rh, rp)

    def _gossip_dispatch(self, sock, header: dict) -> None:
        """The control plane from this server's GossipNode: the ``gossip``
        anti-entropy verb, and the registry service's register /
        heartbeat / unregister / list with `RegistryServer`'s response
        shapes, so a `RemoteRegistry` pointed here works unchanged."""
        node = self.gossip
        verb = header.get("verb")
        if verb == "gossip":
            plan = self.fault_plan
            if plan is not None:
                rule = plan.fire("gossip", SITE_KINDS["gossip"], side=self.fault_side,
                                 peer=header.get("peer_id"), verb=verb)
                if rule is not None:
                    if rule.kind == "gossip_drop":
                        # The initiator's round dies on its read timeout; a
                        # later round converges.
                        return
                    node.merge(header.get("entries") or ())   # duplicate
            merged = node.merge(header.get("entries") or ())
            resp = {"verb": "gossip", "peer_id": self.peer_id, "merged": merged}
            digest = header.get("digest")
            if digest is not None:
                # A round's opener: our digest, and the entries the
                # initiator's digest lacks.
                resp["digest"] = node.digest()
                resp["entries"] = node.delta_for(digest)
                _tm.get("gossip_rounds_total").labels(role="responder").inc()
            _send_frame(sock, resp)
            return
        _tm.get("gossip_mirror_requests_total").labels(verb=verb).inc()
        if verb == "register":
            node.publish(dict(header["record"]))
            _send_frame(sock, {"verb": "ok", "ttl": node.ttl})
        elif verb == "heartbeat":
            ok = node.apply_heartbeat(
                header["peer_id"], throughput=header.get("throughput"),
                cache_tokens_left=header.get("cache_tokens_left"),
                next_server_rtts=header.get("next_server_rtts"))
            _send_frame(sock, {"verb": "ok", "known": ok, "ttl": node.ttl})
        elif verb == "unregister":
            node.apply_unregister(header["peer_id"])
            _send_frame(sock, {"verb": "ok"})
        else:   # list: a client discovering through this server
            now = time.monotonic()
            records = [dict(rec_to_dict(r), age_s=max(0.0, now - r.timestamp))
                       for r in node.live_servers()]
            _ev.emit("gossip_served_discovery", peer=self.peer_id, records=len(records))
            _send_frame(sock, {"verb": "records", "ttl": node.ttl, "records": records})

    def _dispatch(self, sock, header: dict, payload: bytes) -> None:
        verb = header.get("verb")
        relay_to = header.pop("relay_to", None)
        if relay_to is not None:
            # This server is the frame's relay volunteer: forward it, minus
            # the routing key, whatever its verb.
            self._relay_forward(sock, relay_to, header, payload)
            return
        if verb == "relay_attach":
            self._relay_attach(sock, header)
            return
        if verb == "reach_check":
            self._reach_check(sock, header)
            return
        if verb == "metrics":
            # Prometheus text of this process's registry (empty when
            # telemetry is off; the scrape never enables it).
            _send_frame(sock, {
                "verb": "metrics",
                "text": _texp.render(_get_metrics_registry()),
            })
            return
        if verb == "dump-events":
            _send_frame(sock, {
                "verb": "events",
                "lines": _ev.get_recorder().render_jsonl(
                    registry=_get_metrics_registry()),
            })
            return
        if verb == "fault":
            _send_frame(sock, self._fault_admin(header))
            return
        if verb == "swarm-stats":
            # This process's stats digest and every live record its mirror
            # holds (each with the stats digest its origin gossips).
            _send_frame(sock, {
                "verb": "swarm-stats", "peer_id": self.peer_id or "?",
                "self": _prof_digest(),
                "records": self.gossip.live_records() if self.gossip is not None else [],
            })
            return
        if self.gossip is not None and verb in (
                "gossip", "register", "heartbeat", "unregister", "list"):
            # Before the executor check: a re-spanning server keeps
            # gossiping and serving discovery.
            self._gossip_dispatch(sock, header)
            return
        # One read: an elastic server may swap or unset the executor at any
        # moment, and the rest of this request must see one executor.
        ex = self.executor
        if ex is None:
            _send_frame(sock, {"verb": "error", "kind": "stage",
                               "peer": self.peer_id or "?",
                               "message": "server is re-spanning"})
            return
        req_model = header.get("model")
        if (req_model is not None and self.model is not None
                and req_model != self.model):
            _send_frame(sock, {"verb": "error", "kind": "stage",
                               "peer": self.peer_id,
                               "model_mismatch": True,
                               "message": f"model mismatch: request is for "
                                          f"{req_model!r}, server holds "
                                          f"{self.model!r}"})
            return
        if verb == "stream_open":
            self._stream_open(sock, header)
        elif verb == "step":
            self._stream_step(sock, ex, header, payload)
        elif verb == "forward":
            self._run_forward(sock, ex, _header_to_request(header, payload),
                              resp_wire_dtype=header.get("wire_dtype"))
        elif verb in ("train_forward", "backward"):
            self._train_verbs(sock, ex, verb, header, payload)
        elif verb == "end_session":
            self._end_session(sock, ex, header["session_id"])
        elif verb == "info":
            _send_frame(sock, self._info(ex))
        else:
            _send_frame(sock, {"verb": "error",
                               "message": f"unknown verb {verb!r}"})

    def _end_session(self, sock, ex, sid: str) -> None:
        # The stream state goes too, or ended sessions' metadata would pile
        # up on a long-lived connection.
        with self._streams_lock:
            self._streams.get(sock, {}).pop(sid, None)
        # Through the compute thread, not inline: a timed-out forward of the
        # same session may still be stepping its KV buffers.
        try:
            self._compute("inference", ex.drop_session, sid)
        except (StageExecutionError, TaskRejected, TimeoutError) as exc:
            self.request_log.record("end_session", session=sid,
                                    outcome="stage_error", detail=str(exc))
            _send_frame(sock, {"verb": "error", "message": str(exc),
                               "kind": "stage"})
            return
        self.request_log.record("end_session", session=sid)
        _send_frame(sock, {"verb": "ok"})

    def _info(self, ex) -> dict:
        spec = ex.spec
        frame = {
            "verb": "info", "peer_id": ex.peer_id,
            "start_block": spec.start, "end_block": spec.end,
            "cache_tokens_left": ex.arena.tokens_left(),
            "requests_served": ex.requests_served,
            "engine": getattr(ex, "engine", "session"),
            "version": 1,
            # LoRA training is served: a trainer checks this before shipping
            # adapters to a peer.
            "lora": True,
            "recent_requests": self.request_log.tail(20),
            "telemetry": _texp.summary(_get_metrics_registry()),
        }
        # A batched engine's rounds, beside the requests it served.
        steps = getattr(getattr(ex, "inner", None), "decode_steps", None)
        if steps is not None:
            frame["decode_steps"] = steps
        # The prefix store's counters, the executor's or the engine's. An
        # empty store is falsy (it has a length): test for None, where the
        # reference's ``or`` drops an empty store's stats.
        store = getattr(ex, "prefix_store", None)
        if store is None:
            store = getattr(getattr(ex, "inner", None), "prefix_store", None)
        if store is not None:
            frame["prefix_cache"] = store.stats()
        return frame

    # ------------------------------------------------------------------
    # Persistent inference streams
    # ------------------------------------------------------------------

    def _on_connection_closed(self, sock) -> None:
        with self._streams_lock:
            self._streams.pop(sock, None)

    def _stream_open(self, sock, header: dict) -> None:
        """Register a session stream on THIS connection: the full metadata
        ships once; `step` frames carry per-step deltas. Re-opening replaces
        the metadata (the client does so when sampling or the route
        changes)."""
        sid = header["session_id"]
        state = {
            "max_length": header.get("max_length", 0),
            "sampling": SamplingParams(
                temperature=header.get("temperature", 0.7),
                top_p=header.get("top_p", 0.9),
                top_k=header.get("top_k", 50),
                repetition_penalty=header.get("repetition_penalty", 1.5),
            ),
            "start_block": header.get("start_block"),
            "end_block": header.get("end_block"),
            "model": header.get("model"),
            "next_servers": tuple(header.get("next_servers", ())),
            # The server keeps the recent-token window: seeded here, then
            # every token this server samples for the session is appended.
            "generated": list(header.get("generated_tokens", ()))[-50:],
            "step_timeout": header.get("step_timeout"),
            "deadline": (time.monotonic() + header["deadline_s"]
                         if header.get("deadline_s") else None),
            "wire_dtype": header.get("wire_dtype"),
        }
        with self._streams_lock:
            self._streams.setdefault(sock, {})[sid] = state
            self.stream_opens += 1
        _send_frame(sock, {"verb": "ok", "session_id": sid})

    def _stream_step(self, sock, ex, header: dict, payload: bytes) -> None:
        sid = header["session_id"]
        with self._streams_lock:
            state = self._streams.get(sock, {}).get(sid)
            self.stream_steps += 1
        if state is None:
            # stream_closed + reason let the client repair a desync (re-open
            # and resend) and tell it from a policy refusal.
            _send_frame(sock, {"verb": "error", "kind": "stage",
                               "peer": self.peer_id,
                               "stream_closed": True, "reason": "no_stream",
                               "message": f"session {sid}: step without "
                                          "stream_open on this connection"})
            return
        if state["deadline"] is not None and time.monotonic() > state["deadline"]:
            with self._streams_lock:
                self._streams.get(sock, {}).pop(sid, None)
            try:
                self._compute("inference", ex.drop_session, sid)
            except (StageExecutionError, TaskRejected, TimeoutError):
                pass
            _send_frame(sock, {"verb": "error", "kind": "stage",
                               "peer": self.peer_id,
                               "stream_closed": True, "reason": "deadline",
                               "message": f"session {sid}: deadline exceeded"})
            return
        req = StageRequest(
            session_id=sid,
            hidden=_to_tensor(_decode_tensor(header["tensor"], payload)),
            seq_len=header["seq_len"],
            cur_len=header["cur_len"],
            is_prefill=header.get("is_prefill", False),
            max_length=state["max_length"],
            sampling=state["sampling"],
            generated_tokens=tuple(state["generated"]),
            step_seed=header.get("step_seed", 0),
            start_block=state["start_block"],
            end_block=state["end_block"],
            model=state["model"],
            next_servers=state["next_servers"],
            start_from_position=header.get("start_from_position"),
            prefix_len=header.get("prefix_len", 0),
            trace=header.get("trace"),
            deadline_budget_s=header.get("deadline_budget_s"),
            priority=header.get("priority"),
        )
        self._run_forward(sock, ex, req, stream=state,
                          step_timeout=state["step_timeout"])

    def _run_forward(self, sock, ex, req: StageRequest, stream: dict = None,
                     step_timeout: Optional[float] = None,
                     resp_wire_dtype: Optional[str] = None) -> None:
        t_req = time.monotonic()
        if resp_wire_dtype is None and stream is not None:
            resp_wire_dtype = stream.get("wire_dtype")
        resp_wire_dtype = resp_wire_dtype or self.wire_dtype
        # The serving boundary: a request's server-side step latency runs
        # from here to the sent response.
        phase = "prefill" if req.is_prefill else "decode"
        m_requests = _tm.get("server_requests_total")
        span = get_tracer().span_from_wire(
            req.trace, "server_forward", kind="server",
            peer=ex.peer_id, phase=phase)

        def _log(outcome, detail=None):
            try:
                peer = "%s:%s" % sock.getpeername()[:2]
            except OSError:
                peer = "?"
            self.request_log.record(
                "prefill" if req.is_prefill else "forward",
                session=req.session_id, peer=peer, tokens=req.seq_len,
                cur=req.cur_len,
                dur_ms=(time.monotonic() - t_req) * 1e3,
                outcome=outcome, detail=detail,
                span=f"[{req.start_block},{req.end_block})",
                replay=int(req.is_replay) or None)

        if req.deadline_budget_s is not None:
            # A spent budget is refused: nobody waits for these tokens.
            remaining = req.deadline_budget_s - (time.monotonic() - t_req)
            if remaining <= 0.0:
                _log("deadline", f"budget {req.deadline_budget_s:.3f}s")
                m_requests.labels(outcome="error").inc()
                _tm.get("server_deadline_rejected_total").inc()
                _ev.emit("deadline_rejected", session_id=req.session_id,
                         trace_id=_trace_id(req), peer=ex.peer_id,
                         budget_s=req.deadline_budget_s,
                         waited_s=round(time.monotonic() - t_req, 6))
                span.end(error="deadline")
                _send_frame(sock, {
                    "verb": "error", "kind": "stage", "peer": ex.peer_id,
                    "deadline_expired": True,
                    "message": f"deadline budget exhausted "
                               f"({req.deadline_budget_s:.3f}s remaining "
                               f"on arrival)"})
                return
            # The compute wait is capped by what is left of the deadline.
            step_timeout = (remaining if step_timeout is None
                            else min(step_timeout, remaining))

        t_compute = time.monotonic()
        try:
            resp = self._compute("inference", ex.forward, req,
                                 size=req.seq_len, timeout=step_timeout,
                                 priority=req.priority)
        # kind="stage" is in the client's retryable taxonomy. TimeoutError
        # is caught on its own: it is an OSError, which the handler loop
        # would take for a dead socket.
        except (StageExecutionError, TaskRejected) as exc:
            _log("stage_error", str(exc))
            m_requests.labels(outcome="error").inc()
            _ev.emit("stage_error", session_id=req.session_id,
                     trace_id=_trace_id(req), peer=ex.peer_id,
                     phase=phase, error=str(exc)[:200])
            span.end(error=repr(exc))
            frame = {"verb": "error", "message": str(exc), "kind": "stage",
                     "peer": ex.peer_id}
            if isinstance(exc, TaskRejected) and exc.permanent:
                # Oversized work never succeeds elsewhere: not retryable.
                frame = {"verb": "error", "message": str(exc),
                         "kind": "stage", "task_rejected": True,
                         "peer": ex.peer_id}
            _send_frame(sock, frame)
            return
        except TimeoutError:
            budget = (step_timeout if step_timeout is not None
                      else COMPUTE_TIMEOUT_S)
            _log("timeout")
            m_requests.labels(outcome="timeout").inc()
            _ev.emit("stage_timeout", session_id=req.session_id,
                     trace_id=_trace_id(req), peer=ex.peer_id,
                     phase=phase, budget_s=budget)
            span.end(error="timeout")
            _send_frame(sock, {"verb": "error", "kind": "stage",
                               "peer": ex.peer_id,
                               "message": f"stage compute timed out after "
                                          f"{budget:.0f}s"})
            return
        # The server span and phase end at compute completion, before the
        # encode, as the reference's (net.py:1316-1323): a hidden state's
        # host copy (which waits for this stage's kernels) and its encode
        # fall outside them.
        _get_profiler().observe("server", time.monotonic() - t_req)
        span.set(cache_len=resp.cache_len,
                 queue_s=max(0.0, t_compute - t_req)).end()
        if resp.is_burst:
            # A burst's tokens: the reference's "burst" reply (net.py:1324).
            frame = {
                "verb": "burst", "session_id": resp.session_id,
                "tokens": list(resp.burst_tokens), "stop": resp.burst_stop,
                "cache_len": resp.cache_len,
            }
            body = b""
        elif resp.is_token:
            if stream is not None:
                # The stream's server-side recent-token window.
                stream["generated"].append(int(resp.token_id))
                del stream["generated"][:-50]
            frame = {
                "verb": "token", "session_id": resp.session_id,
                "token_id": resp.token_id, "cache_len": resp.cache_len,
            }
            if resp.token_ids is not None:   # batch>1 per-row sampling
                frame["token_ids"] = list(resp.token_ids)
            body = b""
        elif resp.is_speculative:
            # The verified run: the reference's "spec" reply (net.py:1349).
            frame = {
                "verb": "spec", "session_id": resp.session_id,
                "tokens": list(resp.tokens), "n_accepted": resp.n_accepted,
                "cache_len": resp.cache_len,
            }
            body = b""
        elif resp.is_beam:
            # Each row's top-N candidates: the reference's "beam" reply
            # (net.py:1359).
            frame = {
                "verb": "beam", "session_id": resp.session_id,
                "cache_len": resp.cache_len,
                "top_tokens": [list(r) for r in resp.top_tokens],
                "top_logprobs": [list(r) for r in resp.top_logprobs],
            }
            body = b""
        elif req.next_servers:
            # Push chain, on this handler thread once the compute thread
            # has answered: the output goes straight to the next hop, whose
            # final answer is relayed back (one client round trip a step).
            nxt = req.next_servers[0]
            nreq = dataclasses.replace(
                req, hidden=resp.hidden, start_block=nxt.get("start_block"),
                end_block=nxt.get("end_block"), next_servers=tuple(req.next_servers[1:]))
            if req.deadline_budget_s is not None:
                # The next hop judges expiry against what is left.
                nreq = dataclasses.replace(
                    nreq, deadline_budget_s=req.deadline_budget_s - (time.monotonic() - t_req))
            try:
                frame, body = self._relay(nxt, nreq, resp_wire_dtype)
            except (ConnectionError, OSError) as exc:
                m_requests.labels(outcome="error").inc()
                err = {"verb": "error", "kind": "push", "peer": nxt.get("peer_id", "?"),
                       "message": f"push to {nxt.get('peer_id')} failed: {exc}"}
                if nxt.get("relay_via"):
                    # The dial that failed was the volunteer's: it takes the
                    # breaker's blame, the hop the routing blame.
                    err["breaker_peer"] = nxt.get("relay_via")
                _send_frame(sock, err)
                return
            if stream is not None and frame.get("verb") == "token" and (
                    frame.get("token_id") is not None):
                # A token sampled downstream joins this stream's window
                # too, or the final stage's repetition penalty would see
                # the window as of stream_open.
                stream["generated"].append(int(frame["token_id"]))
                del stream["generated"][:-50]
            _send_frame(sock, frame, body)
            frame = None
        else:
            meta, body = _encode_tensor(_host_array(resp.hidden), resp_wire_dtype)
            frame = {
                "verb": "hidden", "session_id": resp.session_id,
                "cache_len": resp.cache_len, "tensor": meta,
            }
        if frame is not None:
            if req.trace is not None:
                frame["span"] = span.to_wire()
            _send_frame(sock, frame, body)
        _tm.get("server_step_latency_seconds").labels(
            phase=phase).observe(time.monotonic() - t_req)
        _tm.get("server_tokens_total").labels(phase=phase).inc(req.seq_len)
        m_requests.labels(outcome="ok").inc()
        _log("ok")

    def _train_verbs(self, sock, ex, verb: str, header: dict, payload: bytes) -> None:
        """``train_forward`` and ``backward`` (the reference's
        ``_train_verbs``), through the runtime's forward and backward pools,
        which inference outranks. A malformed manifest, or a tensor count
        that the header does not account for, is a clean stage error, not a
        connection-level one the client would take for a dead peer."""
        try:
            tensors = [_to_tensor(a) for a in _decode_tensors(header["tensors"], payload)]
            manifest = header.get("lora_manifest") or []
            base = 1 if verb == "train_forward" else 2
            has_prompts = bool(header.get("has_prompts", len(tensors) - len(manifest) > base))
            want = base + int(has_prompts) + len(manifest)
            if len(tensors) != want:
                raise StageExecutionError(
                    f"{verb} frame carries {len(tensors)} tensors, want {want}: {base} "
                    f"activation{'s' if base > 1 else ''}, {int(has_prompts)} prompts "
                    f"(has_prompts), {len(manifest)} LoRA (lora_manifest)")
            lora = None
            if manifest:
                try:
                    lora = lora_from_list(manifest, tensors[-len(manifest):])
                except ValueError as exc:
                    raise StageExecutionError(str(exc)) from exc
                tensors = tensors[:-len(manifest)]
            lora_scale = float(header.get("lora_scale", 1.0))
            prompts = tensors[base] if has_prompts else None
            if verb == "train_forward":
                req = StageRequest(
                    session_id=header["session_id"], hidden=tensors[0],
                    seq_len=header["seq_len"], cur_len=0, is_prefill=False,
                    max_length=0, train=True, prompts=prompts, lora=lora,
                    lora_scale=lora_scale, start_block=header.get("start_block"),
                    end_block=header.get("end_block"))
                resp = self._compute("forward", ex.train_forward, req, size=req.seq_len)
                meta, body = _encode_tensor(_host_array(resp.hidden), self.wire_dtype)
                _send_frame(sock, {"verb": "hidden", "session_id": resp.session_id,
                                   "cache_len": 0, "tensor": meta}, body)
                return
            breq = BackwardRequest(
                session_id=header["session_id"], hidden=tensors[0], grad_output=tensors[1],
                seq_len=header["seq_len"], prompts=prompts, lora=lora,
                lora_scale=lora_scale, start_block=header.get("start_block"),
                end_block=header.get("end_block"))
            bresp = self._compute("backward", ex.backward, breq, size=breq.seq_len)
            arrs = [_host_array(bresp.grad_input)]
            if bresp.grad_prompts is not None:
                arrs.append(_host_array(bresp.grad_prompts))
            out = {"verb": "grads", "session_id": bresp.session_id}
            if bresp.grad_lora:
                gmanifest, garrs = lora_to_list(bresp.grad_lora)
                out["lora_manifest"] = gmanifest
                arrs += [_host_array(a) for a in garrs]
            metas, body = _encode_tensors(arrs, "f32")
            out["tensors"] = metas
            _send_frame(sock, out, body)
        except (StageExecutionError, TaskRejected) as exc:
            frame = {"verb": "error", "message": str(exc), "kind": "stage",
                     "peer": ex.peer_id}
            if isinstance(exc, TaskRejected) and exc.permanent:
                frame["task_rejected"] = True
            _send_frame(sock, frame)
        except TimeoutError:
            _send_frame(sock, {"verb": "error", "kind": "stage", "peer": ex.peer_id,
                               "message": f"stage compute timed out after "
                                          f"{COMPUTE_TIMEOUT_S:.0f}s"})

    def _reach_check(self, sock, header: dict) -> None:
        """"Can YOU dial this address?": peers answer for each other, so a
        booting server can learn whether its advertised address is
        reachable from outside."""
        target = header.get("target", "")
        ok = False
        try:
            host, port = target.rsplit(":", 1)
            with socket.create_connection((host, int(port)), timeout=3.0) as s:
                _send_frame(s, {"verb": "info"})
                hdr, _ = _recv_frame(s)
                # An error frame is still an answer: the probe is about
                # connectivity.
                ok = hdr.get("verb") in ("info", "error")
        except (ConnectionError, OSError, ValueError):
            ok = False
        _send_frame(sock, {"verb": "reach_check", "target": target,
                           "ok": ok})


# ---------------------------------------------------------------------------
# Client transport
# ---------------------------------------------------------------------------

class TcpTransport(Transport):
    """Client-side transport resolving peers via registry `address` fields.
    A peer whose record names a relay volunteer (``relay_via``) is dialed
    at the volunteer's address, on a connection of its own, and every
    frame to it is stamped ``relay_to``."""

    def __init__(self, registry, wire_dtype: str = "bf16",
                 model: Optional[str] = None):
        self.registry = registry
        # Echoed in every request: a peer holding another model refuses.
        self.model = model
        self.wire_dtype = wire_dtype
        # Plain prefill and decode ride persistent per-session streams.
        self._conns: Dict[str, socket.socket] = {}
        # (peer_id, session_id) -> {"snap", "sock", "window", "returns_tokens"}
        self._streams: Dict[Tuple[str, str], dict] = {}
        # peer_id -> its relay volunteer's peer_id (None: dialed directly),
        # refreshed by _addr at each dial.
        self._via_relay: Dict[str, Optional[str]] = {}
        self._lock = threading.Lock()
        # Chaos layer: client-side injection hook (set_fault_plan).
        self.fault_plan: Optional[FaultPlan] = None
        # peer_id -> its cached `info` reply (None: the probe failed; the
        # capability check then lets the call through).
        self._peer_caps: Dict[str, Optional[dict]] = {}
        # Byte counters cover tensor payloads, not frame overhead, as
        # LocalTransport's do.
        self._m_calls = _tm.get("transport_calls_total")
        self._m_sent = _tm.get("transport_bytes_sent_total")
        self._m_recv = _tm.get("transport_bytes_received_total")
        self._m_rtt = _tm.get("transport_rtt_seconds")

    def _tagged(self, hdr: dict) -> dict:
        """Stamp the client's model identity on an outgoing request header."""
        if self.model is not None:
            hdr["model"] = self.model
        return hdr

    def _addr(self, peer_id: str) -> Tuple[str, int]:
        rec = self.registry.get(peer_id)
        if rec is None or not rec.address:
            raise PeerUnavailable(f"no address for peer {peer_id}")
        addr = rec.address
        via = getattr(rec, "relay_via", None)
        if via:
            # A NAT'd peer's own address is unreachable: dial its volunteer.
            rrec = self.registry.get(via)
            if rrec is None or not rrec.address:
                raise PeerUnavailable(f"no address for relay {via} of peer {peer_id}")
            addr = rrec.address
        with self._lock:
            self._via_relay[peer_id] = via
        host, port = addr.rsplit(":", 1)
        return host, int(port)

    def _send(self, peer_id: str, sock, hdr: dict, body: bytes = b"") -> None:
        """Every request frame to `peer_id` goes through here: a relayed
        peer's is stamped ``relay_to``, whatever its verb."""
        with self._lock:
            via = self._via_relay.get(peer_id)
        if via:
            hdr["relay_to"] = peer_id
        _send_frame(sock, hdr, body)

    def _unavailable(self, peer_id: str, exc: Exception) -> PeerUnavailable:
        """A socket failure on `peer_id`'s connection. Through a relay the
        socket is the volunteer's: the breaker blames it
        (``breaker_peer_id``), the routing blame stays on the peer."""
        err = PeerUnavailable(f"peer {peer_id} connection failed: {exc}")
        with self._lock:
            via = self._via_relay.get(peer_id)
        if via:
            err.breaker_peer_id = via
        return err

    def _note_relay_failure(self, peer_id: str, request: StageRequest,
                            error: Exception) -> None:
        """The flight recorder's mark of a failed exchange with a peer
        reached through a volunteer (the doctor tells a relay loss by it)."""
        with self._lock:
            via = self._via_relay.get(peer_id)
        if via:
            verb = ("backward" if isinstance(request, BackwardRequest)
                    else "step" if self._streamable(request) else "forward")
            _ev.emit("relay_forward_error", session_id=request.session_id,
                     trace_id=_trace_id(request), relay=via, peer=peer_id, verb=verb,
                     error=str(error)[:200])

    def _connect(self, peer_id: str) -> socket.socket:
        with self._lock:
            sock = self._conns.get(peer_id)
        if sock is not None:
            return sock
        plan = self.fault_plan
        if plan is not None and plan.fire(
                "connect", SITE_KINDS["connect"], side="client",
                peer=peer_id) is not None:
            raise PeerUnavailable(
                f"cannot reach {peer_id}: connection refused (injected)")
        host, port = self._addr(peer_id)
        try:
            sock = socket.create_connection((host, port),
                                            timeout=CONNECT_TIMEOUT_S)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as exc:
            err = PeerUnavailable(f"cannot reach {peer_id} at {host}:{port}: {exc}")
            with self._lock:
                via = self._via_relay.get(peer_id)
            if via:
                # The volunteer's socket failed to open: it takes the
                # breaker's blame.
                err.breaker_peer_id = via
            raise err from exc
        if plan is not None:
            sock = FaultSocket(sock, plan, side="client", peer=peer_id)
        with self._lock:
            self._conns[peer_id] = sock
        return sock

    def _drop(self, peer_id: str) -> None:
        with self._lock:
            sock = self._conns.pop(peer_id, None)
            # Streams live on the dropped connection: the next step re-opens.
            for key in [k for k in self._streams if k[0] == peer_id]:
                del self._streams[key]
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def alive(self, peer_id: str) -> bool:
        """Liveness: an `info` round trip on a short deadline."""
        try:
            self.info(peer_id, timeout=3.0)
            return True
        except (PeerUnavailable, TimeoutError, ConnectionError, OSError):
            return False

    def ping(self, peer_id: str) -> Optional[float]:
        """Wire RTT: one `info` round trip on the pooled connection."""
        try:
            t0 = time.perf_counter()
            self.info(peer_id, timeout=3.0)
            rtt = time.perf_counter() - t0
            self._m_rtt.observe(rtt)
            return rtt
        except (PeerUnavailable, TimeoutError, ConnectionError, OSError):
            return None

    def _streamable(self, request: StageRequest) -> bool:
        """Plain prefill and decode ride the persistent stream; every other
        request shape (training and replay among them) the classic full
        frame."""
        return (not request.train and request.hypo_ids is None and request.num_logprobs == 0
                and request.draft_tokens is None and not request.is_replay
                and request.prompts is None and not request.burst_len)

    def _exchange(self, peer_id: str, request: StageRequest, sock, frames):
        """Send `frames` (header, body) on `sock`, read one reply; socket
        failures become the retryable taxonomy."""
        try:
            for hdr, body in frames:
                self._send(peer_id, sock, hdr, body)
                self._m_sent.inc(len(body))
            header, payload = _recv_frame(sock)
            self._m_recv.inc(len(payload))
            return header, payload
        except socket.timeout as exc:
            self._drop(peer_id)
            _ev.emit("transport_timeout", session_id=request.session_id,
                     trace_id=_trace_id(request), peer=peer_id)
            raise TimeoutError(f"peer {peer_id} timed out") from exc
        except (ConnectionError, OSError) as exc:
            self._drop(peer_id)
            self._note_relay_failure(peer_id, request, exc)
            _ev.emit("transport_error", session_id=request.session_id,
                     trace_id=_trace_id(request), peer=peer_id,
                     error=str(exc)[:200])
            raise self._unavailable(peer_id, exc) from exc

    def _connect_for(self, peer_id: str, request: StageRequest) -> socket.socket:
        try:
            return self._connect(peer_id)
        except PeerUnavailable as exc:
            self._note_relay_failure(peer_id, request, exc)
            raise

    def _capabilities(self, peer_id: str) -> Optional[dict]:
        """The peer's `info` reply (its capability flags: version, lora),
        asked once per peer. An unreachable peer or a failed probe caches
        None, and the capability check lets the call through: only a reply
        that lacks a capability blocks one."""
        with self._lock:
            if peer_id in self._peer_caps:
                return self._peer_caps[peer_id]
        try:
            caps: Optional[dict] = self.info(peer_id)
            if not isinstance(caps, dict) or caps.get("verb") != "info":
                caps = None
        except (PeerUnavailable, TimeoutError, ConnectionError, OSError):
            caps = None
        with self._lock:
            self._peer_caps[peer_id] = caps
        return caps

    def _train_frame(self, request: StageRequest) -> Tuple[dict, bytes]:
        """A ``train_forward`` frame: the activation at the session's wire
        dtype; the prompts and the adapters float32 (they are trained, and
        rounding them every step would round the tuning signal)."""
        arrs, wds = [_host_array(request.hidden)], [self.wire_dtype]
        if request.prompts is not None:
            arrs.append(_host_array(request.prompts))
            wds.append("f32")
        hdr = {"verb": "train_forward", "session_id": request.session_id,
               "seq_len": request.seq_len, "start_block": request.start_block,
               "end_block": request.end_block, "has_prompts": request.prompts is not None}
        if request.lora:
            manifest, lora_arrs = lora_to_list(request.lora)
            hdr["lora_manifest"] = manifest
            hdr["lora_scale"] = float(request.lora_scale)
            arrs += [_host_array(a) for a in lora_arrs]
            wds += ["f32"] * len(lora_arrs)
        metas, body = _encode_tensors(arrs, wds)
        hdr["tensors"] = metas
        return hdr, body

    def call(self, peer_id: str, request: StageRequest,
             timeout: Optional[float] = None) -> StageResponse:
        if request.train and request.lora:
            # A pre-LoRA server would take the adapters at the frame's tail
            # for prompts and train the base span: refuse before shipping,
            # with a stage error (retryable: the trainer fails over to a
            # replica that advertises the capability).
            caps = self._capabilities(peer_id)
            if caps is not None and not caps.get("lora"):
                exc = StageExecutionError(
                    f"peer {peer_id} (info version {caps.get('version', 0)}) does not "
                    "advertise LoRA support; upgrade that server or detach the "
                    "adapters for this span")
                exc.peer_id = peer_id
                raise exc
        if self._streamable(request):
            return self._call_stream(peer_id, request, timeout)
        sock = self._connect_for(peer_id, request)
        if self.fault_plan is not None and isinstance(sock, FaultSocket):
            sock.ctx_verb = "train_forward" if request.train else "forward"
            sock.ctx_session = request.session_id
        self._m_calls.labels(verb="train" if request.train else "forward").inc()
        sock.settimeout(timeout)
        if request.train:
            hdr, body = self._train_frame(request)
            header, payload = self._exchange(peer_id, request, sock,
                                             [(self._tagged(hdr), body)])
            return self._parse_response(peer_id, header, payload)
        if request.prompts is not None:
            # Deep prompts ride as a second payload tensor, kept float32.
            metas, body = _encode_tensors(
                [_host_array(request.hidden), _host_array(request.prompts)],
                [self.wire_dtype, "f32"])
            hdr = _request_header(request, metas[0], prompts_meta=metas[1])
        else:
            meta, body = _encode_tensor(_host_array(request.hidden),
                                        self.wire_dtype)
            hdr = _request_header(request, meta)
        # The server encodes its response at the client's precision.
        hdr["wire_dtype"] = self.wire_dtype
        header, payload = self._exchange(peer_id, request, sock,
                                         [(self._tagged(hdr), body)])
        return self._parse_response(peer_id, header, payload)

    def _call_stream(self, peer_id: str, request: StageRequest,
                     timeout: Optional[float] = None) -> StageResponse:
        """Persistent-stream path: session metadata ships once per (peer,
        connection) in `stream_open`; steps carry {cur_len, seq_len, seed}
        and the tensor. The transport mirrors the server's recent-token
        window and re-opens the stream when the client's window diverges
        (tokens sampled elsewhere during a failover)."""
        key = (peer_id, request.session_id)
        snap = (request.sampling.temperature, request.sampling.top_p,
                request.sampling.top_k, request.sampling.repetition_penalty,
                request.max_length, request.start_block, request.end_block,
                tuple(json.dumps(n, sort_keys=True)
                      for n in request.next_servers))
        sock = self._connect_for(peer_id, request)
        if self.fault_plan is not None and isinstance(sock, FaultSocket):
            sock.ctx_verb = "step"
            sock.ctx_session = request.session_id
        sock.settimeout(timeout)
        with self._lock:
            st = self._streams.get(key)
        if st is not None and st["snap"] == snap and st["sock"] is sock and (
                st["returns_tokens"]
                and st["window"] != list(request.generated_tokens)[-50:]):
            st = None   # the window drifted: re-open carrying it
        if st is None or st["snap"] != snap or st["sock"] is not sock:
            open_hdr = {
                "verb": "stream_open",
                "session_id": request.session_id,
                "max_length": request.max_length,
                "temperature": request.sampling.temperature,
                "top_p": request.sampling.top_p,
                "top_k": request.sampling.top_k,
                "repetition_penalty": request.sampling.repetition_penalty,
                "generated_tokens": list(request.generated_tokens),
                "start_block": request.start_block,
                "end_block": request.end_block,
                "next_servers": list(request.next_servers),
                # This client declares no step timeout or session deadline;
                # a reference client may, and the server enforces them.
                "step_timeout": None,
                "deadline_s": None,
                "wire_dtype": self.wire_dtype,
            }
            h, _ = self._exchange(peer_id, request, sock,
                                  [(self._tagged(open_hdr), b"")])
            if h.get("verb") != "ok":
                self._parse_response(peer_id, h, b"")  # raises
                raise WireError(f"bad stream_open reply {h.get('verb')!r}")
            st = {"snap": snap, "sock": sock,
                  "window": list(request.generated_tokens)[-50:],
                  "returns_tokens": None}
            with self._lock:
                self._streams[key] = st
        hdr = {
            "verb": "step",
            "session_id": request.session_id,
            "seq_len": request.seq_len,
            "cur_len": request.cur_len,
            "step_seed": request.step_seed,
        }
        if request.is_prefill:
            hdr["is_prefill"] = True
            if request.prefix_len:
                hdr["prefix_len"] = request.prefix_len
        if request.start_from_position is not None:
            hdr["start_from_position"] = request.start_from_position
        if request.trace is not None:
            hdr["trace"] = request.trace
        if request.deadline_budget_s is not None:
            hdr["deadline_budget_s"] = request.deadline_budget_s
        if request.priority is not None:
            hdr["priority"] = request.priority
        meta, body = _encode_tensor(_host_array(request.hidden), self.wire_dtype)
        hdr["tensor"] = meta
        self._m_calls.labels(verb="step").inc()
        header, payload = self._exchange(peer_id, request, sock, [(hdr, body)])
        try:
            resp = self._parse_response(peer_id, header, payload)
        except StageExecutionError:
            if header.get("stream_closed"):
                # The server no longer holds the stream: a desync is
                # repaired by one re-open and resend; a refusal propagates.
                with self._lock:
                    self._streams.pop(key, None)
                if header.get("reason") == "no_stream":
                    return self._call_stream(peer_id, request, timeout)
            raise
        if resp.token_id is not None:
            st["returns_tokens"] = True
            st["window"].append(int(resp.token_id))
            del st["window"][:-50]
        elif resp.hidden is not None and st["returns_tokens"] is None:
            st["returns_tokens"] = False
        return resp

    def _parse_response(self, peer_id: str, header: dict,
                        payload: bytes) -> StageResponse:
        verb = header.get("verb")
        span = header.get("span")
        if verb == "spec":
            return StageResponse(
                session_id=header["session_id"],
                tokens=tuple(header["tokens"]),
                n_accepted=header["n_accepted"],
                cache_len=header["cache_len"],
                span=span,
            )
        if verb == "beam":
            return StageResponse(
                session_id=header["session_id"],
                cache_len=header["cache_len"],
                top_tokens=tuple(tuple(r) for r in header["top_tokens"]),
                top_logprobs=tuple(tuple(r) for r in header["top_logprobs"]),
                span=span,
            )
        if verb == "burst":
            return StageResponse(
                session_id=header["session_id"],
                burst_tokens=tuple(header["tokens"]),
                burst_stop=header.get("stop"),
                cache_len=header["cache_len"],
                span=span,
            )
        if verb == "token":
            ids = header.get("token_ids")
            return StageResponse(
                session_id=header["session_id"],
                token_id=header["token_id"],
                token_ids=None if ids is None else tuple(ids),
                cache_len=header["cache_len"],
                span=span,
            )
        if verb == "hidden":
            return StageResponse(
                session_id=header["session_id"],
                hidden=_to_tensor(_decode_tensor(header["tensor"], payload)),
                cache_len=header["cache_len"],
                span=span,
            )
        if verb == "error":
            # Wire markers -> typed exceptions through the one catalog.
            raise _errors.from_wire(header, peer_id)
        raise WireError(f"unexpected response verb {verb!r}")

    def backward(self, peer_id: str, request: BackwardRequest,
                 timeout: Optional[float] = None) -> BackwardResponse:
        """The training backward over the classic frame, every tensor
        float32: bf16 gradients would lose mantissa at every hop."""
        sock = self._connect_for(peer_id, request)
        if self.fault_plan is not None and isinstance(sock, FaultSocket):
            sock.ctx_verb = "backward"
            sock.ctx_session = request.session_id
        self._m_calls.labels(verb="backward").inc()
        sock.settimeout(timeout)
        arrs = [_host_array(request.hidden), _host_array(request.grad_output)]
        if request.prompts is not None:
            arrs.append(_host_array(request.prompts))
        hdr = {"verb": "backward", "session_id": request.session_id,
               "seq_len": request.seq_len, "start_block": request.start_block,
               "end_block": request.end_block, "has_prompts": request.prompts is not None}
        if request.lora:
            manifest, lora_arrs = lora_to_list(request.lora)
            hdr["lora_manifest"] = manifest
            hdr["lora_scale"] = float(request.lora_scale)
            arrs += [_host_array(a) for a in lora_arrs]
        metas, body = _encode_tensors(arrs, "f32")
        hdr["tensors"] = metas
        header, payload = self._exchange(peer_id, request, sock, [(self._tagged(hdr), body)])
        if header.get("verb") == "grads":
            tensors = [_to_tensor(a) for a in _decode_tensors(header["tensors"], payload)]
            n_lora = len(header.get("lora_manifest", ()))
            grad_lora = None
            if n_lora:
                grad_lora = lora_from_list(header["lora_manifest"], tensors[-n_lora:])
                tensors = tensors[:-n_lora]
            return BackwardResponse(session_id=header["session_id"], grad_input=tensors[0],
                                    grad_prompts=tensors[1] if len(tensors) > 1 else None,
                                    grad_lora=grad_lora)
        if header.get("verb") == "error":
            raise _errors.from_wire(header, peer_id)
        raise WireError(f"unexpected response verb {header.get('verb')!r}")

    def _rpc(self, peer_id: str, header: dict, timeout: float) -> dict:
        """One request/response on the pooled connection; a socket failure
        drops it and raises PeerUnavailable."""
        sock = self._connect(peer_id)
        try:
            sock.settimeout(timeout)
            self._send(peer_id, sock, header)
            h, _ = _recv_frame(sock)
            return h
        except (ConnectionError, OSError) as exc:
            self._drop(peer_id)
            raise PeerUnavailable(f"peer {peer_id}: {exc}") from exc

    def end_session(self, peer_id: str, session_id: str) -> None:
        with self._lock:
            self._streams.pop((peer_id, session_id), None)
        try:
            self._rpc(peer_id, {"verb": "end_session", "session_id": session_id},
                      CONNECT_TIMEOUT_S)
        except PeerUnavailable:
            pass

    def info(self, peer_id: str, timeout: float = 5.0) -> dict:
        return self._rpc(peer_id, {"verb": "info"}, timeout)

    def _expect(self, peer_id: str, header: dict, verb: str,
                timeout: float) -> dict:
        h = self._rpc(peer_id, header, timeout)
        if h.get("verb") != verb:
            raise WireError(f"unexpected response verb {h.get('verb')!r}")
        return h

    def metrics_text(self, peer_id: str, timeout: float = 5.0) -> str:
        """Prometheus text of a peer's process registry (empty when the peer
        runs with telemetry off)."""
        return self._expect(peer_id, {"verb": "metrics"}, "metrics",
                            timeout).get("text", "")

    def events_text(self, peer_id: str, timeout: float = 5.0) -> str:
        """A peer's flight-recorder ring as JSONL (the ``dump-events``
        verb)."""
        return self._expect(peer_id, {"verb": "dump-events"}, "events",
                            timeout).get("lines", "")

    def swarm_stats(self, peer_id: str, timeout: float = 5.0) -> dict:
        """A peer's swarm view (the ``swarm-stats`` verb): its own stats
        digest under ``"self"`` and every live record of its mirror under
        ``"records"``."""
        return self._expect(peer_id, {"verb": "swarm-stats"}, "swarm-stats", timeout)

    def reach_check(self, peer_id: str, target: str,
                    timeout: float = 8.0) -> bool:
        """Ask `peer_id` whether IT can dial `target` ("host:port")."""
        return bool(self._rpc(peer_id, {"verb": "reach_check", "target": target},
                              timeout).get("ok"))

    def relay_attach(self, peer_id: str, my_peer_id: str, my_address: str,
                     timeout: float = 5.0) -> dict:
        """Ask volunteer `peer_id` to open (or renew: the verb is an
        idempotent lease) a circuit to `my_peer_id` at `my_address`, an
        address the volunteer can dial. Raises PeerUnavailable when it
        sheds (saturated) or is gone, so the picker tries the next one."""
        h = self._rpc(peer_id, {"verb": "relay_attach", "peer_id": my_peer_id,
                                "address": my_address}, timeout)
        if h.get("verb") != "ok":
            raise PeerUnavailable(f"relay {peer_id} refused attach: {h.get('message')}")
        return h

    # -- chaos layer (runtime.faults) -----------------------------------

    def set_fault_plan(self, plan: Optional[FaultPlan]) -> None:
        """Arm (or with None, clear) a FaultPlan on this transport's own
        dial and send path; pooled connections are dropped so the wrapping
        always matches the armed state."""
        self.close()
        self.fault_plan = plan

    def _fault_rpc(self, peer_id: str, header: dict,
                   timeout: float = 5.0) -> dict:
        h = self._rpc(peer_id, header, timeout)
        if h.get("verb") == "error":
            raise RuntimeError(f"peer {peer_id}: {h.get('message')}")
        return h

    def install_fault_plan(self, peer_id: str,
                           plan: Optional[FaultPlan]) -> dict:
        """Install (or with None, clear) a FaultPlan on a remote peer; it
        refuses unless started with --allow_fault_injection."""
        if plan is None:
            return self._fault_rpc(peer_id,
                                   {"verb": "fault", "action": "clear"})
        return self._fault_rpc(peer_id,
                               {"verb": "fault", "plan": plan.to_dict()})

    def fault_report(self, peer_id: str) -> list:
        """The remote peer's fault-firing log, in order."""
        return self._fault_rpc(
            peer_id, {"verb": "fault", "action": "report"}).get("firings", [])

    def close(self) -> None:
        with self._lock:
            conns, self._conns = dict(self._conns), {}
            self._streams.clear()
        for sock in conns.values():
            try:
                sock.close()
            except OSError:
                pass


def check_direct_reachability(transport: TcpTransport, registry,
                              my_address: str, max_peers: int = 5,
                              threshold: float = 0.5) -> Optional[bool]:
    """The dial-back vote: am I reachable at `my_address`? Up to
    `max_peers` live peers are asked to dial it; at least `threshold` of
    the answers saying yes means direct. None when no peer answered (a
    server alone in its swarm cannot tell)."""
    votes = []
    for rec in registry.live_servers():
        if len(votes) >= max_peers:
            break
        if not getattr(rec, "address", None) or rec.address == my_address:
            continue
        try:
            votes.append(transport.reach_check(rec.peer_id, my_address))
        except (PeerUnavailable, TimeoutError, ConnectionError, OSError):
            continue
    if not votes:
        return None
    return sum(votes) / len(votes) >= threshold


def attach_via_relay(transport: TcpTransport, registry, my_peer_id: str,
                     my_address: str, exclude=()) -> Optional[dict]:
    """Attach to a relay volunteer after a failed vote. Candidates: live
    peers that advertise relay capacity and are not relayed themselves,
    the most capacity first; a saturated one sheds and the next is tried.
    Returns the volunteer's ok frame with ``"relay"`` its peer_id, or None
    when nobody takes the attach."""
    skip = set(exclude) | {my_peer_id}
    cands = [r for r in registry.live_servers()
             if r.peer_id not in skip and getattr(r, "address", None)
             and (getattr(r, "relay_capacity", None) or 0) > 0
             and not getattr(r, "relay_via", None)]
    cands.sort(key=lambda r: -(r.relay_capacity or 0))
    for rec in cands:
        try:
            ok = transport.relay_attach(rec.peer_id, my_peer_id, my_address)
        except (PeerUnavailable, TimeoutError, ConnectionError, OSError, WireError):
            continue
        ok["relay"] = rec.peer_id
        return ok
    return None


def gossip_exchange(node: GossipNode, address: str,
                    timeout: float = 5.0) -> Tuple[int, int]:
    """One digest-then-delta anti-entropy round with the stage server at
    `address` (the initiator's side; `TcpStageServer._gossip_dispatch` is
    the responder's): ship our digest and merge the entries the peer
    answers with, then ship the entries its digest lacks. Returns
    (entries sent, entries merged). Connection errors propagate: the
    gossip loop takes a dead peer as one lost round."""
    host, port = address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.settimeout(timeout)
        _send_frame(sock, {"verb": "gossip", "peer_id": node.peer_id,
                           "digest": node.digest()})
        resp, _ = _recv_frame(sock)
        if resp.get("verb") != "gossip":
            raise ConnectionError(f"peer at {address} does not gossip: "
                                  f"{resp.get('message', resp.get('verb'))!r}")
        merged = node.merge(resp.get("entries") or ())
        delta = node.delta_for(resp.get("digest") or {})
        if delta:
            _send_frame(sock, {"verb": "gossip", "peer_id": node.peer_id,
                               "entries": delta})
            _recv_frame(sock)      # the ack: {"verb": "gossip", "merged": n}
        _tm.get("gossip_rounds_total").labels(role="initiator").inc()
        _ev.emit("gossip_round", peer=address, sent=len(delta), merged=merged)
        return len(delta), merged
    finally:
        try:
            sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Registry service (control plane)
# ---------------------------------------------------------------------------

class RegistryServer(_FramedTcpServer):
    """JSON-over-TCP registry service backed by a PlacementRegistry."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ttl: float = 45.0, allow_fault_injection: bool = False):
        self.registry = PlacementRegistry(ttl=ttl)
        super().__init__(host, port)
        self.fault_side = "registry"
        self.allow_fault_injection = allow_fault_injection

    def _dispatch(self, sock, header: dict, payload: bytes) -> None:
        del payload
        plan = self.fault_plan
        if plan is not None:
            # duplicate: process the verb twice, reply once (the verbs are
            # idempotent); stale_registry: age every record first.
            rule = plan.fire("registry", SITE_KINDS["registry"],
                             side="registry", verb=header.get("verb"))
            if rule is not None:
                if rule.kind == "duplicate":
                    self._handle_verb(header)
                else:
                    self.registry.age_records(rule.age_s)
        _send_frame(sock, self._handle_verb(header))

    def _handle_verb(self, h: dict) -> dict:
        verb = h.get("verb")
        if verb == "fault":
            return self._fault_admin(h)
        if verb == "register":
            self.registry.register(dict_to_rec(h["record"]))
            # The TTL rides every write response: peers pace their
            # heartbeats off the registry's real expiry.
            return {"verb": "ok", "ttl": self.registry.ttl}
        if verb == "heartbeat":
            ok = self.registry.heartbeat(
                h["peer_id"], throughput=h.get("throughput"),
                cache_tokens_left=h.get("cache_tokens_left"),
                next_server_rtts=h.get("next_server_rtts"))
            return {"verb": "ok", "known": ok, "ttl": self.registry.ttl}
        if verb == "unregister":
            self.registry.unregister(h["peer_id"])
            return {"verb": "ok"}
        if verb == "list":
            # age_s, not the monotonic timestamp: clocks differ across hosts.
            now = time.monotonic()
            return {"verb": "records", "ttl": self.registry.ttl,
                    "records": [dict(rec_to_dict(r),
                                     age_s=max(0.0, now - r.timestamp))
                                for r in self.registry.live_servers()]}
        return {"verb": "error", "message": f"unknown verb {verb!r}"}


class RemoteRegistry:
    """Client for RegistryServer with the PlacementRegistry query surface.

    Queries fetch the live-record list and evaluate it locally. ``address``
    may be a comma-separated list of registries (a primary and standbys,
    each an independent ``--mode registry`` process):

      * writes (register / heartbeat / unregister) go to every address and
        succeed if any registry took them; a registration made while every
        registry is down is buffered and flushed on the next success;
      * reads (list) try the addresses from the last good one; when all are
        down, a stage server's gossip mirror answers ``list`` (every
        ``--mode serve`` process of either package embeds one), and failing
        that the last snapshot serves under its records' TTL (stale-cache
        grace).

    ``peers_cache`` persists the snapshot's server addresses to a file, so
    a fresh process has bootstrap candidates with every registry down."""

    def __init__(self, address: str, timeout: float = 5.0,
                 peers_cache: Optional[str] = None):
        self._addrs = []
        for part in str(address).split(","):
            part = part.strip()
            if not part:
                continue
            host, port = part.rsplit(":", 1)
            self._addrs.append((host, int(port)))
        if not self._addrs:
            raise ValueError(f"no registry address in {address!r}")
        self.timeout = timeout
        self._socks: List[Optional[socket.socket]] = [None] * len(self._addrs)
        self._read_idx = 0          # last-good registry for reads
        # A registry that failed is skipped for this long (except as a last
        # resort), so a dead standby does not cost a connect timeout per write.
        self.down_backoff_s = 4 * timeout
        self._down_until = [0.0] * len(self._addrs)
        self._lock = threading.Lock()
        self._local = PlacementRegistry(rng=random.Random(0))
        self._have_snapshot = False
        self._stale_since: Optional[float] = None
        self._seeds_down_since: Optional[float] = None
        self.ttl = self._local.ttl
        self.peers_cache = peers_cache
        self._cached_peer_addrs: List[str] = self._load_peers_cache()
        self._pending_register: Dict[str, dict] = {}

    def _rpc_one_locked(self, i: int, header: dict) -> dict:
        """One exchange with registry i (caller holds the lock). A failure
        on a reused connection retries once on a fresh one: a restarted
        registry leaves the old socket half-open."""
        for attempt in (0, 1):
            fresh = self._socks[i] is None
            try:
                if fresh:
                    self._socks[i] = socket.create_connection(
                        self._addrs[i], timeout=self.timeout)
                _send_frame(self._socks[i], header)
                resp, _ = _recv_frame(self._socks[i])
                self._down_until[i] = 0.0
                if self._pending_register and header.get("verb") != "register":
                    self._flush_pending_locked(i)
                return resp
            except (ConnectionError, OSError):
                if self._socks[i] is not None:
                    try:
                        self._socks[i].close()
                    finally:
                        self._socks[i] = None
                if fresh or attempt:
                    self._down_until[i] = time.monotonic() + self.down_backoff_s
                    raise
        raise AssertionError("unreachable")

    def _flush_pending_locked(self, i: int) -> None:
        """Replay buffered registrations into registry `i`; a failure leaves
        the rest buffered."""
        for peer in list(self._pending_register):
            rec = self._pending_register[peer]
            try:
                _send_frame(self._socks[i], {"verb": "register",
                                             "record": rec})
                resp, _ = _recv_frame(self._socks[i])
            except (ConnectionError, OSError):
                return
            self._pending_register.pop(peer, None)
            self._sync_ttl(resp)
            logger.info("flushed buffered registration of %s to %s:%d",
                        peer, *self._addrs[i])

    def _up_order(self, start: int = 0) -> List[int]:
        """Registry indices rotated from `start`, backed-off ones last."""
        now = time.monotonic()
        idxs = [(start + k) % len(self._addrs)
                for k in range(len(self._addrs))]
        return ([i for i in idxs if self._down_until[i] <= now]
                + [i for i in idxs if self._down_until[i] > now])

    def _rpc(self, header: dict) -> dict:
        """Read path: the first registry that answers."""
        with self._lock:
            last_exc: Optional[Exception] = None
            for i in self._up_order(self._read_idx):
                try:
                    resp = self._rpc_one_locked(i, header)
                    self._read_idx = i
                    return resp
                except (ConnectionError, OSError) as exc:
                    last_exc = exc
            raise last_exc  # type: ignore[misc]

    def _rpc_all(self, header: dict) -> List[dict]:
        """Write path: every registry not backed off; those only when
        nothing else answered."""
        with self._lock:
            now = time.monotonic()
            resps, last_exc = [], None
            skipped = []
            for i in range(len(self._addrs)):
                if self._down_until[i] > now:
                    skipped.append(i)
                    continue
                try:
                    resps.append(self._rpc_one_locked(i, header))
                except (ConnectionError, OSError) as exc:
                    last_exc = exc
            if not resps:
                for i in skipped:
                    try:
                        resps.append(self._rpc_one_locked(i, header))
                    except (ConnectionError, OSError) as exc:
                        last_exc = exc
            if not resps:
                raise last_exc  # type: ignore[misc]
            return resps

    # -- write path ---------------------------------------------------------

    def _sync_ttl(self, resp: dict) -> None:
        if resp.get("ttl"):
            self.ttl = float(resp["ttl"])

    def register(self, record: ServerRecord, ttl: Optional[float] = None) -> None:
        del ttl  # server-side TTL policy
        rec = rec_to_dict(record)
        try:
            resps = self._rpc_all({"verb": "register", "record": rec})
        except (ConnectionError, OSError):
            with self._lock:
                self._pending_register[record.peer_id] = rec
            logger.warning(
                "register(%s): every registry unreachable; buffered for "
                "flush on reconnect", record.peer_id)
            return
        with self._lock:
            self._pending_register.pop(record.peer_id, None)
        for resp in resps:
            self._sync_ttl(resp)

    def heartbeat(self, peer_id: str, throughput: Optional[float] = None,
                  cache_tokens_left: Optional[int] = None,
                  next_server_rtts: Optional[Dict[str, float]] = None) -> bool:
        resps = self._rpc_all({"verb": "heartbeat", "peer_id": peer_id,
                               "throughput": throughput,
                               "cache_tokens_left": cache_tokens_left,
                               "next_server_rtts": next_server_rtts})
        for resp in resps:
            self._sync_ttl(resp)
        # known = AND over the registries that answered: one that forgot us
        # makes the caller re-register everywhere.
        return all(bool(r.get("known")) for r in resps)

    def unregister(self, peer_id: str) -> None:
        self._rpc_all({"verb": "unregister", "peer_id": peer_id})

    # -- read path (local evaluation over fetched records) ------------------

    def _refresh(self) -> None:
        source = "seed"
        try:
            resp = self._rpc({"verb": "list"})
        except (ConnectionError, OSError):
            if self._seeds_down_since is None:
                self._seeds_down_since = time.monotonic()
                _ev.emit("registry_unreachable", registries=len(self._addrs))
                logger.warning(
                    "all %d registry seed%s unreachable",
                    len(self._addrs),
                    " is" if len(self._addrs) == 1 else "s are")
            resp = self._fallback_list()
            source = "mirror"
            if resp is None:
                if not self._have_snapshot:
                    raise
                # Stale-cache grace: the last snapshot ages out through
                # the normal TTL.
                _tm.get("client_registry_stale_reads_total").inc()
                if self._stale_since is None:
                    self._stale_since = time.monotonic()
                    _ev.emit("registry_stale_serve",
                             registries=len(self._addrs))
                    logger.warning(
                        "no registry and no live stage server reachable; "
                        "serving the cached record snapshot under TTL "
                        "grace")
                return
        now = time.monotonic()
        if source == "seed":
            if self._seeds_down_since is not None:
                _ev.emit("registry_recovered", source="seed",
                         stale_s=round(now - self._seeds_down_since, 3))
                logger.info("registry seeds reachable again")
            self._seeds_down_since = None
        elif self._stale_since is not None:
            _ev.emit("registry_recovered", source="mirror",
                     stale_s=round(now - self._stale_since, 3))
        self._stale_since = None
        self._sync_ttl(resp)
        # The snapshot's records expire on the registry's TTL.
        fresh = PlacementRegistry(ttl=self.ttl, rng=random.Random(0))
        now = time.monotonic()
        for d in resp.get("records", []):
            rec = dict_to_rec(d)
            fresh.register(rec)
            # Freshness from the reported age (register() stamps "now").
            rec.timestamp = now - float(d.get("age_s") or 0.0)
            rec.expires_at = rec.timestamp + fresh.ttl
        self._local = fresh
        self._have_snapshot = True
        self._save_peers_cache()

    def _fallback_list(self) -> Optional[dict]:
        """`list` answered by a live stage server, over the snapshot's
        addresses and then the peers cache; None when nobody answered."""
        for addr in self._fallback_candidates():
            try:
                host, port = addr.rsplit(":", 1)
                sock = socket.create_connection((host, int(port)),
                                                timeout=self.timeout)
                try:
                    sock.settimeout(self.timeout)
                    _send_frame(sock, {"verb": "list"})
                    resp, _ = _recv_frame(sock)
                finally:
                    sock.close()
            except (ConnectionError, OSError, ValueError):
                continue
            if resp.get("verb") != "records":
                continue   # a server without a mirror answers an error frame
            _tm.get("client_registry_fallback_reads_total").inc()
            _ev.emit("gossip_fallback", address=addr,
                     records=len(resp.get("records") or ()))
            logger.warning(
                "registry reads served by stage server %s (gossip mirror)",
                addr)
            return resp
        return None

    def _fallback_candidates(self) -> List[str]:
        seeds = {"%s:%d" % a for a in self._addrs}
        seen, out = set(seeds), []
        for r in self._local.live_servers():
            a = getattr(r, "address", None)
            if a and a not in seen:
                seen.add(a)
                out.append(a)
        for a in self._cached_peer_addrs:
            if a and a not in seen:
                seen.add(a)
                out.append(a)
        return out

    def _load_peers_cache(self) -> List[str]:
        if not self.peers_cache:
            return []
        try:
            with open(self.peers_cache, "r", encoding="utf-8") as fh:
                data = json.load(fh)
            return [str(a) for a in data.get("addresses", [])]
        except (OSError, ValueError):
            return []

    def _save_peers_cache(self) -> None:
        """Persist the snapshot's server addresses (atomic rename)."""
        addrs = []
        for r in self._local.live_servers():
            a = getattr(r, "address", None)
            if a and a not in addrs:
                addrs.append(a)
        self._cached_peer_addrs = addrs
        if not self.peers_cache or not addrs:
            return
        try:
            tmp = f"{self.peers_cache}.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"addresses": addrs, "saved_wall": time.time()}, fh)
            os.replace(tmp, self.peers_cache)
        except OSError:
            logger.debug("could not write peers cache %s", self.peers_cache,
                         exc_info=True)

    def stale_info(self) -> dict:
        """The current outage windows: since every seed stopped answering,
        and since reads fell back to the stale snapshot (0 = healthy)."""
        now = time.monotonic()
        sd, st = self._seeds_down_since, self._stale_since
        return {"seeds_down": sd is not None,
                "seeds_down_s": 0.0 if sd is None else now - sd,
                "stale": st is not None,
                "stale_s": 0.0 if st is None else now - st}

    def live_servers(self, model=None):
        self._refresh()
        return self._local.live_servers(model=model)

    def get(self, peer_id: str):
        self._refresh()
        return self._local.get(peer_id)

    def discover_stage(self, stage_index: int, exclude=(), model=None,
                       prefer_engine=None, avoid_engine=None,
                       min_context=None, affinity=None):
        self._refresh()
        return self._local.discover_stage(stage_index, exclude, model=model,
                                          prefer_engine=prefer_engine,
                                          avoid_engine=avoid_engine,
                                          min_context=min_context,
                                          affinity=affinity)

    def discover_block(self, block: int, exclude=(), model=None):
        self._refresh()
        return self._local.discover_block(block, exclude, model=model)
