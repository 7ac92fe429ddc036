"""The gateway: many tenants in, one fairly-scheduled swarm out.

``GatewayServer`` is the framed-TCP front door (verb ``submit``). Handler
threads do the cheap work — admission, enqueue, streaming frames back —
while ONE scheduler thread owns every ``PipelineClient`` and interleaves
all active generations a single pipeline step at a time
(``PipelineClient.generate_stepwise``). That single-threaded core is
load-bearing twice over:

  * fairness is enforced where the cost is paid — deficit-round-robin
    picks which SESSION runs the next decode step, so served TOKENS (not
    admitted requests) track the configured weights;
  * determinism survives — a session's per-step sampling seed is purely
    session-local, so interleaving decode steps across sessions cannot
    change any session's tokens versus running it alone.

Tokens stream back per step: the scheduler drops them into a per-request
queue and the handler thread (the only writer on its socket) relays them
as ``token`` frames, ending with ``submit_done`` or a typed error frame
(``overloaded: true`` + ``retry_after_s`` for admission refusals).
"""

from __future__ import annotations

import logging
import queue as _queue
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..ops.sampling import SamplingParams
from ..runtime.net import _FramedTcpServer, _recv_frame, _send_frame
from ..runtime.transport import DeadlineExceeded
from ..telemetry import catalog as _tm
from ..telemetry import events as _ev
from ..telemetry import exposition as _texp
from ..telemetry import get_registry as _get_metrics_registry
from ..telemetry.profiling import get_profiler as _get_profiler
from .admission import AdmissionController, Overloaded, TenantConfig
from .fair_queue import DeficitRoundRobin, FairQueue

logger = logging.getLogger(__name__)


class SloTracker:
    """Rolling-window SLO burn rates per tenant and objective.

    Tenants declare latency objectives in their config (``slo_ttft_s``,
    ``slo_token_s``, met by at least ``slo_target`` of observations). Each
    observation lands in a rolling window as good or bad; the burn rate is

        (bad fraction over the window) / (1 - slo_target)

    — the Tail-at-Scale/SRE convention: 1.0 consumes the error budget at
    exactly the sustainable rate, >1.0 is on course to violate the SLO, and
    a 100%-bad window with a 99% target burns at 100x. Rates surface as the
    ``gateway_slo_burn_rate`` gauge, the gateway ``info`` verb (--mode top),
    and the doctor. Clock injectable so tests pin the window."""

    def __init__(self, tenants: Dict[str, TenantConfig],
                 window_s: float = 300.0, now=time.monotonic):
        self.tenants = tenants
        self.window_s = float(window_s)
        self._now = now
        self._lock = threading.Lock()
        # {(tenant, objective): deque[(stamp, bad)]}
        self._obs: Dict[tuple, deque] = {}

    def _limit(self, tenant: str, objective: str) -> Optional[float]:
        cfg = self.tenants.get(tenant)
        if cfg is None:
            return None
        return cfg.slo_ttft_s if objective == "ttft" else cfg.slo_token_s

    def observe(self, tenant: str, objective: str, seconds: float) -> None:
        """Record one latency observation against the tenant's declared
        objective (no-op for tenants without one)."""
        limit = self._limit(tenant, objective)
        if limit is None:
            return
        bad = seconds > limit
        if bad:
            name = ("gateway_slo_ttft_violations_total" if objective == "ttft"
                    else "gateway_slo_token_violations_total")
            _tm.get(name).labels(tenant=tenant).inc()
        now = self._now()
        with self._lock:
            dq = self._obs.setdefault((tenant, objective), deque())
            dq.append((now, bad))
            self._prune_locked(dq, now)
        _tm.get("gateway_slo_burn_rate").labels(
            tenant=tenant, objective=objective).set(
                self.burn_rate(tenant, objective))

    def _prune_locked(self, dq: deque, now: float) -> None:
        horizon = now - self.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def burn_rate(self, tenant: str, objective: str) -> float:
        """Error-budget burn rate over the rolling window (0.0 with no
        observations or no declared objective)."""
        cfg = self.tenants.get(tenant)
        if cfg is None or self._limit(tenant, objective) is None:
            return 0.0
        now = self._now()
        with self._lock:
            dq = self._obs.get((tenant, objective))
            if not dq:
                return 0.0
            self._prune_locked(dq, now)
            total = len(dq)
            bad = sum(1 for _, b in dq if b)
        if total == 0:
            return 0.0
        return (bad / total) / max(1e-9, 1.0 - cfg.slo_target)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{tenant: {objective: burn_rate}} for every declared objective —
        the shape the gateway ``info`` verb ships to ``--mode top``."""
        out: Dict[str, Dict[str, float]] = {}
        for tenant, cfg in self.tenants.items():
            objs = {}
            if cfg.slo_ttft_s is not None:
                objs["ttft"] = round(self.burn_rate(tenant, "ttft"), 3)
            if cfg.slo_token_s is not None:
                objs["token"] = round(self.burn_rate(tenant, "token"), 3)
            if objs:
                out[tenant] = objs
        return out


class _GatewayRequest:
    """One admitted submit: queued payload + the handler's stream sink."""

    __slots__ = ("tenant", "session_id", "prompt_ids", "max_new_tokens",
                 "sampling", "eos_token_id", "deadline_at", "admitted_at",
                 "sink")

    def __init__(self, tenant: str, session_id: str,
                 prompt_ids: Sequence[int], max_new_tokens: int,
                 sampling: SamplingParams, eos_token_id: Optional[int],
                 deadline_at: Optional[float], admitted_at: float):
        self.tenant = tenant
        self.session_id = session_id
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.deadline_at = deadline_at
        self.admitted_at = admitted_at
        # ("token", id) | ("done", GenerationResult, queue_wait_s)
        # | ("error", exc) — handler thread drains, scheduler fills.
        self.sink: _queue.Queue = _queue.Queue()


class _ActiveSession:
    """A generation the scheduler is currently stepping."""

    __slots__ = ("req", "stepper", "queue_wait_s", "first_token_at",
                 "tokens")

    def __init__(self, req: _GatewayRequest, stepper, queue_wait_s: float):
        self.req = req
        self.stepper = stepper
        self.queue_wait_s = queue_wait_s
        self.first_token_at: Optional[float] = None
        self.tokens = 0


class GatewayServer(_FramedTcpServer):
    """Multi-tenant serving gateway over one or more PipelineClients.

    ``clients`` all drive the same swarm/model; sessions are bound to a
    client round-robin at start (a client's stage0 KV is per-session, so
    a session must stay on its client). ``start_paused=True`` holds the
    scheduler until ``resume()`` — soak tests preload the queue so every
    tenant is contending from the very first step."""

    def __init__(self, clients: List, tenants: Dict[str, TenantConfig],
                 host: str = "127.0.0.1", port: int = 0, *,
                 max_queue_depth: int = 64, max_active: int = 8,
                 start_paused: bool = False,
                 allow_fault_injection: bool = False,
                 burst: int = 0):
        if not clients:
            raise ValueError("gateway needs at least one PipelineClient")
        self.clients = list(clients)
        # burst > 0: sessions decode in N-tick bursts (one jitted dispatch
        # per scheduler pick — PipelineClient burst mode). Fairness,
        # deadlines, and shedding then operate at BURST granularity: a DRR
        # pick is charged the burst's token count (fair_queue.charge), the
        # deadline budget is re-stamped per burst, and sessions join/leave
        # the decode set only between bursts.
        self.burst = int(burst)
        self.tenants = dict(tenants)
        weights = {name: cfg.weight for name, cfg in tenants.items()}
        self.admission = AdmissionController(tenants,
                                             max_queue_depth=max_queue_depth)
        self.queue = FairQueue(weights)
        self.max_active = int(max_active)
        # Which SESSION decodes next: DRR over tenants of active sessions
        # (cost: one pipeline step ~= one token), round-robin within.
        self._step_drr = DeficitRoundRobin(weights)
        self._tenant_rr: Dict[str, deque] = {t: deque() for t in tenants}
        self._sessions: Dict[str, _ActiveSession] = {}
        self._next_client = 0
        self._sessions_started = 0
        # Audit trail for fairness assertions: the tenant of each served
        # token, in service order (bounded; soaks read a prefix).
        self.step_log: deque = deque(maxlen=4096)
        self.slo = SloTracker(self.tenants)
        self._paused = threading.Event()
        if not start_paused:
            self._paused.set()
        self._stopping = threading.Event()
        self._scheduler: Optional[threading.Thread] = None
        super().__init__(host, port)
        self.allow_fault_injection = allow_fault_injection

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._scheduler = threading.Thread(
            target=self._schedule_loop, daemon=True, name="gateway-sched")
        self._scheduler.start()

    def resume(self) -> None:
        """Release a gateway started with ``start_paused=True``."""
        self._paused.set()

    def stop(self) -> None:
        self._stopping.set()
        self._paused.set()  # a paused scheduler must still observe the stop
        sched = self._scheduler
        if sched is not None:
            sched.join(timeout=10.0)
        # Fail whatever is still queued or mid-generation: waiters must not
        # hang for their full client timeout on a gateway shutdown.
        for tenant, req in self.queue.drain():
            self.admission.release(tenant)
            req.sink.put(("error",
                          ConnectionError("gateway shutting down")))
        for sess in list(self._sessions.values()):
            try:
                sess.stepper.close()  # releases the session's KV/journal
            except Exception:
                pass
            self.admission.release(sess.req.tenant)
            sess.req.sink.put(("error",
                               ConnectionError("gateway shutting down")))
        self._sessions.clear()
        super().stop()

    # -- scheduler core -----------------------------------------------------

    def _start_session(self, tenant: str, req: _GatewayRequest) -> None:
        client = self.clients[self._next_client % len(self.clients)]
        self._next_client += 1
        self._sessions_started += 1
        queue_wait = time.monotonic() - req.admitted_at
        _tm.get("gateway_queue_wait_seconds").labels(
            tenant=tenant).observe(queue_wait)
        _get_profiler().observe("gateway_queue", queue_wait)
        cfg = self.tenants[tenant]
        stepper = client.generate_stepwise(
            req.prompt_ids, req.max_new_tokens, sampling=req.sampling,
            eos_token_id=req.eos_token_id, session_id=req.session_id,
            deadline_at=req.deadline_at,
            # Lower = more urgent server-side: a tenant with 4x the weight
            # gets 1/4 the queue-priority value on contended stage pools.
            priority=1.0 / cfg.weight,
            burst=self.burst,
        )
        sess = _ActiveSession(req, stepper, queue_wait)
        self._sessions[req.session_id] = sess
        self._tenant_rr[tenant].append(req.session_id)
        _tm.get("gateway_active_sessions").set(len(self._sessions))
        _tm.get("gateway_queue_depth").set(self.queue.depth())

    def _finish_session(self, sess: _ActiveSession, outcome: str,
                        payload) -> None:
        sid = sess.req.session_id
        tenant = sess.req.tenant
        self._sessions.pop(sid, None)
        try:
            self._tenant_rr[tenant].remove(sid)
        except ValueError:
            pass
        self.admission.release(tenant)
        _tm.get("gateway_active_sessions").set(len(self._sessions))
        _tm.get("gateway_requests_total").labels(
            tenant=tenant, outcome=outcome).inc()
        _ev.emit("request_completed", session_id=sid, tenant=tenant,
                 tokens=sess.tokens,
                 queue_wait_s=round(sess.queue_wait_s, 6), outcome=outcome)
        if outcome == "ok":
            sess.req.sink.put(("done", payload, sess.queue_wait_s))
        else:
            sess.req.sink.put(("error", payload))

    def _step_session(self, sess: _ActiveSession) -> None:
        tenant = sess.req.tenant
        t_step = time.monotonic()
        try:
            step = next(sess.stepper)
        except StopIteration:
            # Defensive: the generator's last yield carries done=True, so
            # a bare StopIteration means it was closed under us.
            self._finish_session(sess, "error",
                                 RuntimeError("generation ended early"))
            return
        except Exception as exc:  # noqa: BLE001 — deliver to the waiter
            self._finish_session(sess, "error", exc)
            return
        if step.new_tokens:
            if sess.first_token_at is None:
                sess.first_token_at = time.monotonic()
                ttft = sess.first_token_at - sess.req.admitted_at
                _tm.get("gateway_ttft_seconds").labels(
                    tenant=tenant).observe(ttft)
                self.slo.observe(tenant, "ttft", ttft)
            else:
                # Decode steps only: the first step's wall time IS the TTFT
                # and is judged by that objective, not the per-token one.
                self.slo.observe(
                    tenant, "token",
                    (time.monotonic() - t_step) / len(step.new_tokens))
            m_tokens = _tm.get("gateway_tokens_served_total").labels(
                tenant=tenant)
            for tok in step.new_tokens:
                m_tokens.inc()
                sess.tokens += 1
                self.step_log.append(tenant)
                sess.req.sink.put(("token", int(tok)))
            if self.burst and len(step.new_tokens) > 1:
                # One scheduler pick served a whole burst: charge the DRR
                # the tokens beyond the single unit pick() already took,
                # so served-token ratios keep tracking the weights.
                self._step_drr.charge(tenant, len(step.new_tokens) - 1)
        if step.done:
            self._finish_session(sess, "ok", step.result)
        else:
            # Re-arm the tenant's round-robin: this session goes to the
            # back so a tenant's own sessions share its quantum fairly.
            rr = self._tenant_rr[tenant]
            try:
                rr.remove(sess.req.session_id)
            except ValueError:
                pass
            rr.append(sess.req.session_id)

    def _admit_into_service(self) -> None:
        while len(self._sessions) < self.max_active:
            got = self.queue.try_pop()
            if got is None:
                break
            tenant, req = got
            self._start_session(tenant, req)

    def _schedule_loop(self) -> None:
        while not self._stopping.is_set():
            if not self._paused.is_set():
                self._paused.wait(timeout=0.1)
                continue
            self._admit_into_service()
            if not self._sessions:
                got = self.queue.pop(timeout=0.05)
                if got is None:
                    continue
                tenant, req = got
                self._start_session(tenant, req)
                continue
            active_tenants = {t for t, rr in self._tenant_rr.items() if rr}
            tenant = self._step_drr.pick(active_tenants)
            if tenant is None:  # pragma: no cover — active implies a tenant
                continue
            sid = self._tenant_rr[tenant][0]
            sess = self._sessions.get(sid)
            if sess is None:  # pragma: no cover — maps kept in lockstep
                self._tenant_rr[tenant].popleft()
                continue
            try:
                self._step_session(sess)
            except Exception:  # pragma: no cover — belt and braces
                logger.exception("gateway scheduler step failed")

    # -- wire front door ----------------------------------------------------

    def _dispatch(self, sock, header: dict, payload: bytes) -> None:
        verb = header.get("verb")
        if verb == "submit":
            self._handle_submit(sock, header)
            return
        if verb == "metrics":
            _send_frame(sock, {"verb": "metrics",
                               "text": _texp.render(_get_metrics_registry())})
            return
        if verb == "dump-events":
            _send_frame(sock, {"verb": "events",
                               "lines": _ev.get_recorder().render_jsonl(
                                   registry=_get_metrics_registry())})
            return
        if verb == "fault":
            _send_frame(sock, self._fault_admin(header))
            return
        if verb == "info":
            _send_frame(sock, {
                "verb": "info", "role": "gateway",
                "tenants": sorted(self.tenants),
                "queue_depth": self.queue.depth(),
                "active_sessions": len(self._sessions),
                "sessions_started": self._sessions_started,
                "slo": self.slo.snapshot(),
            })
            return
        _send_frame(sock, {"verb": "error",
                           "message": f"unknown verb {verb!r}"})

    def _handle_submit(self, sock, header: dict) -> None:
        tenant = header.get("tenant", "")
        prompt_ids = header.get("prompt_ids") or []
        if tenant not in self.tenants:
            _send_frame(sock, {"verb": "error",
                               "message": f"unknown tenant {tenant!r}"})
            return
        if not prompt_ids:
            _send_frame(sock, {"verb": "error",
                               "message": "submit needs prompt_ids"})
            return
        try:
            self.admission.try_admit(tenant, self.queue.depth())
        except Overloaded as exc:
            _send_frame(sock, {
                "verb": "error", "overloaded": True,
                "retry_after_s": exc.retry_after_s, "reason": exc.reason,
                "message": str(exc)})
            return
        now = time.monotonic()
        deadline_s = header.get("deadline_s")
        sid = header.get("session_id") or f"gw-{self._req_id()}"
        req = _GatewayRequest(
            tenant=tenant, session_id=sid, prompt_ids=prompt_ids,
            max_new_tokens=int(header.get("max_new_tokens", 64)),
            sampling=SamplingParams(
                temperature=float(header.get("temperature", 0.0)),
                top_p=float(header.get("top_p", 1.0)),
                top_k=int(header.get("top_k", 0)),
                repetition_penalty=float(
                    header.get("repetition_penalty", 1.0)),
            ),
            eos_token_id=header.get("eos_token_id"),
            # Deadline anchored at ADMISSION: queue wait spends the budget,
            # exactly like every downstream hop spends it.
            deadline_at=(now + float(deadline_s)
                         if deadline_s is not None else None),
            admitted_at=now,
        )
        depth = self.queue.push(tenant, req, deadline_at=req.deadline_at)
        _tm.get("gateway_queue_depth").set(depth)
        _ev.emit("request_admitted", session_id=sid, tenant=tenant,
                 queue_depth=depth, deadline_s=deadline_s)
        self._stream_back(sock, req)

    def _req_id(self) -> str:
        return f"{time.monotonic_ns():x}-{self._sessions_started}"

    def _stream_back(self, sock, req: _GatewayRequest) -> None:
        """Relay the scheduler's sink to the socket. This thread is the
        connection's only writer; a dead socket abandons the request (the
        scheduler notices nothing — generation completes and the tokens
        are dropped, the simple semantics; cancellation-on-disconnect is
        future work)."""
        index = 0
        while True:
            try:
                kind, *rest = req.sink.get(timeout=0.5)
            except _queue.Empty:
                if self._stopping.is_set():
                    _send_frame(sock, {"verb": "error",
                                       "message": "gateway shutting down"})
                    return
                continue
            if kind == "token":
                _send_frame(sock, {"verb": "token",
                                   "session_id": req.session_id,
                                   "index": index, "token_id": rest[0]})
                index += 1
            elif kind == "done":
                result, queue_wait_s = rest
                _send_frame(sock, {
                    "verb": "submit_done", "session_id": req.session_id,
                    "tokens": [int(t) for t in result.tokens],
                    "stopped_by": result.stopped_by,
                    "ttft_s": result.ttft_s,
                    "queue_wait_s": queue_wait_s})
                return
            else:  # "error"
                exc = rest[0]
                frame = {"verb": "error", "session_id": req.session_id,
                         "message": f"{type(exc).__name__}: {exc}"}
                if isinstance(exc, DeadlineExceeded):
                    frame["deadline_expired"] = True
                _send_frame(sock, frame)
                return


class GatewaySubmitClient:
    """Load-generator / SDK side of the ``submit`` verb: one request per
    call, tokens surfacing via ``on_token`` as frames arrive."""

    def __init__(self, address: str, connect_timeout: float = 5.0):
        self.address = address
        self.connect_timeout = connect_timeout

    def info(self, timeout: float = 5.0) -> dict:
        """The gateway's ``info`` verb: queue depth, active sessions, and
        the per-tenant SLO burn-rate snapshot (``--mode top`` row)."""
        host, port = self.address.rsplit(":", 1)
        with socket.create_connection((host, int(port)),
                                      timeout=self.connect_timeout) as sock:
            sock.settimeout(timeout)
            _send_frame(sock, {"verb": "info"})
            resp, _ = _recv_frame(sock)
            return resp

    def submit(self, tenant: str, prompt_ids: Sequence[int],
               max_new_tokens: int = 64, *, temperature: float = 0.0,
               top_p: float = 1.0, top_k: int = 0,
               repetition_penalty: float = 1.0,
               deadline_s: Optional[float] = None,
               session_id: Optional[str] = None,
               eos_token_id: Optional[int] = None,
               timeout: Optional[float] = 60.0,
               on_token=None) -> dict:
        """Returns {"tokens", "stopped_by", "ttft_s", "queue_wait_s"}.
        Raises :class:`Overloaded` (typed, non-retryable, with
        ``retry_after_s``) on an admission refusal."""
        host, port = self.address.rsplit(":", 1)
        hdr = {
            "verb": "submit", "tenant": tenant,
            "prompt_ids": [int(t) for t in prompt_ids],
            "max_new_tokens": int(max_new_tokens),
            "temperature": temperature, "top_p": top_p, "top_k": top_k,
            "repetition_penalty": repetition_penalty,
        }
        if deadline_s is not None:
            hdr["deadline_s"] = float(deadline_s)
        if session_id is not None:
            hdr["session_id"] = session_id
        if eos_token_id is not None:
            hdr["eos_token_id"] = int(eos_token_id)
        with socket.create_connection((host, int(port)),
                                      timeout=self.connect_timeout) as sock:
            sock.settimeout(timeout)
            _send_frame(sock, hdr)
            tokens: List[int] = []
            while True:
                resp, _ = _recv_frame(sock)
                verb = resp.get("verb")
                if verb == "token":
                    tokens.append(int(resp["token_id"]))
                    if on_token is not None:
                        on_token(int(resp["token_id"]))
                elif verb == "submit_done":
                    return {"tokens": [int(t) for t in resp["tokens"]],
                            "stopped_by": resp.get("stopped_by"),
                            "ttft_s": resp.get("ttft_s"),
                            "queue_wait_s": resp.get("queue_wait_s")}
                elif verb == "error":
                    if resp.get("overloaded"):
                        raise Overloaded(
                            resp.get("message", "gateway overloaded"),
                            float(resp.get("retry_after_s", 0.0)),
                            tenant=tenant,
                            reason=resp.get("reason", "overloaded"))
                    raise RuntimeError(
                        f"gateway error: {resp.get('message')}")
                else:
                    raise RuntimeError(f"unexpected gateway verb {verb!r}")
