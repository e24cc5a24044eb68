"""OpenAI- and Anthropic-wire HTTP server over the port's engine (the port
of the reference's ``serving/server.py``: colocated and disaggregated
serving, and the ``/v1/kv`` page-set wire).

Routes, as in the reference (``docs/SERVING.md`` is the contract):

* ``POST /v1/chat/completions`` (OpenAI) and ``POST /v1/messages``
  (Anthropic), plain or ``"stream": true`` (SSE in each wire's dialect);
* ``GET /healthz`` (with the serving ``role`` and the engine's radix
  ``prefix_summary``; 503 with ``"wedged": true`` while the engine's
  dispatch watchdog holds it degraded), ``GET /v1/models``, ``GET /metrics`` (JSON with the
  ``handoff`` and ``kv_migrate`` ticket stats, or Prometheus text under
  ``Accept: text/plain``);
* disaggregated handoff: ``role`` is ``prefill``, ``decode`` or ``both``.
  A body ``"handoff": true`` asks a non-decode server (engine permitting,
  not streamed) for a prefill-role export: the request stops after its
  first token with its pages pinned and the answer is a
  ``handoff.ticket``; ``GET /v1/handoff/{ticket}`` serves the payload
  (``serving/handoff.py`` codec) and ``POST /v1/handoff/{ticket}/ack``
  consumes the ticket and releases the pages.  A body ``"handoff":
  {"ticket", "source"}`` on a non-prefill server pulls the payload from
  the source, acks it, and decodes from the imported pages;
* the ``/v1/kv`` page-set wire: ``POST /v1/kv/export {"preamble"}`` pins
  one warm preamble's page set under a ticket, ``GET /v1/kv/{ticket}``
  serves it, ``POST /v1/kv/{ticket}/ack`` drops it, and ``POST
  /v1/kv/import {"ticket", "source"}`` pulls, installs and acks.
  ``LMRS_KV_MIGRATE=0`` answers 501 on all four.

An orphan-sweeper thread releases the pins of tickets never acked once
``handoff_ttl_s`` passes, and drops expired page-set blobs.

Concurrent requests micro-batch: a dispatcher thread collects the queue for
``batch_window_s`` and hands the wave to ONE ``Engine.generate_batch``;
streamed requests ride the same wave through ``on_tokens``.  Headers:
``X-LMRS-Trace`` (adopted, else minted), ``X-LMRS-Deadline`` (relative
seconds, anchored at ingress; garbage is a 400).  A client that goes away
cancels its request through the engine's ``cancel`` hook.

* durable jobs (``jobs_dir``): ``POST /v1/jobs {"transcript", "params"}``,
  ``GET /v1/jobs``, ``GET`` and ``DELETE /v1/jobs/{id}``, over a
  ``JobManager`` whose engine traffic rides the micro-batcher; journals
  found in the directory recover at start-up;
* live sessions (``live_dir``): ``POST /v1/sessions``, ``GET
  /v1/sessions``, ``POST /v1/sessions/{id}/segments`` (``"refresh"``
  optional), ``POST /v1/sessions/{id}/refresh``, ``GET
  /v1/sessions/{id}[/summary[?refresh=1]]`` and ``DELETE
  /v1/sessions/{id}``, over a ``SessionManager`` on the same batcher.
  Without a manager, both surfaces forward to an engine that has
  ``job_request`` / ``session_request`` (a ``RouterEngine``), else answer
  501.  ``X-LMRS-Tenant`` labels a job or session.

* observability: ``GET /v1/usage`` (the engine's per-tenant cost-ledger
  rollups; a router's fleet aggregation), ``GET /v1/anatomy`` (the step
  anatomy; 501 with ``LMRS_ANATOMY=0``), ``GET /v1/trace`` (this host's
  span ring as Chrome-trace JSON, 409 unless tracing is on; a router's
  stitched fleet trace) and ``POST /v1/debug/profile {"duration_s",
  "out_dir"}`` (a bounded ``torch.profiler`` capture through the engine's
  ``debug_profile`` hook, written under ``LMRS_PROFILE_DIR`` by default;
  501 for an engine without the hook).  ``/healthz`` carries the engine's
  ``slo`` block and ``/metrics`` text merges the engine's registry.  A
  completion's tenant is ``X-LMRS-Tenant`` (else the body's ``tenant``,
  else ``"default"``), minted at ingress and carried through handoffs;
  responses carry the ledger's bill as ``usage.cost``.  While
  ``LMRS_QOS`` is armed a completion's QoS class is ``X-LMRS-QoS-Class``
  (else the body's ``qos_class``; ``interactive`` or ``batch``, anything
  else none), carried through handoffs; the batcher dispatches a wave in
  the engine's fair-share order when the engine has a policy (the mock's
  gate), and ``GET /v1/usage`` carries the policy's ``qos`` block.

Standard library only (``http.server``).
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import queue
import re
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from lmrs_tpu_torch.engine.api import Engine, GenerationRequest, GenerationResult
from lmrs_tpu_torch.fleet.qos import clean_qos_class as _clean_qos_class
from lmrs_tpu_torch.fleet.qos import qos_enabled
from lmrs_tpu_torch.obs import (DEFAULT_TENANT, MetricsRegistry, get_tracer,
                                merge_expositions, new_trace_id)
from lmrs_tpu_torch.serving.handoff import (ImportLog, TicketRegistry,
                                            decode_payload, encode_payload)
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.utils.env import env_bool

logger = logging.getLogger("lmrs_torch.serving")

# X-LMRS-Trace values: a safe alphabet and length, else a fresh id is minted
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")

def _handoff_error(message: str, kind: str = "handoff_error") -> dict:
    return {"error": {"message": message, "type": kind}}


def clean_trace_id(raw) -> str | None:
    """A wire-supplied trace id, validated; None when absent or garbage."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _TRACE_ID_RE.match(raw) else None


def clean_tenant(raw, default: str | None = None) -> str | None:
    """A wire-supplied ``X-LMRS-Tenant`` label, validated against the trace
    id's alphabet; ``default`` when absent or garbage (completion ingress
    passes ``DEFAULT_TENANT``, so anonymous traffic bills to one named
    tenant; adoption sites keep None so absence stays observable)."""
    return clean_trace_id(raw) or default


def clean_qos_class(raw) -> str | None:
    """A wire-supplied ``X-LMRS-QoS-Class`` label (or ``qos_class`` body
    field): "interactive" | "batch", else None (fleet/qos.py resolves None
    to "interactive")."""
    return _clean_qos_class(raw)


def _cost(res: GenerationResult) -> dict:
    """The ledger's bill as the wire ``usage.cost`` block, when there is
    one."""
    return {"cost": res.usage} if res.usage else {}


class _Job:
    __slots__ = ("request", "result", "event", "deltas", "rid", "cancelled",
                 "done_cb")

    def __init__(self, request: GenerationRequest, stream: bool = False,
                 done_cb=None):
        self.request = request
        self.result: GenerationResult | None = None
        self.event = threading.Event()
        # streaming jobs: the dispatcher routes on_tokens deltas here; a
        # None sentinel, pushed AFTER ``result`` is set, ends the stream
        self.deltas: queue.Queue[str | None] | None = (
            queue.Queue() if stream else None)
        self.rid: int | None = None  # set at enqueue
        self.cancelled = False  # set by _Batcher.cancel (handler threads)
        # fired right after ``event`` (_BatcherEngine waits on one shared
        # event for a whole request set)
        self.done_cb = done_cb

    def finish(self, result: GenerationResult) -> None:
        self.result = result
        self.event.set()
        if self.done_cb is not None:
            self.done_cb()
        if self.deltas is not None:  # sentinel strictly after the result
            self.deltas.put(None)


class _Batcher:
    """Micro-batching dispatcher: collect jobs for up to ``window_s`` (or
    ``max_batch``) and run them as ONE ``generate_batch`` call."""

    def __init__(self, engine: Engine, window_s: float = 0.02,
                 max_batch: int = 256):
        self.engine = engine
        self.window_s = window_s
        self.max_batch = max_batch
        self.queue: queue.Queue[_Job | None] = queue.Queue()
        self.closed = False
        # orders every submit against shutdown(): a job is enqueued before
        # the sentinel (the final drain completes it) or rejected at once
        self._close_lock = threading.Lock()
        # the running wave's jobs by rid (only the dispatcher writes it):
        # cancel() routes a disconnect into the running engine call
        self._inflight: dict[int, _Job] = {}
        # rids grow across waves, so a cancel that races a wave boundary
        # can never alias another client's request
        self._next_rid = 0
        self.batches_run = 0
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _enqueue(self, job: _Job) -> _Job:
        """Give the job its rid and queue it; after shutdown, finish it
        with an error result at once."""
        with self._close_lock:
            job.rid = self._next_rid
            self._next_rid += 1
            job.request.request_id = job.rid
            if self.closed:
                job.finish(GenerationResult(request_id=job.rid,
                                            finish_reason="error",
                                            error="server shutting down"))
            else:
                self.queue.put(job)
        return job

    def submit(self, request: GenerationRequest, poll_disconnect=None,
               poll_interval: float = 0.5) -> GenerationResult:
        """Enqueue and block until the result is ready.  ``poll_disconnect``
        is called every ``poll_interval`` seconds while waiting; True
        (the client went away) cancels the job, and the wait goes on for
        the cancellation's result."""
        job = self._enqueue(_Job(request))
        if poll_disconnect is None:
            job.event.wait()
        else:
            while not job.event.wait(poll_interval):
                if not job.cancelled and poll_disconnect():
                    logger.debug("non-stream client disconnected; cancelling")
                    self.cancel(job)
        return job.result

    def submit_stream(self, request: GenerationRequest) -> _Job:
        """Enqueue without blocking; the caller reads ``job.deltas`` until
        the None sentinel, after which ``job.result`` is set."""
        return self._enqueue(_Job(request, stream=True))

    def submit_job(self, request: GenerationRequest, done_cb=None) -> _Job:
        """Enqueue without blocking or a delta stream; the caller waits on
        ``job.event``.  ``done_cb`` (set before enqueue, so no completion
        races past it) fires on completion."""
        return self._enqueue(_Job(request, done_cb=done_cb))

    def cancel(self, job: _Job) -> None:
        """Abort ``job``: a queued job is dropped before dispatch, one in
        the running wave goes through the engine's ``cancel`` hook (the
        scheduler frees its slot and pages at the next block boundary).
        Called from handler threads."""
        job.cancelled = True
        if self._inflight.get(job.rid) is job:
            eng_cancel = getattr(self.engine, "cancel", None)
            if eng_cancel is not None:
                eng_cancel(job.rid)

    def shutdown(self) -> None:
        with self._close_lock:
            self.closed = True
            self.queue.put(None)
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            job = self.queue.get()
            if job is None:
                self._drain_on_shutdown()
                return
            jobs = [job]
            deadline = time.monotonic() + self.window_s
            while len(jobs) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(jobs)
                    self._drain_on_shutdown()
                    return
                jobs.append(nxt)
            self._run(jobs)

    def _drain_on_shutdown(self) -> None:
        """Finish the jobs queued behind a shutdown sentinel with an error
        result, so no submit() waits forever (dispatcher thread only)."""
        while True:
            try:
                job = self.queue.get_nowait()
            except queue.Empty:
                return
            if job is not None:
                job.finish(GenerationResult(request_id=job.rid,
                                            finish_reason="error",
                                            error="server shutting down"))

    def _qos_order(self, jobs: list[_Job]) -> list[_Job]:
        """Fair-share wave order (fleet/qos.py): when the engine carries an
        armed policy (the mock's admission gate; the scheduler reorders in
        its own admission instead) the wave dispatches in repeated
        policy-pick order, interactive before batch and under-served
        tenants before flooding ones.  The identity when the engine has no
        policy or ``LMRS_QOS=0``."""
        pol = getattr(self.engine, "qos", None)
        if pol is None or len(jobs) < 2:
            return jobs
        remaining = list(jobs)
        out: list[_Job] = []
        while remaining:
            out.append(remaining.pop(
                pol.pick_index([j.request for j in remaining])))
        return out

    def _run(self, jobs: list[_Job]) -> None:
        # publish the wave BEFORE dispatch so cancel() can reach it, then
        # drop the jobs cancelled while queued (no engine work for them)
        self._inflight = {j.rid: j for j in jobs}
        for job in jobs:
            if job.cancelled:
                job.finish(GenerationResult(request_id=job.rid,
                                            finish_reason="cancelled"))
        jobs = self._qos_order([j for j in jobs if not j.cancelled])
        if not jobs:
            self._inflight = {}
            return
        stream_jobs = {j.rid: j for j in jobs if j.deltas is not None}
        kw = {}
        if stream_jobs:
            def on_tokens(rid: int, delta: str) -> None:
                j = stream_jobs.get(rid)
                if j is not None:
                    j.deltas.put(delta)

            kw["on_tokens"] = on_tokens
        try:
            results = self.engine.generate_batch([j.request for j in jobs],
                                                 **kw)
        except Exception as e:  # per-request errors; the dispatcher lives
            logger.exception("engine batch failure")
            results = [GenerationResult(request_id=j.rid,
                                        finish_reason="error", error=str(e))
                       for j in jobs]
        self.batches_run += 1
        self.requests_served += len(jobs)
        self._inflight = {}
        by_id = {r.request_id: r for r in results}
        for job in jobs:
            job.finish(by_id.get(job.rid, GenerationResult(
                request_id=job.rid, finish_reason="error",
                error="engine returned no result")))


class _BatcherEngine:
    """Engine facade that routes the job and session managers' requests
    through the server's micro-batcher (``_Batcher.submit_job``): their
    chunk and reduce work pools into the same engine waves as interactive
    traffic, and never calls the raw engine concurrently with the
    dispatcher.  ``on_result`` deliveries (and so journal appends) come as
    each batcher job completes."""

    schedules_internally = True  # the batcher admission-controls

    def __init__(self, batcher: _Batcher):
        self._batcher = batcher
        self._inflight: dict[int, _Job] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None,
                       on_tokens=None) -> list[GenerationResult]:
        import dataclasses

        # one completion signal for the whole call: every finishing job
        # sets it, and the streaming loop wakes exactly then
        wake = threading.Event()

        def submit_one(req: GenerationRequest) -> _Job:
            # the batcher reassigns request_id at enqueue: submit a COPY so
            # the caller's id survives for the result
            job = self._batcher.submit_job(dataclasses.replace(req),
                                           done_cb=wake.set)
            with self._lock:
                self._inflight[req.request_id] = job
            return job

        def finish(req: GenerationRequest, job: _Job) -> GenerationResult:
            with self._lock:
                self._inflight.pop(req.request_id, None)
            return dataclasses.replace(job.result, request_id=req.request_id)

        if on_result is None:
            jobs = [(r, submit_one(r)) for r in requests]
            for _, job in jobs:
                job.event.wait()
            return [finish(r, j) for r, j in jobs]
        # streaming: deliver each result as its batcher job completes,
        # collecting retry submissions into the run
        pending = list(requests)
        live: list[tuple[GenerationRequest, _Job]] = []
        results: list[GenerationResult] = []

        def submit(more: list[GenerationRequest]) -> None:
            pending.extend(more)

        while pending or live:
            while pending:
                req = pending.pop(0)
                live.append((req, submit_one(req)))
            idx = next((k for k, (_r, j) in enumerate(live)
                        if j.event.is_set()), None)
            if idx is None:
                # clear-then-rescan: a completion between the scan and
                # this wait already set ``wake``
                wake.wait()
                wake.clear()
                continue
            req, job = live.pop(idx)
            res = finish(req, job)
            results.append(res)
            on_result(res, submit)
        return results

    def cancel(self, request_id: int) -> None:
        with self._lock:
            job = self._inflight.get(request_id)
        if job is not None:
            self._batcher.cancel(job)

    def shutdown(self) -> None:  # the server owns the real engine
        pass


def _anthropic_stop_reason(res: GenerationResult) -> str:
    """GenerationResult -> Anthropic ``stop_reason``; ``deadline`` and
    ``shed`` pass through as extension values."""
    if res.stop_sequence is not None:
        return "stop_sequence"
    if res.finish_reason == "stop":
        return "end_turn"
    if res.finish_reason in ("deadline", "shed"):
        return res.finish_reason
    return "max_tokens"


def _clamp_max_tokens(value, cap: int) -> int:
    """0 is a real request for zero completion tokens; only None defaults."""
    n = 1000 if value is None else int(value)
    return min(max(n, 0), cap)


def _cache_prefix(body: dict) -> int | None:
    """The wire's ``cache_prefix`` hint (an integer char count), or None
    when absent or garbage (bools included)."""
    raw = body.get("cache_prefix")
    if isinstance(raw, bool) or not isinstance(raw, (int, float)):
        return None
    return int(raw)


def _flatten_messages(messages: list) -> tuple[list[str], list[str]]:
    """Both wires' messages[] collapse: system messages join the system
    prompt, user and tool turns concatenate in order, assistant turns
    become role-tagged context for the next user turn."""
    system_parts, user_parts = [], []
    for msg in messages:
        role = msg.get("role", "user")
        content = msg.get("content", "")
        if isinstance(content, list):  # content-blocks form
            content = "".join(
                blk.get("text", "") for blk in content if isinstance(blk, dict))
        if role == "system":
            system_parts.append(content)
        elif role == "user" or role == "tool":
            user_parts.append(content)
        else:
            user_parts.append(f"[assistant]: {content}")
    return system_parts, user_parts


def _chat_to_request(body: dict, max_tokens_cap: int) -> GenerationRequest:
    """OpenAI ``messages`` -> one GenerationRequest."""
    system_parts, user_parts = _flatten_messages(body.get("messages", []))
    stop = body.get("stop") or body.get("stop_sequences") or ()
    if isinstance(stop, str):
        stop = (stop,)
    return GenerationRequest(
        prompt="\n\n".join(user_parts),
        system_prompt="\n\n".join(system_parts) or None,
        max_new_tokens=_clamp_max_tokens(body.get("max_tokens"),
                                         max_tokens_cap),
        temperature=float(body.get("temperature", 0.3)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        stop=tuple(stop),
        seed=body.get("seed"),
        cache_prefix=_cache_prefix(body),
    )


def _messages_to_request(body: dict, max_tokens_cap: int) -> GenerationRequest:
    """Anthropic messages -> GenerationRequest (the top-level ``system``
    field, plus system-role messages routed into the system prompt)."""
    system = body.get("system") or None
    if isinstance(system, list):  # content-block form
        system = "".join(
            blk.get("text", "") for blk in system if isinstance(blk, dict))
    msg_system, user_parts = _flatten_messages(body.get("messages", []))
    system_parts = ([system] if system else []) + msg_system
    stop = body.get("stop_sequences") or ()
    if isinstance(stop, str):
        stop = (stop,)
    return GenerationRequest(
        prompt="\n\n".join(user_parts),
        system_prompt="\n\n".join(system_parts) or None,
        max_new_tokens=_clamp_max_tokens(body.get("max_tokens"),
                                         max_tokens_cap),
        temperature=float(body.get("temperature", 0.3)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        stop=tuple(stop),
        cache_prefix=_cache_prefix(body),
    )


class EngineHTTPServer:
    """Threaded HTTP server bound to an Engine through the micro-batcher."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8000, model_name: str = "lmrs-tpu",
                 max_tokens_cap: int = 4096, batch_window_s: float = 0.02,
                 role: str = "both", handoff_ttl_s: float = 60.0,
                 jobs_dir: str | None = None, live_dir: str | None = None,
                 pipeline_config=None):
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown serving role {role!r}; "
                             "want prefill|decode|both")
        self.engine = engine
        self.model_name = model_name
        self.max_tokens_cap = max_tokens_cap
        self.batcher = _Batcher(engine, window_s=batch_window_s)
        self.started = time.time()
        # durable jobs and live sessions: each manager's engine traffic
        # rides the micro-batcher, and journals found in its directory
        # recover here.  A None directory falls back to LMRS_JOBS_DIR /
        # LMRS_LIVE_DIR (the config); empty disables the API (501, or
        # forwarding when the engine is a router)
        self.jobs = None
        self.live = None
        if jobs_dir is None or live_dir is None or pipeline_config is not None:
            from lmrs_tpu_torch.config import PipelineConfig

            pipeline_config = pipeline_config or PipelineConfig()
            if jobs_dir is None:
                jobs_dir = pipeline_config.jobs.jobs_dir
            if live_dir is None:
                live_dir = pipeline_config.live.sessions_dir
        if jobs_dir:
            from lmrs_tpu_torch.jobs.manager import JobManager

            self.jobs = JobManager(_BatcherEngine(self.batcher), jobs_dir,
                                   config=pipeline_config)
            recovered = self.jobs.recover()
            if recovered:
                logger.info("job recovery: %d interrupted job(s) re-queued "
                            "from %s", recovered, jobs_dir)
        if live_dir:
            from lmrs_tpu_torch.live.session import SessionManager

            self.live = SessionManager(_BatcherEngine(self.batcher),
                                       live_dir, config=pipeline_config)
            rehydrated = self.live.recover()
            if rehydrated:
                logger.info("session recovery: %d live session(s) "
                            "rehydrated from %s", rehydrated, live_dir)
        # the role is a policy, not a capability: a prefill-role server
        # short-circuits only requests that ask for a handoff (plain ones
        # run whole, which keeps the router's colocated fallback open),
        # and a decode-role server mints no tickets
        self.role = role
        self.handoff_ttl_s = handoff_ttl_s
        self.handoff = TicketRegistry()  # exporting side: live tickets
        self._imported = ImportLog()     # importing side: dedup
        # the /v1/kv page-set wire; LMRS_KV_MIGRATE=0 answers 501 and
        # reports no migration state
        self.kv_migrate = env_bool("LMRS_KV_MIGRATE", True)
        self.kv_tickets = TicketRegistry()
        self._kv_imported = ImportLog()
        self._kv_lock = threading.Lock()
        # ticket -> encoded blob, held until ack or expiry
        self._kv_payloads: dict[str, bytes] = {}  # guarded-by: _kv_lock
        self._handoff_reg = MetricsRegistry()
        hc, hh = self._handoff_reg.counter, self._handoff_reg.histogram
        self._c_tickets = hc("lmrs_handoff_tickets_total",
                             "handoff tickets published (prefill side)")
        self._c_acks = hc("lmrs_handoff_acks_total",
                          "handoff acks accepted (prefill side)")
        self._c_dup_rejects = hc("lmrs_handoff_duplicate_rejects_total",
                                 "duplicate/stale imports rejected "
                                 "idempotently (decode side)")
        self._c_ack_failures = hc("lmrs_handoff_ack_failures_total",
                                  "acks lost after retries (pages left to "
                                  "the prefill orphan sweep)")
        self._h_transfer = hh("lmrs_handoff_transfer_seconds",
                              help="payload fetch prefill→decode",
                              unit="seconds")
        self._sweep_stop = threading.Event()
        self._sweeper = threading.Thread(target=self._sweep_loop, daemon=True)
        self._sweeper.start()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _send(self, code: int, payload: dict) -> None:
                self._send_text(code, json.dumps(payload), "application/json")

            def _send_text(self, code: int, text: str,
                           content_type: str) -> None:
                data = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _read_json(self) -> dict | None:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    return json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return None

            def _no_route(self) -> None:
                self._send(404, {"error": {"message": f"no route {self.path}"}})

            def do_GET(self):
                if self.path == "/healthz":
                    # a watchdog-degraded engine answers 503 + wedged:true
                    # (the optional ``wedged`` hook): the supervisor
                    # SIGKILL-respawns on it and the router's probe does
                    # not re-admit the host
                    wedged = False
                    hook = getattr(outer.engine, "wedged", None)
                    if hook is not None:
                        try:
                            wedged = bool(hook())
                        except Exception:  # noqa: BLE001 - stay healthy
                            logger.debug("wedged hook failed", exc_info=True)
                    payload = {"status": "wedged" if wedged else "ok",
                               "wedged": wedged, "role": outer.role,
                               "uptime_s": round(time.time() - outer.started, 1)}
                    if wedged:
                        self._send(503, payload)
                        return
                    summary = outer.prefix_summary()
                    if summary is not None:
                        payload["prefix_summary"] = summary
                    # the burn-rate SLO state rides the probe (the router's
                    # placement reads it); health answers even if it breaks
                    slo = getattr(outer.engine, "slo_report", None)
                    if slo is not None:
                        try:
                            payload["slo"] = slo()
                        except Exception:  # noqa: BLE001 - stay healthy
                            logger.debug("slo report failed", exc_info=True)
                    self._send(200, payload)
                elif self.path == "/v1/usage":
                    self._get_report("usage_report", "usage",
                                     "no cost ledger")
                elif self.path == "/v1/anatomy":
                    self._get_report("anatomy_report", "anatomy",
                                     "no step anatomy")
                elif self.path == "/v1/trace":
                    self._get_trace()
                elif self.path == "/v1/models":
                    self._send(200, {"object": "list", "data": [
                        {"id": outer.model_name, "object": "model",
                         "owned_by": "lmrs-tpu"}]})
                elif self.path == "/metrics":
                    accept = self.headers.get("Accept", "") or ""
                    if "text/plain" in accept or "openmetrics" in accept:
                        self._send_text(
                            200, outer.prometheus_text(),
                            "text/plain; version=0.0.4; charset=utf-8")
                        return
                    payload = {"engine": outer.engine.engine_metrics(),
                               "http_batches": outer.batcher.batches_run,
                               "http_requests": outer.batcher.requests_served,
                               "handoff": outer.handoff_stats()}
                    if outer.kv_migrate:
                        payload["kv_migrate"] = outer.kv_stats()
                    summary = outer.prefix_summary()
                    if summary is not None:
                        payload["prefix_summary"] = summary
                    if outer.jobs is not None:
                        payload["jobs"] = outer.jobs.stats()
                    if outer.live is not None:
                        payload["live"] = outer.live.stats()
                    self._send(200, payload)
                elif self.path.startswith("/v1/handoff/"):
                    self._get_handoff(self.path.split("/")[3])
                elif self.path.startswith("/v1/kv/"):
                    self._get_kv(self.path.split("/")[3])
                elif self.path == "/v1/jobs" or self.path.startswith(
                        "/v1/jobs/"):
                    self._send(*outer._job_http("GET", self.path, None))
                elif (self.path.split("?", 1)[0] == "/v1/sessions"
                        or self.path.startswith("/v1/sessions/")):
                    path, _, query = self.path.partition("?")
                    self._send(*outer._session_http("GET", path, None,
                                                    query=query))
                else:
                    self._no_route()

            def do_DELETE(self):
                if self.path.startswith("/v1/jobs/"):
                    self._send(*outer._job_http("DELETE", self.path, None))
                elif self.path.startswith("/v1/sessions/"):
                    self._send(*outer._session_http("DELETE", self.path,
                                                    None))
                else:
                    self._no_route()

            # ------------------------------------------------ observability

            def _get_report(self, hook_name: str, what: str,
                            missing: str) -> None:
                """``GET /v1/usage`` / ``GET /v1/anatomy``: the engine's
                report (a router's fleet merge); 501 when the engine has
                no such hook, or the anatomy is off."""
                hook = getattr(outer.engine, hook_name, None)
                if hook is None:
                    self._send(501, {"error": {
                        "message": f"this engine backend has {missing}",
                        "type": f"{what}_error"}})
                    return
                try:
                    doc = hook()
                    # the per-tenant fair-share block (fleet/qos.py),
                    # omitted when the policy is off or a router's fleet
                    # merge already carries one
                    qos = getattr(outer.engine, "qos_report", None)
                    if (what == "usage" and qos is not None
                            and "qos" not in doc):
                        q = qos()
                        if q.get("enabled"):
                            doc["qos"] = q
                except Exception as e:  # noqa: BLE001 - marked error
                    logger.exception("%s report failed", what)
                    self._send(502, {"error": {
                        "message": f"{what} report failed: "
                                   f"{type(e).__name__}: {e}",
                        "type": f"{what}_error"}})
                    return
                if what == "anatomy" and not doc.get("enabled"):
                    self._send(501, {"error": {
                        "message": "step anatomy is disabled "
                                   "(LMRS_ANATOMY=0)",
                        "type": "anatomy_error"}})
                    return
                self._send(200, doc)

            def _get_trace(self) -> None:
                """``GET /v1/trace``: this host's trace ring as Chrome-trace
                JSON, or, when the engine is a router (``stitched_trace``),
                the fleet's rings pulled, clock-aligned and merged.  409
                when tracing is off here (``--trace`` / ``LMRS_TRACE=1``)."""
                stitch = getattr(outer.engine, "stitched_trace", None)
                if stitch is not None:
                    try:
                        self._send(200, stitch())
                    except Exception as e:  # noqa: BLE001 - marked error
                        logger.exception("trace stitch failed")
                        self._send(502, {"error": {
                            "message": f"trace stitch failed: "
                                       f"{type(e).__name__}: {e}",
                            "type": "trace_error"}})
                    return
                tr = get_tracer()
                if tr is None:
                    self._send(409, {"error": {
                        "message": "tracing is not enabled on this host "
                                   "(start lmrs-serve-torch with --trace or "
                                   "LMRS_TRACE=1)",
                        "type": "trace_error"}})
                    return
                self._send(200, tr.payload(host=f"{outer.host}:{outer.port}"))

            def _post_profile(self, body: dict) -> None:
                """``POST /v1/debug/profile``: a bounded torch.profiler
                capture through the engine's ``debug_profile`` hook.  Body
                ``{"duration_s": 2.0, "out_dir": "..."}`` (``out_dir``
                defaults to ``LMRS_PROFILE_DIR``)."""
                hook = getattr(outer.engine, "debug_profile", None)
                if hook is None:
                    self._send(501, {"error": {
                        "message": "this engine backend has no profiler",
                        "type": "profile_error"}})
                    return
                try:
                    duration = float(body.get("duration_s", 2.0))
                except (TypeError, ValueError):
                    self._send(400, {"error": {
                        "message": "duration_s must be a number",
                        "type": "profile_error"}})
                    return
                from lmrs_tpu_torch.obs.perf import default_profile_dir

                out_dir = body.get("out_dir") or default_profile_dir()
                ok, msg = hook(duration, str(out_dir))
                if not ok:
                    self._send(409, {"error": {"message": msg,
                                               "type": "profile_error"}})
                    return
                self._send(200, {"status": "capturing", "dir": msg,
                                 "duration_s": duration})

            def _client_gone(self) -> bool:
                """Disconnect probe for non-streaming waits: a MSG_PEEK read
                returning b'' means the peer sent FIN (a half-closed client
                reads as gone, as in the reference)."""
                # injection site: a fired plan reports the client gone (the
                # disconnect -> cancel path without a socket teardown)
                if faults.check("server.client_disconnect"):
                    return True
                try:
                    self.connection.setblocking(False)
                    try:
                        data = self.connection.recv(1, socket.MSG_PEEK)
                    finally:
                        self.connection.setblocking(True)
                except (BlockingIOError, InterruptedError):
                    return False  # nothing to read: still connected
                except OSError:
                    return True
                return data == b""

            def _ingress(self, req: GenerationRequest, body: dict) -> bool:
                """Trace, deadline and handoff at ingress; False after an
                error answer.  The trace id is adopted from
                ``X-LMRS-Trace`` or minted.  The deadline (relative
                seconds: ``X-LMRS-Deadline``, else the ``deadline_s`` body
                field) is anchored to this server's clock; a non-finite or
                unparseable one is a 400 (dropping it would run the
                request unbounded)."""
                supplied = clean_trace_id(self.headers.get("X-LMRS-Trace"))
                req.trace_id = supplied or new_trace_id()
                # the tenant: header, else body field, else the explicit
                # default (minted here, so it yields to a handoff
                # payload's label)
                tenant = (clean_tenant(self.headers.get("X-LMRS-Tenant"))
                          or clean_tenant(body.get("tenant")))
                self._tenant_minted = tenant is None
                req.tenant = tenant or DEFAULT_TENANT
                # the QoS class rides the same ingress, parsed only while
                # LMRS_QOS is armed (the kill switch keeps the wire as it
                # was)
                if qos_enabled():
                    req.qos_class = (
                        clean_qos_class(self.headers.get("X-LMRS-QoS-Class"))
                        or clean_qos_class(body.get("qos_class")))
                raw = self.headers.get("X-LMRS-Deadline")
                if raw is None:
                    raw = body.get("deadline_s")
                if raw is not None:
                    try:
                        budget = float(raw)
                        if not math.isfinite(budget):
                            raise ValueError(budget)
                    except (TypeError, ValueError):
                        self._send(400, {"error": {
                            "message": f"invalid deadline budget {raw!r} "
                                       "(want finite seconds as a number)"}})
                        return False
                    req.deadline_s = time.time() + budget
                return self._apply_handoff(req, body)

            def _apply_handoff(self, req: GenerationRequest,
                               body: dict) -> bool:
                """The body's ``handoff`` field: ``true`` asks for a
                prefill-role export (ignored, i.e. a whole colocated
                generation, on a decode-role server, an engine without
                handoff, or a streamed request); a ticket descriptor asks
                for a decode-role import (pulled from the source and acked
                here).  False after an error answer."""
                h = body.get("handoff")
                if h in (None, False):
                    return True
                supported = getattr(outer.engine, "supports_handoff", False)
                if h is True:
                    if (outer.role != "decode" and supported
                            and not body.get("stream")):
                        req.handoff_export = True
                    return True
                if not isinstance(h, dict):
                    self._send(400, _handoff_error(
                        "handoff must be true or a ticket descriptor object"))
                    return False
                if outer.role == "prefill" or not supported:
                    self._send(409, _handoff_error(
                        f"this host does not import handoffs "
                        f"(role={outer.role})"))
                    return False
                payload, err = outer._fetch_handoff(h)
                if err is not None:
                    self._send(*err)
                    return False
                req.handoff_state = payload
                # the decode leg bills to the tenant the prefill leg did
                # (a locally minted default counts as absent)
                if (getattr(self, "_tenant_minted", False)
                        and clean_tenant(payload.get("tenant"))):
                    req.tenant = payload["tenant"]
                # the decode leg competes in the class the prefill leg was
                # admitted under
                if req.qos_class is None:
                    req.qos_class = clean_qos_class(payload.get("qos_class"))
                return True

            # ---------------------------------------- disaggregated handoff

            def _get_handoff(self, ticket: str) -> None:
                """Serve a pinned payload to the pulling decode side; an
                unknown, expired or consumed ticket is 410 (at most once)."""
                rec = outer.handoff.lookup(ticket)
                export = getattr(outer.engine, "export_handoff", None)
                try:
                    if rec is None or export is None:
                        raise KeyError(ticket)
                    data = encode_payload(export(rec["rid"]))
                except KeyError:  # unknown, or the pins were swept
                    self._send(410, _handoff_error(
                        f"handoff ticket {ticket} gone (expired, consumed, "
                        "or unknown)"))
                    return
                self._send_bytes(data)

            def _ack_handoff(self, ticket: str) -> None:
                """Consume a ticket exactly once and release its pinned
                pages; a duplicate or late ack is 410 and frees nothing."""
                rid = outer.handoff.consume(ticket)
                if rid is None:
                    self._send(410, _handoff_error(
                        f"handoff ticket {ticket} not ackable (expired, "
                        "consumed, or unknown)"))
                    return
                release = getattr(outer.engine, "release_handoff", None)
                pages = release(rid) if release is not None else 0
                outer._c_acks.inc()
                self._send(200, {"status": "acked", "pages_released": pages})

            def _respond_ticket(self, res: GenerationResult,
                                req: GenerationRequest) -> None:
                """Publish a ticket for a prefill-role result (only a
                request that asked for a handoff ever gets one)."""
                ttl = outer.handoff_ttl_s
                tid = outer.handoff.create(res.request_id, time.time() + ttl,
                                           trace_id=req.trace_id)
                outer._c_tickets.inc()
                self._send(200, {"object": "handoff.ticket", "handoff": {
                    "ticket": tid, "first_text": res.text,
                    "prompt_tokens": res.prompt_tokens,
                    "completion_tokens": res.completion_tokens,
                    "expires_in_s": ttl, "trace": req.trace_id}})

            def _send_bytes(self, data: bytes) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            # ---------------------------------------- the /v1/kv wire

            def _kv_disarmed(self) -> bool:
                if outer.kv_migrate:
                    return False
                self._send(501, _handoff_error(
                    "KV migration disabled (LMRS_KV_MIGRATE=0)",
                    "kv_migrate_error"))
                return True

            def _post_kv_export(self, body: dict) -> None:
                """Capture one warm preamble's page set and publish a
                ticket for it; 404 when cold here (or the engine is
                mid-run: the caller retries)."""
                export = getattr(outer.engine, "kv_export", None)
                preamble = body.get("preamble")
                if export is None:
                    self._send(501, _handoff_error(
                        "this engine backend has no KV page-set export",
                        "kv_migrate_error"))
                    return
                if not isinstance(preamble, str) or not preamble:
                    self._send(400, _handoff_error(
                        "body needs a preamble hash string",
                        "kv_migrate_error"))
                    return
                payload = export(preamble)
                if payload is None:
                    self._send(404, _handoff_error(
                        f"preamble {preamble} is not warm here (cold, "
                        "unknown, or engine busy)", "kv_migrate_error"))
                    return
                data = encode_payload(payload)
                ttl = outer.handoff_ttl_s
                tid = outer.kv_tickets.create(preamble, time.time() + ttl)
                with outer._kv_lock:
                    outer._kv_payloads[tid] = data
                self._send(200, {"object": "kv.ticket", "ticket": tid,
                                 "preamble": preamble,
                                 "tokens": int(payload.get("tokens", 0)),
                                 "bytes": len(data), "expires_in_s": ttl})

            def _get_kv(self, ticket: str) -> None:
                if self._kv_disarmed():
                    return
                rec = outer.kv_tickets.lookup(ticket)
                with outer._kv_lock:
                    data = outer._kv_payloads.get(ticket)
                if rec is None or data is None:
                    self._send(410, _handoff_error(
                        f"kv ticket {ticket} gone (expired, consumed, or "
                        "unknown)", "kv_migrate_error"))
                    return
                self._send_bytes(data)

            def _ack_kv(self, ticket: str) -> None:
                if outer.kv_tickets.consume(ticket) is None:
                    self._send(410, _handoff_error(
                        f"kv ticket {ticket} not ackable (expired, "
                        "consumed, or unknown)", "kv_migrate_error"))
                    return
                with outer._kv_lock:
                    outer._kv_payloads.pop(ticket, None)
                self._send(200, {"status": "acked"})

            def _post_kv_import(self, body: dict) -> None:
                """Pull a page-set blob from its source, install it into
                the prefix cache and ack.  A duplicate ticket or a geometry
                mismatch is 409, a busy engine 503."""
                imp = getattr(outer.engine, "kv_import", None)
                if imp is None:
                    self._send(501, _handoff_error(
                        "this engine backend has no KV page-set import",
                        "kv_migrate_error"))
                    return
                tid, source = body.get("ticket"), body.get("source")
                if not tid or not source:
                    self._send(400, _handoff_error(
                        "body needs ticket + source", "kv_migrate_error"))
                    return
                if outer._kv_imported.seen(tid):
                    self._send(409, _handoff_error(
                        f"duplicate kv import of ticket {tid} (already "
                        "imported on this host)", "kv_migrate_error"))
                    return
                payload, err = outer._fetch_blob(f"/v1/kv/{tid}", source,
                                                 "kv_migrate_error")
                if err is not None:
                    self._send(*err)
                    return
                try:
                    tokens = imp(payload)
                except RuntimeError as e:  # busy: retryable
                    self._send(503, _handoff_error(
                        f"kv import deferred: {e}", "kv_migrate_error"))
                    return
                except ValueError as e:  # geometry or framing: permanent
                    self._send(409, _handoff_error(
                        f"kv import rejected: {e}", "kv_migrate_error"))
                    return
                if not outer._kv_imported.add(tid):
                    self._send(409, _handoff_error(
                        f"duplicate kv import of ticket {tid}",
                        "kv_migrate_error"))
                    return
                outer._send_ack(f"/v1/kv/{tid}/ack", source)
                self._send(200, {"status": "imported",
                                 "imported_tokens": tokens})

            def do_POST(self):
                if self.path.startswith("/v1/handoff/") \
                        and self.path.endswith("/ack"):
                    self._ack_handoff(self.path.split("/")[3])
                    return
                if self.path.startswith("/v1/kv/") \
                        and self.path.endswith("/ack"):
                    if not self._kv_disarmed():
                        self._ack_kv(self.path.split("/")[3])
                    return
                body = self._read_json()
                if body is None:
                    self._send(400, {"error": {"message": "invalid JSON body"}})
                    return
                if self.path == "/v1/debug/profile":
                    self._post_profile(body)
                    return
                # a tenant label takes the trace id's alphabet; absent or
                # garbage, a job or session bills to its own id
                labels = {"trace_id": clean_trace_id(
                              self.headers.get("X-LMRS-Trace")),
                          "tenant": clean_tenant(
                              self.headers.get("X-LMRS-Tenant"))}
                if self.path == "/v1/jobs":
                    self._send(*outer._job_http("POST", self.path, body,
                                                **labels))
                    return
                if (self.path == "/v1/sessions"
                        or self.path.startswith("/v1/sessions/")):
                    self._send(*outer._session_http("POST", self.path, body,
                                                    **labels))
                    return
                if self.path in ("/v1/kv/export", "/v1/kv/import"):
                    if not self._kv_disarmed():
                        try:
                            if self.path == "/v1/kv/export":
                                self._post_kv_export(body)
                            else:
                                self._post_kv_import(body)
                        except Exception as e:
                            logger.exception("kv page-set request failed")
                            self._send(500, {"error": {"message": str(e)}})
                    return
                if self.path == "/v1/chat/completions":
                    parse, stream, respond = (_chat_to_request,
                                              self._stream_openai,
                                              self._respond_openai)
                elif self.path == "/v1/messages":
                    parse, stream, respond = (_messages_to_request,
                                              self._stream_anthropic,
                                              self._respond_anthropic)
                else:
                    self._no_route()
                    return
                try:
                    req = parse(body, outer.max_tokens_cap)
                    if not self._ingress(req, body):
                        return
                    if body.get("stream"):
                        stream(body, outer.batcher.submit_stream(req))
                        return
                    res = outer.batcher.submit(
                        req, poll_disconnect=self._client_gone)
                    # always attempt the write: a half-closed client still
                    # reads, and a dead socket just raises
                    try:
                        if res.finish_reason == "handoff":
                            self._respond_ticket(res, req)
                        else:
                            respond(body, res)
                    except OSError:
                        logger.debug("client gone before response write")
                except Exception as e:
                    logger.exception("request handling failed")
                    self._send(500, {"error": {"message": str(e)}})

            # ------------------------------------------------ SSE streaming

            def _sse_headers(self) -> None:
                # no Content-Length: the connection closes to end the body
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True

            def _sse(self, data: str, event: str | None = None) -> None:
                frame = (f"event: {event}\n" if event else "") + f"data: {data}\n\n"
                self.wfile.write(frame.encode())
                self.wfile.flush()

            def _drain(self, job: _Job):
                """Yield deltas until the sentinel (then ``job.result`` is
                set), probing for a disconnect while the stream is silent
                (prefill, or bytes of a character still arriving)."""
                while True:
                    try:
                        d = job.deltas.get(timeout=0.5)
                    except queue.Empty:
                        if not job.cancelled and self._client_gone():
                            logger.debug("silent stream client disconnected; "
                                         "cancelling")
                            outer.batcher.cancel(job)
                        continue
                    if d is None:
                        return
                    yield d

            def _stream_openai(self, body: dict, job: _Job) -> None:
                """chat.completion.chunk SSE: a role chunk, content deltas,
                the finish chunk (+ usage under
                ``stream_options.include_usage``), [DONE]."""
                cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
                created = int(time.time())
                model = body.get("model") or outer.model_name

                def chunk(delta: dict, finish=None, usage=None) -> None:
                    payload = {
                        "id": cid, "object": "chat.completion.chunk",
                        "created": created, "model": model,
                        "choices": [{"index": 0, "delta": delta,
                                     "finish_reason": finish}],
                    }
                    if usage is not None:
                        payload["usage"] = usage
                    self._sse(json.dumps(payload))

                self._sse_headers()
                try:
                    chunk({"role": "assistant", "content": ""})
                    for delta in self._drain(job):
                        chunk({"content": delta})
                    res = job.result
                    if res.error is not None:
                        self._sse(json.dumps({"error": {
                            "message": res.error, "type": "engine_error"}}))
                    else:
                        want_usage = (body.get("stream_options") or {}).get(
                            "include_usage")
                        chunk({}, finish=res.finish_reason,
                              usage={"prompt_tokens": res.prompt_tokens,
                                     "completion_tokens": res.completion_tokens,
                                     "total_tokens": res.total_tokens,
                                     **_cost(res)}
                              if want_usage else None)
                    self._sse("[DONE]")
                except OSError:  # the client went away: abort the request
                    logger.debug("stream client disconnected; cancelling")
                    outer.batcher.cancel(job)

            def _stream_anthropic(self, body: dict, job: _Job) -> None:
                """Anthropic messages SSE: message_start, one text content
                block of deltas, message_delta (stop_reason, usage),
                message_stop."""
                mid = f"msg_{uuid.uuid4().hex[:24]}"
                model = body.get("model") or outer.model_name
                self._sse_headers()
                try:
                    self._sse(json.dumps({
                        "type": "message_start",
                        "message": {
                            "id": mid, "type": "message", "role": "assistant",
                            "model": model, "content": [],
                            "stop_reason": None, "stop_sequence": None,
                            # corrected in the closing message_delta
                            "usage": {"input_tokens": 0, "output_tokens": 0},
                        }}), event="message_start")
                    self._sse(json.dumps({
                        "type": "content_block_start", "index": 0,
                        "content_block": {"type": "text", "text": ""}}),
                        event="content_block_start")
                    for delta in self._drain(job):
                        self._sse(json.dumps({
                            "type": "content_block_delta", "index": 0,
                            "delta": {"type": "text_delta", "text": delta}}),
                            event="content_block_delta")
                    res = job.result
                    if res.error is not None:
                        self._sse(json.dumps({
                            "type": "error",
                            "error": {"type": "api_error",
                                      "message": res.error}}), event="error")
                        return
                    self._sse(json.dumps({
                        "type": "content_block_stop", "index": 0}),
                        event="content_block_stop")
                    self._sse(json.dumps({
                        "type": "message_delta",
                        "delta": {"stop_reason": _anthropic_stop_reason(res),
                                  "stop_sequence": res.stop_sequence},
                        "usage": {"input_tokens": res.prompt_tokens,
                                  "output_tokens": res.completion_tokens,
                                  **_cost(res)}}),
                        event="message_delta")
                    self._sse(json.dumps({"type": "message_stop"}),
                              event="message_stop")
                except OSError:
                    logger.debug("stream client disconnected; cancelling")
                    outer.batcher.cancel(job)

            def _respond_openai(self, body: dict, res: GenerationResult) -> None:
                if res.error is not None:
                    self._send(500, {"error": {"message": res.error,
                                               "type": "engine_error"}})
                    return
                self._send(200, {
                    "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
                    "object": "chat.completion",
                    "created": int(time.time()),
                    "model": body.get("model") or outer.model_name,
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": res.text},
                        "finish_reason": res.finish_reason,
                    }],
                    "usage": {"prompt_tokens": res.prompt_tokens,
                              "completion_tokens": res.completion_tokens,
                              "total_tokens": res.total_tokens,
                              **_cost(res)},
                })

            def _respond_anthropic(self, body: dict,
                                   res: GenerationResult) -> None:
                if res.error is not None:
                    self._send(500, {"type": "error",
                                     "error": {"type": "api_error",
                                               "message": res.error}})
                    return
                self._send(200, {
                    "id": f"msg_{uuid.uuid4().hex[:24]}",
                    "type": "message",
                    "role": "assistant",
                    "model": body.get("model") or outer.model_name,
                    "content": [{"type": "text", "text": res.text}],
                    "stop_reason": _anthropic_stop_reason(res),
                    "stop_sequence": res.stop_sequence,
                    "usage": {"input_tokens": res.prompt_tokens,
                              "output_tokens": res.completion_tokens,
                              **_cost(res)},
                })

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]

    def prefix_summary(self) -> list[dict] | None:
        """The engine's radix summary (None when it has none, or the hook
        broke: health must answer regardless)."""
        summary = getattr(self.engine, "prefix_summary", None)
        if summary is None:
            return None
        try:
            return summary()
        except Exception:  # noqa: BLE001 - stay healthy
            logger.debug("prefix summary failed", exc_info=True)
            return None

    # ------------------------------------------- job and session plumbing

    def _job_http(self, method: str, path: str, body: dict | None,
                  trace_id: str | None = None,
                  tenant: str | None = None):
        """The /v1/jobs surface: returns ``(status, payload)``.

        Local-first: a configured JobManager answers here.  Without one,
        an engine exposing ``job_request`` (RouterEngine) forwards to the
        backend fleet: jobs live next to the engine that runs them, so
        their journals survive that host's restarts.  Neither: 501.
        ``trace_id`` (the submit header) rides into the job journal."""
        if self.jobs is None:
            forward = getattr(self.engine, "job_request", None)
            if forward is not None:
                try:
                    return forward(method, path, body, trace_id=trace_id,
                                   tenant=tenant)
                except Exception as e:  # noqa: BLE001 - marked, never a 500 crash
                    logger.exception("job forward failed")
                    return 502, {"error": {
                        "message": f"job forward failed: "
                                   f"{type(e).__name__}: {e}",
                        "type": "job_error"}}
            return 501, {"error": {
                "message": "job API disabled on this host; start "
                           "lmrs-serve-torch with --jobs-dir (or "
                           "LMRS_JOBS_DIR)",
                "type": "job_error"}}
        if method == "POST":
            transcript = (body or {}).get("transcript")
            if not isinstance(transcript, dict) or not isinstance(
                    transcript.get("segments"), list):
                return 400, {"error": {
                    "message": "body needs transcript.segments (a transcript "
                               "JSON object), plus optional params",
                    "type": "job_error"}}
            try:
                job = self.jobs.submit(transcript,
                                       (body or {}).get("params"),
                                       trace_id=trace_id, tenant=tenant)
            except ValueError as e:  # unknown/malformed param values
                return 400, {"error": {"message": str(e),
                                       "type": "job_error"}}
            except Exception as e:  # noqa: BLE001 - e.g. jobs_dir disk full:
                # a 5xx body, never a dropped connection
                logger.exception("job submit failed")
                return 500, {"error": {
                    "message": f"job submit failed: {type(e).__name__}: {e}",
                    "type": "job_error"}}
            return 200, self.jobs.status_doc(job)
        if method == "GET" and path == "/v1/jobs":
            return 200, {"object": "list",
                         "data": [self.jobs.status_doc(j)
                                  for j in self.jobs.jobs()]}
        jid = path.split("/v1/jobs/", 1)[-1].strip("/")
        job = self.jobs.get(jid)
        if job is None:
            return 404, {"error": {"message": f"no job {jid}",
                                   "type": "job_error"}}
        if method == "DELETE":
            job = self.jobs.cancel(jid) or job
        return 200, self.jobs.status_doc(job)

    def _session_http(self, method: str, path: str, body: dict | None,
                      trace_id: str | None = None, query: str = "",
                      tenant: str | None = None):
        """The /v1/sessions surface: returns ``(status, payload)``.

        Local-first like jobs: a configured SessionManager answers here;
        without one, an engine exposing ``session_request``
        (RouterEngine) forwards to the backend fleet sticky by session id
        (a session's journal and its warm prefix tree live with the
        backend that runs it).  Neither: 501."""
        if self.live is None:
            forward = getattr(self.engine, "session_request", None)
            if forward is not None:
                try:
                    full = path + (f"?{query}" if query else "")
                    return forward(method, full, body, trace_id=trace_id,
                                   tenant=tenant)
                except Exception as e:  # noqa: BLE001 - marked, never a crash
                    logger.exception("session forward failed")
                    return 502, {"error": {
                        "message": f"session forward failed: "
                                   f"{type(e).__name__}: {e}",
                        "type": "session_error"}}
            return 501, {"error": {
                "message": "session API disabled on this host; start "
                           "lmrs-serve-torch with --live-dir (or "
                           "LMRS_LIVE_DIR)",
                "type": "session_error"}}
        body = body or {}
        try:
            if method == "POST" and path.rstrip("/") == "/v1/sessions":
                session = self.live.create(body.get("params"),
                                           session_id=body.get("session_id"),
                                           trace_id=trace_id,
                                           tenant=tenant)
                return 200, self.live.status_doc(session)
            if method == "GET" and path.rstrip("/") == "/v1/sessions":
                return 200, {"object": "list",
                             "data": [self.live.status_doc(s)
                                      for s in self.live.sessions()]}
            rest = path.split("/v1/sessions/", 1)[-1].strip("/")
            sid, _, sub = rest.partition("/")
            if not sid:
                return 404, {"error": {"message": f"no route {path}",
                                       "type": "session_error"}}
            if self.live.get(sid) is None:
                # cross-host resume: an unknown session may have a journal
                # in a SHARED live directory, written by a drained or
                # killed sibling; rehydrate it before answering 404
                self.live.recover_one(sid)
            if method == "POST" and sub == "segments":
                return 200, self.live.append(sid, body.get("segments"),
                                             refresh=body.get("refresh"),
                                             klass=body.get("class"))
            if method == "POST" and sub == "refresh":
                return 200, self.live.refresh(sid, body.get("class"))
            if method == "GET" and sub == "summary":
                from urllib.parse import parse_qs

                q = parse_qs(query or "")
                if q.get("refresh", ["0"])[-1] not in ("0", "false", ""):
                    self.live.refresh(sid, (q.get("class") or [None])[-1])
                return 200, self.live.summary_doc(sid)
            if method == "GET" and not sub:
                session = self.live.get(sid)
                if session is None or session.closed:
                    raise KeyError(sid)
                return 200, self.live.status_doc(session)
            if method == "DELETE" and not sub:
                session = self.live.close(sid)
                if session is None:
                    raise KeyError(sid)
                return 200, {"object": "session", "id": sid,
                             "status": "closed"}
            return 404, {"error": {"message": f"no route {method} {path}",
                                   "type": "session_error"}}
        except KeyError:
            return 404, {"error": {"message": f"no session {sid}",
                                   "type": "session_error"}}
        except ValueError as e:
            return 400, {"error": {"message": str(e),
                                   "type": "session_error"}}
        except Exception as e:  # noqa: BLE001 - a 5xx body, never a crash
            logger.exception("session request failed")
            return 500, {"error": {
                "message": f"session request failed: "
                           f"{type(e).__name__}: {e}",
                "type": "session_error"}}

    # ------------------------------------------------- handoff plumbing

    def _fetch_blob(self, path: str, source: str, kind: str,
                    site: str | None = None):
        """GET a payload blob from ``source`` and decode it: ``(payload,
        None)`` or ``(None, (status, error body))`` — a marked failure the
        router falls back from, never an empty success."""
        conn = None
        try:
            conn = http.client.HTTPConnection(source, timeout=30.0)
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                return None, (502, _handoff_error(
                    f"payload fetch from {source} failed: HTTP "
                    f"{resp.status}", kind))
            data = resp.read(1 << 16)
            if site:
                # injection site: the transfer dies MID-PAYLOAD, after the
                # first body read (one occurrence a transfer); the import
                # is a marked failure
                faults.fire(site, OSError)
            data += resp.read()
            return decode_payload(data), None
        except (OSError, http.client.HTTPException, ValueError) as e:
            return None, (502, _handoff_error(
                f"transfer from {source} failed: {type(e).__name__}: {e}",
                kind))
        finally:
            if conn is not None:
                conn.close()

    def _fetch_handoff(self, desc: dict):
        """Pull a handoff payload from its source, dedup against tickets
        imported here, and ack it.  ``(payload, None)`` or ``(None,
        (status, error body))``."""
        tid, source = desc.get("ticket"), desc.get("source")
        if not tid or not source:
            return None, (400, _handoff_error(
                "handoff descriptor needs ticket + source"))
        if self._imported.seen(tid):
            self._c_dup_rejects.inc()
            return None, (409, _handoff_error(
                f"duplicate handoff import of ticket {tid} (already "
                "imported on this host)"))
        t0 = time.time()
        payload, err = self._fetch_blob(f"/v1/handoff/{tid}", source,
                                        "handoff_error",
                                        site="handoff.transfer")
        if err is not None:
            return None, err
        self._h_transfer.observe(time.time() - t0)
        if not self._imported.add(tid):  # raced a concurrent duplicate
            self._c_dup_rejects.inc()
            return None, (409, _handoff_error(
                f"duplicate handoff import of ticket {tid}"))
        if not self._send_ack(f"/v1/handoff/{tid}/ack", source,
                              site="handoff.ack"):
            self._c_ack_failures.inc()
        return payload, None

    def _send_ack(self, path: str, source: str,
                  site: str | None = None) -> bool:
        """Ack an import so the source releases its pins; one retry.  A
        lost ack is not the request's failure: the source's orphan sweep
        reclaims the pins at the ticket deadline.  ``site`` names the
        injection site each attempt fires."""
        for attempt in range(2):
            conn = None
            try:
                if site:
                    # injection site: the ack vanishes on the wire (pages
                    # stay pinned until the orphan sweep)
                    faults.fire(site, OSError)
                conn = http.client.HTTPConnection(source, timeout=5.0)
                conn.request("POST", path)
                resp = conn.getresponse()
                resp.read()
                return resp.status == 200  # 410: retrying will not help
            except (OSError, http.client.HTTPException) as e:
                logger.warning("ack %s to %s failed (attempt %d): %s: %s",
                               path, source, attempt + 1,
                               type(e).__name__, e)
            finally:
                if conn is not None:
                    conn.close()
            time.sleep(0.05 * (attempt + 1))
        logger.warning("ack %s to %s lost; the source's orphan sweep "
                       "reclaims its pins", path, source)
        return False

    def sweep_handoffs(self, now: float | None = None) -> int:
        """One orphan-sweep pass: expired un-acked handoff tickets release
        their pins, expired page-set blobs drop, and the engine's own TTL
        sweep backstops pins whose ticket was never minted.  Returns what
        was released."""
        released = 0
        release = getattr(self.engine, "release_handoff", None)
        for tid, rid, consumed in self.handoff.sweep(now):
            if not consumed and release is not None:
                released += release(rid, orphaned=True)
                logger.warning("handoff ticket %s expired un-acked; pinned "
                               "pages reclaimed", tid)
        for tid, _preamble, consumed in self.kv_tickets.sweep(now):
            with self._kv_lock:
                dropped = self._kv_payloads.pop(tid, None)
            if dropped is not None and not consumed:
                released += 1
        sweep = getattr(self.engine, "sweep_handoffs", None)
        if sweep is not None:
            released += sweep(now)
        return released

    def _sweep_loop(self) -> None:
        interval = max(0.5, self.handoff_ttl_s / 4.0)
        while not self._sweep_stop.wait(interval):
            try:
                self.sweep_handoffs()
            except Exception:  # noqa: BLE001 - the sweeper must survive
                logger.exception("handoff orphan sweep failed")

    def kv_stats(self) -> dict:
        """Page-set ticket state for the JSON ``/metrics``."""
        with self._kv_lock:
            pinned_bytes = sum(len(b) for b in self._kv_payloads.values())
        return {**self.kv_tickets.stats(), "pinned_bytes": pinned_bytes}

    def handoff_stats(self) -> dict:
        return {"role": self.role, **self.handoff.stats(),
                "tickets_published": int(self._c_tickets.value),
                "acks": int(self._c_acks.value),
                "duplicate_rejects": int(self._c_dup_rejects.value),
                "ack_failures": int(self._c_ack_failures.value)}

    def prometheus_text(self) -> str:
        """``GET /metrics`` under ``Accept: text/plain``: the engine's page
        (a router's merged fleet page, else the scheduler's registry) and
        this server's HTTP counters, merged so each family has one
        header."""
        parts: list[str] = []
        prom = getattr(self.engine, "prometheus_metrics", None)
        reg_fn = getattr(self.engine, "metrics_registry", None)
        if prom is not None:
            parts.append(prom())
        elif reg_fn is not None:
            parts.append(reg_fn().render_prometheus())
        reg = MetricsRegistry()
        reg.counter("lmrs_http_batches_total",
                    "engine waves dispatched by the micro-batcher"
                    ).inc(self.batcher.batches_run)
        reg.counter("lmrs_http_requests_total",
                    "HTTP requests served through the batcher"
                    ).inc(self.batcher.requests_served)
        reg.gauge("lmrs_uptime_seconds", "server uptime", "seconds").set(
            time.time() - self.started)
        parts.append(reg.render_prometheus())
        parts.append(self._handoff_reg.render_prometheus())
        if self.jobs is not None:
            parts.append(self.jobs.registry.render_prometheus())
        if self.live is not None:
            parts.append(self.live.registry.render_prometheus())
        return merge_expositions(parts)

    def serve_forever(self) -> None:
        logger.info("serving on http://%s:%d (model=%s)",
                    self.host, self.port, self.model_name)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self._sweep_stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        # the managers before the batcher: their in-flight requests drain
        # (or fast-fail) through a still-open dispatch queue
        if self.jobs is not None:
            self.jobs.shutdown()
        if self.live is not None:
            self.live.shutdown()
        self.batcher.shutdown()


def serve(engine: Engine, host: str = "127.0.0.1", port: int = 8000,
          **kw) -> EngineHTTPServer:
    """Build and serve in the foreground; returns after ``shutdown()``."""
    server = EngineHTTPServer(engine, host, port, **kw)
    server.serve_forever()
    return server
