"""OpenAI- and Anthropic-wire HTTP server over the port's engine (the port
of the reference's ``serving/server.py``, colocated serving only).

Routes, as in the reference (``docs/SERVING.md`` is the contract):

* ``POST /v1/chat/completions`` (OpenAI) and ``POST /v1/messages``
  (Anthropic), plain or ``"stream": true`` (SSE in each wire's dialect);
* ``GET /healthz`` (with the engine's radix ``prefix_summary``),
  ``GET /v1/models``, ``GET /metrics`` (JSON, or Prometheus text under
  ``Accept: text/plain``).

Concurrent requests micro-batch: a dispatcher thread collects the queue for
``batch_window_s`` and hands the wave to ONE ``Engine.generate_batch``;
streamed requests ride the same wave through ``on_tokens``.  Headers:
``X-LMRS-Trace`` (adopted, else minted), ``X-LMRS-Deadline`` (relative
seconds, anchored at ingress; garbage is a 400).  A client that goes away
cancels its request through the engine's ``cancel`` hook.

Not in the port yet, refused by name: ``/v1/jobs*`` and ``/v1/sessions*``
answer 501 (durable jobs and live sessions, A13); ``/v1/handoff/*``,
``/v1/kv/*`` and a ``handoff`` body field (KV movement, A4), and
``/v1/usage``, ``/v1/anatomy``, ``/v1/trace`` and ``/v1/debug/profile``
(observability, A10) answer with an error naming the slice.  The
``X-LMRS-Tenant`` and ``X-LMRS-QoS-Class`` headers are accepted and not
acted on: their consumers, the cost ledger and QoS, are A10's.

Standard library only (``http.server``).
"""

from __future__ import annotations

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
from lmrs_tpu_torch.obs import MetricsRegistry, merge_expositions, new_trace_id

logger = logging.getLogger("lmrs_torch.serving")

# X-LMRS-Trace values: a safe alphabet and length, else a fresh id is minted
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")

_A4 = "KV movement (A4)"
_A10 = "observability (A10)"
_A13 = "durable jobs and live sessions (A13)"
# GET/POST route prefix -> the slice that brings it
_LATER_ROUTES = (("/v1/handoff/", _A4), ("/v1/kv/", _A4),
                 ("/v1/usage", _A10), ("/v1/anatomy", _A10),
                 ("/v1/trace", _A10), ("/v1/debug/profile", _A10))


def clean_trace_id(raw) -> str | None:
    """A wire-supplied trace id, validated; None when absent or garbage."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _TRACE_ID_RE.match(raw) else None


def _not_ported(what: str, later: str) -> dict:
    return {"error": {"message": f"{what} is not in the port yet; it "
                                 f"arrives with the {later} slice",
                      "type": "not_ported"}}


class _Job:
    __slots__ = ("request", "result", "event", "deltas", "rid", "cancelled")

    def __init__(self, request: GenerationRequest, stream: bool = False):
        self.request = request
        self.result: GenerationResult | None = None
        self.event = threading.Event()
        # streaming jobs: the dispatcher routes on_tokens deltas here; a
        # None sentinel, pushed AFTER ``result`` is set, ends the stream
        self.deltas: queue.Queue[str | None] | None = (
            queue.Queue() if stream else None)
        self.rid: int | None = None  # set at enqueue
        self.cancelled = False  # set by _Batcher.cancel (handler threads)

    def finish(self, result: GenerationResult) -> None:
        self.result = result
        self.event.set()
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

    def _run(self, jobs: list[_Job]) -> None:
        # publish the wave BEFORE dispatch so cancel() can reach it, then
        # drop the jobs cancelled while queued (no engine work for them)
        self._inflight = {j.rid: j for j in jobs}
        for job in jobs:
            if job.cancelled:
                job.finish(GenerationResult(request_id=job.rid,
                                            finish_reason="cancelled"))
        jobs = [j for j in jobs if not j.cancelled]
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
                 max_tokens_cap: int = 4096, batch_window_s: float = 0.02):
        self.engine = engine
        self.model_name = model_name
        self.max_tokens_cap = max_tokens_cap
        self.batcher = _Batcher(engine, window_s=batch_window_s)
        self.started = time.time()
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

            def _later_route(self) -> bool:
                """Answer a route of a later slice: 501 for jobs and
                sessions (as the reference with them off), 404 naming the
                slice for the rest.  False when the path is none of them."""
                path = self.path.split("?", 1)[0]
                if path in ("/v1/jobs", "/v1/sessions") or path.startswith(
                        ("/v1/jobs/", "/v1/sessions/")):
                    what = "job" if path.startswith("/v1/jobs") else "session"
                    self._send(501, _not_ported(f"the {what} API", _A13))
                    return True
                for prefix, later in _LATER_ROUTES:
                    if path == prefix.rstrip("/") or path.startswith(prefix):
                        self._send(404, _not_ported(f"route {path}", later))
                        return True
                return False

            def do_GET(self):
                if self.path == "/healthz":
                    payload = {"status": "ok", "wedged": False, "role": "both",
                               "uptime_s": round(time.time() - outer.started, 1)}
                    summary = outer.prefix_summary()
                    if summary is not None:
                        payload["prefix_summary"] = summary
                    self._send(200, payload)
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
                               "http_requests": outer.batcher.requests_served}
                    summary = outer.prefix_summary()
                    if summary is not None:
                        payload["prefix_summary"] = summary
                    self._send(200, payload)
                elif not self._later_route():
                    self._no_route()

            def do_DELETE(self):
                if not self._later_route():
                    self._no_route()

            def _client_gone(self) -> bool:
                """Disconnect probe for non-streaming waits: a MSG_PEEK read
                returning b'' means the peer sent FIN (a half-closed client
                reads as gone, as in the reference)."""
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
                req.trace_id = (clean_trace_id(self.headers.get("X-LMRS-Trace"))
                                or new_trace_id())
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
                if body.get("handoff") not in (None, False):
                    self._send(409, _not_ported("disaggregated handoff", _A4))
                    return False
                return True

            def do_POST(self):
                if self._later_route():
                    return
                body = self._read_json()
                if body is None:
                    self._send(400, {"error": {"message": "invalid JSON body"}})
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
                                     "total_tokens": res.total_tokens}
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
                                  "output_tokens": res.completion_tokens}}),
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
                              "total_tokens": res.total_tokens},
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
                              "output_tokens": res.completion_tokens},
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

    def prometheus_text(self) -> str:
        """``GET /metrics`` under ``Accept: text/plain``: the engine's page
        (a router's merged fleet page) and this server's HTTP counters,
        merged so each family has one header."""
        parts: list[str] = []
        prom = getattr(self.engine, "prometheus_metrics", None)
        if prom is not None:
            parts.append(prom())
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
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()


def serve(engine: Engine, host: str = "127.0.0.1", port: int = 8000,
          **kw) -> EngineHTTPServer:
    """Build and serve in the foreground; returns after ``shutdown()``."""
    server = EngineHTTPServer(engine, host, port, **kw)
    server.serve_forever()
    return server
