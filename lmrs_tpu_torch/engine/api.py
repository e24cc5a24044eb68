"""Engine protocol of the port: requests, results, the deadline and
degraded-result helpers, post-hoc streaming delivery, the tenant and
draft-hint stamp of jobs and sessions and the engine factory (trimmed copy
of the reference's ``engine/api.py``).  The factory builds
the ``"torch"`` engine, the ``"mock"`` engine (``engine/mock.py``) and the
``"http"`` router over running servers (``serving/router.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:
    from lmrs_tpu_torch.config import EngineConfig, ModelConfig


@dataclass
class GenerationRequest:
    """One unit of generation work."""

    prompt: str
    request_id: int = 0
    system_prompt: str | None = None
    max_new_tokens: int = 1000
    temperature: float = 0.3
    top_p: float = 1.0
    top_k: int = 0
    stop: tuple[str, ...] = ()
    seed: int | None = None
    # Prefix-cache hint (engine/prefix_cache.py): how many LEADING CHARACTERS
    # of ``prompt`` are expected to be shared with other requests (the map /
    # reduce preamble before per-chunk content).  None = no hint, cache the
    # whole full-page prompt prefix; 0 = the prompt body shares nothing (a
    # shared system prompt, encoded ahead of the prompt, is still cached);
    # negative = never cache this request's prefix.  Approximate by design:
    # the cap is rounded up to a KV page at token level.
    cache_prefix: int | None = None
    # Absolute deadline (``time.time()`` epoch seconds) after which the
    # result is worthless to its caller; None = unbounded.  A request whose
    # remaining budget cannot cover the engine's TTFT estimate is shed
    # before prefill (``finish_reason="shed"``, no engine work); one that
    # expires in flight finishes at the next block boundary with
    # ``finish_reason="deadline"``, keeping the tokens generated so far;
    # executor retries clip to the remaining budget.
    deadline_s: float | None = None
    # Distributed trace id: minted at ingress (the HTTP server reads the
    # ``X-LMRS-Trace`` header or mints one; the router mints for callers
    # that carry none) and resent on every forward and retry, so one
    # request is one trace across hosts.  None for engine-direct callers.
    trace_id: str | None = None
    # Disaggregated prefill→decode handoff.  ``handoff_export=True``: run
    # prefill and the first token only, then PIN the sequence's KV pages
    # for export instead of freeing them; the result comes back
    # ``finish_reason="handoff"`` and the pages stay held until
    # ``release_handoff`` (the decode side's ack) or the orphan sweep.
    # ``handoff_state``: an imported payload dict (in-process only): the
    # engine resumes decoding from the transferred pages and first token
    # instead of prefilling.
    handoff_export: bool = False
    handoff_state: dict | None = None
    # Cost-attribution label, adopted at ingress from ``X-LMRS-Tenant`` and
    # resent on forwards; jobs and live sessions stamp their own identity
    # (``TenantStampEngine``); the cost ledger rolls usage up under it.
    tenant: str | None = None
    # QoS priority class (fleet/qos.py): "interactive" | "batch".  Stamped
    # at ingress from ``X-LMRS-QoS-Class`` (or the body's ``qos_class``)
    # and propagated like the tenant label; jobs stamp their fan-out
    # "batch", live sessions by session class.  None resolves to
    # "interactive", so QoS never demotes traffic that carries no label.
    # Stamping happens only while LMRS_QOS is armed, so the kill switch
    # keeps the wire byte-identical.
    qos_class: str | None = None
    # Cross-refresh draft hint: text whose tokens are likely to recur in
    # the completion (a live session passes its previous summary).  Under
    # tree speculation the scheduler seeds it ahead of the row's token
    # history in the draft buffer, so the n-gram lookup drafts from it.
    # Advisory only: verification is exact, so outputs do not change.
    draft_hint: str | None = None


def preamble_text(system_prompt: str | None, prompt: str,
                  cache_prefix: int | None) -> str:
    """A request's SHARED-PREAMBLE text region: the system prompt plus the
    ``cache_prefix``-hinted head of the prompt — exactly the region the
    scheduler donates to the prefix cache.  Empty when the hint is
    negative (the request declares nothing shared)."""
    if cache_prefix is not None and cache_prefix < 0:
        return ""
    head = prompt[:cache_prefix] if cache_prefix is not None else ""
    return ((system_prompt + "\n\n") if system_prompt else "") + head


def preamble_key(system_prompt: str | None, prompt: str,
                 cache_prefix: int | None) -> str | None:
    """Stable hash of ``preamble_text``; None when the request declares
    nothing shared (negative hint, or the preamble text is empty)."""
    text = preamble_text(system_prompt, prompt, cache_prefix)
    if not text:
        return None
    import hashlib

    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()[:16]


def remaining_budget(req: GenerationRequest,
                     now: float | None = None) -> float | None:
    """Seconds of deadline budget left (negative = expired); None when the
    request carries no deadline.  Shared by admission shedding and the
    executor's retry clip."""
    if req.deadline_s is None:
        return None
    import time

    return req.deadline_s - (time.time() if now is None else now)


@dataclass
class GenerationResult:
    """Completion + accounting."""

    request_id: int
    text: str = ""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # stop | length | error | cancelled | deadline | shed | handoff.
    # "handoff" is not client-terminal: the request stopped after its
    # first token with its pages pinned for export (``handoff_export``);
    # the serving layer turns it into a ticket.  "cancelled":
    # aborted by ``cancel()``, tokens generated so far kept; "deadline":
    # expired in flight (partial text kept) or, as a queued preemption
    # continuation, with its prior tokens; "shed": rejected at admission
    # before any engine work.  Engine-side none of the three sets
    # ``error`` (they are outcomes, not faults to retry); the one exception
    # is the executor's retry clip, which marks a request that FAILED and
    # then ran out of budget to retry with both finish_reason="deadline"
    # and the error, so the failure stays visible.
    finish_reason: str = "stop"
    stop_sequence: str | None = None
    device_seconds: float = 0.0
    error: str | None = None
    # The cost ledger's bill for this request (obs/ledger.py
    # ``CostLedger.finish``): device-seconds by phase, tokens, tokens
    # saved, page-seconds, queue wait and the tenant.  None when the
    # ledger is off or the engine keeps none.
    usage: dict | None = None

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


def degraded_reason(res: GenerationResult) -> str | None:
    """Why this result carries NO usable content, or None when it does:
    the error itself, or a content-less terminal (``shed`` / ``deadline``
    / ``cancelled`` with no text).  The pipeline branches on this, not on
    ``res.error``: a shed map chunk must not pass as an empty summary.  A
    deadline or cancel result that carries partial text is usable."""
    if res.error is not None:
        return res.error
    if res.finish_reason in ("shed", "deadline", "cancelled") and not res.text:
        return f"request {res.finish_reason} before any output"
    return None


def apply_stop_sequences(text: str, stops: tuple[str, ...]) -> tuple[str, str | None]:
    """Truncate ``text`` at the earliest-in-text stop string (ties broken by
    list order).  Returns (truncated_text, stop_hit_or_None).  Empty stop
    strings are skipped."""
    best_pos, best_stop = len(text) + 1, None
    for stop in stops:
        if not stop:
            continue
        pos = text.find(stop)
        if pos != -1 and pos < best_pos:
            best_pos, best_stop = pos, stop
    if best_stop is None:
        return text, None
    return text[:best_pos], best_stop


@runtime_checkable
class Engine(Protocol):
    """Batch generation backend (see ``TorchEngine``)."""

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None, on_tokens=None) -> list[GenerationResult]:
        """Generate every request (and any ``on_result(result, submit)``
        submits).  ``on_tokens(request_id, text_delta)``, when given, fires
        as text becomes available: at each host fetch on the continuous
        scheduler, one whole-text delta elsewhere; the deltas of a request
        join to its result's ``text``."""
        ...

    def shutdown(self) -> None: ...

    def engine_metrics(self) -> dict: ...


def drain_with_callback(run_batch, requests: list[GenerationRequest],
                        on_result) -> list[GenerationResult]:
    """Streaming semantics for engines without a mid-run hook: run a wave,
    deliver each result through ``on_result(result, submit)``, collect what
    the callback submits, repeat until nothing is left."""
    all_results: list[GenerationResult] = []
    pending = list(requests)
    submitted: list[GenerationRequest] = []

    def submit(new_requests: list[GenerationRequest]) -> None:
        submitted.extend(new_requests)

    while pending:
        results = run_batch(pending)
        all_results.extend(results)
        for res in results:
            on_result(res, submit)
        pending, submitted = submitted, []
    return all_results


class TenantStampEngine:
    """Engine facade that (a) stamps ``tenant``, ``qos_class`` and
    ``draft_hint`` onto every request that carries none (how jobs and live
    sessions bill their chunk and reduce traffic to their own identity,
    rank it in the fair-share policy, and how a refresh threads its
    previous summary to the draft buffer) and (b) accumulates
    every result's ledger ``usage`` block into one rollup dict
    (``obs.merge_usage``), the ``usage`` block of the job and session
    status docs.  ``publish`` receives a snapshot dict after every merge
    (readers hold a reference that is replaced, never mutated); ``seed``
    carries a prior rollup forward across refreshes and resumes.  Every
    other attribute passes through to the wrapped engine."""

    def __init__(self, engine: Engine, tenant: str | None,
                 publish=None, seed: dict | None = None,
                 qos_class: str | None = None,
                 draft_hint: str | None = None):
        import threading

        from lmrs_tpu_torch.fleet.qos import qos_enabled

        self._engine = engine
        self.tenant = tenant
        # jobs pass "batch", live sessions their session's class; applied
        # only while LMRS_QOS is armed and never over a submit's own label
        self.qos_class = qos_class if qos_enabled() else None
        self.draft_hint = draft_hint or None
        self.usage_rollup: dict = dict(seed or {})  # guarded-by: _rollup_lock
        self._publish = publish
        self._rollup_lock = threading.Lock()

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None, on_tokens=None):
        self._stamp(requests)

        def absorb(res: GenerationResult) -> None:
            if res.usage:
                from lmrs_tpu_torch.obs.ledger import merge_usage

                with self._rollup_lock:
                    merge_usage(self.usage_rollup, res.usage)
                    snap = dict(self.usage_rollup)
                if self._publish is not None:
                    self._publish(snap)

        if on_result is None:
            out = self._engine.generate_batch(requests, on_tokens=on_tokens)
            for res in out:
                absorb(res)
            return out

        def wrapped(res, submit):
            absorb(res)

            def stamped_submit(more: list[GenerationRequest]) -> None:
                self._stamp(more)
                submit(more)

            on_result(res, stamped_submit)

        return self._engine.generate_batch(requests, on_result=wrapped,
                                           on_tokens=on_tokens)

    def _stamp(self, requests: list[GenerationRequest]) -> None:
        for req in requests:
            if self.tenant and req.tenant is None:
                req.tenant = self.tenant
            if self.qos_class and req.qos_class is None:
                req.qos_class = self.qos_class
            if self.draft_hint and req.draft_hint is None:
                req.draft_hint = self.draft_hint

    def __getattr__(self, name: str):
        return getattr(self._engine, name)


HTTP_NEEDS_HOSTS = (
    "backend='http' needs hosts (--hosts host:port,... or LMRS_HOSTS; role "
    "pools via LMRS_PREFILL_HOSTS/LMRS_DECODE_HOSTS): the addresses of "
    "running lmrs-serve processes")


def make_engine(engine_cfg: "EngineConfig",
                model_cfg: "ModelConfig | None" = None,
                device=None, tokenizer=None) -> Engine:
    """Engine factory keyed on ``EngineConfig.backend``: ``"torch"`` on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), ``"mock"`` and
    ``"http"`` (neither touches a device).  A non-empty
    ``engine_cfg.fault_plan`` arms the fault-injection plane for the
    process first (idempotent per plan string)."""
    if engine_cfg.fault_plan:
        from lmrs_tpu_torch.testing import faults

        faults.install_spec(engine_cfg.fault_plan)
    if engine_cfg.backend == "mock":
        from lmrs_tpu_torch.engine.mock import MockEngine

        return MockEngine(seed=engine_cfg.seed,
                          handoff_ttl_s=engine_cfg.handoff_ttl_s,
                          mixed_batch=engine_cfg.mixed_batch,
                          mixed_token_budget=engine_cfg.mixed_token_budget,
                          prefix_cache=engine_cfg.prefix_cache,
                          host_kv=engine_cfg.host_kv,
                          host_kv_gb=engine_cfg.host_kv_gb,
                          speculate_k=engine_cfg.speculate_k)
    if engine_cfg.backend == "http":
        from lmrs_tpu_torch.serving.router import RouterEngine

        if not (engine_cfg.hosts or engine_cfg.prefill_hosts
                or engine_cfg.decode_hosts):
            raise ValueError(HTTP_NEEDS_HOSTS)
        # the router's timeout is a per-recv socket timeout, and a
        # non-streamed generation sends nothing until it completes: floor
        # it at the router's own worst-case-generation default
        return RouterEngine(list(engine_cfg.hosts),
                            timeout_s=max(engine_cfg.request_timeout, 600.0),
                            prefill_hosts=list(engine_cfg.prefill_hosts),
                            decode_hosts=list(engine_cfg.decode_hosts))
    if engine_cfg.backend != "torch":
        raise ValueError(f"unknown engine backend {engine_cfg.backend!r}")
    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    if model_cfg is None:
        model_cfg = model_preset(engine_cfg.model)
    return TorchEngine(engine_cfg, model_cfg, device=device,
                       tokenizer=tokenizer)
