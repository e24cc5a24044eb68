"""Map-stage executor (the port of the reference's ``engine/executor.py``):
chunks become requests, the engine runs them, results land on the chunks.

* Request cap: engines without their own admission control get waves of
  at most ``max_concurrent_requests``; an engine that schedules internally
  (``TorchEngine``) gets the whole queue at once.
* Retries: failed requests are retried up to ``retry_attempts``, after
  ``retry_delay`` seconds clipped to the soonest remaining deadline budget;
  ``cancel`` and ``interrupt`` wake the backoff.  The streaming path
  resubmits a failed request into the same engine stream at once.
* Degrade-and-continue: an engine exception turns its batch into error
  results (logged with the traceback); a request that exhausts its retries
  gets an error result, never an exception.
* Multi-transcript batching: ``process_chunk_groups`` pools several
  transcripts' chunks into one queue, interleaved round-robin.
* Engine-side ids: each run offsets caller ids by an epoch base (run N uses
  ``[N << 20, (N + 1) << 20)``; retry clones sit just below the base), so
  every id the engine sees is unique in the process and a stale cancel
  never aliases a later request.  Caller ids must lie in ``[0, 2**19)``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import replace
from typing import Sequence

from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.data.chunker import Chunk
from lmrs_tpu_torch.engine.api import (Engine, GenerationRequest,
                                       GenerationResult, degraded_reason,
                                       remaining_budget)
from lmrs_tpu_torch.obs.trace import PID_PIPELINE, get_tracer
from lmrs_tpu_torch.prompts import safe_format, shared_prefix_chars

logger = logging.getLogger("lmrs_torch.executor")

_ID_LIMIT = 1 << 19


class MapExecutor:
    """Runs the map stage (and the reduce tree's request lists)."""

    def __init__(self, engine: Engine, config: EngineConfig | None = None):
        self.engine = engine
        self.config = config or EngineConfig()
        self.total_tokens_used = 0
        self.total_device_seconds = 0.0
        self.total_requests = 0
        self.failed_requests = 0
        # run-scoped cancel state: caller ids are reused across runs (map
        # chunks and reduce nodes both count from 0), so a cancel targets
        # the run in flight only; the lock orders cancel()'s liveness check
        # against the run-start clear and the run-end flag
        self._cancelled: set[int] = set()
        self._run_live = False
        self._cancel_lock = threading.Lock()
        self._epoch = 0
        self._rid_base = 0
        # caller id -> engine id of its live streaming retry clone
        self._live_clone: dict[int, int] = {}
        # wakes the retry backoff early; _interrupted skips every later
        # backoff of the run too
        self._wake = threading.Event()
        self._interrupted = False

    def cancel(self, request_id: int) -> None:
        """Abort ``request_id`` of the current run: it is never retried, a
        live retry clone is chased through the engine's ``cancel``, and a
        sleeping backoff wakes.  Callable from any thread; a no-op with no
        run in flight."""
        with self._cancel_lock:
            if not self._run_live:
                return
            self._cancelled.add(request_id)
            engine_rid = self._rid_base + request_id
            clone = self._live_clone.get(request_id)
        self._wake.set()
        eng_cancel = getattr(self.engine, "cancel", None)
        if eng_cancel is not None:
            eng_cancel(engine_rid)
            if clone is not None:
                eng_cancel(clone)

    def interrupt(self) -> None:
        """Wake any retry backoff in progress and skip the rest of this
        run's backoffs (shutdown paths); cleared at the next run's start."""
        self._interrupted = True
        self._wake.set()

    def _start_run(self) -> int:
        """Reset the run-scoped cancel state and advance to the next
        engine-id epoch; returns the run's base."""
        with self._cancel_lock:
            self._cancelled.clear()
            self._live_clone.clear()
            self._rid_base = self._epoch
            self._epoch += 1 << 20
            self._interrupted = False
            self._run_live = True
            return self._rid_base

    def _end_run(self) -> None:
        with self._cancel_lock:
            self._run_live = False

    @staticmethod
    def _check_ids(reqs: list[GenerationRequest]) -> None:
        for r in reqs:
            if not 0 <= r.request_id < _ID_LIMIT:
                raise ValueError(f"request_ids must be in [0, {_ID_LIMIT}) "
                                 f"(got {r.request_id}); the engine-boundary "
                                 "epoch reserves the rest")

    @staticmethod
    def _cancelled_result(rid: int, res: GenerationResult) -> GenerationResult:
        """A cancelled id reports ``cancelled``; text and tokens survive only
        from a completed attempt, and no error surfaces."""
        ok = res.error is None
        return GenerationResult(
            request_id=rid, text=res.text if ok else "",
            prompt_tokens=res.prompt_tokens if ok else 0,
            completion_tokens=res.completion_tokens if ok else 0,
            finish_reason="cancelled")

    def _stamp_deadlines(self, reqs: list[GenerationRequest]) -> None:
        """Give the config's deadline budget to requests that carry none:
        the one place ``request_deadline_s`` enters the request stream."""
        budget = self.config.request_deadline_s
        if budget and budget > 0:
            now = time.time()
            for r in reqs:
                if r.deadline_s is None:
                    r.deadline_s = now + budget

    # ------------------------------------------------------------------ map

    def process_chunks(self, chunks: Sequence[Chunk], prompt_template: str,
                       summary_type: str = "summary",
                       system_prompt: str | None = None) -> list[Chunk]:
        """Summarize every chunk in place; returns chunks by chunk_index."""
        self.process_chunk_groups([chunks], prompt_template, summary_type,
                                  system_prompt)
        return sorted(chunks, key=lambda c: c.chunk_index)

    def process_chunk_groups(self, groups: Sequence[Sequence[Chunk]],
                             prompt_template: str,
                             summary_type: str = "summary",
                             system_prompt: str | None = None) -> None:
        """Summarize every chunk of every group through ONE request queue,
        summaries written onto the chunks in place.  Groups interleave
        round-robin (admission is FIFO: whole groups in order would make
        the last transcript's first chunk wait behind every other chunk);
        request ids are unique in the pool, not chunk indices."""
        t0 = time.time()
        requests, flat = [], []
        queues = [list(chunks) for chunks in groups]
        while any(queues):
            for g in queues:
                if not g:
                    continue
                chunk = g.pop(0)
                requests.append(self.build_map_request(
                    chunk, prompt_template, summary_type, system_prompt,
                    request_id=len(flat)))
                flat.append(chunk)
        failed = 0
        for chunk, res in zip(flat, self.run_requests(requests)):
            # shed/deadline terminals carry no error but may carry no
            # content either: an empty summary must be marked
            reason = degraded_reason(res)
            if reason is not None:
                chunk.summary = f"[Error processing chunk: {reason}]"
                chunk.error = reason
                failed += 1
            else:
                chunk.summary = res.text
            chunk.tokens_used = res.total_tokens
            chunk.device_seconds = res.device_seconds
        tr = get_tracer()
        if tr:
            tr.complete("map_stage", t0, time.time(), pid=PID_PIPELINE,
                        args={"chunks": len(flat), "groups": len(groups),
                              "failed": failed})
        logger.info("map stage: %d chunks (%d groups) in %.2fs (%d failed)",
                    len(flat), len(groups), time.time() - t0, failed)

    def build_map_request(self, chunk: Chunk, prompt_template: str,
                          summary_type: str = "summary",
                          system_prompt: str | None = None,
                          request_id: int = 0) -> GenerationRequest:
        """One chunk -> one map request (the barrier and streaming paths
        both build map prompts here)."""
        prompt = safe_format(prompt_template,
                             transcript=chunk.text_with_context,
                             summary_type=summary_type)
        return GenerationRequest(
            prompt=prompt, request_id=request_id,
            system_prompt=chunk.system_prompt or system_prompt,
            max_new_tokens=self.config.max_tokens,
            temperature=self.config.temperature, seed=self.config.seed,
            # prefix-cache hint: everything before the per-chunk transcript
            # substitution is the map preamble every chunk shares
            cache_prefix=shared_prefix_chars(
                prompt_template, "transcript", summary_type=summary_type))

    # ----------------------------------------------------- request plumbing

    def run_requests(self, requests: list[GenerationRequest]) -> list[GenerationResult]:
        """Waves + retries + accounting; results in request order.  An
        engine that schedules internally gets the whole queue at once (a
        barrier between waves would leave its slots draining idle)."""
        if getattr(self.engine, "schedules_internally", False):
            wave = max(1, len(requests))
        else:
            wave = max(1, self.config.max_concurrent_requests)
        self._check_ids(requests)
        self._stamp_deadlines(requests)
        self._start_run()
        try:
            return self._run_waves(list(requests), wave, requests)
        finally:
            self._end_run()

    def _run_waves(self, pending, wave, requests) -> list[GenerationResult]:
        done: dict[int, GenerationResult] = {}
        last_error: dict[int, str] = {}
        attempt = 1
        while pending:
            # re-armed before the wave: a cancel or interrupt from now on
            # leaves the event set and the backoff below returns at once
            self._wake.clear()
            failed: list[GenerationRequest] = []
            for i in range(0, len(pending), wave):
                batch = pending[i: i + wave]
                base = self._rid_base
                ebatch = [replace(r, request_id=base + r.request_id)
                          for r in batch]
                try:
                    results = [replace(res, request_id=res.request_id - base)
                               for res in self.engine.generate_batch(ebatch)]
                except Exception as e:  # noqa: BLE001 - fail the batch
                    logger.exception("engine batch failure")
                    results = [GenerationResult(request_id=r.request_id,
                                                finish_reason="error",
                                                error=str(e))
                               for r in batch]
                for req, res in zip(batch, results):
                    self.total_requests += 1
                    if (req.request_id in self._cancelled
                            and res.finish_reason != "cancelled"):
                        done[req.request_id] = self._cancelled_result(
                            req.request_id, res)
                    elif res.error is not None:
                        last_error[req.request_id] = res.error
                        failed.append(req)
                    else:
                        done[res.request_id] = res
                        self.total_tokens_used += res.total_tokens
                        self.total_device_seconds += res.device_seconds
            if not failed:
                break
            if attempt >= self.config.retry_attempts:
                for req in failed:
                    self.failed_requests += 1
                    cause = last_error.get(req.request_id)
                    done.setdefault(req.request_id, GenerationResult(
                        request_id=req.request_id, finish_reason="error",
                        error=f"failed after {attempt} attempts"
                              + (f": {cause}" if cause else "")))
                break
            # the backoff clips to the soonest positive remaining budget (an
            # expired request is dropped below and must not zero it)
            delay = self.config.retry_delay
            rems = [r for r in (remaining_budget(q) for q in failed)
                    if r is not None and r > 0]
            if rems:
                delay = max(0.0, min(delay, min(rems)))
            logger.warning("retrying %d failed requests (attempt %d/%d) "
                           "after %.1fs", len(failed), attempt + 1,
                           self.config.retry_attempts, delay)
            if delay and not self._interrupted:
                self._wake.wait(delay)
            # cancelled ids are not retried; a request whose budget is gone
            # finishes as "deadline", keeping its failure
            now = time.time()
            pending = []
            for req in failed:
                rid = req.request_id
                if rid in self._cancelled:
                    done.setdefault(rid, GenerationResult(
                        request_id=rid, finish_reason="cancelled"))
                elif req.deadline_s is not None and req.deadline_s <= now:
                    self.failed_requests += 1
                    done.setdefault(rid, GenerationResult(
                        request_id=rid, finish_reason="deadline",
                        error=last_error.get(
                            rid, "deadline exceeded before retry")))
                else:
                    pending.append(req)
            attempt += 1
        return [done[r.request_id] for r in requests]

    def run_requests_streaming(self, requests: list[GenerationRequest],
                               on_final) -> None:
        """One engine stream: results go out through ``on_final(result,
        submit)`` as they complete, and ``submit(more)`` feeds new requests
        into the same stream.  A failed request is resubmitted at once, up
        to ``retry_attempts``, under a clone id just below the run's epoch
        base, and delivered under its own id; then it is delivered with its
        error."""
        by_id: dict[int, GenerationRequest] = {}  # caller ids throughout
        attempts: dict[int, int] = {}
        orig_of: dict[int, int] = {}  # engine clone id -> caller id
        finals: set[int] = set()
        retry_seq = [0]
        base = self._start_run()

        def register(reqs: list[GenerationRequest]) -> None:
            self._stamp_deadlines(reqs)
            self._check_ids(reqs)
            for r in reqs:
                by_id[r.request_id] = r
                attempts[r.request_id] = 1

        def to_engine(reqs: list[GenerationRequest]) -> list[GenerationRequest]:
            return [replace(r, request_id=base + r.request_id) for r in reqs]

        def wrapper(res: GenerationResult, submit) -> None:
            rid = orig_of.pop(res.request_id, None)
            if rid is not None:  # a retry clone came home
                self._live_clone.pop(rid, None)
            else:
                rid = res.request_id - base
            self.total_requests += 1
            req = by_id.get(rid)
            cancelled = rid in self._cancelled
            expired = (req is not None and req.deadline_s is not None
                       and req.deadline_s <= time.time())
            if (res.error is not None and req is not None
                    and not cancelled and not expired
                    and attempts[rid] < self.config.retry_attempts):
                attempts[rid] += 1
                retry_seq[0] -= 1
                clone = replace(req, request_id=base + retry_seq[0])
                orig_of[clone.request_id] = rid
                self._live_clone[rid] = clone.request_id
                logger.warning("streaming retry %d/%d for request %d",
                               attempts[rid], self.config.retry_attempts, rid)
                submit([clone])
                return
            if cancelled and res.finish_reason != "cancelled":
                # a recorded cancel is terminal: a completed attempt must
                # not come back as a success for an abandoned id
                res = self._cancelled_result(rid, res)
            elif (res.error is not None and expired and req is not None
                    and attempts[rid] < self.config.retry_attempts):
                # the retry was blocked by the expired budget alone
                res = replace(res, request_id=rid, finish_reason="deadline")
            if res.error is not None:
                self.failed_requests += 1
            else:
                self.total_tokens_used += res.total_tokens
                self.total_device_seconds += res.device_seconds
            if res.request_id != rid:
                res = replace(res, request_id=rid)
            finals.add(rid)

            def submit_user(new_reqs: list[GenerationRequest]) -> None:
                register(new_reqs)
                submit(to_engine(new_reqs))

            on_final(res, submit_user)

        try:
            register(requests)
        except ValueError:
            self._end_run()
            raise

        def deliver_missing(msg: str) -> None:
            # every registered id gets exactly one final
            for rid in [r for r in by_id if r not in finals]:
                self.total_requests += 1
                self.failed_requests += 1
                finals.add(rid)
                on_final(GenerationResult(request_id=rid,
                                          finish_reason="error", error=msg),
                         lambda new_reqs: None)

        try:
            self.engine.generate_batch(to_engine(requests), on_result=wrapper)
        except Exception as e:  # noqa: BLE001 - degrade-and-continue
            logger.exception("engine stream failure")
            deliver_missing(str(e) or type(e).__name__)
        else:
            # a retry clone submitted after the engine's stream ended never
            # ran: its id must not end the stream without a final
            deliver_missing("engine stream ended before a retry could run")
        finally:
            self._end_run()

    # ------------------------------------------------------------ reporting

    def stats(self) -> dict:
        return {
            "total_tokens_used": self.total_tokens_used,
            "total_device_seconds": round(self.total_device_seconds, 4),
            "total_requests": self.total_requests,
            "failed_requests": self.failed_requests,
        }
