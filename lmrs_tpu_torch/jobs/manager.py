"""Durable summarization jobs: crash-safe map/reduce over a write-ahead
journal (the port of the reference's ``jobs/manager.py``).

* ``JobManager.submit`` gives a job a CONTENT-ADDRESSED id (transcript x
  config fingerprint, ``journal.job_id_for``), persists the request
  (``<id>.req.json``) and a journal header, and queues the job; a
  duplicate submit converges on the existing job;
* each chunk summary is journaled as it completes, through the executor's
  streaming result path (``run_requests_streaming``);
* the reduce tree runs through ``ResultAggregator`` with a
  content-addressed node cache: every finished node is journaled
  (``reduce_node_done``), so a crash mid-reduce resumes at the node;
* ``recover()`` (the server calls it at start-up) re-queues every journal
  without a terminal record and re-registers terminal jobs;
* degraded completion: a failed-chunk fraction at or under
  ``JobsConfig.max_failed_chunk_fraction`` finishes ``status="degraded"``
  with per-chunk ``degraded_reason``s.

Chunking, prompts and the tree shape are deterministic in (transcript,
config) and the journal keeps exact summary text, so a killed-and-resumed
greedy job ends on the same final summary as an uninterrupted one.  Each
job's engine results roll their ledger ``usage`` up into the status doc's
``usage`` block (this process life's engine work: journal-answered chunks
cost nothing), and the manager records ``job_submit``, ``job_recover``,
``job_resume`` and ``job_done`` on the tracer's pipeline track.  The
``jobs.recover`` fault-injection site (``testing/faults.py``, ``OSError``)
fires in ``recover`` once a job.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from lmrs_tpu_torch.config import JobsConfig, PipelineConfig
from lmrs_tpu_torch.data.chunker import Chunk
from lmrs_tpu_torch.data.preprocessor import (extract_speakers,
                                              get_transcript_duration)
from lmrs_tpu_torch.engine.api import TenantStampEngine, degraded_reason
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.jobs import journal as jl
from lmrs_tpu_torch.obs import (DEFAULT_LATENCY_BUCKETS_S, PID_PIPELINE,
                                MetricsRegistry, get_tracer, new_trace_id)
from lmrs_tpu_torch.pipeline import build_chunker, prepare_segments
from lmrs_tpu_torch.prompts import (resolve_map_prompt, resolve_reduce_prompt,
                                    resolve_system_prompt)
from lmrs_tpu_torch.reduce.aggregator import ResultAggregator
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.utils.timing import format_duration

logger = logging.getLogger("lmrs_torch.jobs")

TERMINAL_STATES = ("done", "degraded", "failed", "cancelled")
# params a job request may carry (everything else is rejected at submit
# so a typo'd knob fails loudly instead of silently running defaults)
_ALLOWED_PARAMS = ("prompt_template", "system_prompt", "aggregator_prompt",
                   "summary_type", "max_tokens_per_chunk")


@dataclass
class Job:
    """In-memory record of one durable job (the journal is the truth)."""

    job_id: str
    params: dict
    fingerprint: str
    req_path: Path
    wal_path: Path
    status: str = "queued"
    created_t: float = field(default_factory=time.time)
    recovered: bool = False
    # trace id: minted (or taken from the submit's X-LMRS-Trace header)
    # at submit, persisted in the journal header, restored by recover(),
    # so a resumed job continues its trace
    trace_id: str | None = None
    # cost-attribution tenant: the submit's X-LMRS-Tenant, else the job's
    # own id; persisted like the trace id and stamped on every chunk and
    # reduce request the job runs
    tenant: str | None = None
    # ledger usage rolled up from this process life's results
    # (obs.merge_usage shape; journal-answered chunks cost nothing)
    usage: dict = field(default_factory=dict)
    # progress (GET /v1/jobs/<id> partial-progress contract)
    n_chunks: int = 0
    chunks_done: int = 0
    chunks_failed: int = 0
    resumed_chunks: int = 0
    reduce_nodes_done: int = 0
    reduce_nodes_reused: int = 0
    result: dict | None = None
    degraded_reasons: list = field(default_factory=list)
    error: str | None = None
    # control plane
    cancel_ev: threading.Event = field(default_factory=threading.Event)
    done_ev: threading.Event = field(default_factory=threading.Event)
    # a resubmit arrived while a cancel was unwinding the RUNNING run:
    # re-queue when the cancelled finish lands (set/cleared under the
    # manager lock)
    resubmit_pending: bool = False
    journal: jl.Journal | None = None
    _executor: MapExecutor | None = None
    _live_rids: set = field(default_factory=set)

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATES


class _JournalNodeCache:
    """ResultAggregator ``node_cache``: looks reduce nodes up by content
    key in the replayed journal state and journals each newly completed
    node — the exact-tree-node resume substrate."""

    def __init__(self, manager: "JobManager", job: Job, nodes: dict[str, str]):
        self._manager = manager
        self._job = job
        self._nodes = dict(nodes)
        self.reused = 0

    def lookup(self, node_id: str, summaries: list[str],
               template: str | None, metadata: dict | None) -> str | None:
        text = self._nodes.get(jl.node_key(summaries, template, metadata))
        if text is not None:
            self.reused += 1
            logger.info("job %s: reduce node %s resumed from journal",
                        self._job.job_id, node_id)
        return text

    def record(self, node_id: str, summaries: list[str],
               template: str | None, metadata: dict | None,
               text: str) -> None:
        key = jl.node_key(summaries, template, metadata)
        self._nodes[key] = text
        self._job.reduce_nodes_done += 1
        self._manager._append(self._job, {
            "type": jl.REC_NODE, "node_id": node_id, "key": key,
            "text": text})


class JobManager:
    """Owns the jobs directory, the journals, and the worker that runs
    queued jobs through a MapExecutor + ResultAggregator over ``engine``.

    One worker thread: raw engines do not accept concurrent
    ``generate_batch`` calls; inside the server the engine is the
    micro-batcher facade (``serving/server.py``), which pools jobs with
    interactive traffic in the same dispatch queue.
    """

    def __init__(self, engine, jobs_dir: str | Path,
                 config: PipelineConfig | None = None,
                 jobs_config: JobsConfig | None = None,
                 start_worker: bool = True):
        self.engine = engine
        self.config = config or PipelineConfig()
        self.jobs_cfg = jobs_config or self.config.jobs
        self.dir = Path(jobs_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jobs: dict[str, Job] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        self._queue: queue.Queue[str | None] = queue.Queue()
        self._stopped = False
        # ---- lmrs_jobs_* metrics (merged into the server's /metrics)
        self.registry = MetricsRegistry()
        c = self.registry.counter
        self._c_submitted = c("lmrs_jobs_submitted_total",
                              "jobs accepted by POST /v1/jobs or submit()")
        self._c_completed = c("lmrs_jobs_completed_total",
                              "jobs finished status=done")
        self._c_degraded = c("lmrs_jobs_degraded_total",
                             "jobs finished status=degraded (failed-chunk "
                             "fraction within policy)")
        self._c_failed = c("lmrs_jobs_failed_total",
                           "jobs finished status=failed")
        self._c_cancelled = c("lmrs_jobs_cancelled_total",
                              "jobs cancelled via DELETE /v1/jobs/<id>")
        self._c_recovered = c("lmrs_jobs_recovered_total",
                              "interrupted jobs re-queued by startup "
                              "recovery")
        self._c_chunks_resumed = c("lmrs_jobs_chunks_resumed_total",
                                   "chunk summaries rehydrated from the "
                                   "journal instead of recomputed")
        self._c_nodes_reused = c("lmrs_jobs_reduce_nodes_reused_total",
                                 "reduce-tree nodes resumed from the "
                                 "journal instead of recomputed")
        self._c_appends = c("lmrs_jobs_journal_appends_total",
                            "journal records durably written")
        self._c_append_failures = c("lmrs_jobs_journal_append_failures_total",
                                    "journal appends/fsyncs that degraded "
                                    "(record dropped or not durable)")
        self._g_active = self.registry.gauge(
            "lmrs_jobs_active", "jobs currently queued or running")
        self._h_duration = self.registry.histogram(
            "lmrs_jobs_duration_seconds", DEFAULT_LATENCY_BUCKETS_S,
            help="wall-clock of one job run (resumed runs count their "
                 "own wall only)", unit="seconds")
        self._worker: threading.Thread | None = None
        if start_worker:
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True, name="lmrs-jobs")
            self._worker.start()

    # ------------------------------------------------------------- public

    def submit(self, transcript_data: dict, params: dict | None = None,
               trace_id: str | None = None,
               tenant: str | None = None) -> Job:
        """Persist + queue a job; returns immediately (POST /v1/jobs).
        Content-addressed: an identical (transcript, params) submit
        returns the existing job — live jobs dedupe, terminal
        failed/cancelled jobs re-queue on the SAME journal so the retry
        resumes everything already journaled.  ``trace_id`` (the submit
        header) is persisted in the journal header so the job's trace
        survives restarts; a duplicate submit keeps the FIRST trace (the
        journal is the truth)."""
        params = self._sanitize_params(params)
        fp = self._fingerprint(params)
        jid = jl.job_id_for(transcript_data, fp)
        with self._lock:
            job = self._jobs.get(jid)
            if job is not None:
                if job.status in ("queued", "running", "done", "degraded"):
                    if job.status == "queued" and job.cancel_ev.is_set():
                        # a resubmit supersedes a still-pending cancel of a
                        # QUEUED job: answering "queued" while letting the
                        # dequeue cancel it would silently swallow the
                        # acknowledged submit
                        job.cancel_ev = threading.Event()
                    elif job.status == "running" and job.cancel_ev.is_set():
                        # same race mid-unwind: the running job WILL finish
                        # cancelled — mark it to re-queue when that finish
                        # lands, so this acknowledged submit still executes
                        job.resubmit_pending = True
                    return job
                # failed/cancelled: a resubmit is an explicit retry — the
                # journal keeps every chunk/node already done (run_job
                # supersedes the stale terminal record), the progress
                # counters start over for the new run.  params/fingerprint
                # refresh and the request re-persists (below, outside the
                # lock): a job registered by a FAILED recovery (params={},
                # fingerprint="", req file possibly unreadable) must heal
                # here, or the retry would run default params and
                # stale-side its own journal
                job.params = params
                job.fingerprint = fp
                self._reset_for_retry_locked(job)
                fresh = False
            else:
                job = self._register(jid, params, fp)
                self._c_submitted.inc()
                self._g_active.set(self._active_count())
                fresh = True
            if job.trace_id is None:
                job.trace_id = trace_id or new_trace_id()
            if job.tenant is None:
                # the submit's tenant wins; anonymous submits bill to the
                # job's own identity (per-job usage rollups for free)
                job.tenant = tenant or f"job:{jid[:24]}"
        # Disk I/O OUTSIDE the lock: the fsync'd header append must not
        # serialize every get()/jobs()/stats() reader behind the disk.  A
        # concurrent duplicate submit finds the registered job and returns
        # it immediately; the worker only sees the jid once the artifacts
        # exist (_queue.put is last).
        try:
            # request persisted ATOMICALLY before the journal header: a
            # crash between the two leaves either nothing or a resumable
            # (req, header) pair — never a header with no way to re-chunk
            tmp = job.req_path.with_suffix(".tmp")
            tmp.write_text(jl.canonical_json({
                "job_id": jid, "fingerprint": fp, "params": params,
                "transcript": transcript_data}), encoding="utf-8")
            os.replace(tmp, job.req_path)
            if job.journal is None:
                job.journal = jl.Journal(job.wal_path)
            if fresh and not job.wal_path.exists():
                self._append(job, {
                    "type": jl.REC_HEADER, "job_id": jid, "fingerprint": fp,
                    "transcript_sha": jl.job_id_for(transcript_data, ""),
                    "trace_id": job.trace_id,
                    "tenant": job.tenant,
                    "created_t": job.created_t})
        except Exception as e:
            # the registered-but-unqueued job must not linger "queued"
            with self._lock:
                job.status = "failed"
                job.error = f"submit failed: {type(e).__name__}: {e}"
                self._g_active.set(self._active_count())
            job.done_ev.set()
            raise
        tr = get_tracer()
        if tr:
            tr.instant("job_submit", pid=PID_PIPELINE,
                       args={"job": jid, "trace": job.trace_id})
        self._queue.put(jid)
        return job

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list[Job]:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.created_t)

    def cancel(self, job_id: str) -> Job | None:
        """Cancel a queued or running job (DELETE /v1/jobs/<id>).  Queued
        jobs terminate at dequeue; a running job's in-flight requests are
        chased through the executor's cancel/interrupt hooks and the job
        finishes ``status="cancelled"`` (journaled, so the cancellation
        itself survives a restart).  Terminal jobs are returned as-is."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.terminal:
                return job
            job.cancel_ev.set()
            ex = job._executor
            rids = list(job._live_rids)
        if ex is not None:
            ex.interrupt()
            for rid in rids:
                ex.cancel(rid)
        return job

    def recover(self) -> int:
        """Scan the jobs directory at startup: terminal jobs re-register
        (their results stay pollable across restarts), interrupted ones
        re-queue.  Returns the number re-queued.  A job whose recovery
        fails (``jobs.recover`` fault site; unreadable request file) is
        registered ``status="failed"`` so the interruption stays visible
        instead of silently vanishing — the others still recover."""
        recovered = 0
        for wal in sorted(self.dir.glob("*.wal")):
            jid = wal.stem
            with self._lock:
                if jid in self._jobs:
                    continue
            try:
                # injection site: recovery of THIS job fails (corrupt
                # request file, permission loss): degrade per job
                faults.fire("jobs.recover", OSError)
                req = json.loads(
                    (self.dir / f"{jid}.req.json").read_text("utf-8"))
                records, _meta = jl.replay(wal)
                state = jl.rebuild_state(records)
                # fingerprint recomputed under the CURRENT config — not the
                # one stored at submit time — so run_job's gate catches a
                # prompt/model surface that changed across the restart and
                # refuses to mix the old journal's summaries into the rerun
                fp = self._fingerprint(req.get("params") or {})
            except Exception as e:  # noqa: BLE001 - degrade per job
                logger.warning("job %s: recovery failed: %s: %s",
                               jid, type(e).__name__, e)
                with self._lock:
                    job = self._register(jid, {}, "")
                    job.status = "failed"
                    job.error = f"recovery failed: {type(e).__name__}: {e}"
                    job.done_ev.set()
                continue
            with self._lock:
                job = self._register(jid, req.get("params") or {}, fp)
                job.journal = jl.Journal(job.wal_path)
                job.recovered = True
                # a resumed job CONTINUES its trace: the header's id was
                # minted at the original submit (pre-trace journals just
                # start a fresh trace here)
                header_trace = (state["header"] or {}).get("trace_id")
                if isinstance(header_trace, str) and header_trace:
                    job.trace_id = header_trace
                # a resumed job keeps billing to its original tenant
                header_tenant = (state["header"] or {}).get("tenant")
                job.tenant = (header_tenant
                              if isinstance(header_tenant, str)
                              and header_tenant else f"job:{jid[:24]}")
                if state["done"] is not None:
                    self._finish_from_record(job, state["done"])
                    continue
                job.n_chunks = (state["header"] or {}).get("num_chunks", 0)
                self._c_recovered.inc()
                self._g_active.set(self._active_count())
            tr = get_tracer()
            if tr:
                tr.instant("job_recover", pid=PID_PIPELINE,
                           args={"job": jid, "trace": job.trace_id})
            logger.info("job %s: interrupted journal found; re-queued "
                        "(%d chunk record(s), %d reduce node(s))", jid,
                        len(state["chunks"]), len(state["nodes"]))
            self._queue.put(jid)
            recovered += 1
        return recovered

    def wait(self, job_id: str, timeout: float = 60.0) -> Job | None:
        """Block until the job is terminal (test/CLI convenience)."""
        job = self.get(job_id)
        if job is not None:
            job.done_ev.wait(timeout)
        return job

    def status_doc(self, job: Job) -> dict:
        """The GET /v1/jobs/<id> response body."""
        doc = {
            "object": "job",
            "id": job.job_id,
            "status": job.status,
            "created_t": job.created_t,
            "recovered": job.recovered,
            "trace_id": job.trace_id,
            "tenant": job.tenant,
            "progress": {
                "num_chunks": job.n_chunks,
                "chunks_done": job.chunks_done,
                "chunks_failed": job.chunks_failed,
                "num_resumed_chunks": job.resumed_chunks,
                "reduce_nodes_done": job.reduce_nodes_done,
                "reduce_nodes_reused": job.reduce_nodes_reused,
            },
        }
        if job.result is not None:
            doc["result"] = job.result
        if job.usage:
            doc["usage"] = job.usage
        if job.degraded_reasons:
            doc["degraded_reasons"] = job.degraded_reasons
        if job.error is not None:
            doc["error"] = job.error
        if job.journal is not None:
            doc["journal"] = job.journal.stats()
        return doc

    def stats(self) -> dict:
        with self._lock:
            by_status: dict[str, int] = {}
            for j in self._jobs.values():
                by_status[j.status] = by_status.get(j.status, 0) + 1
        return {"jobs": sum(by_status.values()), "by_status": by_status,
                "jobs_dir": str(self.dir)}

    def shutdown(self) -> None:
        self._stopped = True
        self._queue.put(None)
        if self._worker is not None:
            self._worker.join(timeout=5)
        with self._lock:
            for job in self._jobs.values():
                if job.journal is not None:
                    job.journal.close()

    # ---------------------------------------------------------- internals

    def _register(self, jid: str, params: dict,
                  fingerprint: str) -> Job:  # holds-lock: _lock
        job = Job(job_id=jid, params=params, fingerprint=fingerprint,
                  req_path=self.dir / f"{jid}.req.json",
                  wal_path=self.dir / f"{jid}.wal")
        self._jobs[jid] = job
        return job

    def _active_count(self) -> int:
        return sum(1 for j in self._jobs.values() if not j.terminal)

    def _reset_for_retry_locked(self, job: Job) -> None:
        """Back to "queued" with fresh progress/control state (caller
        holds the lock and owns the _queue.put)."""
        job.status = "queued"
        job.error = None
        job.result = None
        job.degraded_reasons = []
        job.chunks_done = job.chunks_failed = 0
        job.resumed_chunks = 0
        job.reduce_nodes_done = job.reduce_nodes_reused = 0
        job.resubmit_pending = False
        job.cancel_ev = threading.Event()
        job.done_ev = threading.Event()
        self._g_active.set(self._active_count())

    def _sanitize_params(self, params: dict | None) -> dict:
        p = dict(params or {})
        unknown = sorted(set(p) - set(_ALLOWED_PARAMS))
        if unknown:
            raise ValueError(f"unknown job param(s) {unknown}; "
                             f"supported: {sorted(_ALLOWED_PARAMS)}")
        if "max_tokens_per_chunk" in p:
            try:
                p["max_tokens_per_chunk"] = int(p["max_tokens_per_chunk"])
            except (TypeError, ValueError):
                raise ValueError(
                    "max_tokens_per_chunk must be an integer "
                    f"(got {p['max_tokens_per_chunk']!r})") from None
        return p

    def _fingerprint(self, params: dict) -> str:
        e = self.config.engine
        c = self.config.chunk
        return jl.config_fingerprint(
            map_prompt=resolve_map_prompt(params.get("prompt_template"), None),
            system_prompt=resolve_system_prompt(
                params.get("system_prompt"), None) or "",
            reduce_prompt=resolve_reduce_prompt(
                params.get("aggregator_prompt"), None) or "",
            summary_type=params.get("summary_type", "summary"),
            backend=e.backend, model=e.model, temperature=e.temperature,
            max_tokens=e.max_tokens, seed=e.seed,
            max_tokens_per_chunk=params.get("max_tokens_per_chunk",
                                            c.max_tokens_per_chunk),
            overlap_tokens=c.overlap_tokens,
            context_tokens=c.context_tokens)

    def _append(self, job: Job, rec: dict) -> None:
        ok = job.journal.append(rec) if job.journal is not None else False
        (self._c_appends if ok else self._c_append_failures).inc()

    def _worker_loop(self) -> None:
        while True:
            jid = self._queue.get()
            if jid is None:
                return
            job = self.get(jid)
            if job is None or job.terminal:
                continue
            if job.cancel_ev.is_set():
                self._finish(job, "cancelled", None, [])
                continue
            try:
                self.run_job(job)
            except Exception as e:  # noqa: BLE001 - the worker must survive
                logger.exception("job %s: run failed", jid)
                self._finish(job, "failed", None, [],
                             error=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------- run

    def run_job(self, job: Job) -> Job:
        """Execute (or resume) one job synchronously.  Used by the worker
        thread; callable directly when the manager was built with
        ``start_worker=False`` (tests, one-shot CLI runs)."""
        t0 = time.time()
        job.status = "running"
        if job.journal is None:
            job.journal = jl.Journal(job.wal_path)
        records, meta = jl.replay(job.wal_path)
        state = jl.rebuild_state(records)
        done_rec = state["done"]
        if done_rec is not None:
            if done_rec.get("status") in ("done", "degraded"):
                # raced a completed run: its result stands
                with self._lock:
                    self._finish_from_record(job, done_rec)
                return job
            # a failed/cancelled terminal record does NOT block an explicit
            # resubmit: this run supersedes it (the _finish below appends a
            # newer job_done; rebuild_state keeps the last one), and every
            # chunk/node journaled before the failure still resumes
        # Fingerprint gate (same contract as pipeline._load_resume): a
        # journal written under a different prompt/model surface must not
        # rehydrate into this run — warn, set the stale WAL aside, start
        # a fresh journal.
        hdr = state["header"]
        if hdr is not None and hdr.get("fingerprint") != job.fingerprint:
            logger.warning(
                "job %s: journal fingerprint %s != expected %s; dropping "
                "journaled progress (stale prompt/model surface)",
                job.job_id, hdr.get("fingerprint"), job.fingerprint)
            state = {"header": None, "chunks": {}, "nodes": {}, "done": None}
            job.journal.close()
            try:
                os.replace(job.wal_path, str(job.wal_path) + ".stale")
            except OSError:
                pass
            job.journal = jl.Journal(job.wal_path)
        if state["header"] is None:
            self._append(job, {
                "type": jl.REC_HEADER, "job_id": job.job_id,
                "fingerprint": job.fingerprint, "created_t": job.created_t,
                "trace_id": job.trace_id, "tenant": job.tenant})

        transcript = json.loads(job.req_path.read_text("utf-8"))["transcript"]
        params = job.params
        map_prompt = resolve_map_prompt(params.get("prompt_template"), None)
        sys_prompt = resolve_system_prompt(params.get("system_prompt"), None)
        reduce_prompt = resolve_reduce_prompt(
            params.get("aggregator_prompt"), None)
        summary_type = params.get("summary_type", "summary")

        # one prep implementation with the batch pipeline (pipeline.py) —
        # the two durability paths must chunk identically or their
        # artifacts go stale against each other.  engine=None on purpose:
        # journal chunk-identity keys need purely (transcript, config)-
        # deterministic boundaries, never engine-instance-dependent ones
        _n, processed = prepare_segments(self.config, transcript)
        chunker = build_chunker(self.config, engine=None,
                                max_tokens_per_chunk=params.get(
                                    "max_tokens_per_chunk"))
        chunks = chunker.chunk_transcript(processed)
        job.n_chunks = len(chunks)
        # journal the chunk count (replay keeps the LAST header): a crash
        # mid-map lets recover() report a real progress denominator on the
        # re-queued job instead of num_chunks=0 until the rerun re-chunks
        hdr0 = state["header"] or {}
        if hdr0.get("num_chunks") != len(chunks):
            self._append(job, {
                **{k: v for k, v in hdr0.items() if k != "type"},
                "type": jl.REC_HEADER, "job_id": job.job_id,
                "fingerprint": job.fingerprint, "created_t": job.created_t,
                "tenant": job.tenant,
                "num_chunks": len(chunks)})

        # ---- resume: rehydrate journaled chunk summaries (errored
        # records are NOT rehydrated — a restart is a fresh retry chance;
        # an EMPTY summary is still a completed success and must resume,
        # so presence is the test, not truthiness)
        resumed = 0
        for c in chunks:
            rec = state["chunks"].get(
                jl.chunk_key(c.chunk_index, c.start_time, c.end_time))
            if rec and rec.get("summary") is not None and not rec.get("error"):
                c.summary = rec["summary"]
                c.tokens_used = rec.get("tokens_used", 0)
                resumed += 1
        job.resumed_chunks = resumed
        job.chunks_done = resumed
        if resumed:
            self._c_chunks_resumed.inc(resumed)
            tr = get_tracer()
            if tr:
                tr.instant("job_resume", pid=PID_PIPELINE,
                           args={"job": job.job_id, "resumed_chunks": resumed,
                                 "journaled_nodes": len(state["nodes"]),
                                 "trace": job.trace_id})
            logger.info("job %s: resumed %d/%d chunk summaries and %d "
                        "reduce node(s) from the journal", job.job_id,
                        resumed, len(chunks), len(state["nodes"]))

        def _publish_usage(snap: dict) -> None:
            # a reference swap: status_doc serializes whatever snapshot it
            # holds, never a dict a merge is resizing
            job.usage = snap

        # batch class: a job's map fan-out is the bulk work the QoS
        # preemption policy victimizes before a live session's refresh
        stamp = TenantStampEngine(self.engine, job.tenant,
                                  publish=_publish_usage, seed=job.usage,
                                  qos_class="batch")
        executor = MapExecutor(stamp, self.config.engine)
        job._executor = executor
        self._run_map(job, executor, chunks, map_prompt, summary_type,
                      sys_prompt)
        if job.cancel_ev.is_set():
            return self._finish(job, "cancelled", None, [], t0=t0)

        # ---- reduce, resuming at journaled tree nodes
        cache = _JournalNodeCache(self, job, state["nodes"])
        aggregator = ResultAggregator(executor, self.config.reduce,
                                      tokenizer=chunker.tokenizer)
        ordered = sorted(chunks, key=lambda c: c.chunk_index)
        duration = get_transcript_duration(processed)
        metadata = {
            "duration": format_duration(duration),
            "speakers": ", ".join(extract_speakers(processed)),
            "num_chunks": len(ordered),
        }
        agg = aggregator.aggregate(ordered, reduce_prompt, metadata,
                                   node_cache=cache)
        job.reduce_nodes_reused = cache.reused
        if cache.reused:
            self._c_nodes_reused.inc(cache.reused)
        if job.cancel_ev.is_set():
            return self._finish(job, "cancelled", None, [], t0=t0)

        failed = [c for c in ordered if c.error]
        frac = len(failed) / len(ordered) if ordered else 0.0
        reduce_errors = agg.get("reduce_errors", 0)
        if agg.get("final_error"):
            # the deliverable itself is an error marker — "done" with a
            # garbage summary would journal terminal and never be retried
            status = "failed"
        elif not failed and not reduce_errors:
            status = "done"
        elif frac <= self.jobs_cfg.max_failed_chunk_fraction:
            status = "degraded"
        else:
            status = "failed"
        reasons = [{"chunk_index": c.chunk_index, "degraded_reason": c.error}
                   for c in failed]
        if reduce_errors:
            reasons.append({"node": "reduce", "degraded_reason":
                            f"{reduce_errors} reduce node(s) degraded to "
                            "error markers"})
        result = {
            "summary": agg["final_summary"],
            "num_chunks": len(ordered),
            "num_resumed_chunks": resumed,
            "failed_chunks": len(failed),
            "reduce_errors": reduce_errors,
            "hierarchical": agg["hierarchical"],
            "reduce_levels": agg["levels"],
            "reduce_nodes_reused": cache.reused,
            **executor.stats(),
        }
        return self._finish(job, status, result, reasons, t0=t0)

    def _run_map(self, job: Job, executor: MapExecutor, chunks: list[Chunk],
                 map_prompt: str, summary_type: str,
                 sys_prompt: str | None) -> None:
        """Map every un-resumed chunk, journaling each summary AS IT
        COMPLETES through the streaming result path — the WAL advances
        inside the stream, not at end-of-map."""
        todo = [c for c in chunks if c.summary is None]
        if not todo:
            return
        chunk_by_rid: dict[int, Chunk] = {}
        requests = []
        for i, c in enumerate(todo):
            requests.append(executor.build_map_request(
                c, map_prompt, summary_type, sys_prompt, request_id=i))
            chunk_by_rid[i] = c
        job._live_rids = set(chunk_by_rid)

        def on_final(res, submit) -> None:
            c = chunk_by_rid[res.request_id]
            job._live_rids.discard(res.request_id)
            reason = degraded_reason(res)
            if reason is not None:
                c.summary = f"[Error processing chunk: {reason}]"
                c.error = reason
                job.chunks_failed += 1
            else:
                c.summary = res.text
            c.tokens_used = res.total_tokens
            c.device_seconds = res.device_seconds
            job.chunks_done += 1
            # a cancelled chunk is not durable progress; everything else
            # (successes AND degraded outcomes) journals — replay retries
            # errored records, so journaling them only aids triage
            if res.finish_reason != "cancelled":
                self._append(job, {
                    "type": jl.REC_CHUNK, "chunk_index": c.chunk_index,
                    "start_time": c.start_time, "end_time": c.end_time,
                    "summary": c.summary, "tokens_used": c.tokens_used,
                    "error": c.error})
            if job.cancel_ev.is_set():
                executor.interrupt()
                for rid in list(job._live_rids):
                    executor.cancel(rid)

        executor.run_requests_streaming(requests, on_final)
        job._live_rids = set()

    def _finish(self, job: Job, status: str, result: dict | None,
                reasons: list, error: str | None = None,
                t0: float | None = None) -> Job:
        with self._lock:
            job.status = status
            job.result = result
            job.degraded_reasons = reasons
            if error is not None:
                job.error = error
            self._g_active.set(self._active_count())
        # A failed/degraded finish during manager shutdown is (at least
        # partly) a shutdown artifact — the batcher fast-fails in-flight
        # requests — and journaling it terminal would make a GRACEFUL
        # restart non-resumable.  Leave the journal non-terminal so
        # recover() re-queues, same as a SIGKILL; explicit cancellations
        # still journal (user intent must survive the restart).
        skip_terminal_rec = self._stopped and status in ("failed", "degraded")
        if job.journal is not None and not skip_terminal_rec:
            self._append(job, {
                "type": jl.REC_DONE, "status": status,
                "summary": (result or {}).get("summary"),
                "result": result, "degraded_reasons": reasons,
                "error": error})
        elif skip_terminal_rec:
            logger.info("job %s: %s during shutdown — terminal record "
                        "withheld so the restart resumes it", job.job_id,
                        status)
        counter = {"done": self._c_completed, "degraded": self._c_degraded,
                   "failed": self._c_failed,
                   "cancelled": self._c_cancelled}.get(status)
        if counter is not None:
            counter.inc()
        if t0 is not None:
            self._h_duration.observe(time.time() - t0)
        tr = get_tracer()
        if tr:
            tr.instant("job_done", pid=PID_PIPELINE,
                       args={"job": job.job_id, "status": status,
                             "trace": job.trace_id})
        logger.info("job %s: %s (%d/%d chunks, %d failed, %d resumed, "
                    "%d node(s) reused)", job.job_id, status,
                    job.chunks_done, job.n_chunks, job.chunks_failed,
                    job.resumed_chunks, job.reduce_nodes_reused)
        job.done_ev.set()
        with self._lock:
            requeue = (status == "cancelled" and job.resubmit_pending
                       and not self._stopped)
            if requeue:
                self._reset_for_retry_locked(job)
        if requeue:
            logger.info("job %s: a resubmit superseded the cancel; "
                        "re-queued", job.job_id)
            self._queue.put(job.job_id)
        return job

    def _finish_from_record(self, job: Job, done: dict) -> None:
        """Register a journal's terminal record (startup recovery / raced
        completion): the result survives the restart without re-running.
        Caller holds ``self._lock``."""
        job.status = done.get("status", "done")
        self._g_active.set(self._active_count())
        job.result = done.get("result")
        job.degraded_reasons = done.get("degraded_reasons") or []
        job.error = done.get("error")
        if job.result:
            job.n_chunks = job.result.get("num_chunks", 0)
            job.chunks_done = job.n_chunks
            job.chunks_failed = job.result.get("failed_chunks", 0)
            job.resumed_chunks = job.result.get("num_resumed_chunks", 0)
        job.done_ev.set()
