"""Live session manager: rolling map-reduce over a growing transcript (the
port of the reference's ``live/session.py``).

A *session* is the live tier's unit of work, as a *job* (``jobs/``) is
the batch tier's: a client opens one, appends transcript segments over
time, and requests (or auto-triggers through ``LiveConfig.refresh_tokens``)
summary refreshes that recompute ONLY what changed since the last one.
Three caches, each keyed on content, make a refresh incremental:

* **chunk boundaries**: the incremental chunker
  (``TranscriptChunker.incremental``) keeps sealed chunks fixed; appends
  extend the open tail chunk or seal new ones;
* **map summaries**: keyed by ``jobs.journal.chunk_key`` (index, start,
  end) and the chunk text's hash, so a sealed chunk's summary is reused
  verbatim and a grown tail recomputes;
* **reduce nodes**: ``ResultAggregator`` with ``stable_tree`` over the
  journal's content-addressed ``node_key``s: appended leaves recompute
  the last batch per level and the root; sibling subtrees answer from the
  cache.

Everything journals through the write-ahead journal
(``jobs.journal.Journal``) as it completes, so ``recover()`` rebuilds a
session after a SIGKILL and its next refresh equals an uninterrupted run.
Live preprocessing is a stateless per-segment map (no same-speaker
merging), so the chunks, the map prompts and the tree depend only on the
concatenated segment stream, never on how appends were batched.

An ``interactive`` refresh stamps ``LiveConfig.interactive_deadline_s``
onto its requests; ``bulk`` runs unbounded.  Each refresh passes the
previous summary as every request's ``draft_hint`` (tree speculation
drafts from it).  Each refresh's engine results roll their ledger
``usage`` up into the session doc's ``usage`` block (this process life's
refresh work: journal- and cache-answered nodes cost nothing), and the
manager records ``session_open``, ``session_append``, ``session_resume``
and ``session_refresh`` on the tracer's pipeline track.  A refresh's
requests carry its session's QoS class (``interactive`` or ``batch``), so
an interactive refresh outranks a job's map wave in the scheduler.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path

from lmrs_tpu_torch.config import LiveConfig, PipelineConfig
from lmrs_tpu_torch.data.chunker import Chunk, IncrementalChunking
from lmrs_tpu_torch.data.preprocessor import preprocess_transcript
from lmrs_tpu_torch.engine.api import TenantStampEngine, degraded_reason
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.jobs import journal as jl
from lmrs_tpu_torch.obs import (DEFAULT_LATENCY_BUCKETS_S, PID_PIPELINE,
                                RATIO_BUCKETS, MetricsRegistry, get_tracer,
                                new_trace_id)
from lmrs_tpu_torch.pipeline import build_chunker
from lmrs_tpu_torch.prompts import (resolve_map_prompt, resolve_reduce_prompt,
                                    resolve_system_prompt)
from lmrs_tpu_torch.reduce.aggregator import ResultAggregator
from lmrs_tpu_torch.utils.timing import format_duration

logger = logging.getLogger("lmrs_torch.live")

# journal record types (jobs.journal's REC_CHUNK / REC_NODE are reused
# verbatim — same idempotent replay keys; unknown types stay ignored by
# the batch-job reader, forward compatibility both ways)
REC_SESSION = "session_header"
REC_SEGMENTS = "segments_appended"
REC_SUMMARY = "summary_done"

# params a session may carry (same fail-loudly contract as jobs)
_ALLOWED_PARAMS = ("prompt_template", "system_prompt", "aggregator_prompt",
                   "summary_type", "max_tokens_per_chunk", "class")

_CLASSES = ("interactive", "bulk")


def _text_sha(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()[:12]


def _clean_segments(segments) -> list[dict]:
    """Validate + coerce one appended batch into the canonical journaled
    form.  Raises ValueError on anything malformed — BEFORE the batch
    reaches the WAL, so a bad append can 400 but never brick replay."""
    import math

    if not isinstance(segments, list) or not segments:
        raise ValueError("segments must be a non-empty list of "
                         "{start, end, text[, speaker]} objects")
    out = []
    for i, s in enumerate(segments):
        if not isinstance(s, dict) or not isinstance(s.get("text"), str):
            raise ValueError(f"segment {i}: want an object with string "
                             "'text' plus numeric 'start'/'end'")
        try:
            start = float(s["start"])
            end = float(s["end"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"segment {i}: 'start'/'end' must be "
                             "numbers") from None
        if not (math.isfinite(start) and math.isfinite(end)) or end < start:
            raise ValueError(f"segment {i}: want finite start <= end "
                             f"(got {start!r}..{end!r})")
        out.append({"start": start, "end": end, "text": s["text"],
                    "speaker": str(s.get("speaker", "UNKNOWN"))})
    return out


def rebuild_live_state(records: list[dict]) -> dict:
    """Fold replayed records into canonical session state:

    ``{"header": rec|None, "segments": {seq: [raw segments]},
    "chunks": {chunk_key: rec}, "nodes": {node_key: text},
    "summary": rec|None}``

    Idempotent like ``jobs.journal.rebuild_state``: duplicates overwrite
    their own key with identical content, so a journal replayed any
    number of times yields byte-identical state."""
    state: dict = {"header": None, "segments": {}, "chunks": {},
                   "nodes": {}, "summary": None}
    for rec in records:
        kind = rec.get("type")
        if kind == REC_SESSION:
            state["header"] = rec
        elif kind == REC_SEGMENTS:
            seq = rec.get("seq")
            if isinstance(seq, int) and seq >= 0:
                state["segments"][seq] = rec.get("segments", [])
        elif kind == jl.REC_CHUNK:
            key = jl.chunk_key(rec.get("chunk_index", -1),
                               rec.get("start_time", 0.0),
                               rec.get("end_time", 0.0))
            state["chunks"][key] = rec
        elif kind == jl.REC_NODE:
            if rec.get("key"):
                state["nodes"][rec["key"]] = rec.get("text", "")
        elif kind == REC_SUMMARY:
            state["summary"] = rec
        # unknown types: ignored (forward compatibility)
    return state


@dataclass
class LiveSession:
    """In-memory record of one live session (the journal is the truth)."""

    session_id: str
    params: dict
    fingerprint: str
    wal_path: Path
    created_t: float = field(default_factory=time.time)
    recovered: bool = False
    trace_id: str | None = None
    # cost-attribution tenant: the create's X-LMRS-Tenant, else the
    # session's own id; persisted in the header, stamped on every refresh
    # request
    tenant: str | None = None
    # ledger usage rolled up from this process life's refresh waves
    usage: dict = field(default_factory=dict)
    journal: jl.Journal | None = None
    closed: bool = False
    # transcript + chunking state (all appended-so-far; serialized by the
    # per-session lock below)
    inc: IncrementalChunking | None = None
    append_seq: int = 0          # segment batches journaled
    n_raw_segments: int = 0      # segments as appended (pre-preprocess)
    n_segments: int = 0          # processed segments fed to the chunker
    speakers: dict[str, None] = field(default_factory=dict)
    end_time: float = 0.0
    # content-addressed caches rehydrated from the journal
    chunk_cache: dict[str, dict] = field(default_factory=dict)
    node_cache: dict[str, str] = field(default_factory=dict)
    # current summary snapshot (None until the first refresh lands)
    summary: dict | None = None
    stale_tokens: int = 0        # appended-but-unsummarized token estimate
    # control plane.  ``lock`` serializes appends/refreshes; ``ctl``
    # is a SHORT lock over the in-flight executor + rid set, so close()
    # can snapshot them without waiting out (or racing) a refresh —
    # iterating _live_rids while the map stream discards from it would
    # raise, and waiting on ``lock`` would defeat the cancel
    lock: threading.RLock = field(default_factory=threading.RLock)
    ctl: threading.Lock = field(default_factory=threading.Lock)
    cancel_ev: threading.Event = field(default_factory=threading.Event)
    _executor: MapExecutor | None = None  # guarded-by: ctl
    _live_rids: set = field(default_factory=set)  # guarded-by: ctl

    @property
    def stale_batches(self) -> int:
        covered = (self.summary or {}).get("seq", 0)
        return self.append_seq - covered


class _SessionNodeCache:
    """``ResultAggregator`` node_cache over the session's journaled
    reduce nodes: lookups answer from the replayed ``node_key`` map,
    fresh nodes journal as they land (error markers never recorded —
    the next refresh retries them)."""

    def __init__(self, manager: "SessionManager", session: LiveSession):
        self._manager = manager
        self._session = session
        self.reused = 0
        self.computed = 0

    def lookup(self, node_id: str, summaries: list[str],
               template: str | None, metadata: dict | None) -> str | None:
        text = self._session.node_cache.get(
            jl.node_key(summaries, template, metadata))
        if text is not None:
            self.reused += 1
        return text

    def record(self, node_id: str, summaries: list[str],
               template: str | None, metadata: dict | None,
               text: str) -> None:
        key = jl.node_key(summaries, template, metadata)
        self._session.node_cache[key] = text
        self.computed += 1
        self._manager._append(self._session, {
            "type": jl.REC_NODE, "node_id": node_id, "key": key,
            "text": text})


class SessionManager:
    """Owns the sessions directory, the journals, and refresh execution
    over ``engine`` (inside lmrs-serve the engine is the micro-batcher
    facade, so refresh waves pool with interactive HTTP traffic; raw
    engines are serialized by the manager's engine lock — raw backends
    do not accept concurrent ``generate_batch`` calls)."""

    def __init__(self, engine, live_dir: str | Path,
                 config: PipelineConfig | None = None,
                 live_config: LiveConfig | None = None):
        self.engine = engine
        self.config = config or PipelineConfig()
        self.live_cfg = live_config or self.config.live
        self.dir = Path(live_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._sessions: dict[str, LiveSession] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        # raw engines accept one generate_batch at a time; the batcher
        # facade pools anyway, so serializing refresh waves here is safe
        # for every backend and required for the raw ones
        self._engine_lock = threading.Lock()
        self._stopped = False
        # ---- lmrs_live_* metrics (merged into the server's /metrics)
        self.registry = MetricsRegistry()
        c = self.registry.counter
        self._c_opened = c("lmrs_live_sessions_opened_total",
                           "sessions created by POST /v1/sessions or "
                           "create()")
        self._c_recovered = c("lmrs_live_sessions_recovered_total",
                              "interrupted session journals rehydrated by "
                              "startup recovery")
        self._c_refreshes = c("lmrs_live_refreshes_total",
                              "summary refreshes run (requested or "
                              "auto-triggered)")
        self._c_segments = c("lmrs_live_segments_appended_total",
                             "transcript segments appended across sessions")
        self._c_nodes_reused = c("lmrs_live_reduce_nodes_reused_total",
                                 "reduce-tree nodes answered from the "
                                 "session's content-addressed cache "
                                 "instead of recomputed")
        self._c_chunks_reused = c("lmrs_live_chunk_summaries_reused_total",
                                  "map summaries reused from the session "
                                  "cache instead of recomputed")
        self._g_active = self.registry.gauge(
            "lmrs_live_sessions_active", "sessions currently open")
        self._h_dirty = self.registry.histogram(
            "lmrs_live_dirty_chunk_ratio", RATIO_BUCKETS,
            help="dirty-chunk fraction per refresh (recomputed map chunks "
                 "over total chunks — low is the incremental win)",
            unit="ratio")
        self._h_refresh = self.registry.histogram(
            "lmrs_live_refresh_seconds", DEFAULT_LATENCY_BUCKETS_S,
            help="wall-clock of one summary refresh", unit="seconds")

    # ------------------------------------------------------------- public

    def create(self, params: dict | None = None,
               session_id: str | None = None,
               trace_id: str | None = None,
               tenant: str | None = None) -> LiveSession:
        """Open a session (POST /v1/sessions).  ``session_id`` may be
        client-supplied (stable id across client retries; validated);
        otherwise one is minted.  Re-creating an existing live session
        returns it (idempotent client retry)."""
        params = self._sanitize_params(params)
        sid = self._clean_sid(session_id) or f"sess-{uuid.uuid4().hex[:12]}"
        fp = self._fingerprint(params)
        with self._lock:
            existing = self._sessions.get(sid)
            if existing is not None and not existing.closed:
                return existing
            session = self._register(sid, params, fp)
            session.trace_id = trace_id or new_trace_id()
            session.tenant = tenant or f"session:{sid[:24]}"
            self._c_opened.inc()
            self._g_active.set(self._active_count())
        self._append(session, {
            "type": REC_SESSION, "session_id": sid, "fingerprint": fp,
            "params": params, "created_t": session.created_t,
            "trace_id": session.trace_id, "tenant": session.tenant})
        tr = get_tracer()
        if tr:
            tr.instant("session_open", pid=PID_PIPELINE,
                       args={"session": sid, "trace": session.trace_id})
        logger.info("session %s: opened (class default %s)", sid,
                    params.get("class", self.live_cfg.class_default))
        return session

    def get(self, session_id: str) -> LiveSession | None:
        with self._lock:
            return self._sessions.get(session_id)

    def sessions(self) -> list[LiveSession]:
        with self._lock:
            return sorted((s for s in self._sessions.values() if not s.closed),
                          key=lambda s: s.created_t)

    def append(self, session_id: str, segments: list[dict],
               refresh: bool | None = None,
               klass: str | None = None) -> dict:
        """Append a batch of raw segments (POST /v1/sessions/<id>/
        segments).  Journals the RAW batch first (the WAL is the only
        copy of the transcript), then extends the incremental chunker
        with the stateless-preprocessed stream.  A refresh runs inline
        when asked for — or auto-triggers once the appended-but-
        unsummarized token estimate crosses ``LiveConfig.refresh_tokens``.
        Returns the session doc (plus the refresh doc when one ran)."""
        session = self._require(session_id)
        # validate + coerce BEFORE anything journals: one malformed batch
        # persisted to the WAL would poison every future replay of the
        # session (recovery degrades per batch, but never by design)
        segments = _clean_segments(segments)
        with session.lock:
            if session.closed:
                raise KeyError(session_id)
            session.append_seq += 1
            session.n_raw_segments += len(segments)
            self._append(session, {
                "type": REC_SEGMENTS, "seq": session.append_seq,
                "segments": segments})
            self._ingest(session, segments)
            self._c_segments.inc(len(segments))
            tr = get_tracer()
            if tr:
                tr.instant("session_append", pid=PID_PIPELINE,
                           args={"session": session.session_id,
                                 "segments": len(segments),
                                 "seq": session.append_seq,
                                 "trace": session.trace_id})
            doc = self.status_doc(session)
            auto = (self.live_cfg.refresh_tokens > 0
                    and session.stale_tokens >= self.live_cfg.refresh_tokens)
            if refresh or (auto and refresh is not False):
                doc["refresh"] = self._refresh_locked(session, klass,
                                                      auto=not refresh)
                doc.update(self.status_doc(session))
        return doc

    def refresh(self, session_id: str, klass: str | None = None) -> dict:
        """Recompute the summary incrementally (POST
        /v1/sessions/<id>/refresh, or GET .../summary?refresh=1)."""
        session = self._require(session_id)
        with session.lock:
            if session.closed:
                raise KeyError(session_id)
            return self._refresh_locked(session, klass)

    def summary_doc(self, session_id: str) -> dict:
        """The GET /v1/sessions/<id>/summary body: current summary text +
        staleness watermark (how far behind the live transcript it is).

        Deliberately LOCK-FREE (GIL-snapshot reads, the repo's reader
        idiom): this endpoint exists so a client can read the stale-but-
        instant snapshot WHILE a refresh runs — taking the session lock
        would block it behind minutes of engine work.  ``session.summary``
        is rebound atomically at refresh end, never mutated in place."""
        session = self._require(session_id)
        snap = session.summary or {}
        return {
            "object": "session.summary",
            "id": session.session_id,
            "summary": snap.get("summary"),
            "watermark": {
                "seq": snap.get("seq", 0),
                "n_segments": snap.get("n_segments", 0),
                "end_time": snap.get("end_time", 0.0),
                "refreshed_t": snap.get("refreshed_t"),
                "num_chunks": snap.get("n_chunks", 0),
            },
            "staleness": {
                "pending_batches": session.stale_batches,
                "pending_tokens": session.stale_tokens,
                "stale": session.stale_batches > 0 or not snap,
            },
        }

    def close(self, session_id: str) -> LiveSession | None:
        """Close + delete a session (DELETE /v1/sessions/<id>): any
        in-flight refresh is cancelled, the journal is removed — a closed
        session is gone, not resumable."""
        with self._lock:
            session = self._sessions.get(session_id)
        if session is None:
            return None
        session.cancel_ev.set()
        with session.ctl:
            ex = session._executor
            rids = list(session._live_rids)
        if ex is not None:
            ex.interrupt()
            for rid in rids:
                ex.cancel(rid)
        with session.lock:  # waits out an in-flight refresh
            session.closed = True
            if session.journal is not None:
                session.journal.close()
            try:
                os.unlink(session.wal_path)
            except OSError:
                pass
        with self._lock:
            self._sessions.pop(session_id, None)
            self._g_active.set(self._active_count())
        logger.info("session %s: closed", session_id)
        return session

    def recover(self) -> int:
        """Scan the sessions directory at startup and rehydrate every
        journal: segments re-chunk deterministically, map summaries and
        reduce nodes answer from their content-addressed records, the
        last summary snapshot serves immediately — no engine work.  A
        journal whose config fingerprint no longer matches keeps its
        TRANSCRIPT (the segments are the part a restart must never lose)
        but drops the stale summaries: the old WAL is set aside and a
        fresh one re-journals header + segments."""
        recovered = 0
        for wal in sorted(self.dir.glob("*.wal")):
            if self._recover_wal(wal):
                recovered += 1
        return recovered

    def recover_one(self, session_id: str) -> LiveSession | None:
        """On-demand single-journal recovery (the cross-host resume path):
        a sibling that inherited a drained/
        killed host's traffic finds the session's journal in the SHARED
        live directory and rehydrates just that session when its first
        request arrives — startup-style recovery, at request time.
        Returns the live session, or None when no journal exists here
        (the 404 stands) or replay fails (degrade per session)."""
        try:
            sid = self._clean_sid(session_id)
        except ValueError:  # garbage sid: the caller's 404 stands
            return None
        if sid is None or self._stopped:
            return None
        with self._lock:
            existing = self._sessions.get(sid)
            if existing is not None:
                return None if existing.closed else existing
        wal = self.dir / f"{sid}.wal"
        if not wal.is_file():
            return None
        if self._recover_wal(wal):
            return self.get(sid)
        return None

    def _recover_wal(self, wal: Path) -> bool:
        """Rehydrate one journal file (shared body of recover() and
        recover_one()).  False when the session already exists, the
        journal is headerless, or replay fails — recovery degrades per
        session, never raises."""
        sid = wal.stem
        with self._lock:
            if sid in self._sessions:
                return False
        try:
            records, _meta = jl.replay(wal)
            state = rebuild_live_state(records)
            if state["header"] is None:
                logger.warning("session %s: journal has no header; "
                               "skipped", sid)
                return False
            params = self._sanitize_params(
                state["header"].get("params") or {})
            fp = self._fingerprint(params)
            stale = state["header"].get("fingerprint") != fp
            with self._lock:
                if sid in self._sessions:  # raced a concurrent recover
                    return False
                session = self._register(sid, params, fp)
                session.recovered = True
                session.created_t = state["header"].get(
                    "created_t", session.created_t)
                header_trace = state["header"].get("trace_id")
                if isinstance(header_trace, str) and header_trace:
                    session.trace_id = header_trace
                header_tenant = state["header"].get("tenant")
                session.tenant = (header_tenant
                                  if isinstance(header_tenant, str)
                                  and header_tenant
                                  else f"session:{sid[:24]}")
                self._g_active.set(self._active_count())
            self._rehydrate(session, state, wal, stale=stale)
        except Exception as e:  # noqa: BLE001 - degrade per session
            logger.warning("session %s: recovery failed: %s: %s",
                           sid, type(e).__name__, e)
            with self._lock:
                self._sessions.pop(sid, None)
                self._g_active.set(self._active_count())
            return False
        self._c_recovered.inc()
        tr = get_tracer()
        if tr:
            tr.instant("session_resume", pid=PID_PIPELINE,
                       args={"session": sid,
                             "segments": session.n_raw_segments,
                             "chunk_records": len(state["chunks"]),
                             "node_records": len(state["nodes"]),
                             "trace": session.trace_id})
        logger.info(
            "session %s: recovered (%d segment batch(es), %d chunk "
            "record(s), %d reduce node(s)%s)", sid, session.append_seq,
            len(state["chunks"]), len(state["nodes"]),
            "; STALE fingerprint — summaries dropped" if stale else "")
        return True

    def status_doc(self, session: LiveSession) -> dict:
        """The GET /v1/sessions/<id> response body."""
        chunks = session.inc.chunk_count if session.inc else 0
        doc = {
            "object": "session",
            "id": session.session_id,
            "created_t": session.created_t,
            "recovered": session.recovered,
            "trace_id": session.trace_id,
            "tenant": session.tenant,
            "params": session.params,
            "append_seq": session.append_seq,
            "num_segments": session.n_raw_segments,
            "num_chunks": chunks,
            "end_time": session.end_time,
            "summarized": session.summary is not None,
            "staleness": {
                "pending_batches": session.stale_batches,
                "pending_tokens": session.stale_tokens,
            },
        }
        if session.usage:
            doc["usage"] = session.usage
        if session.journal is not None:
            doc["journal"] = session.journal.stats()
        return doc

    def stats(self) -> dict:
        with self._lock:
            n = len([s for s in self._sessions.values() if not s.closed])
        return {"sessions": n, "live_dir": str(self.dir)}

    def shutdown(self) -> None:
        self._stopped = True
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            s.cancel_ev.set()
            with s.ctl:
                ex = s._executor
            if ex is not None:
                ex.interrupt()
        for s in sessions:
            with s.lock:
                if s.journal is not None:
                    s.journal.close()

    # ---------------------------------------------------------- internals

    def _register(self, sid: str, params: dict,
                  fingerprint: str) -> LiveSession:  # holds-lock: _lock
        session = LiveSession(session_id=sid, params=params,
                              fingerprint=fingerprint,
                              wal_path=self.dir / f"{sid}.wal")
        session.inc = self._build_inc(params)
        # the journal handle exists BEFORE the session is visible: an
        # append racing create()/recover() must never find journal=None
        # and silently skip the WAL (Journal.__init__ is I/O-free)
        session.journal = jl.Journal(session.wal_path)
        self._sessions[sid] = session
        return session

    def _active_count(self) -> int:  # holds-lock: _lock
        return sum(1 for s in self._sessions.values() if not s.closed)

    def _require(self, session_id: str) -> LiveSession:
        session = self.get(session_id)
        if session is None or session.closed:
            raise KeyError(session_id)
        return session

    @staticmethod
    def _clean_sid(raw: str | None) -> str | None:
        if not isinstance(raw, str):
            return None
        raw = raw.strip()
        if raw and len(raw) <= 64 and all(
                ch.isalnum() or ch in "-_." for ch in raw):
            return raw
        if raw:
            raise ValueError(f"invalid session_id {raw!r} (want <=64 chars "
                             "of [A-Za-z0-9._-])")
        return None

    def _sanitize_params(self, params: dict | None) -> dict:
        p = dict(params or {})
        unknown = sorted(set(p) - set(_ALLOWED_PARAMS))
        if unknown:
            raise ValueError(f"unknown session param(s) {unknown}; "
                             f"supported: {sorted(_ALLOWED_PARAMS)}")
        if "max_tokens_per_chunk" in p:
            try:
                p["max_tokens_per_chunk"] = int(p["max_tokens_per_chunk"])
            except (TypeError, ValueError):
                raise ValueError(
                    "max_tokens_per_chunk must be an integer "
                    f"(got {p['max_tokens_per_chunk']!r})") from None
        if "class" in p and p["class"] not in _CLASSES:
            raise ValueError(f"unknown deadline class {p['class']!r}; "
                             f"want one of {_CLASSES}")
        return p

    def _fingerprint(self, params: dict) -> str:
        """The (prompt, model, chunking, tree) surface that determines
        what the journaled summaries MEAN — same gate as jobs: a journal
        written under a different surface must not rehydrate summaries
        into this run (the transcript itself always survives)."""
        e, c, r = self.config.engine, self.config.chunk, self.config.reduce
        return jl.config_fingerprint(
            live=True,  # live trees are stable-arity; never share a batch
                        # job's fingerprint space
            map_prompt=resolve_map_prompt(params.get("prompt_template"),
                                          None),
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
            context_tokens=c.context_tokens,
            arity=max(2, r.max_summaries_per_batch),
            max_levels=r.max_levels)

    def _build_inc(self, params: dict) -> IncrementalChunking:
        # engine=None on purpose (the jobs rule): chunk identity keys must
        # be purely (transcript, config)-deterministic
        chunker = build_chunker(self.config, engine=None,
                                max_tokens_per_chunk=params.get(
                                    "max_tokens_per_chunk"))
        return chunker.incremental()

    def _prepare(self, segments: list[dict]) -> list[dict]:
        """Live preprocessing: a STATELESS per-segment map.  Same-speaker
        merging and interval re-bucketing are disabled — both are
        stateful across the stream, so the result would depend on how
        appends were batched and a merge across an append boundary would
        rewrite a sealed chunk.  Long-segment splitting and text cleaning
        are per-segment and keep their config."""
        return preprocess_transcript(
            segments,
            merge_same_speaker=False,
            time_interval_seconds=None,
            max_segment_duration=self.config.data.max_segment_duration,
            preserve_timestamps=self.config.data.preserve_timestamps,
        )

    def _ingest(self, session: LiveSession,
                raw_segments: list[dict]) -> None:
        """Extend chunking + staleness state with one raw batch (caller
        holds the session lock; used by append and replay)."""
        processed = self._prepare(raw_segments)
        if not processed:
            return
        session.inc.append(processed)
        session.n_segments += len(processed)
        for s in processed:
            session.speakers.setdefault(s.get("speaker", "UNKNOWN"))
            session.end_time = max(session.end_time, s["end"])
        tok = session.inc.chunker.tokenizer
        batch_count = getattr(tok, "count_batch", None)
        texts = [s["text"] for s in processed]
        session.stale_tokens += (sum(batch_count(texts)) if batch_count
                                 else sum(tok.count(t) for t in texts))

    def _append(self, session: LiveSession, rec: dict) -> None:
        if session.journal is not None:
            session.journal.append(rec)

    def _rehydrate(self, session: LiveSession, state: dict, wal: Path,
                   stale: bool) -> None:
        """Rebuild a recovered session from replayed state (under the
        session lock — recovery usually runs before serving, but a
        handler racing it must see either nothing or the whole session).
        With a stale fingerprint the old WAL is set aside and a fresh
        journal re-persists header + segments; summaries/nodes drop
        (they were produced under a different surface)."""
        with session.lock:
            if stale:
                try:
                    os.replace(wal, str(wal) + ".stale")
                except OSError:
                    pass
                session.journal = jl.Journal(session.wal_path)
                self._append(session, {
                    "type": REC_SESSION, "session_id": session.session_id,
                    "fingerprint": session.fingerprint,
                    "params": session.params,
                    "created_t": session.created_t,
                    "trace_id": session.trace_id,
                    "tenant": session.tenant})
            tokens_by_seq: dict[int, int] = {}
            for seq in sorted(state["segments"]):
                raw = state["segments"][seq]
                session.append_seq = seq
                before = session.stale_tokens
                try:
                    self._ingest(session, raw)
                except Exception as e:  # noqa: BLE001 - degrade per batch
                    # a batch only a pre-validation build could have
                    # journaled: skip IT, never drop the whole session
                    logger.warning(
                        "session %s: segment batch %d unreplayable "
                        "(%s: %s); skipped", session.session_id, seq,
                        type(e).__name__, e)
                    continue
                session.n_raw_segments += len(raw)
                if stale:
                    self._append(session, {
                        "type": REC_SEGMENTS, "seq": seq, "segments": raw})
                tokens_by_seq[seq] = session.stale_tokens - before
            if stale:
                return
            for key, rec in state["chunks"].items():
                # errored records are NOT rehydrated: a restart is a
                # fresh retry chance (the jobs rule); empty-but-
                # successful summaries resume on presence, not truthiness
                if rec.get("summary") is not None and not rec.get("error"):
                    session.chunk_cache[key] = rec
            session.node_cache = dict(state["nodes"])
            snap = state["summary"]
            if snap is not None:
                session.summary = {k: snap.get(k) for k in
                                   ("summary", "seq", "n_segments",
                                    "end_time", "refreshed_t", "n_chunks",
                                    "levels", "hierarchical")}
            # staleness = tokens of the batches the recovered summary
            # does NOT cover (counting the whole transcript here would
            # both misreport pending_tokens and spuriously fire the
            # auto-refresh threshold on the next tiny append)
            covered = (session.summary or {}).get("seq", 0)
            session.stale_tokens = sum(
                t for seq, t in tokens_by_seq.items() if seq > covered)

    # ------------------------------------------------------------- refresh

    def _refresh_locked(self, session: LiveSession,
                        klass: str | None = None,
                        auto: bool = False) -> dict:
        """One incremental refresh (caller holds the session lock):
        re-run only dirty map chunks, then the reduce-tree path from each
        dirty leaf to the root through the stable tree + node cache."""
        t0 = time.time()
        if klass is not None and klass not in _CLASSES:
            raise ValueError(f"unknown deadline class {klass!r}; "
                             f"want one of {_CLASSES}")
        klass = (klass or session.params.get("class")
                 or self.live_cfg.class_default)
        params = session.params
        map_prompt = resolve_map_prompt(params.get("prompt_template"), None)
        sys_prompt = resolve_system_prompt(params.get("system_prompt"), None)
        reduce_prompt = resolve_reduce_prompt(
            params.get("aggregator_prompt"), None)
        summary_type = params.get("summary_type", "summary")

        chunks = session.inc.chunks()
        chunker = session.inc.chunker
        dirty: list[Chunk] = []
        reused = 0
        for c in chunks:
            # live map prompts use the APPEND-STABLE context header: the
            # batch header's "of N" / position% change on every append,
            # and a cached summary must mean the same thing a cold run of
            # the grown transcript would compute for this chunk
            c.text_with_context = chunker.stable_context_header(c) + c.text
            key = jl.chunk_key(c.chunk_index, c.start_time, c.end_time)
            rec = session.chunk_cache.get(key)
            # the text hash must match too: the open tail's (index,start,
            # end) can survive an append that grows its text (zero-
            # duration segments, sub-rounding end deltas) — reusing the
            # old summary there would break refresh==cold token identity
            if rec is not None and rec.get("text_sha") == _text_sha(c.text):
                c.summary = rec["summary"]
                c.tokens_used = rec.get("tokens_used", 0)
                c.error = None
                reused += 1
            else:
                c.summary = None
                c.error = None
                dirty.append(c)
        self._c_chunks_reused.inc(reused)

        # an interactive refresh carries a deadline budget end to end —
        # the executor stamps map AND reduce requests, so the scheduler
        # sheds/expires it ahead of unbounded bulk work
        engine_cfg = self.config.engine
        if klass == "interactive":
            engine_cfg = dataclasses.replace(
                engine_cfg,
                request_deadline_s=self.live_cfg.interactive_deadline_s)
        # cross-refresh drafting (tree speculation): the PREVIOUS refresh's
        # summary seeds the device draft buffer for every request of this
        # refresh — a rolling summary mostly restates itself, so the prior
        # text is a near-perfect n-gram draft source.  Advisory only
        # (exact-distribution verify): outputs are unchanged either way.
        prior = session.summary or {}

        def _publish_usage(snap: dict) -> None:
            session.usage = snap  # a reference swap (see status_doc)

        # the QoS class rides the refresh's deadline class: an interactive
        # refresh outranks batch job fan-out (fleet/qos.py); a bulk refresh
        # competes as batch like any other bulk work
        stamp = TenantStampEngine(self.engine, session.tenant,
                                  publish=_publish_usage, seed=session.usage,
                                  qos_class=("interactive"
                                             if klass == "interactive"
                                             else "batch"),
                                  draft_hint=prior.get("summary"))
        executor = MapExecutor(stamp, engine_cfg)
        with session.ctl:
            session._executor = executor

        map_failed = 0
        if dirty and not session.cancel_ev.is_set():
            map_failed = self._run_map(session, executor, dirty,
                                       map_prompt, summary_type, sys_prompt)
        if session.cancel_ev.is_set():
            with session.ctl:
                session._executor = None
            return {"cancelled": True}

        cache = _SessionNodeCache(self, session)
        reduce_cfg = dataclasses.replace(self.config.reduce,
                                         stable_tree=True)
        aggregator = ResultAggregator(executor, reduce_cfg,
                                      tokenizer=session.inc.chunker.tokenizer)
        metadata = {
            "duration": format_duration(session.end_time),
            "speakers": ", ".join(session.speakers),
            "num_chunks": len(chunks),
        }
        with self._engine_lock:
            agg = aggregator.aggregate(chunks, reduce_prompt, metadata,
                                       node_cache=cache)
        with session.ctl:
            session._executor = None
        if session.cancel_ev.is_set():
            return {"cancelled": True}
        self._c_nodes_reused.inc(cache.reused)

        final_error = bool(agg.get("final_error"))
        if not final_error:
            snap = {
                "summary": agg["final_summary"],
                "seq": session.append_seq,
                "n_segments": session.n_raw_segments,
                "end_time": session.end_time,
                "refreshed_t": time.time(),
                "n_chunks": len(chunks),
                "levels": agg["levels"],
                "hierarchical": agg["hierarchical"],
            }
            session.summary = snap
            session.stale_tokens = 0
            self._append(session, {"type": REC_SUMMARY, **snap})
        else:
            # the deliverable itself is an error marker (the final reduce
            # degraded — same rule as the jobs tier's failed status):
            # installing it would overwrite the last GOOD summary, journal
            # the marker as the session's truth, and zero the staleness
            # that should keep the auto-refresh threshold armed
            logger.warning(
                "session %s: refresh produced an error-marker final "
                "summary; previous summary retained, staleness kept",
                session.session_id)
        wall = time.time() - t0
        self._c_refreshes.inc()
        if chunks:
            self._h_dirty.observe(len(dirty) / len(chunks))
        self._h_refresh.observe(wall)
        tr = get_tracer()
        if tr:
            tr.instant("session_refresh", pid=PID_PIPELINE,
                       args={"session": session.session_id,
                             "dirty_chunks": len(dirty),
                             "total_chunks": len(chunks),
                             "nodes_reused": cache.reused,
                             "nodes_computed": cache.computed,
                             "class": klass,
                             "trace": session.trace_id})
        logger.info(
            "session %s: refresh (%s%s) %d/%d dirty chunks, %d/%d reduce "
            "nodes reused, %.2fs", session.session_id, klass,
            ", auto" if auto else "", len(dirty), len(chunks),
            cache.reused, cache.reused + cache.computed, wall)
        return {
            "object": "session.refresh",
            "class": klass,
            "auto": auto,
            "num_chunks": len(chunks),
            "dirty_chunks": len(dirty),
            "chunk_summaries_reused": reused,
            "map_failed": map_failed,
            "reduce_nodes_reused": cache.reused,
            "reduce_nodes_computed": cache.computed,
            "levels": agg["levels"],
            "hierarchical": agg["hierarchical"],
            "reduce_errors": agg.get("reduce_errors", 0),
            "final_error": final_error,
            "refresh_seconds": round(wall, 4),
            "summary": agg["final_summary"],
        }

    def _run_map(self, session: LiveSession, executor: MapExecutor,
                 dirty: list[Chunk], map_prompt: str, summary_type: str,
                 sys_prompt: str | None) -> int:
        """Map the dirty chunks, journaling each summary AS IT COMPLETES
        (the WAL advances inside the stream — the SIGKILL contract).
        Returns the failed-chunk count.  Successful summaries enter the
        session's chunk cache; failures keep their error marker for THIS
        refresh but are not cached, so the next refresh retries them."""
        chunk_by_rid = {i: c for i, c in enumerate(dirty)}
        requests = [executor.build_map_request(
            c, map_prompt, summary_type, sys_prompt, request_id=i)
            for i, c in enumerate(dirty)]
        with session.ctl:
            session._live_rids = set(chunk_by_rid)
        failed = [0]

        def on_final(res, submit) -> None:
            c = chunk_by_rid[res.request_id]
            with session.ctl:
                session._live_rids.discard(res.request_id)
            reason = degraded_reason(res)
            if reason is not None:
                c.summary = f"[Error processing chunk: {reason}]"
                c.error = reason
                failed[0] += 1
            else:
                c.summary = res.text
            c.tokens_used = res.total_tokens
            key = jl.chunk_key(c.chunk_index, c.start_time, c.end_time)
            if res.finish_reason != "cancelled":
                rec = {"type": jl.REC_CHUNK, "chunk_index": c.chunk_index,
                       "start_time": c.start_time, "end_time": c.end_time,
                       # tail-chunk guard: (index,start,end) alone is not
                       # enough identity for the OPEN chunk — a zero-
                       # duration (or sub-rounding) append grows its text
                       # without moving its end, and the stale summary
                       # would rehydrate over the grown content
                       "text_sha": _text_sha(c.text),
                       "summary": c.summary, "tokens_used": c.tokens_used,
                       "error": c.error}
                self._append(session, rec)
                if c.error is None:
                    session.chunk_cache[key] = rec
            if session.cancel_ev.is_set():
                executor.interrupt()
                with session.ctl:
                    rids = list(session._live_rids)
                for rid in rids:
                    executor.cancel(rid)

        with self._engine_lock:
            executor.run_requests_streaming(requests, on_final)
        with session.ctl:
            session._live_rids = set()
        return failed[0]
