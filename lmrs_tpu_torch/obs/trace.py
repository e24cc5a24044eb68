"""Request-lifecycle tracer: bounded ring buffer of Chrome trace events
(a copy of the reference's ``obs/trace.py``).

One process-wide tracer (enabled explicitly — ``--trace-out`` on the CLI /
bench, or ``enable_tracing()`` in tests) records span events as plain
dicts in a ``deque(maxlen=...)``: recording is an O(1) append, dropping is
oldest-first, and a disabled tracer costs one ``None`` check at each call
site — the ≤2% overhead budget is met by never formatting or allocating
when tracing is off.

Event vocabulary (the per-request chain the scheduler emits):

    enqueue → admit → [prefix_match] → prefill → first_token
        → decode_block* → finish | preempt | cancel

Deadline-lifecycle terminals add ``shed`` (rejected before prefill) and
``deadline`` (queued expiry) instants; an in-flight expiry closes the
``decode`` span and emits ``finish`` with ``reason="deadline"``.

plus scheduler-track ``decode_block``/``prefill_dispatch`` dispatch spans
and pipeline-track ``map_stage``/``reduce_level``/stage spans.  Export is
Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable directly in
Perfetto / chrome://tracing; ``validate_trace_file`` checks the fields
Perfetto requires and is shared by the tests and the CI trace-export gate.

Track layout: pid 1 = engine (tid 0 the scheduler dispatch track, tid
10+request_id one track per request), pid 2 = pipeline stages.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from pathlib import Path

PID_ENGINE = 1
PID_PIPELINE = 2
PID_STITCH = 9  # stitched per-trace tracks (stitch_traces output)
TID_SCHED = 0
REQ_TID_BASE = 10  # request_id -> tid offset (tid 0..9 reserved for tracks)
# trace-id-keyed tracks allocate from a disjoint base so they can never
# collide with the int-keyed ``REQ_TID_BASE + request_id`` tracks (HTTP
# batcher rids start at 0; executor rids ride 1<<20 epoch bands)
TRACE_TID_BASE = 1 << 30
# thread_name prefix that marks a track as belonging to one distributed
# trace — the cross-host stitcher keys on it, so the trace id needs to
# ride only the track METADATA, not every event's args
TRACE_TRACK_PREFIX = "trace:"

_PHASES = {"X", "i", "I", "B", "E", "M", "C"}


def req_tid(request_id: int) -> int:
    return REQ_TID_BASE + request_id


def new_trace_id() -> str:
    """Mint a fleet-unique trace id (ingress: server or router).  Short
    enough to ride headers/tickets/journals, unique enough that two hosts
    minting concurrently can never collide in one stitched trace."""
    return uuid.uuid4().hex[:16]


class Tracer:
    """Bounded in-memory trace recorder (thread-safe: deque.append is
    atomic, and writers only append)."""

    def __init__(self, capacity: int = 262_144):
        self.capacity = capacity
        self._events: deque[dict] = deque(maxlen=capacity)
        # total ever recorded (recorded - len = dropped).  The int += is a
        # read-modify-write — scheduler, HTTP handler, and sweeper threads
        # record concurrently, so it counts under the trace lock (a bare
        # increment was measured losing updates under concurrent spans;
        # the race detector's guarded-by annotation keeps it fixed).
        self.recorded = 0  # guarded-by: _trace_lock
        self._track_names: dict[tuple[int, int], str] = {}
        self._process_names: dict[int, str] = {
            PID_ENGINE: "lmrs-engine", PID_PIPELINE: "lmrs-pipeline"}
        # trace-id -> allocated tid (track_for): the per-request track key
        # for distributed traces — stable within a process, named
        # ``trace:<id>`` so the stitcher can match tracks across hosts
        self._trace_tids: dict[str, int] = {}  # guarded-by: _trace_lock
        self._trace_lock = threading.Lock()
        self.name_track(PID_ENGINE, TID_SCHED, "scheduler dispatches")
        self.name_track(PID_PIPELINE, TID_SCHED, "stages")

    # ------------------------------------------------------------- recording

    def instant(self, name: str, ts: float | None = None, *,
                tid: int = TID_SCHED, pid: int = PID_ENGINE,
                args: dict | None = None) -> None:
        """Point event at ``ts`` (seconds, default now)."""
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": (time.time() if ts is None else ts) * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._events.append(ev)
        with self._trace_lock:
            self.recorded += 1

    def complete(self, name: str, t0: float, t1: float, *,
                 tid: int = TID_SCHED, pid: int = PID_ENGINE,
                 args: dict | None = None) -> None:
        """Span [t0, t1] (seconds since epoch, same clock as instant)."""
        ev = {"name": name, "ph": "X", "ts": t0 * 1e6,
              "dur": max(t1 - t0, 0.0) * 1e6, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._events.append(ev)
        with self._trace_lock:
            self.recorded += 1

    def name_track(self, pid: int, tid: int, name: str) -> None:
        """Label a track (kept outside the ring so names survive overflow)."""
        self._track_names[(pid, tid)] = name

    def track_for(self, key: str | int, pid: int = PID_ENGINE) -> int:
        """Track id for a per-request span chain.  An int key is the
        legacy request-id mapping (``REQ_TID_BASE + id`` — unchanged, so
        engine-direct callers and their tests keep their track layout); a
        STRING key is a distributed trace id: the first call allocates a
        process-stable tid from ``TRACE_TID_BASE`` and names the track
        ``trace:<id>``, which is what lets the cross-host stitcher merge
        one request's spans from several hosts into one causal chain —
        and frees the per-request track from the executor's epoch-banded
        int ids (1<<20 bands made tids meaningless across runs)."""
        if isinstance(key, int):
            return req_tid(key)
        with self._trace_lock:
            tid = self._trace_tids.get(key)
            if tid is None:
                tid = TRACE_TID_BASE + len(self._trace_tids)
                self._trace_tids[key] = tid
                self.name_track(pid, tid, f"{TRACE_TRACK_PREFIX}{key}")
            return tid

    def clear(self) -> None:
        self._events.clear()
        with self._trace_lock:
            self.recorded = 0

    # --------------------------------------------------------------- reading

    def events(self) -> list[dict]:
        return list(self._events)

    def timestamps(self, name: str, tid: int | None = None,
                   ph: str | None = None) -> list[float]:
        """Start timestamps (seconds, sorted) of retained events named
        ``name``, optionally filtered by track/phase — the dispatch-gap
        analysis hook (``timestamps("decode_block", tid=TID_SCHED)`` is
        the per-dispatch list)."""
        return sorted(e["ts"] / 1e6 for e in self._events
                      if e["name"] == name
                      and (tid is None or e["tid"] == tid)
                      and (ph is None or e["ph"] == ph))

    def spans_by_tid(self, pid: int = PID_ENGINE) -> dict[int, list[dict]]:
        """Events grouped per track, each track ts-sorted (test helper)."""
        out: dict[int, list[dict]] = {}
        for e in self._events:
            if e["pid"] == pid:
                out.setdefault(e["tid"], []).append(e)
        for evs in out.values():
            evs.sort(key=lambda e: e["ts"])
        return out

    # --------------------------------------------------------------- export

    def payload(self, host: str | None = None) -> dict:
        """The exportable Chrome-trace document (also the ``GET /v1/trace``
        response body).  Metadata (process/thread names) is regenerated on
        every call so ring overflow can never drop it; ``clock_s`` stamps
        this host's wall clock at export time (a stitcher-side sanity
        anchor — the real skew anchor is the handoff event pair)."""
        meta: list[dict] = []
        # snapshot the name dicts under the lock: /v1/trace exports the
        # LIVE tracer while scheduler/handler threads allocate new trace
        # tracks (track_for), and iterating a mutating dict raises
        with self._trace_lock:
            process_names = list(self._process_names.items())
            track_names = list(self._track_names.items())
        for pid, name in process_names:
            meta.append({"name": "process_name", "ph": "M", "ts": 0,
                         "pid": pid, "tid": 0, "args": {"name": name}})
        for (pid, tid), name in track_names:
            meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                         "pid": pid, "tid": tid, "args": {"name": name}})
        doc = {"displayTimeUnit": "ms",
               "traceEvents": meta + list(self._events),
               "clock_s": time.time()}
        if host:
            doc["host"] = host
        return doc

    def export(self, path: str | Path) -> int:
        """Write Chrome trace-event JSON; returns the event count written."""
        payload = self.payload()
        Path(path).write_text(json.dumps(payload), encoding="utf-8")
        return len(payload["traceEvents"])


# ------------------------------------------------------------ global tracer

_tracer: Tracer | None = None


def get_tracer() -> Tracer | None:
    """The process tracer, or None when tracing is off (call sites guard
    with ``if tr:`` — the disabled path must stay allocation-free)."""
    return _tracer


def enable_tracing(capacity: int = 262_144) -> Tracer:
    """Install (or return the existing) process tracer."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(capacity=capacity)
    return _tracer


def disable_tracing() -> None:
    global _tracer
    _tracer = None


def export_current(path: str | Path) -> tuple[int | None, str | None]:
    """Export the process tracer (if any) to ``path`` without ever raising:
    returns (event_count, None) on success, (None, reason) otherwise.  The
    one exit-path export helper shared by the CLI and bench — both export
    in a ``finally`` where a raise would mask the run's real error."""
    tr = get_tracer()
    if tr is None:
        return None, "tracing was not enabled"
    try:
        return tr.export(path), None
    except Exception as e:  # noqa: BLE001 - includes serialization errors;
        return None, str(e)  # a raise here would mask the run's real error


# ----------------------------------------------------------------- validation

# Lifecycle instants whose args are a CONTRACT consumers parse (the
# stitcher's skew anchors, the postmortem reader, the jobs dashboard):
# a rename or dropped key here must fail the trace gate, not silently
# break a downstream reader.
_INSTANT_REQUIRED_ARGS: dict[str, tuple[str, ...]] = {
    "handoff_export": ("pages", "kv_len"),
    "handoff_import": ("pages", "kv_len"),
    "handoff_release": ("pages", "orphaned"),
    "job_submit": ("job",),
    "job_recover": ("job",),
    "job_resume": ("job", "resumed_chunks"),
    "job_done": ("job", "status"),
    "qos_reorder": ("picked",),
    "qos_preempt": ("slot",),
    "autoscale_action": ("action",),
}

# Perf-attribution (and counting) args: whenever present they must be
# finite non-negative numbers — a NaN MFU or negative byte count in a
# trace poisons every aggregation built on it.
_NONNEG_NUMERIC_ARGS = ("pages", "kv_len", "tokens", "prompt_tokens",
                        "completion_tokens", "resumed_chunks",
                        "flops_g", "hbm_gb", "mfu", "hbm_util")


def validate_trace_events(events: list) -> list[dict]:
    """Schema-check a trace-event list against what Perfetto requires:
    every event carries ``name``/``ph``/``ts``/``pid``/``tid``, ``X``
    events carry a non-negative ``dur``, ``M`` events carry ``args.name``.
    Handoff/job lifecycle instants must carry their contract args
    (``_INSTANT_REQUIRED_ARGS``) and perf-attribution args must be finite
    non-negative numbers.  Returns the events; raises ValueError with the
    first offender."""
    import math

    if not isinstance(events, list) or not events:
        raise ValueError("trace has no events")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"event {i} has a non-string name: {ev}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} has non-numeric ts: {ev}")
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"], int):
            raise ValueError(f"event {i} has non-int pid/tid: {ev}")
        if ev["ph"] == "X" and (not isinstance(ev.get("dur"), (int, float))
                                or ev["dur"] < 0):
            raise ValueError(f"event {i}: X event needs dur >= 0: {ev}")
        if ev["ph"] == "M" and "name" not in (ev.get("args") or {}):
            raise ValueError(f"event {i}: metadata event needs args.name")
        args = ev.get("args") or {}
        want = _INSTANT_REQUIRED_ARGS.get(ev["name"])
        if want is not None and ev["ph"] in ("i", "I"):
            for key in want:
                if key not in args:
                    raise ValueError(
                        f"event {i}: {ev['name']} instant missing "
                        f"args.{key}: {ev}")
        for key in _NONNEG_NUMERIC_ARGS:
            if key in args:
                v = args[key]
                if (isinstance(v, bool) or not isinstance(v, (int, float))
                        or not math.isfinite(v) or v < 0):
                    raise ValueError(
                        f"event {i}: args.{key} must be a finite "
                        f"non-negative number, got {v!r}: {ev}")
    return events


def validate_trace_file(path: str | Path) -> list[dict]:
    """Load + schema-check an exported trace (the CI trace-export gate)."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if events is None:
            raise ValueError("trace JSON object lacks 'traceEvents'")
    else:
        events = data
    return validate_trace_events(events)


# --------------------------------------------------- cross-host stitching
#
# A disaggregated request's spans live in two (or more) hosts' ring
# buffers, each on that host's wall clock.  ``stitch_traces`` merges the
# per-host ``/v1/trace`` pages into ONE Perfetto document:
#
# * every host keeps its own tracks (pids remapped so they never collide;
#   process names prefixed with the host's netloc);
# * host clocks are aligned using the handoff ticket's export/import
#   instant pair as the skew anchor — on real wall clocks an import
#   STRICTLY follows its export (the payload crossed the wire between
#   them) and the exporter's ``handoff_release`` strictly follows the
#   import (the ack crossed back), so each matched trace id yields a
#   feasible offset interval per host;
# * every track named ``trace:<id>`` contributes its events to a
#   synthesized per-trace track under ``PID_STITCH`` — the "one causal
#   chain" view where a request reads enqueue → prefill (pod A) →
#   handoff → decode (pod B) → finish on a single timeline.


def _host_offsets(per_host: list[dict]) -> list[float]:
    """Per-host clock offsets (seconds to ADD to that host's timestamps),
    host 0 as the reference.  For each unaligned host, matched handoff
    pairs against already-aligned hosts bound a feasible interval
    [lo, hi]; clocks already consistent (0 inside the interval) are left
    untouched, otherwise the minimal shift restoring causality is
    applied.  Hosts with no anchor pairs keep offset 0."""
    def anchors(info: dict) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {
            "handoff_export": {}, "handoff_import": {}, "handoff_release": {}}
        for e in info["events"]:
            if e.get("ph") == "M" or e.get("name") not in out:
                continue
            trace = info["tidmap"].get((e.get("pid"), e.get("tid")))
            if trace is not None:
                out[e["name"]].setdefault(trace, e.get("ts", 0) / 1e6)
        return out

    anch = [anchors(info) for info in per_host]
    offsets = [0.0] * len(per_host)
    aligned = {0} if per_host else set()
    eps = 1e-6
    progress = True
    while progress:
        progress = False
        for j in range(len(per_host)):
            if j in aligned:
                continue
            lo, hi = float("-inf"), float("inf")
            found = False
            for k in aligned:
                # host j imported what host k exported: export_k < import_j
                # < release_k (on the merged clock)
                for t, imp in anch[j]["handoff_import"].items():
                    exp = anch[k]["handoff_export"].get(t)
                    if exp is not None:
                        lo = max(lo, exp + offsets[k] - imp)
                        found = True
                    rel = anch[k]["handoff_release"].get(t)
                    if rel is not None and exp is not None:
                        hi = min(hi, rel + offsets[k] - imp)
                # host j exported what host k imported: the mirror bounds
                for t, exp in anch[j]["handoff_export"].items():
                    imp = anch[k]["handoff_import"].get(t)
                    if imp is None:
                        continue
                    hi = min(hi, imp + offsets[k] - exp)
                    found = True
                    rel = anch[j]["handoff_release"].get(t)
                    if rel is not None:
                        lo = max(lo, imp + offsets[k] - rel)
            if not found:
                continue
            if lo <= 0.0 <= hi:
                offsets[j] = 0.0  # clocks already causally consistent
            elif lo > 0.0:
                offsets[j] = lo + eps  # minimal forward shift
            else:
                offsets[j] = hi - eps  # minimal backward shift
            aligned.add(j)
            progress = True
    return offsets


def stitch_traces(pages: list[tuple[str, dict]]) -> dict:
    """Merge per-host trace pages (``[(netloc, /v1/trace payload)]``) into
    one Perfetto document (see the section comment above).  The returned
    dict carries a ``stitch`` block with the hosts merged, the applied
    clock offsets (ms), and the trace ids found — extra top-level keys
    Perfetto ignores but the CI gate and dashboards read."""
    per_host: list[dict] = []
    for host, doc in pages:
        events = (doc or {}).get("traceEvents") or []
        tidmap: dict[tuple, str] = {}
        for e in events:
            if (e.get("ph") == "M" and e.get("name") == "thread_name"):
                nm = (e.get("args") or {}).get("name", "")
                if isinstance(nm, str) and nm.startswith(TRACE_TRACK_PREFIX):
                    tidmap[(e.get("pid"), e.get("tid"))] = (
                        nm[len(TRACE_TRACK_PREFIX):])
        per_host.append({"host": host, "events": events, "tidmap": tidmap})
    offsets = _host_offsets(per_host)

    out_events: list[dict] = []
    for i, info in enumerate(per_host):
        off_us = offsets[i] * 1e6
        # pid remap: host i's pid p -> 10*(i+1)+p, far from PID_STITCH and
        # collision-free for any realistic per-host pid set (1, 2)
        for e in info["events"]:
            ne = dict(e)
            ne["pid"] = 10 * (i + 1) + int(e.get("pid", 0))
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    old = (e.get("args") or {}).get("name", "")
                    ne["args"] = {"name": f"{info['host']} {old}".strip()}
                out_events.append(ne)
                continue
            ne["ts"] = e.get("ts", 0) + off_us
            out_events.append(ne)

    traces = sorted({t for info in per_host for t in info["tidmap"].values()})
    trace_tid = {t: REQ_TID_BASE + j for j, t in enumerate(traces)}
    stitched: list[dict] = []
    for i, info in enumerate(per_host):
        off_us = offsets[i] * 1e6
        for e in info["events"]:
            if e.get("ph") == "M":
                continue
            trace = info["tidmap"].get((e.get("pid"), e.get("tid")))
            if trace is None:
                continue
            se = dict(e)
            se["pid"] = PID_STITCH
            se["tid"] = trace_tid[trace]
            se["ts"] = e.get("ts", 0) + off_us
            args = dict(se.get("args") or {})
            args.setdefault("host", info["host"])
            se["args"] = args
            stitched.append(se)
    stitched.sort(key=lambda e: e["ts"])

    meta: list[dict] = [{"name": "process_name", "ph": "M", "ts": 0,
                         "pid": PID_STITCH, "tid": 0,
                         "args": {"name": "lmrs-stitched"}}]
    for t, tid in trace_tid.items():
        meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                     "pid": PID_STITCH, "tid": tid,
                     "args": {"name": f"{TRACE_TRACK_PREFIX}{t}"}})
    return {
        "displayTimeUnit": "ms",
        "traceEvents": meta + out_events + stitched,
        "stitch": {
            "hosts": [info["host"] for info in per_host],
            "offsets_ms": {info["host"]: round(offsets[i] * 1e3, 3)
                           for i, info in enumerate(per_host)},
            "traces": traces,
        },
    }


def stitched_chains(events: list[dict]) -> dict[str, list[dict]]:
    """trace id -> ts-ordered events of its stitched track (``PID_STITCH``)
    from a stitched document's event list — the per-request causal chain
    the CI gate asserts on."""
    tid_trace: dict[int, str] = {}
    for e in events:
        if (e.get("ph") == "M" and e.get("name") == "thread_name"
                and e.get("pid") == PID_STITCH):
            nm = (e.get("args") or {}).get("name", "")
            if isinstance(nm, str) and nm.startswith(TRACE_TRACK_PREFIX):
                tid_trace[e["tid"]] = nm[len(TRACE_TRACK_PREFIX):]
    chains: dict[str, list[dict]] = {}
    for e in events:
        if e.get("ph") == "M" or e.get("pid") != PID_STITCH:
            continue
        trace = tid_trace.get(e.get("tid"))
        if trace is not None:
            chains.setdefault(trace, []).append(e)
    for evs in chains.values():
        evs.sort(key=lambda e: e.get("ts", 0))
    return chains
