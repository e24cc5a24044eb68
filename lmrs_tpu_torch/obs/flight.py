"""Flight recorder: crash-adjacent postmortem dumps.

When the serving path hits one of the "what just happened" events — a
dispatch fault killing a scheduler run, a deadline-expiry storm, an
invariant-auditor failure — the in-memory trace ring still holds the
last N spans and the metric registry the counters that led up to it.
``dump_postmortem`` freezes both into one atomically-written JSON file
so the evidence survives the process (the same motivation as the jobs
WAL, applied to telemetry).

Disabled unless ``LMRS_POSTMORTEM_DIR`` points at a directory (the chaos
suite arms it per scenario); dumps are throttled per reason
(``LMRS_POSTMORTEM_MIN_S``, default 5 s) so a fault storm cannot turn
the recorder itself into a disk-filling failure mode.  Never raises —
a postmortem writer that can crash the process it is documenting would
be worse than no recorder.

Schema (``validate_postmortem_file``)::

    {"schema": "lmrs-postmortem-v1", "reason": str, "ts": float,
     "host": str, "pid": int, "spans": [trace events...],
     "metrics": {...}, "extra": {...}}
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from pathlib import Path

from lmrs_tpu_torch.obs.trace import get_tracer, validate_trace_events
from lmrs_tpu_torch.utils.env import env_float, env_str

logger = logging.getLogger("lmrs_torch.obs.flight")

POSTMORTEM_SCHEMA = "lmrs-postmortem-v1"
DEFAULT_LAST_N_SPANS = 2048

_throttle_lock = threading.Lock()
_last_dump: dict[str, float] = {}  # reason -> monotonic time of last dump


def postmortem_dir() -> Path | None:
    """The armed dump directory, or None when the recorder is disabled."""
    d = env_str("LMRS_POSTMORTEM_DIR")
    return Path(d) if d else None


def _min_interval_s() -> float:
    # the shared parser owns the hard cases: "" means the documented 5 s
    # default, and a NaN can never reach the throttle comparison (NaN
    # compares False against the elapsed time, i.e. an unthrottled storm)
    return env_float("LMRS_POSTMORTEM_MIN_S", 5.0, lo=0.0)


def dump_postmortem(reason: str, *, metrics: dict | None = None,
                    extra: dict | None = None,
                    last_n: int = DEFAULT_LAST_N_SPANS,
                    out_dir: str | Path | None = None) -> Path | None:
    """Write one postmortem file; returns its path, or None when the
    recorder is disabled, throttled, or the write failed (logged).  The
    write is atomic (tmp + rename) so a reader — or a second crash — can
    never observe a torn dump."""
    try:
        d = Path(out_dir) if out_dir is not None else postmortem_dir()
        if d is None:
            return None
        now_mono = time.monotonic()
        with _throttle_lock:
            last = _last_dump.get(reason)
            if last is not None and now_mono - last < _min_interval_s():
                return None
            _last_dump[reason] = now_mono
        tr = get_tracer()
        spans = tr.events()[-last_n:] if tr is not None else []
        doc = {
            "schema": POSTMORTEM_SCHEMA,
            "reason": reason,
            "ts": time.time(),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "spans": spans,
            "metrics": dict(metrics or {}),
            "extra": dict(extra or {}),
        }
        d.mkdir(parents=True, exist_ok=True)
        name = f"postmortem-{reason}-{int(time.time() * 1e3)}-{os.getpid()}"
        path = d / f"{name}.json"
        tmp = d / f"{name}.tmp"
        tmp.write_text(json.dumps(doc), encoding="utf-8")
        os.replace(tmp, path)
        logger.warning("flight recorder: %s postmortem written to %s "
                       "(%d spans)", reason, path, len(spans))
        return path
    except Exception:  # noqa: BLE001 - the recorder must never crash its host
        logger.warning("flight recorder dump failed", exc_info=True)
        return None


def validate_postmortem_file(path: str | Path) -> dict:
    """Load + schema-check one postmortem dump (the chaos gate's check).
    Raises ValueError on any violation; returns the document."""
    doc = json.loads(Path(path).read_text(encoding="utf-8"))
    if not isinstance(doc, dict):
        raise ValueError("postmortem is not a JSON object")
    if doc.get("schema") != POSTMORTEM_SCHEMA:
        raise ValueError(f"unknown postmortem schema {doc.get('schema')!r}")
    for key, typ in (("reason", str), ("ts", (int, float)), ("host", str),
                     ("pid", int), ("spans", list), ("metrics", dict),
                     ("extra", dict)):
        if not isinstance(doc.get(key), typ):
            raise ValueError(f"postmortem field {key!r} missing or wrong "
                             f"type: {doc.get(key)!r}")
    if not doc["reason"]:
        raise ValueError("postmortem reason is empty")
    if doc["spans"]:  # an empty ring (tracing off) is a valid dump
        validate_trace_events(doc["spans"])
    return doc
