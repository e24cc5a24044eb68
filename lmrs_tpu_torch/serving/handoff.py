"""KV page handoff: the wire codec and the ticket bookkeeping both sides of a
disaggregated pair share (the port of the reference's
``serving/handoff.py``; the wire is byte for byte the reference's).

* ``encode_payload``/``decode_payload``: a payload dict (numpy page data,
  bf16 or int8, plus slot state) as one self-framing blob,
  ``<8-byte big-endian header length><JSON header><raw bytes>``; each array
  becomes ``{"__nd__": [dtype, shape, offset, nbytes]}`` in the header.
  No pickle.  bfloat16 travels as raw 2-byte words: it decodes into the
  ``BF16`` dtype (``engine/host_kv.py``), which ``torch.frombuffer(...,
  dtype=torch.bfloat16)`` or a ``.view`` reads, and encodes under the name
  ``"bfloat16"``.
* ``TicketRegistry``: the exporting side's published tickets.  A ticket is
  consumed exactly once by the importer's ack and expires at its deadline;
  a consumed or expired ticket answers None to every later fetch or ack,
  so a duplicate ack can never double-free.
* ``ImportLog``: the importing side's dedup set, so a re-delivered ticket
  is rejected instead of imported twice.

Standard library and numpy only.
"""

from __future__ import annotations

import json
import threading
import time
import uuid

import numpy as np

from lmrs_tpu_torch.engine.host_kv import dtype_name, np_dtype

__all__ = ["encode_payload", "decode_payload", "TicketRegistry", "ImportLog"]


def encode_payload(payload: dict) -> bytes:
    """A payload dict as one self-framing blob (raw array bytes, never
    base64-in-JSON)."""
    header: dict = {}
    blobs: list[bytes] = []
    off = 0
    for key, val in payload.items():
        if isinstance(val, np.ndarray):
            raw = np.ascontiguousarray(val).tobytes()
            header[key] = {"__nd__": [dtype_name(val), list(val.shape),
                                      off, len(raw)]}
            blobs.append(raw)
            off += len(raw)
        else:
            header[key] = val
    head = json.dumps(header).encode("utf-8")
    return len(head).to_bytes(8, "big") + head + b"".join(blobs)


def decode_payload(data: bytes) -> dict:
    """Inverse of :func:`encode_payload`.  Raises ``ValueError`` on a
    truncated or malformed blob (a transfer cut mid-payload is a rejected
    import, never short page data)."""
    if len(data) < 8:
        raise ValueError("handoff payload truncated (no header frame)")
    hlen = int.from_bytes(data[:8], "big")
    if len(data) < 8 + hlen:
        raise ValueError("handoff payload truncated (header incomplete)")
    try:
        header = json.loads(data[8:8 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"handoff payload header unparseable: {e}") from e
    body = memoryview(data)[8 + hlen:]
    out: dict = {}
    for key, val in header.items():
        if isinstance(val, dict) and "__nd__" in val:
            dtype_str, shape, off, nbytes = val["__nd__"]
            if off + nbytes > len(body):
                raise ValueError(
                    f"handoff payload truncated: array {key!r} needs "
                    f"{off + nbytes} body bytes, have {len(body)}")
            try:
                dt = np_dtype(dtype_str)
            except TypeError as e:
                raise ValueError(f"handoff payload dtype {dtype_str!r} "
                                 f"unknown: {e}") from e
            out[key] = np.frombuffer(body[off:off + nbytes],
                                     dtype=dt).reshape(shape)
        else:
            out[key] = val
    return out


class TicketRegistry:
    """Exporting side's ticket table: id -> (request id, deadline,
    consumed).  Thread-safe; ``clock`` is injectable for tests."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._tickets: dict[str, dict] = {}  # guarded-by: _lock

    def create(self, request_id, deadline_t: float,
               trace_id: str | None = None) -> str:
        """Publish a ticket; ``trace_id`` rides the record so the importing
        leg stays on the request's trace."""
        tid = uuid.uuid4().hex
        with self._lock:
            self._tickets[tid] = {"rid": request_id, "deadline_t": deadline_t,
                                  "consumed": False, "trace_id": trace_id,
                                  "created_t": self._clock()}
        return tid

    def lookup(self, ticket: str) -> dict | None:
        """A copy of a live ticket's record, or None when unknown,
        consumed or expired (the fetch's 410)."""
        now = self._clock()
        with self._lock:
            rec = self._tickets.get(ticket)
            if rec is None or rec["consumed"] or rec["deadline_t"] <= now:
                return None
            return dict(rec)

    def consume(self, ticket: str):
        """The ack: mark the ticket consumed exactly once and return its
        request id; None for unknown, expired or already consumed."""
        now = self._clock()
        with self._lock:
            rec = self._tickets.get(ticket)
            if rec is None or rec["consumed"] or rec["deadline_t"] <= now:
                return None
            rec["consumed"] = True
            return rec["rid"]

    def sweep(self, now: float | None = None) -> list[tuple]:
        """Drop expired tickets; returns ``[(ticket, rid, was_consumed)]``
        — the un-consumed ones are ORPHANS whose pins the caller
        releases."""
        now = self._clock() if now is None else now
        out: list[tuple] = []
        with self._lock:
            for tid in [t for t, r in self._tickets.items()
                        if r["deadline_t"] <= now]:
                rec = self._tickets.pop(tid)
                out.append((tid, rec["rid"], rec["consumed"]))
        return out

    def stats(self) -> dict:
        with self._lock:
            live = sum(1 for r in self._tickets.values() if not r["consumed"])
            return {"tickets": len(self._tickets), "unconsumed": live}


class ImportLog:
    """Importing side's dedup of imported ticket ids (bounded FIFO set)."""

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._lock = threading.Lock()
        self._seen: dict[str, None] = {}  # guarded-by: _lock

    def seen(self, ticket: str) -> bool:
        with self._lock:
            return ticket in self._seen

    def add(self, ticket: str) -> bool:
        """Record an import; False when the ticket was imported already."""
        with self._lock:
            if ticket in self._seen:
                return False
            self._seen[ticket] = None
            while len(self._seen) > self._cap:
                self._seen.pop(next(iter(self._seen)))
            return True
