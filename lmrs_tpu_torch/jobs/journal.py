"""Append-only, fsync'd, CRC-framed JSONL write-ahead journal (the port of
the reference's ``jobs/journal.py``; the same frame, keys and replay, so a
journal written by either package replays to the same state in the other).

Every unit of completed work (a chunk summary, a reduce-tree node, the
terminal record) is appended as ONE framed line and fsync'd before the
in-memory state advances, so a SIGKILL at any instant loses at most the
record being written.

Frame format (one record per line)::

    crc32-hex SP canonical-json LF

Replay: a torn final line is dropped (``meta["torn"]``) and its unit of
work redone; a record that fails its CRC before the tail stops replay
(``meta["corrupt"]``; everything after it is untrusted); duplicates are
idempotent (``rebuild_state`` keys chunks by identity and nodes by
content).  A failed append or fsync degrades (the journal marks itself
non-durable and the job goes on); it never raises.  The
``journal.append`` and ``journal.fsync`` fault-injection sites
(``testing/faults.py``, ``OSError``) fire inside ``Journal.append``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import zlib
from pathlib import Path

from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.utils.fingerprint import canonical_json, config_fingerprint

logger = logging.getLogger("lmrs_torch.jobs.journal")

# record types the manager writes (unknown types are ignored on replay —
# forward compatibility).  REC_HEADER fields: job_id, fingerprint,
# transcript_sha, created_t, trace_id, tenant; a superseding header adds
# num_chunks.
REC_HEADER = "job_header"
REC_CHUNK = "chunk_done"
REC_NODE = "reduce_node_done"
REC_DONE = "job_done"


def job_id_for(transcript_data: dict, fingerprint: str) -> str:
    """Content-addressed job id: the same transcript under the same config
    fingerprint is the same job, so a resubmit after a crash (or a
    duplicate POST) converges on one journal."""
    digest = hashlib.sha256()
    digest.update(fingerprint.encode("utf-8"))
    digest.update(b":")
    digest.update(canonical_json(transcript_data).encode("utf-8"))
    return "job-" + digest.hexdigest()[:16]


def chunk_key(chunk_index: int, start_time: float, end_time: float) -> str:
    """Chunk identity key (the (index, start, end) match rule of the
    pipeline's ``_load_resume``): a record of another chunking never
    rehydrates the wrong span."""
    return f"{chunk_index}:{round(start_time, 3)}:{round(end_time, 3)}"


def node_key(summaries: list[str], template: str | None,
             metadata: dict | None) -> str:
    """Content-addressed reduce-node key: exactly the inputs that decide
    the node's prompt, so a resumed run (same chunks, same tree) lands on
    the journaled nodes without structural bookkeeping."""
    return hashlib.sha256(canonical_json(
        [template or "", metadata or {}, list(summaries)]
    ).encode("utf-8")).hexdigest()[:16]


class Journal:
    """One job's append-only WAL.  Thread-safe (the map stream's
    ``on_final`` callbacks and the manager's control path both append).

    ``append`` returns True when the record is durably on disk; a failed
    append/fsync degrades (record dropped / not-yet-durable, ``degraded``
    set, warning logged) instead of raising — a journal I/O error must
    not kill the job whose progress it was recording.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None  # guarded-by: _lock
        self._lock = threading.Lock()
        self.appends = 0  # guarded-by: _lock
        self.append_failures = 0  # guarded-by: _lock
        self.fsync_failures = 0  # guarded-by: _lock
        self.degraded = False  # guarded-by: _lock

    def append(self, rec: dict) -> bool:
        payload = canonical_json(rec)
        data = payload.encode("utf-8")
        line = f"{zlib.crc32(data):08x} ".encode("ascii") + data + b"\n"
        with self._lock:
            try:
                # injection site: the append itself fails (disk full,
                # volume gone): the job degrades to non-durable progress
                faults.fire("journal.append", OSError)
                if self._fh is None:
                    # (re)opening: the file may end in a PARTIAL line — a
                    # torn tail from a crashed predecessor, or bytes a
                    # failed append left behind.  Appending onto it would
                    # merge two records into one corrupt mid-file line,
                    # and replay would then drop every record after it —
                    # records already acknowledged durable.  Truncate back
                    # to the last complete newline first.
                    self._truncate_partial_tail()
                    self._fh = open(self.path, "ab")
                self._fh.write(line)
                self._fh.flush()
            except Exception as e:  # noqa: BLE001 - degrade, never fatal
                self.append_failures += 1
                self.degraded = True
                logger.warning(
                    "journal %s: append failed (%s: %s); record dropped — "
                    "durability degraded", self.path, type(e).__name__, e)
                self._close_locked()  # the handle may be poisoned
                return False
            self.appends += 1
            try:
                # injection site: the write landed in the page cache but
                # the fsync fails (the record may not survive a crash)
                faults.fire("journal.fsync", OSError)
                # the fsync runs inside the lock on purpose: append
                # durability ordering is the journal's contract, so every
                # appender serializes on the disk here
                os.fsync(self._fh.fileno())  # lint: ignore[race.blocking-under-lock]
            except Exception as e:  # noqa: BLE001 - degrade, never fatal
                self.fsync_failures += 1
                self.degraded = True
                logger.warning(
                    "journal %s: fsync failed (%s: %s); record may not "
                    "survive a crash — durability degraded",
                    self.path, type(e).__name__, e)
                return False
            return True

    def _truncate_partial_tail(self) -> None:
        """Drop trailing bytes past the last complete newline (caller
        holds the lock).  Best-effort: if the disk is too broken to
        repair, the append that follows degrades like any other."""
        try:
            with open(self.path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                keep = size
                while keep > 0:
                    back = min(keep, 1 << 16)
                    fh.seek(keep - back)
                    data = fh.read(back)
                    nl = data.rfind(b"\n")
                    if nl >= 0:
                        keep = keep - back + nl + 1
                        break
                    keep -= back
                if keep < size:
                    fh.truncate(keep)
                    logger.warning(
                        "journal %s: truncated %d trailing partial byte(s) "
                        "(torn tail / failed append) before appending",
                        self.path, size - keep)
        except OSError:
            pass  # no file yet, or unrepairable — append will handle it

    def _close_locked(self) -> None:  # holds-lock: _lock
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:  # noqa: BLE001
                pass
            self._fh = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def stats(self) -> dict:
        return {"appends": self.appends,
                "append_failures": self.append_failures,
                "fsync_failures": self.fsync_failures,
                "degraded": self.degraded}


def replay(path: str | Path) -> tuple[list[dict], dict]:
    """Read every intact record; returns ``(records, meta)`` where meta
    carries ``records`` / ``dropped`` counts plus the ``torn`` (partial
    final line dropped) and ``corrupt`` (mid-file damage; suffix dropped)
    flags.  Never raises on journal content — a journal exists to survive
    crashes, so its reader must survive what crashes leave behind."""
    meta = {"records": 0, "dropped": 0, "torn": False, "corrupt": False}
    p = Path(path)
    try:
        data = p.read_bytes()
    except OSError:
        return [], meta
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()  # file ended with a complete newline
    records: list[dict] = []
    for i, raw in enumerate(lines):
        rec = _parse_line(raw)
        if rec is None:
            if i == len(lines) - 1:
                # torn tail: the crash window this format exists for
                meta["torn"] = True
                meta["dropped"] += 1
                logger.warning("journal %s: dropped torn tail record", p)
            else:
                # mid-file damage: the suffix is untrusted
                meta["corrupt"] = True
                meta["dropped"] += len(lines) - i
                logger.error(
                    "journal %s: corrupt record at line %d; dropping it "
                    "and the %d record(s) after it",
                    p, i + 1, len(lines) - i - 1)
            break
        records.append(rec)
    meta["records"] = len(records)
    return records, meta


def _parse_line(raw: bytes) -> dict | None:
    """One framed line -> record dict, or None when the frame is invalid
    (short line, bad CRC, malformed JSON, non-object payload)."""
    if len(raw) < 10 or raw[8:9] != b" ":
        return None
    try:
        want = int(raw[:8], 16)
    except ValueError:
        return None
    payload = raw[9:]
    if zlib.crc32(payload) != want:
        return None
    try:
        rec = json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def rebuild_state(records: list[dict]) -> dict:
    """Fold replayed records into the canonical job state:

    ``{"header": rec|None, "chunks": {chunk_key: rec}, "nodes":
    {node_key: text}, "done": rec|None}``

    Idempotent by construction — duplicates overwrite their own key with
    identical content, so the same journal replayed any number of times
    yields byte-identical state (``canonical_json(rebuild_state(...))``;
    the replay-determinism test asserts exactly this).
    """
    state: dict = {"header": None, "chunks": {}, "nodes": {}, "done": None}
    for rec in records:
        kind = rec.get("type")
        if kind == REC_HEADER:
            state["header"] = rec
        elif kind == REC_CHUNK:
            key = chunk_key(rec.get("chunk_index", -1),
                            rec.get("start_time", 0.0),
                            rec.get("end_time", 0.0))
            state["chunks"][key] = rec
        elif kind == REC_NODE:
            if rec.get("key"):
                state["nodes"][rec["key"]] = rec.get("text", "")
        elif kind == REC_DONE:
            state["done"] = rec
        # unknown types: ignored (forward compatibility)
    return state
