"""Token-budget transcript chunker ("Big Chunkeroosky" capability).

Greedy packer over preprocessed segments into chunks bounded by
``max_tokens_per_chunk - context_tokens``, with sentence-aware splitting of
oversized segments, clause/word fallbacks for pathological sentences,
per-sentence timestamp interpolation by character position, and a context
header per chunk (time range, speakers, ordinal, position-in-transcript).

Reference: big_chunkeroosky.py:20-567 (greedy loop :80-137; sentence split
:267-435; clause fallback :437-542; header :197-232; finalize :147-195).

Deliberate fixes over the reference (SURVEY.md §2.3):
* ``overlap_tokens`` is real: each chunk after the first re-includes trailing
  sentences of the previous chunk up to the overlap budget (quirk 1 — the
  reference stores the knob and never reads it).
* ``position_percentage`` is measured against the WHOLE transcript span, not
  the chunk's own span (quirk 2).
* Sentence segmentation is an in-tree splitter (no NLTK punkt download).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Any

from lmrs_tpu_torch.data.preprocessor import format_timestamp
from lmrs_tpu_torch.data.tokenizer import Tokenizer, get_tokenizer

logger = logging.getLogger("lmrs_torch.chunker")

Segment = dict[str, Any]

# Sentence boundary: terminal punctuation (+ closing quotes/brackets) followed
# by whitespace and an upper-case/digit/bracket start.  Common abbreviations
# are protected.  Replaces NLTK punkt (big_chunkeroosky.py:14-18,44) — punkt
# model data is not available offline.
_ABBREV = r"(?<!\b[A-Z])(?<!\bDr)(?<!\bMr)(?<!\bMs)(?<!\bMrs)(?<!\bSt)(?<!\bvs)(?<!\be\.g)(?<!\bi\.e)(?<!\betc)"
_SENT_RE = re.compile(_ABBREV + r'([.!?]+["\')\]]*)\s+(?=["\'(\[]?[A-Z0-9])')
_CLAUSE_RE = re.compile(r"(?<=[,;:])\s+")


def split_sentences(text: str) -> list[str]:
    """Split text into sentences, keeping terminal punctuation attached."""
    if not text:
        return []
    parts: list[str] = []
    last = 0
    for m in _SENT_RE.finditer(text):
        parts.append(text[last : m.end(1)].strip())
        last = m.end(1)
    tail = text[last:].strip()
    if tail:
        parts.append(tail)
    return [p for p in parts if p]


@dataclass
class Chunk:
    """One map-stage work item (reference chunk record schema,
    big_chunkeroosky.py:70-77,166-195)."""

    segments: list[Segment] = field(default_factory=list)
    text: str = ""
    token_count: int = 0
    start_time: float = 0.0
    end_time: float = 0.0
    speakers: list[str] = field(default_factory=list)
    chunk_index: int = 0
    total_chunks: int = 0
    position_percentage: float = 0.0
    text_with_context: str = ""
    # filled by the map stage (llm_executor.py:205-211 equivalents)
    summary: str | None = None
    tokens_used: int = 0
    device_seconds: float = 0.0
    error: str | None = None
    system_prompt: str | None = None

    def to_dict(self) -> dict:
        return {
            "segments": self.segments,
            "text": self.text,
            "token_count": self.token_count,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "speakers": self.speakers,
            "chunk_index": self.chunk_index,
            "total_chunks": self.total_chunks,
            "position_percentage": self.position_percentage,
            "text_with_context": self.text_with_context,
            "summary": self.summary,
            "tokens_used": self.tokens_used,
            "error": self.error,
        }


class TranscriptChunker:
    """Greedy token-budget packer (reference BigChunkeroosky,
    big_chunkeroosky.py:23-44)."""

    def __init__(
        self,
        max_tokens_per_chunk: int = 4000,
        overlap_tokens: int = 200,
        tokenizer: Tokenizer | str = "approx",
        context_tokens: int = 150,
    ):
        if max_tokens_per_chunk <= context_tokens:
            raise ValueError("max_tokens_per_chunk must exceed context_tokens")
        self.max_tokens_per_chunk = max_tokens_per_chunk
        self.overlap_tokens = max(0, overlap_tokens)
        self.context_tokens = context_tokens
        self.effective_max_tokens = max_tokens_per_chunk - context_tokens
        self.tokenizer = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer

    # -- public API ---------------------------------------------------------

    def chunk_transcript(self, segments: list[Segment]) -> list[Chunk]:
        """Pack segments into token-budgeted chunks (big_chunkeroosky.py:46-145).

        One-shot chunking IS the incremental state machine fed everything
        at once (``incremental()``), so there is exactly one packing loop."""
        if not segments:
            return []
        inc = self.incremental()
        inc.append(segments)
        chunks = inc.chunks()
        logger.info(
            "chunked %d segments -> %d chunks (budget %d tok, overlap %d)",
            len(segments), len(chunks), self.effective_max_tokens, self.overlap_tokens,
        )
        return chunks

    def incremental(self) -> "IncrementalChunking":
        """Append-only chunking state for a transcript that GROWS (live
        sessions): ``append`` extends the stream,
        ``chunks`` snapshots the pack so far.  Sealed chunk identities
        ``(chunk_index, start_time, end_time)`` and text are frozen the
        moment a later chunk opens; only the open tail chunk extends —
        the stability every downstream cache key (map summaries, reduce
        nodes) leans on."""
        return IncrementalChunking(self)

    def postprocess_chunks(self, chunks: list[Chunk]) -> list[Chunk]:
        """Backfill total_chunks + refresh headers (big_chunkeroosky.py:544-567)."""
        total = len(chunks)
        for c in chunks:
            c.total_chunks = total
            c.text_with_context = self._create_context_header(c) + c.text
        return chunks

    # -- internals ----------------------------------------------------------

    def _count(self, text: str) -> int:
        return self.tokenizer.count(text)

    def _count_batch(self, texts: list[str]) -> list[int]:
        """One call for many strings."""
        fn = getattr(self.tokenizer, "count_batch", None)
        if fn is not None:
            return fn(texts)
        return [self.tokenizer.count(t) for t in texts]

    def _overlap_segments(self, packed: list[Segment]) -> list[Segment]:
        """Trailing sentences of a finished chunk, up to ``overlap_tokens``.

        Real implementation of the knob the reference ignores (quirk 1).
        Overlap re-enters the next chunk as a synthetic context segment so
        timestamps stay truthful.
        """
        if not self.overlap_tokens:
            return []
        picked: list[str] = []
        budget = self.overlap_tokens
        last = packed[-1]
        for sent in reversed(split_sentences(last["text"])):
            n = self._count(sent)
            if n > budget:
                break
            picked.insert(0, sent)
            budget -= n
        if not picked:
            return []
        return [
            {
                "start": last["start"],
                "end": last["end"],
                "text": " ".join(picked),
                "speaker": last.get("speaker", "UNKNOWN"),
                "is_overlap": True,
            }
        ]

    def _finalize_chunk(
        self, segments: list[Segment], index: int, t0: float, t1: float
    ) -> Chunk:
        """Assemble the chunk record (big_chunkeroosky.py:147-195).

        ``position_percentage`` is the chunk start's position within the WHOLE
        transcript span — the reference mistakenly normalizes by the chunk's
        own span (quirk 2)."""
        start = min(s["start"] for s in segments)
        end = max(s["end"] for s in segments)
        speakers: dict[str, None] = {}
        for s in segments:
            speakers.setdefault(s.get("speaker", "UNKNOWN"))
        text = " ".join(self._format_segment(s) for s in segments)
        span = max(t1 - t0, 1e-9)
        chunk = Chunk(
            segments=[dict(s) for s in segments],
            text=text,
            token_count=self._count(text),
            start_time=start,
            end_time=end,
            speakers=list(speakers),
            chunk_index=index,
            position_percentage=100.0 * (start - t0) / span,
        )
        chunk.text_with_context = self._create_context_header(chunk) + chunk.text
        return chunk

    def _format_segment(self, seg: Segment) -> str:
        """Per-segment text with a leading timestamp marker
        (big_chunkeroosky.py:244-265)."""
        marker = f"[{format_timestamp(seg['start'])}]"
        if seg.get("is_overlap"):
            return f"(context from previous chunk: {seg['text']})"
        if seg["text"].startswith("["):  # already carries inline markers
            return seg["text"]
        return f"{marker} {seg['text']}"

    def _create_context_header(self, chunk: Chunk) -> str:
        """Orientation header the map model sees (big_chunkeroosky.py:197-232)."""
        time_range = (
            f"{format_timestamp(chunk.start_time)} - {format_timestamp(chunk.end_time)}"
        )
        total = chunk.total_chunks or "?"
        return (
            f"[TRANSCRIPT SECTION {chunk.chunk_index + 1} of {total}]\n"
            f"[TIME RANGE: {time_range}]\n"
            f"[SPEAKERS: {', '.join(chunk.speakers)}]\n"
            f"[POSITION: {chunk.position_percentage:.0f}% through the transcript]\n\n"
        )

    def stable_context_header(self, chunk: Chunk) -> str:
        """Append-stable variant of the context header (live sessions,
        ``live/session.py``): no ``of N`` total and no position percentage —
        both change on every append, so a map prompt carrying them could
        never be cached across refreshes (the summary a sealed chunk got
        at 8 chunks would differ from the one a cold run of 31 chunks
        gives it).  Everything left is a pure function of the chunk
        itself."""
        time_range = (
            f"{format_timestamp(chunk.start_time)} - {format_timestamp(chunk.end_time)}"
        )
        return (
            f"[TRANSCRIPT SECTION {chunk.chunk_index + 1}]\n"
            f"[TIME RANGE: {time_range}]\n"
            f"[SPEAKERS: {', '.join(chunk.speakers)}]\n\n"
        )

    def _chunk_large_segment(self, seg: Segment) -> list[Segment]:
        """Split an oversized segment into sentence-level pieces, each under
        the budget, with timestamps interpolated by character position
        (big_chunkeroosky.py:267-435, interpolation :351-366)."""
        sentences = split_sentences(seg["text"])
        sent_counts = dict(zip(sentences, self._count_batch(sentences)))
        pieces: list[Segment] = []
        total_chars = max(len(seg["text"]), 1)
        span = seg["end"] - seg["start"]
        cursor = 0

        def time_at(char_pos: int) -> float:
            return seg["start"] + span * (char_pos / total_chars)

        buf: list[str] = []
        buf_tokens = 0
        buf_start_char = 0

        def flush_buf(end_char: int) -> None:
            nonlocal buf, buf_tokens, buf_start_char
            if buf:
                pieces.append(
                    {
                        "start": time_at(buf_start_char),
                        "end": time_at(end_char),
                        "text": " ".join(buf),
                        "speaker": seg.get("speaker", "UNKNOWN"),
                    }
                )
            buf, buf_tokens = [], 0
            buf_start_char = end_char

        for sent in sentences:
            n = sent_counts[sent]
            if n > self.effective_max_tokens:
                flush_buf(cursor)
                # advance the char cursor per fragment so interior flushes
                # interpolate distinct timestamps (not the sentence start)
                for frag in self._split_long_sentence(sent):
                    fn = self._count(frag)
                    if buf_tokens + fn > self.effective_max_tokens:
                        flush_buf(cursor)
                    buf.append(frag)
                    buf_tokens += fn
                    cursor += len(frag) + 1
                flush_buf(cursor)
                continue
            if buf_tokens + n > self.effective_max_tokens:
                flush_buf(cursor)
            buf.append(sent)
            buf_tokens += n
            cursor += len(sent) + 1
        flush_buf(total_chars)
        return pieces

    def _split_long_sentence(self, sentence: str) -> list[str]:
        """Clause-level split with ~20-word group fallback
        (big_chunkeroosky.py:437-542)."""
        clauses = _CLAUSE_RE.split(sentence)
        out: list[str] = []
        for clause in clauses:
            if self._count(clause) <= self.effective_max_tokens:
                out.append(clause)
                continue
            words = clause.split()
            for i in range(0, len(words), 20):
                out.append(" ".join(words[i : i + 20]))
        return [c for c in out if c]


class IncrementalChunking:
    """Append-only chunking state (``TranscriptChunker.incremental``).

    THE packing loop of the repo — ``chunk_transcript`` routes through it
    — restructured so the greedy cursor survives between appends.  The
    greedy packer is forward-only (a chunk's contents depend only on
    segments before it), which is what makes incremental emission
    byte-identical to a one-shot pack over the same segment prefix:

    * **sealed chunks** (everything before the open tail) froze their
      segment list, text, token count, and ``(chunk_index, start_time,
      end_time)`` identity the moment the next chunk opened — an append
      can never move an emitted boundary;
    * the **open tail chunk** extends (or flushes and opens successors)
      exactly as the one-shot loop would have, had the appended segments
      been present from the start;
    * snapshot-time fields that depend on the WHOLE transcript so far
      (``total_chunks``, ``position_percentage``, the context header) are
      recomputed per ``chunks()`` call — they are presentation, not
      identity, and the one-shot path recomputes them the same way.

    Not thread-safe: callers (the live session tier) serialize appends
    per session.
    """

    def __init__(self, chunker: TranscriptChunker):
        self._ck = chunker
        self._sealed: list[Chunk] = []   # identity/text frozen forever
        self._current: list[Segment] = []  # the open tail's segments
        self._current_tokens = 0
        self._t0: float | None = None    # running min(start) over the stream
        self._t1: float | None = None    # running max(end)
        self._n_segments = 0

    @property
    def sealed_count(self) -> int:
        """Chunks whose identity and text can never change again."""
        return len(self._sealed)

    @property
    def chunk_count(self) -> int:
        """Sealed chunks + the open tail (what ``chunks()`` would return)."""
        return len(self._sealed) + (1 if self._current else 0)

    @property
    def chunker(self) -> TranscriptChunker:
        return self._ck

    @property
    def n_segments(self) -> int:
        return self._n_segments

    def append(self, segments: list[Segment]) -> None:
        """Extend the stream.  Continues the greedy pack exactly where the
        previous append left it (big_chunkeroosky.py:46-145 loop body)."""
        ck = self._ck
        if not segments:
            return
        for s in segments:
            self._t0 = s["start"] if self._t0 is None else min(self._t0, s["start"])
            self._t1 = s["end"] if self._t1 is None else max(self._t1, s["end"])
        self._n_segments += len(segments)
        seg_counts = ck._count_batch([s["text"] for s in segments])
        for seg, n in zip(segments, seg_counts):
            if n > ck.effective_max_tokens:
                # Oversized segment: flush, then split sentence-aware into
                # its own run of chunks (big_chunkeroosky.py:101-128).
                self._flush()
                if self._current:  # drop overlap before an oversized split run
                    self._current, self._current_tokens = [], 0
                for piece in ck._chunk_large_segment(seg):
                    pn = ck._count(piece["text"])
                    if self._current_tokens + pn > ck.effective_max_tokens:
                        self._flush()
                    self._current.append(piece)
                    self._current_tokens += pn
                continue
            if self._current_tokens + n > ck.effective_max_tokens:
                self._flush()
                if self._current_tokens + n > ck.effective_max_tokens:
                    # overlap seeding left no room for this segment — drop
                    # the overlap rather than exceed the budget
                    self._current, self._current_tokens = [], 0
            self._current.append(seg)
            self._current_tokens += n

    def _flush(self) -> None:
        """Seal the open tail and seed the next chunk with its overlap."""
        ck = self._ck
        if self._current:
            self._sealed.append(ck._finalize_chunk(
                self._current, len(self._sealed), self._t0, self._t1))
            overlap = ck._overlap_segments(self._current)
            self._current = overlap
            self._current_tokens = sum(ck._count(s["text"]) for s in overlap)

    def chunks(self) -> list[Chunk]:
        """Snapshot the pack so far — byte-identical to
        ``chunk_transcript`` over the same segment stream.

        Sealed chunks are the SAME objects across snapshots (their
        ``summary``/accounting fields, written by the map stage, survive);
        the open tail chunk is rebuilt per snapshot since appends extend
        it.  ``position_percentage`` / ``total_chunks`` / the context
        header are refreshed against the stream seen so far."""
        out = list(self._sealed)
        if self._current:
            out.append(self._ck._finalize_chunk(
                self._current, len(self._sealed), self._t0, self._t1))
        # whole-transcript presentation fields: the span grew with every
        # append, so sealed chunks' stored positions are stale snapshots
        span = max((self._t1 or 0.0) - (self._t0 or 0.0), 1e-9)
        for c in out:
            c.position_percentage = 100.0 * (c.start_time - (self._t0 or 0.0)) / span
        self._ck.postprocess_chunks(out)
        return out

