"""Transcript segment preprocessing.

Capability parity with the reference preprocessor (preprocessor.py:15-361):
drop empties, clean text, merge consecutive same-speaker segments under a
duration cap (keeping per-original timing + inline ``[MM:SS]`` markers), or
re-bucket into fixed time intervals.  Pure functions of their inputs — the
deterministic half of the pipeline, unit-tested directly (SURVEY.md §4).

Divergences from the reference (deliberate, per SURVEY.md §2.3):
* no dead ``is_single_speaker`` computation (quirk 4);
* no ``print`` progress — structured logging only (§5.5).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Iterable

from lmrs_tpu_torch.runtime import native

logger = logging.getLogger("lmrs_torch.preprocessor")

Segment = dict[str, Any]

_WS_RE = re.compile(r"\s+")
_REPEAT_WORD_RE = re.compile(r"\b(\w+)(\s+\1\b)+", re.IGNORECASE)
_PUNCT_SPACE_RE = re.compile(r"([.!?,;:])([A-Za-z])")


def clean_text_py(text: str) -> str:
    """The Python cleaner: the plain version of the native scan."""
    if not text:
        return ""
    text = _WS_RE.sub(" ", text).strip()
    text = _REPEAT_WORD_RE.sub(r"\1", text)
    text = _PUNCT_SPACE_RE.sub(r"\1 \2", text)
    return text


def clean_text(text: str) -> str:
    """Normalize a segment's text (reference clean_text, preprocessor.py:69-89).

    Collapses whitespace, dedups immediately-repeated words ("the the" →
    "the"), and restores a missing space after sentence punctuation
    ("end.Next" → "end. Next").  Runs the C++ scan (``runtime/native``)
    unless ``LMRS_NATIVE=0`` selects ``clean_text_py``.
    """
    if not text:
        return ""
    if native.enabled():
        return native.clean_text_native(text)
    return clean_text_py(text)


def _clean_all(texts: list) -> list[str]:
    """Clean a list of texts: one native batch call, or the Python cleaner
    under ``LMRS_NATIVE=0``.  Non-string entries (e.g. ``"text": null`` in
    the input JSON) clean to "" and are dropped by the caller."""
    texts = [t if isinstance(t, str) else "" for t in texts]
    if native.enabled():
        return native.clean_text_batch(texts)
    return [clean_text_py(t) for t in texts]


def format_timestamp(seconds: float) -> str:
    """Seconds → ``MM:SS`` (or ``H:MM:SS`` past one hour).

    Reference: preprocessor.py:91-107.
    """
    seconds = max(0, int(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}:{m:02d}:{s:02d}"
    return f"{m:02d}:{s:02d}"


def preprocess_transcript(
    segments: Iterable[Segment],
    merge_same_speaker: bool = True,
    time_interval_seconds: float | None = None,
    max_segment_duration: float = 120.0,
    preserve_timestamps: bool = True,
) -> list[Segment]:
    """Clean + merge diarized segments (reference preprocess_transcript,
    preprocessor.py:15-67).

    Input schema per segment: ``{"start": s, "end": s, "text": str,
    "speaker": str}`` (README.md:162-175).  Output segments add
    ``segment_timestamps`` (per-original timing) when merged.
    """
    segments = list(segments)
    texts = _clean_all([seg.get("text", "") for seg in segments])
    cleaned: list[Segment] = []
    for seg, text in zip(segments, texts):
        if not text:
            continue  # drop empty segments (preprocessor.py:37-39)
        cleaned.append(
            {
                "start": float(seg.get("start", 0.0)),
                "end": float(seg.get("end", 0.0)),
                "text": text,
                "speaker": seg.get("speaker", "UNKNOWN"),
            }
        )

    if time_interval_seconds:
        out = aggregate_by_time_interval(cleaned, time_interval_seconds, preserve_timestamps)
    elif merge_same_speaker:
        out = combine_same_speaker_segments(cleaned, max_segment_duration, preserve_timestamps)
    else:
        out = cleaned

    logger.info("preprocessed %d segments -> %d", len(list(cleaned)), len(out))
    return out


def combine_same_speaker_segments(
    segments: list[Segment],
    max_segment_duration: float = 120.0,
    preserve_timestamps: bool = True,
) -> list[Segment]:
    """Merge consecutive same-speaker segments up to a duration cap.

    Reference: combine_same_speaker_segments (preprocessor.py:109-165) +
    create_combined_segment (:167-215).
    """
    if not segments:
        return []
    merged: list[Segment] = []
    run: list[Segment] = [segments[0]]
    for seg in segments[1:]:
        same = seg["speaker"] == run[0]["speaker"]
        would_span = seg["end"] - run[0]["start"]
        if same and would_span <= max_segment_duration:
            run.append(seg)
        else:
            merged.append(_combine_run(run, preserve_timestamps))
            run = [seg]
    merged.append(_combine_run(run, preserve_timestamps))
    return merged


def _combine_run(run: list[Segment], preserve_timestamps: bool) -> Segment:
    if len(run) == 1:
        seg = dict(run[0])
        seg["segment_timestamps"] = [(seg["start"], seg["end"])]
        return seg
    if preserve_timestamps:
        # Inline [MM:SS] markers keep provenance through the merge
        # (reference embeds markers at preprocessor.py:190-197).
        parts = [f"[{format_timestamp(s['start'])}] {s['text']}" for s in run]
    else:
        parts = [s["text"] for s in run]
    return {
        "start": run[0]["start"],
        "end": run[-1]["end"],
        "text": " ".join(parts),
        "speaker": run[0]["speaker"],
        "segment_timestamps": [(s["start"], s["end"]) for s in run],
    }


def aggregate_by_time_interval(
    segments: list[Segment],
    interval_seconds: float,
    preserve_timestamps: bool = True,
) -> list[Segment]:
    """Re-bucket segments into fixed wall-clock intervals.

    Reference: aggregate_by_time_interval (preprocessor.py:217-324).  Buckets
    that receive no segments are simply absent.  Multi-speaker buckets get
    ``speaker="MULTIPLE"`` and per-utterance ``SPEAKER:`` prefixes.
    """
    if not segments or interval_seconds <= 0:
        return segments
    buckets: dict[int, list[Segment]] = {}
    for seg in segments:
        buckets.setdefault(int(seg["start"] // interval_seconds), []).append(seg)

    out: list[Segment] = []
    for idx in sorted(buckets):
        group = buckets[idx]
        speakers = {s["speaker"] for s in group}
        parts = []
        for s in group:
            prefix = f"[{format_timestamp(s['start'])}] " if preserve_timestamps else ""
            who = f"{s['speaker']}: " if len(speakers) > 1 else ""
            parts.append(f"{prefix}{who}{s['text']}")
        out.append(
            {
                "start": group[0]["start"],
                "end": group[-1]["end"],
                "text": " ".join(parts),
                "speaker": group[0]["speaker"] if len(speakers) == 1 else "MULTIPLE",
                "segment_timestamps": [(s["start"], s["end"]) for s in group],
            }
        )
    return out


def extract_speakers(segments: Iterable[Segment]) -> list[str]:
    """Unique speakers in first-appearance order (preprocessor.py:326-342)."""
    seen: dict[str, None] = {}
    for seg in segments:
        seen.setdefault(seg.get("speaker", "UNKNOWN"))
    return list(seen)


def get_transcript_duration(segments: list[Segment]) -> float:
    """Total span in seconds (preprocessor.py:344-361)."""
    if not segments:
        return 0.0
    return max(s["end"] for s in segments) - min(s["start"] for s in segments)


if __name__ == "__main__":  # stage demo (pattern: preprocessor.py:364-441)
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    segs = load_demo_transcript()["segments"]
    out = preprocess_transcript(segs)
    print(f"segments in : {len(segs)}")
    print(f"segments out: {len(out)} (merge ratio {len(out) / max(len(segs), 1):.3f})")
    print(f"speakers    : {extract_speakers(out)}")
    print(f"duration    : {get_transcript_duration(out) / 3600:.2f} h")
    if out:
        print(f"first merged segment:\n  {out[0]['text'][:300]}")
