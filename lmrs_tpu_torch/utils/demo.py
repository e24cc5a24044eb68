"""Demo transcript loader: the example fixture when the repo carries one,
otherwise a deterministic synthetic transcript (same generator and seed as
the reference package's loader, so both packages see the same text)."""

from __future__ import annotations

import json
import random
from pathlib import Path

_FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "data"
            / "transcript-example.json")


def load_demo_transcript(max_segments: int | None = None) -> dict:
    """``{"segments": [...]}`` — example fixture if present, else synthetic."""
    if _FIXTURE.exists():
        data = json.loads(_FIXTURE.read_text())
    else:
        data = {"segments": _synthesize()}
    if max_segments is not None:
        data = {**data, "segments": data["segments"][:max_segments]}
    return data


def _synthesize(n: int = 600) -> list[dict]:
    rng = random.Random(0)
    words = (
        "the roadmap review covers inference latency kernel design hiring "
        "budget datasets evaluation and the quarterly launch milestones"
    ).split()
    segs, t = [], 0.0
    for i in range(n):
        dur = 2.0 + rng.random() * 6.0
        text = " ".join(rng.choice(words) for _ in range(10 + rng.randrange(15)))
        segs.append({"start": round(t, 2), "end": round(t + dur, 2),
                     "text": text.capitalize() + ".",
                     "speaker": f"SPEAKER_{(i // 7) % 2:02d}"})
        t += dur + rng.random()
    return segs
