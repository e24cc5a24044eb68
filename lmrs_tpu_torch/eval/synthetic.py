"""Synthetic transcript→summary pairs for the offline quality gate.

This environment has no network, so no real LLM API output and no real
pretrained checkpoint can anchor summary quality (the reference's quality
bar lives behind OpenAI's API, llm_executor.py:250-326).  What CAN be
demonstrated offline, end-to-end through the real stack, is that the
training loop + engine learn an actual summarization mapping: transcripts
are generated with known topic structure, the ground-truth summary is a
deterministic function of that structure, a model is fine-tuned on
(prompt, summary) pairs with the production loss masking
(training/cli.load_examples format), and held-out generations are ROUGE-
scored against the ground truth — with a trivial extractive baseline as
the bar to beat (tests/test_quality.py).

The task is summarization in miniature: find the topic mentions buried in
filler dialogue and emit them in a fixed report format.  Byte-level
models must learn format, topic vocabulary, and content selection; a
model that merely copies the transcript opening (the extractive baseline)
scores poorly.

A copy of the reference's ``eval/synthetic.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import numpy as np

TOPICS = [
    "budget", "hiring", "roadmap", "metrics", "launch", "pricing",
    "staffing", "marketing", "support", "security", "testing", "design",
]

_OPENERS = [
    "so next up we have {t}",
    "let's talk about {t} now",
    "moving on to {t} today",
    "the team walked through {t}",
    "quick update on {t} from me",
    "we spent a while on {t}",
]

_FILLER = [
    "okay everyone settle in please.",
    "sorry my audio cut out there.",
    "let me share my screen quickly.",
    "we are running a bit behind.",
    "any questions before we move on?",
    "i will post the notes after.",
]


def make_example(rng: np.random.Generator) -> dict:
    """One (prompt, summary) pair: a short timestamped transcript whose
    ground-truth summary lists the topics in order of appearance."""
    n_topics = int(rng.integers(2, 4))
    topics = [TOPICS[i] for i in rng.choice(len(TOPICS), n_topics, replace=False)]
    lines = []
    minute = 0
    for t in topics:
        if rng.random() < 0.7:
            lines.append(f"[00:{minute:02d}] {rng.choice(_FILLER)}")
            minute += int(rng.integers(1, 3))
        opener = str(rng.choice(_OPENERS)).format(t=t)
        lines.append(f"[00:{minute:02d}] {opener}.")
        minute += int(rng.integers(1, 3))
    transcript = "\n".join(lines)
    return {
        "prompt": f"List the topics.\n{transcript}\nTopics:",
        "summary": " " + ", ".join(topics) + ".",
        "topics": topics,
    }


def make_dataset(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [make_example(rng) for _ in range(n)]


def extractive_baseline(prompt: str) -> str:
    """The trivial baseline the trained model must beat: parrot the first
    transcript line (classic lead-1 extraction)."""
    for line in prompt.splitlines():
        if line.startswith("["):
            return line
    return prompt[:60]
