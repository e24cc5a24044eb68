"""ROUGE-1 / ROUGE-2 / ROUGE-L, self-contained (no egress for rouge-score).

Standard definitions (Lin 2004): n-gram recall/precision/F1 against one or
more references; ROUGE-L from the longest common subsequence.  Tokenization
matches the common implementation: lowercase, alphanumeric runs only.

The reference repo has no metrics at all; this is the quality gate demanded
by BASELINE.json (.metric = "ROUGE-L parity with the GPT-4o API baseline").

A copy of the reference's ``eval/rouge.py`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Iterable

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def _f_measure(matches: int, cand_total: int, ref_total: int) -> dict[str, float]:
    p = matches / cand_total if cand_total else 0.0
    r = matches / ref_total if ref_total else 0.0
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return {"precision": p, "recall": r, "f": f}


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(candidate: str, reference: str, n: int = 1) -> dict[str, float]:
    """Clipped n-gram overlap between candidate and one reference."""
    cand = _ngrams(tokenize(candidate), n)
    ref = _ngrams(tokenize(reference), n)
    matches = sum((cand & ref).values())
    return _f_measure(matches, sum(cand.values()), sum(ref.values()))


def _lcs_len(a: list[str], b: list[str]) -> int:
    """Length of the longest common subsequence, O(len(a)*len(b)) time,
    O(min) memory — summaries are short enough that this is instant."""
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(candidate: str, reference: str) -> dict[str, float]:
    """Sentence-level ROUGE-L (LCS over the whole token streams)."""
    cand = tokenize(candidate)
    ref = tokenize(reference)
    return _f_measure(_lcs_len(cand, ref), len(cand), len(ref))


def rouge_scores(candidate: str, references: str | Iterable[str]) -> dict[str, dict[str, float]]:
    """ROUGE-1/2/L against one or more references (best-F per metric)."""
    if isinstance(references, str):
        references = [references]
    references = list(references)
    if not references:
        raise ValueError("rouge_scores needs at least one reference")
    best: dict[str, dict[str, float]] = {}
    for ref in references:
        for name, score in (
            ("rouge1", rouge_n(candidate, ref, 1)),
            ("rouge2", rouge_n(candidate, ref, 2)),
            ("rougeL", rouge_l(candidate, ref)),
        ):
            if name not in best or score["f"] > best[name]["f"]:
                best[name] = score
    return best
