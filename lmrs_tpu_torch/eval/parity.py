"""Parity harness: run the pipeline and score its summary against a stored
baseline with ROUGE (the port of the reference's ``eval/parity.py``).

The baseline file is either a plain-text summary or a JSON record
``{"summary": "...", "meta": {...}}``.  ``run_parity`` executes the full
map-reduce pipeline (``TranscriptSummarizer``) on a transcript and reports
ROUGE-1/2/L plus throughput; ``evaluate_parity`` scores an
already-produced summary.

CLI: ``python -m lmrs_tpu_torch.eval.parity --input t.json --baseline
ref.txt [--backend mock|torch|http] [--device cuda|cpu]``; exit 0 when
ROUGE-L F clears ``--threshold``, 1 when it does not, 2 on unreadable
inputs.  ``--backend http`` fans over the servers named by ``LMRS_HOSTS``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any

from lmrs_tpu_torch.eval.rouge import rouge_scores


@dataclasses.dataclass
class ParityReport:
    """ROUGE scores + run stats, with a single pass/fail gate on ROUGE-L F."""

    rouge1_f: float
    rouge2_f: float
    rougeL_f: float
    threshold: float
    chunks: int = 0
    wall_s: float = 0.0
    chunks_per_sec: float = 0.0
    summary: str = ""

    @property
    def passed(self) -> bool:
        return self.rougeL_f >= self.threshold

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["passed"] = self.passed
        return d


def load_baseline(path: str | Path) -> str:
    """Baseline summary from plain text or a {"summary": ...} JSON record."""
    raw = Path(path).read_text(encoding="utf-8")
    try:
        obj = json.loads(raw)
    except json.JSONDecodeError:
        return raw.strip()
    if isinstance(obj, dict):
        if "summary" not in obj:
            raise ValueError(
                f"baseline {path} is JSON but has no top-level 'summary' key "
                f"(keys: {sorted(obj)[:8]}); extract the summary text first"
            )
        return str(obj["summary"]).strip()
    if isinstance(obj, list):
        raise ValueError(f"baseline {path} is a JSON array, not a summary record")
    return raw.strip()


def evaluate_parity(candidate: str, baseline: str, threshold: float = 0.3) -> ParityReport:
    scores = rouge_scores(candidate, baseline)
    return ParityReport(
        rouge1_f=scores["rouge1"]["f"],
        rouge2_f=scores["rouge2"]["f"],
        rougeL_f=scores["rougeL"]["f"],
        threshold=threshold,
        summary=candidate,
    )


def run_parity(
    transcript: dict[str, Any],
    baseline_summary: str,
    config: Any = None,
    threshold: float = 0.3,
    device=None,
    **summarize_kw: Any,
) -> ParityReport:
    """Full pipeline on ``transcript`` scored against ``baseline_summary``;
    the engine runs on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for)."""
    from lmrs_tpu_torch.config import PipelineConfig
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer

    cfg = config or PipelineConfig()
    summarizer = TranscriptSummarizer(cfg, device=device)
    t0 = time.time()
    try:
        result = summarizer.summarize(transcript, **summarize_kw)
        wall = time.time() - t0  # exclude engine teardown from throughput
    finally:
        summarizer.shutdown()
    report = evaluate_parity(result["summary"], baseline_summary, threshold)
    report.chunks = result.get("num_chunks", 0)
    report.wall_s = wall
    report.chunks_per_sec = report.chunks / wall if wall > 0 else 0.0
    return report


def _main(argv: list[str] | None = None) -> int:
    import argparse

    from lmrs_tpu_torch.config import EngineConfig, PipelineConfig

    p = argparse.ArgumentParser(description="ROUGE parity vs a stored baseline summary")
    p.add_argument("--input", "-i", required=True, help="transcript JSON")
    p.add_argument("--baseline", "-b", required=True, help="baseline summary (txt or JSON)")
    p.add_argument("--backend", default="mock", help="mock | torch | http")
    p.add_argument("--model", default="tiny", help="model preset name")
    p.add_argument("--device", default="cuda",
                   help="backend torch: cuda (default) | cpu")
    p.add_argument("--threshold", type=float, default=0.3, help="ROUGE-L F gate")
    p.add_argument("--json", action="store_true", help="print the full report as JSON")
    args = p.parse_args(argv)

    try:
        transcript = json.loads(Path(args.input).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        print(f"error: cannot read transcript {args.input}: {e}", file=sys.stderr)
        return 2
    try:
        baseline = load_baseline(args.baseline)
    except (OSError, ValueError, UnicodeDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        # make_engine resolves EngineConfig.model to a preset itself.
        cfg = PipelineConfig(engine=EngineConfig(backend=args.backend,
                                                 model=args.model))
        report = run_parity(transcript, baseline, cfg,
                            threshold=args.threshold, device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(
            f"ROUGE-1 {report.rouge1_f:.4f}  ROUGE-2 {report.rouge2_f:.4f}  "
            f"ROUGE-L {report.rougeL_f:.4f}  (gate {report.threshold})  "
            f"{report.chunks} chunks in {report.wall_s:.2f}s "
            f"({report.chunks_per_sec:.2f} chunks/s)  "
            f"{'PASS' if report.passed else 'FAIL'}"
        )
    return 0 if report.passed else 1


if __name__ == "__main__":
    raise SystemExit(_main())
