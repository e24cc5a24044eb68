"""``lmrs-lint-torch`` — the static-analysis passes over the port
(docs/torch/ANALYSIS.md).

Exit status: 0 when no NEW findings (baseline-accepted ones don't fail;
expired baseline entries print as warnings), 1 when new findings exist,
2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from lmrs_tpu_torch.analysis.core import (BASELINE_FILE, Baseline,
                                          RepoContext, find_repo_root,
                                          run_passes)

FAMILIES = ("race", "tracing", "drift", "env")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lmrs-lint-torch",
        description="static analysis of the PyTorch port: lock discipline "
                    "/ race detection, eager-step hazards, contract drift, "
                    "and LMRS_* env discipline")
    p.add_argument("root", nargs="?", default=None,
                   help="repo root to scan (default: auto-detected from "
                        "cwd)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline file (default: <root>/{BASELINE_FILE})")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings: rewrite the baseline "
                        "to exactly this run's findings and exit 0")
    p.add_argument("--family", action="append", choices=FAMILIES,
                   dest="families", metavar="FAMILY",
                   help="run only this pass family (repeatable; default: "
                        "all)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, baseline ignored")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    root = Path(args.root).resolve() if args.root else find_repo_root()
    if not (root / "lmrs_tpu_torch").is_dir():
        print(f"lmrs-lint-torch: {root} does not look like the repo root "
              "(no lmrs_tpu_torch/)", file=sys.stderr)
        return 2
    ctx = RepoContext.load(root)
    families = tuple(args.families) if args.families else FAMILIES
    findings = run_passes(ctx, families)

    baseline_path = Path(args.baseline) if args.baseline \
        else root / BASELINE_FILE
    if args.write_baseline:
        if args.families:
            # a subset run would overwrite the ENTIRE baseline, silently
            # discarding the families that did not run
            print("lmrs-lint-torch: --write-baseline requires a full run "
                  "(drop --family)", file=sys.stderr)
            return 2
        Baseline.from_findings(findings).save(baseline_path)
        print(f"lmrs-lint-torch: baseline written to {baseline_path} "
              f"({len(findings)} accepted finding(s))")
        return 0
    if args.no_baseline:
        new, accepted, expired = findings, [], []
    else:
        new, accepted, expired = Baseline.load(baseline_path).apply(
            findings)

    if args.json:
        doc = {
            "new": [f.__dict__ for f in new],
            "accepted": [f.__dict__ for f in accepted],
            "expired_baseline_keys": expired,
            "families": list(families),
        }
        print(json.dumps(doc, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    if expired:
        print(f"\nwarning: {len(expired)} baseline entr"
              f"{'y' if len(expired) == 1 else 'ies'} no longer match any "
              "finding (fixed — prune with --write-baseline):")
        for key in expired:
            print(f"    {key}")
    print(f"\nlmrs-lint-torch: {len(new)} new finding(s), {len(accepted)} "
          f"baseline-accepted, {len(expired)} expired baseline entr"
          f"{'y' if len(expired) == 1 else 'ies'} "
          f"[families: {', '.join(families)}]")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
