"""chip_smoke's quality-gate recipe (phase 19b: bench-smoke widths trained
in f32 for 200 AdamW steps, served in bf16 by the continuous engine through
the card's kernels) from each init seed given: how far that gate's ROUGE-L
depends on the draw.  One JSON line a seed, after the card's name and
power limit.  Needs one CUDA card; imports no JAX.

    python scripts/torch_quality_seeds.py 0 1 2 3 4 5 6 7

``scripts/quality_seeds_reference.py`` is its CPU counterpart beside the
JAX package's trainer.
"""
import _pathfix  # noqa: F401  (repo root on sys.path)

import argparse
import json
import subprocess

import numpy as np

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="+", type=int)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for seed in args.seeds:
        task = chip_smoke.quality_task(seed)
        outs, launches, _ = chip_smoke.quality_engine_run(
            task["serve_cfg"], task["params"], task["reqs"])
        chip_smoke.require_launches(launches, f"seed {seed}",
                                    ("flash_prefill", "paged_decode_fused"))
        print(json.dumps({
            "seed": seed, "card": smi, "final_loss": task["loss"],
            "rouge_l": float(np.mean(chip_smoke.quality_scores(task, outs))),
            "lead1_rouge_l": task["lead1"]}), flush=True)
        chip_smoke.free_cuda()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
