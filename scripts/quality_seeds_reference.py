"""The recipe of chip_smoke's quality gate (phase 19b) in both packages on
the CPU, from each init seed given: a second witness for how far that
gate's ROUGE-L depends on the draw, and whether the port's trainer draws
like the JAX package's.

For each seed, the JAX package's ``init_params(PRNGKey(seed))`` at
bench-smoke's widths in f32 is trained twice on the same batches (200
AdamW steps at 4e-3, 16 x 320, ``make_dataset(192, seed=0)`` through each
package's ``load_examples`` / ``batches``): once by the JAX package's
trainer (``optax.adamw``), once by the port's (``torch.optim.AdamW`` at
optax's defaults).  Each result is cast to bf16 and served by the port's
continuous engine on the CPU (the kernels' plain versions; 4 slots, 48
tokens, blocks of 8, greedy) over phase 19b's 8 held-out prompts.  One
JSON line a seed and trainer: final loss, mean ROUGE-L, lead-1.

    JAX_PLATFORMS=cpu python scripts/quality_seeds_reference.py 0 1 2 3

A CPU comparison like the repo's parity tests: it imports both packages
and never runs on the card.
"""
import _pathfix  # noqa: F401  (repo root on sys.path)

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np

STEPS, BATCH, SEQ_LEN, LR = 200, 16, 320, 4e-3


def widths() -> tuple:
    """(JAX config, port config): bench-smoke's widths, f32."""
    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu_torch.config import model_preset

    tcfg = dataclasses.replace(model_preset("bench-smoke"), dtype="float32")
    jnames = {f.name for f in dataclasses.fields(JModelConfig)}
    jcfg = JModelConfig(**{k: v for k, v in dataclasses.asdict(tcfg).items()
                           if k in jnames})
    return jcfg, tcfg


def write_train_pairs(path: Path) -> None:
    from lmrs_tpu_torch.eval.synthetic import make_dataset

    path.write_text("\n".join(json.dumps({"prompt": ex["prompt"],
                                          "summary": ex["summary"]})
                              for ex in make_dataset(192, seed=0)))


def train_jax(jcfg, tree, data: Path) -> tuple:
    import jax.numpy as jnp
    import optax

    from lmrs_tpu.data.tokenizer import ByteTokenizer
    from lmrs_tpu.training.cli import batches, load_examples
    from lmrs_tpu.training.train import make_train_step

    seqs, masks = load_examples(str(data), ByteTokenizer())
    opt = optax.adamw(LR)
    params, state = tree, opt.init(tree)
    step = make_train_step(jcfg, opt, None, masked=True)
    it = batches(seqs, masks, BATCH, SEQ_LEN, 0)
    for _ in range(STEPS):
        t, m = next(it)
        params, state, loss = step(params, state, jnp.asarray(t),
                                   jnp.asarray(m))
    return params, float(loss)


def train_port(tcfg, tree, data: Path) -> tuple:
    import torch

    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.models.convert import params_from_jax
    from lmrs_tpu_torch.training.cli import batches, load_examples
    from lmrs_tpu_torch.training.train import (adamw, make_train_step,
                                               trainable)

    seqs, masks = load_examples(str(data), ByteTokenizer())
    params = trainable(params_from_jax(tree, tcfg))
    step = make_train_step(tcfg, adamw(params, LR), masked=True)
    it = batches(seqs, masks, BATCH, SEQ_LEN, 0)
    for _ in range(STEPS):
        t, m = next(it)
        loss = step(params, torch.from_numpy(t), torch.from_numpy(m))
    return params, float(loss)


def serve_and_score(params, held: list[dict]) -> float:
    """Mean ROUGE-L of the port's bf16 engine on the CPU over ``held``."""
    import torch

    from lmrs_tpu_torch.config import EngineConfig, model_preset
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.eval.rouge import rouge_l
    from lmrs_tpu_torch.training.train import map_params

    served = map_params(lambda t: t.detach().to(torch.bfloat16), params)
    engine = TorchEngine(
        EngineConfig(scheduler="continuous", max_tokens=48, max_batch_slots=4,
                     seed=0, decode_block=8),
        model_preset("bench-smoke"), device="cpu", params=served,
        tokenizer=ByteTokenizer())
    outs = engine.generate_batch([
        GenerationRequest(prompt=ex["prompt"], request_id=i, temperature=0.0,
                          max_new_tokens=48) for i, ex in enumerate(held)])
    engine.shutdown()
    return float(np.mean([rouge_l(o.text, ex["summary"])["f"]
                          for ex, o in zip(held, outs)]))


def held_out() -> list[dict]:
    """Phase 19b's 8 held-out prompts (none equal to a training prompt)."""
    from lmrs_tpu_torch.eval.synthetic import make_dataset

    train = {ex["prompt"] for ex in make_dataset(192, seed=0)}
    return [ex for ex in make_dataset(32, seed=999)
            if ex["prompt"] not in train][:8]


def main() -> int:
    import jax

    from lmrs_tpu.models.transformer import init_params
    from lmrs_tpu_torch.eval.rouge import rouge_l
    from lmrs_tpu_torch.eval.synthetic import extractive_baseline
    from lmrs_tpu_torch.models.convert import params_from_jax

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="+", type=int)
    args = ap.parse_args()
    jcfg, tcfg = widths()
    held = held_out()
    lead1 = float(np.mean([rouge_l(extractive_baseline(ex["prompt"]),
                                   ex["summary"])["f"] for ex in held]))
    with tempfile.TemporaryDirectory() as td:
        data = Path(td) / "train.jsonl"
        write_train_pairs(data)
        for seed in args.seeds:
            tree = jax.tree.map(np.asarray,
                                init_params(jcfg, jax.random.PRNGKey(seed)))
            for name in ("jax", "port"):
                t0 = time.time()
                if name == "jax":
                    trained, loss = train_jax(jcfg, tree, data)
                    params = params_from_jax(
                        jax.tree.map(np.asarray, trained), tcfg)
                else:
                    params, loss = train_port(tcfg, tree, data)
                train_s = time.time() - t0
                print(json.dumps({"seed": seed, "trainer": name,
                                  "final_loss": loss,
                                  "rouge_l": serve_and_score(params, held),
                                  "lead1_rouge_l": lead1,
                                  "train_seconds": train_s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
