"""``lmrs-train-torch``: fine-tune a model preset on text/summary data (the
port of the reference's ``lmrs-train``).

Data format: JSONL, one object per line —
    {"text": "..."}                       plain causal-LM text
    {"prompt": "...", "summary": "..."}   loss masked to the summary tokens

Runs on the card unless ``--device cpu`` is given.  ``--init-checkpoint``
and ``--output`` are native checkpoint directories
(``models/loader.load_checkpoint`` / ``save_checkpoint``), so ``lmrs-torch
--checkpoint`` serves what this writes.  The model trains in its preset's
dtype with ``training.train.adamw`` (``optax.adamw``'s defaults).
``--mesh`` is refused by name: it arrives with the multi-GPU slice.
From a checkout: ``python -m lmrs_tpu_torch.training.cli``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

from lmrs_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger("lmrs_torch.train")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "lmrs-train-torch",
        description="Fine-tune a summarization model on PyTorch/CUDA")
    p.add_argument("--data", required=True, help="JSONL training data")
    p.add_argument("--model", default="tiny", help="model preset name")
    p.add_argument("--tokenizer", default="byte",
                   help='"byte", "approx", a SentencePiece *.model file or a '
                        'local HF tokenizer directory')
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--init-checkpoint", default=None,
                   help="native checkpoint to start from (default: random init)")
    p.add_argument("--output", required=True,
                   help="native checkpoint output directory")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--remat", action="store_true",
                   help="recompute layers in backward (long sequences)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--quiet", "-q", action="store_true")
    # not in the port yet: accepted only to refuse it by name
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    return p


def load_examples(path: str, tokenizer) -> tuple[list[list[int]], list[list[int]]]:
    """Tokenize the JSONL file; returns (token_seqs, loss_masks)."""
    seqs, masks = [], []
    for lineno, line in enumerate(
        Path(path).read_text(encoding="utf-8").splitlines(), 1
    ):
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        if "text" in row:
            ids = [tokenizer.bos_id] + tokenizer.encode(row["text"])
            mask = [1] * len(ids)
        elif "prompt" in row and "summary" in row:
            p_ids = [tokenizer.bos_id] + tokenizer.encode(row["prompt"])
            s_ids = tokenizer.encode(row["summary"]) + [tokenizer.eos_id]
            ids = p_ids + s_ids
            mask = [0] * len(p_ids) + [1] * len(s_ids)
        else:
            raise ValueError(
                f"{path}:{lineno}: row needs 'text' or 'prompt'+'summary' "
                f"keys, got {sorted(row)}")
        seqs.append(ids)
        masks.append(mask)
    if not seqs:
        raise ValueError(f"no examples in {path}")
    return seqs, masks


def batches(seqs, masks, batch_size: int, seq_len: int, seed: int):
    """Yield (tokens [B,S], loss_mask [B,S]) int32 numpy arrays forever,
    shuffled per epoch; the tail batch fills up by cycling the epoch's
    permutation."""
    rng = np.random.default_rng(seed)
    n = len(seqs)
    while True:
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            idx = order[i : i + batch_size]
            if len(idx) < batch_size:  # tail: top up by cycling the epoch
                idx = np.concatenate(
                    [idx, np.resize(order, batch_size - len(idx))])
            t = np.zeros((batch_size, seq_len), np.int32)
            m = np.zeros((batch_size, seq_len), np.int32)
            for r, j in enumerate(idx):
                ids = seqs[j][:seq_len]
                t[r, : len(ids)] = ids
                m[r, : len(ids)] = masks[j][: len(ids)]
            yield t, m


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # logs on stderr, as the port's CLIs always had them: stdout carries
    # their output
    setup_logging(quiet=args.quiet, stream=sys.stderr)
    if args.mesh:
        parser.error("--mesh is not in the port yet; it arrives with the "
                     "multi-GPU (A8) slice")

    import torch

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.data.tokenizer import get_tokenizer
    from lmrs_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.training.train import adamw, make_train_step, trainable
    from lmrs_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    try:
        cfg = model_preset(args.model)
        tokenizer = get_tokenizer(args.tokenizer)
        seqs, masks = load_examples(args.data, tokenizer)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        logger.error("could not set up training: %s", e)
        return 1
    max_id = max(max(s) for s in seqs)
    if max_id >= cfg.vocab_size:
        # silently clamping would corrupt both inputs and loss targets
        logger.error(
            "tokenizer produced id %d but model %s has vocab_size %d — "
            "pick a tokenizer matching the model's vocabulary",
            max_id, cfg.name, cfg.vocab_size)
        return 1
    logger.info("loaded %d examples from %s", len(seqs), args.data)

    if args.init_checkpoint:
        params = load_checkpoint(args.init_checkpoint, cfg, device)
    else:
        params = init_params(cfg, args.seed, device)
    trainable(params)
    optimizer = adamw(params, args.lr)
    step_fn = make_train_step(cfg, optimizer, remat=args.remat, masked=True)

    it = batches(seqs, masks, args.batch_size, args.seq_len, args.seed)
    t0 = time.time()
    for step in range(1, args.steps + 1):
        tokens, mask = next(it)
        loss = step_fn(params, torch.from_numpy(tokens).to(device),
                       torch.from_numpy(mask).to(device))
        if step % args.log_every == 0 or step == args.steps:
            loss = float(loss)  # the loop's only host sync
            tok_s = step * args.batch_size * args.seq_len / (time.time() - t0)
            logger.info("step %d/%d  loss %.4f  %.0f tok/s",
                        step, args.steps, loss, tok_s)

    save_checkpoint(args.output, params)
    logger.info("saved fine-tuned checkpoint to %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
