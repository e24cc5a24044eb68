"""``lmrs-torch-convert``: a local HuggingFace checkpoint -> the port's
native checkpoint, one command (the port of the reference's
``lmrs-convert``).

    lmrs-torch-convert --src /path/to/hf-mixtral --model mixtral-8x7b \\
                       --output ckpt/mixtral-8x7b
    lmrs-torch --model mixtral-8x7b --checkpoint ckpt/mixtral-8x7b \\
               --tokenizer /path/to/hf-mixtral --quantize int8 -i t.json

The family is inferred from the preset as the reference does (a Gemma
preset, by name or GELU activation, takes the Gemma converter: tied
embeddings, ``1 + w`` norms; everything else the Llama/Mixtral one),
overridable with ``--family``.  The conversion streams one layer at a time
(``models/loader.hf_params``).  Exit codes: 0 converted, 1 unknown preset
or failed conversion, 2 bad arguments.
"""

from __future__ import annotations

import argparse
import logging
import sys

from lmrs_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger("lmrs_torch.convert")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lmrs-torch-convert",
        description="Convert a local HF safetensors checkpoint to the "
                    "port's native checkpoint")
    p.add_argument("--src", required=True,
                   help="directory with HF *.safetensors shards")
    p.add_argument("--model", required=True,
                   help="model preset the checkpoint matches "
                        "(e.g. bench-8b, gemma-2b, mixtral-8x7b)")
    p.add_argument("--output", required=True, help="native checkpoint dir")
    p.add_argument("--family", choices=["llama", "gemma"], default=None,
                   help="converter family (default: inferred from preset)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # logs on stderr, as the port's CLIs always had them: stdout carries
    # their output
    setup_logging(quiet=args.quiet, stream=sys.stderr)
    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.loader import hf_params, save_checkpoint

    try:
        cfg = model_preset(args.model)
    except (KeyError, ValueError) as e:
        logger.error("unknown model preset %r: %s", args.model, e)
        return 1
    family = args.family or ("gemma" if "gemma" in cfg.name.lower()
                             or cfg.activation == "gelu" else "llama")
    try:
        if family == "gemma" and not cfg.tie_embeddings:
            raise ValueError("Gemma checkpoints tie lm_head to the embedding")
        params = hf_params(args.src, cfg,
                           norm_offset=0.0 if family == "gemma" else 1.0)
        n_bytes = save_checkpoint(args.output, params)
    except (FileNotFoundError, KeyError, ValueError) as e:
        logger.error("conversion failed: %s", e)
        return 1
    logger.info("converted %s (%s family, %.1f MiB) -> %s", args.src, family,
                n_bytes / 2**20, args.output)
    print(f"run with:  lmrs-torch --model {args.model} --checkpoint "
          f"{args.output} --tokenizer {args.src} --input <transcript.json>")
    return 0


if __name__ == "__main__":
    sys.exit(main())
