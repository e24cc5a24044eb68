"""``lmrs-torch``: summarize a transcript through the PyTorch/CUDA port.

Flag spellings follow the reference CLI (``lmrs``).  Runs on the card by
default; ``--device cpu`` runs the plain PyTorch path.  ``--quantize int8``
and ``--kv-quantize int8`` select int8 weights and int8 KV pages.
``--save-chunks`` dumps the chunk summaries after the map stage and
``--resume-from`` maps only the chunks such a dump lacks; ``--stream-reduce``
feeds the reduce tree into the map stage's engine stream;
``--max-concurrent-requests`` caps the executor's waves for engines that do
not schedule internally (the port's engine does, so it gets the whole
queue).  ``--speculate-k K`` drafts K tokens a chain: under the default
mixed steps that is tree speculation, as in the reference CLI (linear
speculation is ``EngineConfig(speculate_k=K, mixed_batch=False)``).
``--checkpoint`` loads a native checkpoint (``lmrs-torch-convert`` makes
one from an HF directory) and ``--tokenizer`` takes a local HF tokenizer
directory or a ``*.model`` file besides ``approx`` and ``byte``; any
tokenizer but ``approx`` is the engine's tokenizer too (one token
authority).  ``--backend mock`` runs the deterministic no-device engine
and ``--backend http --hosts h:p,...`` fans the pipeline's requests over
running ``lmrs-serve-torch`` servers (``serving/router.py``;
``LMRS_PREFILL_HOSTS``/``LMRS_DECODE_HOSTS`` add disaggregated role pools).
The host and disk KV tiers are set, as in the reference, through
``EngineConfig`` and the environment (``LMRS_HOST_KV``, ``LMRS_KV_DISK``
and their budgets), not by flag.  ``--trace-out FILE`` records every
request's lifecycle spans and the pipeline's stages and writes a Chrome
trace (Perfetto) on every exit path; ``--no-trace`` forces tracing off even
with ``--trace-out``; ``--profile`` wraps each stage in a
``torch.profiler`` and NVTX range.  ``--mesh`` (multi-GPU) is refused by
name with the slice that brings it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from pathlib import Path

from lmrs_tpu_torch.config import (ChunkConfig, DataConfig, EngineConfig,
                                   PipelineConfig, ReduceConfig)
from lmrs_tpu_torch.engine.api import HTTP_NEEDS_HOSTS
from lmrs_tpu_torch.pipeline import TranscriptSummarizer
from lmrs_tpu_torch.utils.logging import setup_logging
from lmrs_tpu_torch.utils.timing import format_duration

logger = logging.getLogger("lmrs_torch.cli")

# flag -> the slice of the port that brings it
_LATER = {"mesh": "multi-GPU (A8)"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lmrs-torch",
        description="Map-reduce summarization of long transcripts on PyTorch/CUDA")
    p.add_argument("--input", "-i", required=True, help="input transcript JSON")
    p.add_argument("--output", "-o", help="write the final summary to this file")
    p.add_argument("--model", default=None, help="model preset (e.g. bench-8b)")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--tokenizer", default="approx",
                   help='token-count authority: "approx", "byte", a local HF '
                        'tokenizer directory or a SentencePiece *.model file '
                        '(any but "approx" is the serving tokenizer too)')
    p.add_argument("--checkpoint", default=None,
                   help="native checkpoint directory (lmrs-torch-convert)")
    p.add_argument("--max-tokens", type=int, default=None,
                   help="generation budget per request")
    p.add_argument("--max-tokens-per-chunk", type=int, default=4000)
    p.add_argument("--overlap-tokens", type=int, default=200)
    p.add_argument("--max-concurrent-requests", type=int, default=None)
    p.add_argument("--max-batch-slots", type=int, default=None)
    p.add_argument("--max-segment-duration", type=float, default=120.0)
    p.add_argument("--time-interval", type=float, default=None)
    p.add_argument("--no-merge", action="store_true")
    p.add_argument("--no-hierarchical", action="store_true")
    p.add_argument("--stream-reduce", action="store_true",
                   help="feed reduce batches into the map stage's engine "
                        "stream as summaries complete (best for long-decode "
                        "workloads; see ReduceConfig.streaming)")
    p.add_argument("--limit-segments", type=int, default=None)
    p.add_argument("--report", action="store_true",
                   help="write <output>.report.json stats")
    p.add_argument("--prompt-file")
    p.add_argument("--system-prompt-file")
    p.add_argument("--aggregator-prompt-file")
    p.add_argument("--save-chunks", help="dump per-chunk summaries JSON after map stage")
    p.add_argument("--resume-from", help="reuse summaries from a prior --save-chunks dump")
    p.add_argument("--summary-type", default="summary")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable shared-prefix KV reuse (the map/reduce "
                        "preambles re-prefill per request)")
    p.add_argument("--quantize", default=None,
                   help="int8: int8 weight-only projections")
    p.add_argument("--kv-quantize", default=None,
                   help="int8: int8 KV pages with per-slot scales (turns the "
                        "prefix cache off)")
    p.add_argument("--speculate-k", type=int, default=None,
                   help="speculative decoding: K n-gram drafts a chain, "
                        "verified per step (tree speculation under the "
                        "default mixed steps; 0 disables)")
    p.add_argument("--backend", "--provider", dest="backend", default=None,
                   help="engine backend: torch (default, the card's engine) "
                        "| mock | http")
    p.add_argument("--hosts", default=None,
                   help="backend=http: comma-separated lmrs-serve-torch "
                        "addresses (host:port,...)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="record per-request lifecycle spans and write a "
                        "Chrome-trace JSON loadable in Perfetto")
    p.add_argument("--no-trace", action="store_true",
                   help="force tracing off even if --trace-out is given "
                        "(overhead A/B control)")
    p.add_argument("--profile", action="store_true",
                   help="wrap each stage in a torch.profiler and NVTX range")
    # not in the port yet: accepted only to refuse it by name
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    return p


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    for name, later in _LATER.items():
        val = getattr(args, name)
        if val not in (None, False):
            raise ValueError(f"--{name.replace('_', '-')} is not in the port "
                             f"yet; it arrives with the {later} slice")
    engine = EngineConfig(seed=args.seed,
                          prefix_cache=not args.no_prefix_cache,
                          quantize=args.quantize,
                          kv_quantize=args.kv_quantize)
    if args.backend:
        engine = dataclasses.replace(engine, backend=args.backend)
    if args.hosts:
        engine = dataclasses.replace(
            engine,
            hosts=tuple(h.strip() for h in args.hosts.split(",") if h.strip()))
    if engine.backend == "http" and not (engine.hosts or engine.prefill_hosts
                                         or engine.decode_hosts):
        raise ValueError(HTTP_NEEDS_HOSTS)
    if args.model:
        engine = dataclasses.replace(engine, model=args.model)
    if args.max_tokens is not None:
        engine = dataclasses.replace(engine, max_tokens=args.max_tokens)
    if args.max_batch_slots is not None:
        engine = dataclasses.replace(engine, max_batch_slots=args.max_batch_slots)
    if args.max_concurrent_requests is not None:
        engine = dataclasses.replace(
            engine, max_concurrent_requests=args.max_concurrent_requests)
    if args.speculate_k is not None:
        engine = dataclasses.replace(engine, speculate_k=args.speculate_k)
    if args.checkpoint:
        engine = dataclasses.replace(engine, checkpoint_path=args.checkpoint)
    if args.tokenizer and args.tokenizer != "approx":
        engine = dataclasses.replace(engine, tokenizer=args.tokenizer)
    return PipelineConfig(
        data=DataConfig(merge_same_speaker=not args.no_merge,
                        time_interval_seconds=args.time_interval,
                        max_segment_duration=args.max_segment_duration,
                        limit_segments=args.limit_segments),
        chunk=ChunkConfig(max_tokens_per_chunk=args.max_tokens_per_chunk,
                          overlap_tokens=args.overlap_tokens,
                          tokenizer=args.tokenizer),
        engine=engine,
        reduce=ReduceConfig(hierarchical=not args.no_hierarchical,
                            streaming=args.stream_reduce),
    )


def _export_trace(trace_out: str) -> None:
    """Write the process tracer to ``trace_out``; a failure is logged,
    never raised (it runs in a ``finally``)."""
    from lmrs_tpu_torch.obs import export_current

    n, err = export_current(trace_out)
    if err is None:
        logger.info("wrote %d trace events to %s (open in "
                    "https://ui.perfetto.dev)", n, trace_out)
    else:
        logger.error("could not write trace %s: %s", trace_out, err)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # logs on stderr, as the port's CLIs always had them: stdout carries
    # their output
    setup_logging(quiet=args.quiet, stream=sys.stderr)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        parser.error(str(e))
    trace_out = None if args.no_trace else args.trace_out
    if trace_out:
        from lmrs_tpu_torch.obs import enable_tracing

        enable_tracing()
    try:
        return _run(args, cfg)
    finally:
        # whatever the ring holds, on every exit path: a failed run is
        # when the trace matters most
        if trace_out:
            _export_trace(trace_out)


def _run(args: argparse.Namespace, cfg: PipelineConfig) -> int:
    try:
        transcript = json.loads(Path(args.input).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        logger.error("could not read transcript %s: %s", args.input, e)
        return 1
    summarizer = TranscriptSummarizer(cfg, device=args.device,
                                      profile=args.profile)
    try:
        stats = summarizer.summarize(
            transcript, prompt_file=args.prompt_file,
            system_prompt_file=args.system_prompt_file,
            aggregator_prompt_file=args.aggregator_prompt_file,
            summary_type=args.summary_type, save_chunks=args.save_chunks,
            resume_from=args.resume_from)
    finally:
        summarizer.shutdown()
    summary = stats["summary"]
    if not args.quiet:
        em = stats["engine_metrics"]
        print("\n" + "=" * 60 + "\nSUMMARY\n" + "=" * 60)
        print(summary)
        print("=" * 60)
        print(f"segments: {stats['num_input_segments']} -> {stats['num_segments']}  "
              f"chunks: {stats['num_chunks']}  "
              f"tokens: {stats['total_tokens_used']}  "
              f"failed: {stats['failed_requests']}  "
              f"wall: {format_duration(stats['processing_time'])}  "
              f"decode {em.get('decode_tokens_per_sec')} tok/s")
        if "hosts" in em:  # router-shaped metrics (backend=http)
            print(f"engine: {em['healthy_hosts']}/{em['hosts']} hosts healthy  "
                  + "  ".join(f"{row['host']}: {row['served']} served"
                              for row in em.get("per_host", [])))
    if args.output:
        try:
            Path(args.output).write_text(summary, encoding="utf-8")
            if args.report:
                report = {k: v for k, v in stats.items() if k != "summary"}
                Path(str(args.output) + ".report.json").write_text(
                    json.dumps(report, indent=2), encoding="utf-8")
        except OSError as e:
            logger.error("could not write output %s: %s", args.output, e)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
