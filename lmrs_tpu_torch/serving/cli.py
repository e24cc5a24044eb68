"""``lmrs-serve-torch``: the OpenAI/Anthropic-wire server over the port's
engine, on the card by default.

    lmrs-serve-torch --model bench-8b --tokenizer byte --port 8000
    lmrs-serve-torch --backend mock --port 8000

    lmrs-serve-torch --role prefill --port 8001   # a disaggregated pair
    lmrs-serve-torch --role decode --port 8002

    lmrs-serve-torch --model bench-8b --tokenizer byte \
        --jobs-dir jobs/ --live-dir live/   # /v1/jobs and /v1/sessions

    lmrs-serve-torch --supervise --model bench-8b --tokenizer byte \
        --jobs-dir jobs/                    # restarted on a wedge or crash

Flag spellings follow the reference's ``lmrs-serve``.  ``--backend`` takes
``torch`` (the default) or ``mock``; ``--device`` takes ``cuda`` (the
default) or ``cpu``.  ``--role`` picks the disaggregated serving role
(``prefill`` mints KV handoff tickets, ``decode`` imports them, ``both``
serves colocated) and ``--handoff-ttl`` the seconds an un-acked ticket
keeps its pages pinned (default ``LMRS_HANDOFF_TTL`` or 60).  ``--jobs-dir``
turns on the durable job API and ``--live-dir`` the live session API
(default ``LMRS_JOBS_DIR`` / ``LMRS_LIVE_DIR``; unset answers 501): their
journals live there, and interrupted jobs and sessions recover at
start-up.  The jobs' map requests ask ``--max-tokens-cap`` tokens.
``--trace`` (or ``LMRS_TRACE=1``) turns the lifecycle tracer on before the
engine is built; ``GET /v1/trace`` then serves this host's span ring.
``--supervise`` runs the server in a child process that the parent
(``serving/supervisor.py``) polls on ``/healthz`` and SIGKILL-respawns on a
watchdog-declared wedge (503 ``"wedged": true``), a hang or a crash; jobs
and sessions resume from their journals across the bounce.  A server whose
engine fails to build exits non-zero; it never moves to the CPU because no
card was found.  ``--mesh`` (multi-GPU, A8) is refused by name.
"""

from __future__ import annotations

import argparse
import logging
import sys

from lmrs_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger("lmrs_torch.serving")

# flag -> the slice of the port that brings it
_LATER = {
    "mesh": "multi-GPU (A8)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lmrs-serve-torch",
        description="OpenAI/Anthropic-wire HTTP server over the PyTorch/CUDA "
                    "port's engine", allow_abbrev=False)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--backend", default="torch", choices=["torch", "mock"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--model", default="tiny", help="model preset name")
    p.add_argument("--checkpoint", default=None,
                   help="native checkpoint directory (lmrs-torch-convert)")
    p.add_argument("--tokenizer", default=None,
                   help="serving tokenizer: 'byte', a *.model SentencePiece "
                        "file or a local HF tokenizer directory (default: "
                        "model-derived)")
    p.add_argument("--quantize", default=None, choices=["int8"])
    p.add_argument("--kv-quantize", default=None, choices=["int8"])
    p.add_argument("--batch-slots", type=int, default=8,
                   help="continuous-batching decode slots")
    p.add_argument("--max-tokens-cap", type=int, default=4096,
                   help="upper bound on any request's max_tokens")
    p.add_argument("--batch-window-ms", type=float, default=20.0,
                   help="micro-batching window for pooling concurrent requests")
    p.add_argument("--role", default="both",
                   choices=["prefill", "decode", "both"],
                   help="disaggregated serving role: 'prefill' stops "
                        "handoff-flagged requests after the first token and "
                        "publishes a KV-page ticket, 'decode' imports "
                        "tickets and continues, 'both' (default) serves "
                        "colocated")
    p.add_argument("--handoff-ttl", type=float, default=None,
                   help="seconds an un-acked handoff ticket pins its KV "
                        "pages before the orphan sweep reclaims them "
                        "(default: LMRS_HANDOFF_TTL or 60)")
    p.add_argument("--jobs-dir", default=None,
                   help="enable the durable job API (POST/GET/DELETE "
                        "/v1/jobs): write-ahead journals live here and "
                        "interrupted jobs resume on startup (default: "
                        "LMRS_JOBS_DIR; unset disables: 501)")
    p.add_argument("--live-dir", default=None,
                   help="enable the live-session API (POST/GET/DELETE "
                        "/v1/sessions*): growing transcripts summarized "
                        "incrementally, journaled here and rehydrated on "
                        "startup (default: LMRS_LIVE_DIR; unset disables: "
                        "501)")
    p.add_argument("--trace", action="store_true",
                   help="enable the in-process lifecycle tracer; GET "
                        "/v1/trace then serves this host's span ring "
                        "(Chrome-trace JSON) for the router-side fleet "
                        "stitcher (also: LMRS_TRACE=1)")
    p.add_argument("--supervise", action="store_true",
                   help="run the server in a supervised CHILD process: the "
                        "parent polls /healthz and SIGKILL-respawns the "
                        "child on a watchdog-declared wedge, a hang or a "
                        "crash; jobs and sessions resume from their "
                        "journals across the bounce")
    p.add_argument("--quiet", "-q", action="store_true")
    # not in the port yet: accepted only to refuse it by name
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, later in _LATER.items():
        val = getattr(args, name)
        if val not in (None, False):
            parser.error(f"--{name.replace('_', '-')} is not in the port "
                         f"yet; it arrives with the {later} slice")
    # logs on stderr, as the port's CLIs always had them: stdout carries
    # their output
    setup_logging(quiet=args.quiet, stream=sys.stderr)
    if args.supervise:
        # parent mode: never builds an engine; it spawns this CLI (minus
        # --supervise, stripped by exact match: the parser takes no
        # abbreviations) as its child and owns only its lifecycle
        from lmrs_tpu_torch.serving.supervisor import Supervisor

        raw = list(argv) if argv is not None else sys.argv[1:]
        child_argv = [a for a in raw if a != "--supervise"]
        return Supervisor(child_argv, host=args.host, port=args.port).run()
    from lmrs_tpu_torch.config import EngineConfig, PipelineConfig
    from lmrs_tpu_torch.engine.api import make_engine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer
    from lmrs_tpu_torch.utils.env import env_bool

    if args.trace or env_bool("LMRS_TRACE", False):
        # before the engine builds: serving spans cover the first request
        from lmrs_tpu_torch.obs import enable_tracing

        enable_tracing()

    try:
        engine_cfg = EngineConfig(
            backend=args.backend, model=args.model,
            max_batch_slots=args.batch_slots,
            checkpoint_path=args.checkpoint, tokenizer=args.tokenizer or "",
            quantize=args.quantize, kv_quantize=args.kv_quantize,
            max_tokens=args.max_tokens_cap,
            # the flag wins over LMRS_HANDOFF_TTL; the config checks it
            **({"handoff_ttl_s": args.handoff_ttl}
               if args.handoff_ttl is not None else {}))
        engine = make_engine(engine_cfg, device=args.device)
    except (ValueError, RuntimeError, OSError, ImportError) as e:
        logger.error("engine init failed: %s", e)
        return 1
    try:
        server = EngineHTTPServer(
            engine, host=args.host, port=args.port, model_name=args.model,
            max_tokens_cap=args.max_tokens_cap,
            batch_window_s=args.batch_window_ms / 1000.0,
            role=args.role, handoff_ttl_s=engine_cfg.handoff_ttl_s,
            jobs_dir=args.jobs_dir, live_dir=args.live_dir,
            # the job and session fingerprints follow the SERVED config
            pipeline_config=PipelineConfig(engine=engine_cfg))
    except OSError as e:
        logger.error("cannot bind %s:%d: %s", args.host, args.port, e)
        engine.shutdown()
        return 1
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.shutdown()
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
