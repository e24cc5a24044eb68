"""``TranscriptSummarizer``: preprocess -> chunk -> map -> reduce through
the port's engine (the port of the reference's ``pipeline.py``): resumable
chunk dumps (``save_chunks`` / ``resume_from``, fingerprinted), the
streaming reduce (``ReduceConfig.streaming``) and multi-transcript batching
(``summarize_many``)."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any

from lmrs_tpu_torch.config import PipelineConfig, model_preset
from lmrs_tpu_torch.data.chunker import Chunk, TranscriptChunker
from lmrs_tpu_torch.data.preprocessor import (extract_speakers,
                                              get_transcript_duration,
                                              preprocess_transcript)
from lmrs_tpu_torch.data.tokenizer import get_tokenizer
from lmrs_tpu_torch.engine.api import make_engine
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.prompts import (resolve_map_prompt, resolve_reduce_prompt,
                                    resolve_system_prompt)
from lmrs_tpu_torch.reduce.aggregator import ResultAggregator
from lmrs_tpu_torch.reduce.streaming import StreamingMapReduce
from lmrs_tpu_torch.utils.fingerprint import config_fingerprint
from lmrs_tpu_torch.utils.timing import StageTimer, format_duration

logger = logging.getLogger("lmrs_torch.pipeline")


def prepare_segments(config: PipelineConfig,
                     transcript_data: dict[str, Any]) -> tuple[int, list]:
    """Limit -> preprocess, the one implementation the batch pipeline and
    the durable jobs (``jobs/manager.py``) share: a resumed job's chunks
    must match the run that journaled them.  Returns
    ``(n_input_segments, processed_segments)``."""
    d = config.data
    segments = transcript_data.get("segments", [])
    if d.limit_segments:
        segments = segments[: d.limit_segments]
    processed = preprocess_transcript(
        segments, merge_same_speaker=d.merge_same_speaker,
        time_interval_seconds=d.time_interval_seconds,
        max_segment_duration=d.max_segment_duration,
        preserve_timestamps=d.preserve_timestamps)
    return len(segments), processed


def build_chunker(config: PipelineConfig, engine: Any = None,
                  max_tokens_per_chunk: int | None = None
                  ) -> TranscriptChunker:
    """The one place a chunker is built from config.  With an ``engine``,
    an "approx" chunk tokenizer becomes the serving model's tokenizer (the
    token-count authority); ``engine=None`` chunks from the config alone,
    which the job and session journals' chunk keys need."""
    tokenizer = config.chunk.tokenizer
    if tokenizer == "approx" and engine is not None:
        engine_tok = getattr(engine, "tokenizer", None)
        if engine_tok is not None:
            tokenizer = engine_tok
    return TranscriptChunker(
        max_tokens_per_chunk=(max_tokens_per_chunk
                              or config.chunk.max_tokens_per_chunk),
        overlap_tokens=config.chunk.overlap_tokens,
        context_tokens=config.chunk.context_tokens, tokenizer=tokenizer)


class TranscriptSummarizer:
    """End-to-end map-reduce transcript summarizer on the port's engine.
    ``device`` None runs on ``cuda`` (raising without a card); pass
    ``device="cpu"`` for the plain PyTorch path.  ``profile`` wraps each
    stage in a ``torch.profiler.record_function`` and an NVTX range."""

    def __init__(self, config: PipelineConfig | None = None, device=None,
                 engine=None, profile: bool = False):
        self.config = config or PipelineConfig()
        self.device = device
        self.profile = profile
        self._engine = engine
        self._executor: MapExecutor | None = None
        self._chunker: TranscriptChunker | None = None
        self._aggregator: ResultAggregator | None = None

    @property
    def executor(self) -> MapExecutor:
        if self._executor is None:
            cfg = self.config
            engine = self._engine
            if engine is None:
                # an explicit chunk tokenizer is the serving tokenizer too
                # (one token authority, loaded once); "approx" leaves the
                # engine's own: engine.tokenizer, else the model default
                tok = (get_tokenizer(cfg.chunk.tokenizer)
                       if cfg.chunk.tokenizer != "approx" else None)
                engine = make_engine(cfg.engine,
                                     cfg.model or model_preset(cfg.engine.model),
                                     device=self.device, tokenizer=tok)
            self._executor = MapExecutor(engine, cfg.engine)
        return self._executor

    @property
    def chunker(self) -> TranscriptChunker:
        if self._chunker is None:
            self._chunker = build_chunker(self.config,
                                          engine=self.executor.engine)
        return self._chunker

    @property
    def aggregator(self) -> ResultAggregator:
        if self._aggregator is None:
            self._aggregator = ResultAggregator(
                self.executor, self.config.reduce, tokenizer=self.chunker.tokenizer)
        return self._aggregator

    def _map_fingerprint(self, map_prompt: str, sys_prompt: str | None,
                         summary_type: str) -> str:
        """Hash of the (prompt, model, chunking) surface that decides what a
        chunk summary means, stamped into ``save_chunks`` dumps and checked
        on ``resume_from``; the reference's field set, so the port's
        ``backend="torch"`` gives a fingerprint of its own."""
        e, c = self.config.engine, self.config.chunk
        return config_fingerprint(
            map_prompt=map_prompt, system_prompt=sys_prompt or "",
            summary_type=summary_type, backend=e.backend, model=e.model,
            temperature=e.temperature, max_tokens=e.max_tokens, seed=e.seed,
            max_tokens_per_chunk=c.max_tokens_per_chunk,
            overlap_tokens=c.overlap_tokens, context_tokens=c.context_tokens,
            tokenizer=str(c.tokenizer))

    def _prep(self, transcript_data: dict[str, Any], timer: StageTimer):
        """Limit -> preprocess -> chunk; returns (n_input_segments,
        processed_segments, chunks)."""
        with timer.stage("preprocess"):
            n_input, processed = prepare_segments(self.config, transcript_data)
        with timer.stage("chunk"):
            chunks = self.chunker.chunk_transcript(processed)
        return n_input, processed, chunks

    def summarize(self, transcript_data: dict[str, Any], *,
                  prompt_template: str | None = None,
                  prompt_file: str | None = None,
                  system_prompt: str | None = None,
                  system_prompt_file: str | None = None,
                  aggregator_prompt: str | None = None,
                  aggregator_prompt_file: str | None = None,
                  summary_type: str = "summary",
                  save_chunks: str | None = None,
                  resume_from: str | None = None) -> dict[str, Any]:
        """Run the full pipeline; returns the stats dict.  ``save_chunks``
        dumps the chunk summaries after the map stage; ``resume_from``
        takes the summaries of such a dump and maps only the rest."""
        timer = StageTimer(profile=self.profile)
        t_start = time.time()
        n_input, processed, chunks = self._prep(transcript_data, timer)
        duration = get_transcript_duration(processed)
        speakers = extract_speakers(processed)
        map_prompt = resolve_map_prompt(prompt_template, prompt_file)
        sys_prompt = resolve_system_prompt(system_prompt, system_prompt_file)
        fingerprint = self._map_fingerprint(map_prompt, sys_prompt, summary_type)
        resumed = 0
        todo = chunks
        if resume_from:
            resumed_chunks, todo = _load_resume(resume_from, chunks,
                                                fingerprint=fingerprint)
            resumed = len(resumed_chunks)
        reduce_prompt = resolve_reduce_prompt(aggregator_prompt, aggregator_prompt_file)
        metadata = {"duration": format_duration(duration),
                    "speakers": ", ".join(speakers), "num_chunks": len(chunks)}
        if self.config.reduce.streaming and todo:
            # one engine stream: reduce batches ride the map stage's slots
            # as their member summaries complete; the dump is written inside
            # the stream when the last map summary lands
            smr = StreamingMapReduce(self.executor, self.aggregator)
            on_map_complete = (
                (lambda cs: _dump_chunks(save_chunks, list(cs),
                                         fingerprint=fingerprint))
                if save_chunks else None)
            agg = smr.run(chunks, map_prompt, summary_type, sys_prompt,
                          reduce_prompt, metadata,
                          on_map_complete=on_map_complete)
            # map = start -> last map summary; reduce = the tail beyond it
            timer.spans["map"] = round(agg["map_seconds"], 4)
            timer.spans["reduce"] = round(agg["reduce_tail_seconds"], 4)
            processed_chunks = sorted(chunks, key=lambda c: c.chunk_index)
        else:
            with timer.stage("map"):
                if todo:
                    self.executor.process_chunks(todo, map_prompt,
                                                 summary_type, sys_prompt)
            processed_chunks = sorted(chunks, key=lambda c: c.chunk_index)
            if save_chunks:
                _dump_chunks(save_chunks, processed_chunks,
                             fingerprint=fingerprint)
            with timer.stage("reduce"):
                agg = self.aggregator.aggregate(processed_chunks, reduce_prompt,
                                                metadata)
        stats = {
            "summary": agg["final_summary"],
            "processing_time": time.time() - t_start,
            "num_input_segments": n_input,
            "num_segments": len(processed),
            "num_chunks": len(chunks),
            "num_resumed_chunks": resumed,
            "transcript_duration": duration,
            "transcript_duration_str": format_duration(duration),
            "speakers": speakers,
            "hierarchical": agg["hierarchical"],
            "reduce_levels": agg["levels"],
            "stage_times": timer.report(),
            # cumulative over this summarizer's life, like the counters
            "engine_metrics": self.executor.engine.engine_metrics(),
            **self.executor.stats(),
        }
        logger.info("pipeline done: %d chunks, %.2fs total", len(chunks),
                    stats["processing_time"])
        return stats

    def summarize_many(self, transcripts: list[dict[str, Any]], *,
                       prompt_template: str | None = None,
                       prompt_file: str | None = None,
                       system_prompt: str | None = None,
                       system_prompt_file: str | None = None,
                       aggregator_prompt: str | None = None,
                       aggregator_prompt_file: str | None = None,
                       summary_type: str = "summary",
                       resume_from: list[str | None] | None = None
                       ) -> list[dict[str, Any]]:
        """Summarize several transcripts through ONE pooled map queue (one
        transcript's decode tail overlaps the next one's prefill); each
        then gets its own reduce tree and a stats dict shaped like
        ``summarize``'s.  ``resume_from`` aligns with ``transcripts`` (None
        = no dump for that one); only un-resumed chunks enter the queue."""
        timer = StageTimer(profile=self.profile)
        t_start = time.time()
        map_prompt = resolve_map_prompt(prompt_template, prompt_file)
        sys_prompt = resolve_system_prompt(system_prompt, system_prompt_file)
        reduce_prompt = resolve_reduce_prompt(aggregator_prompt, aggregator_prompt_file)
        prepped = [self._prep(data, timer) for data in transcripts]
        resumed_counts = [0] * len(prepped)
        if resume_from:
            if len(resume_from) != len(transcripts):
                raise ValueError(
                    f"resume_from has {len(resume_from)} entries for "
                    f"{len(transcripts)} transcripts (use None for "
                    "transcripts without a dump)")
            fingerprint = self._map_fingerprint(map_prompt, sys_prompt,
                                                summary_type)
            for i, (path, (_n, _p, chunks)) in enumerate(
                    zip(resume_from, prepped)):
                if path:
                    resumed_chunks, _todo = _load_resume(
                        path, chunks, fingerprint=fingerprint)
                    resumed_counts[i] = len(resumed_chunks)
        with timer.stage("map"):
            self.executor.process_chunk_groups(
                [[c for c in chunks if c.summary is None]
                 for _, _, chunks in prepped],
                map_prompt, summary_type, sys_prompt)
        out = []
        for i, (n_input, processed, chunks) in enumerate(prepped):
            ordered = sorted(chunks, key=lambda c: c.chunk_index)
            duration = get_transcript_duration(processed)
            speakers = extract_speakers(processed)
            metadata = {"duration": format_duration(duration),
                        "speakers": ", ".join(speakers),
                        "num_chunks": len(ordered)}
            with timer.stage("reduce"):
                agg = self.aggregator.aggregate(ordered, reduce_prompt, metadata)
            out.append({
                "summary": agg["final_summary"],
                "num_input_segments": n_input,
                "num_segments": len(processed),
                "num_chunks": len(ordered),
                "num_resumed_chunks": resumed_counts[i],
                "transcript_duration": duration,
                "transcript_duration_str": format_duration(duration),
                "speakers": speakers,
                "hierarchical": agg["hierarchical"],
                "reduce_levels": agg["levels"],
            })
        total = time.time() - t_start
        # shared accounting is copied into each result, so an edit to one
        # result's dicts cannot bleed into the others
        for stats in out:
            stats.update({
                "processing_time": total,
                "stage_times": dict(timer.report()),
                "engine_metrics": dict(self.executor.engine.engine_metrics()),
                **self.executor.stats(),
            })
        logger.info("pipeline done: %d transcripts, %d chunks, %.2fs total",
                    len(transcripts), sum(s["num_chunks"] for s in out), total)
        return out

    async def asummarize(self, transcript_data: dict[str, Any],
                         **kw: Any) -> dict[str, Any]:
        """Async facade of ``summarize`` (the engine is local)."""
        return self.summarize(transcript_data, **kw)

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.engine.shutdown()


# ---------------------------------------------------------------- artifacts


def _dump_chunks(path: str, chunks: list[Chunk],
                 fingerprint: str | None = None) -> None:
    """Write the chunk summaries (the reference's dump format, with the
    map-surface ``fingerprint``); a failed write is logged, never fatal."""
    payload = {
        "timestamp": time.time(),
        "fingerprint": fingerprint,
        "chunks": [{"chunk_index": c.chunk_index, "start_time": c.start_time,
                    "end_time": c.end_time, "summary": c.summary,
                    "tokens_used": c.tokens_used, "error": c.error}
                   for c in chunks],
    }
    try:
        Path(path).write_text(json.dumps(payload, indent=2), encoding="utf-8")
        logger.info("saved %d chunk summaries to %s", len(chunks), path)
    except OSError as e:
        logger.error("could not save chunks to %s: %s", path, e)


def _load_resume(path: str, chunks: list[Chunk],
                 fingerprint: str | None = None
                 ) -> tuple[list[Chunk], list[Chunk]]:
    """Take the summaries of a ``save_chunks`` dump; returns (resumed,
    still_todo).  Chunks match on (chunk_index, start, end), and error or
    empty summaries are redone.  A dump stamped with another fingerprint is
    dropped (warning); an unreadable one is logged and every chunk stays to
    do."""
    try:
        payload = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        logger.error("could not resume from %s: %s", path, e)
        return [], chunks
    saved_fp = payload.get("fingerprint")
    if fingerprint and saved_fp and saved_fp != fingerprint:
        logger.warning(
            "resume dump %s was produced under config/prompt fingerprint %s "
            "!= this run's %s; dropping its summaries (a different map "
            "prompt, model, or chunking surface would mix stale content "
            "into this run)", path, saved_fp, fingerprint)
        return [], chunks
    saved = {
        (d["chunk_index"], round(d["start_time"], 3), round(d["end_time"], 3)): d
        for d in payload.get("chunks", [])
        if d.get("summary") and not d.get("error")
    }
    resumed, todo = [], []
    for c in chunks:
        d = saved.get((c.chunk_index, round(c.start_time, 3),
                       round(c.end_time, 3)))
        if d:
            c.summary = d["summary"]
            c.tokens_used = d.get("tokens_used", 0)
            resumed.append(c)
        else:
            todo.append(c)
    logger.info("resumed %d/%d chunk summaries from %s", len(resumed),
                len(chunks), path)
    return resumed, todo
