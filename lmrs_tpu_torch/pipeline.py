"""``TranscriptSummarizer``: preprocess -> chunk -> map -> reduce through
the port's engine (the port of the reference's ``pipeline.py``; resumable
chunk dumps and multi-transcript batching are later slices)."""

from __future__ import annotations

import logging
import time
from typing import Any

from lmrs_tpu_torch.config import PipelineConfig, model_preset
from lmrs_tpu_torch.data.chunker import TranscriptChunker
from lmrs_tpu_torch.data.preprocessor import (extract_speakers,
                                              get_transcript_duration,
                                              preprocess_transcript)
from lmrs_tpu_torch.data.tokenizer import get_tokenizer
from lmrs_tpu_torch.engine.api import make_engine
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.prompts import (resolve_map_prompt, resolve_reduce_prompt,
                                    resolve_system_prompt)
from lmrs_tpu_torch.reduce.aggregator import ResultAggregator
from lmrs_tpu_torch.utils.timing import StageTimer, format_duration

logger = logging.getLogger("lmrs_torch.pipeline")


class TranscriptSummarizer:
    """End-to-end map-reduce transcript summarizer on the port's engine.
    ``device`` None runs on ``cuda`` (raising without a card); pass
    ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, config: PipelineConfig | None = None, device=None,
                 engine=None):
        self.config = config or PipelineConfig()
        self.device = device
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
                # (one token authority); "approx" leaves the model default
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
            c = self.config.chunk
            tokenizer = c.tokenizer
            if tokenizer == "approx":  # the serving model's tokenizer counts
                tokenizer = getattr(self.executor.engine, "tokenizer", tokenizer)
            self._chunker = TranscriptChunker(
                max_tokens_per_chunk=c.max_tokens_per_chunk,
                overlap_tokens=c.overlap_tokens,
                context_tokens=c.context_tokens, tokenizer=tokenizer)
        return self._chunker

    @property
    def aggregator(self) -> ResultAggregator:
        if self._aggregator is None:
            self._aggregator = ResultAggregator(
                self.executor, self.config.reduce, tokenizer=self.chunker.tokenizer)
        return self._aggregator

    def summarize(self, transcript_data: dict[str, Any], *,
                  prompt_template: str | None = None,
                  prompt_file: str | None = None,
                  system_prompt: str | None = None,
                  system_prompt_file: str | None = None,
                  aggregator_prompt: str | None = None,
                  aggregator_prompt_file: str | None = None,
                  summary_type: str = "summary") -> dict[str, Any]:
        """Run the full pipeline; returns the stats dict."""
        timer = StageTimer()
        t_start = time.time()
        d = self.config.data
        segments = transcript_data.get("segments", [])
        if d.limit_segments:
            segments = segments[: d.limit_segments]
        with timer.stage("preprocess"):
            processed = preprocess_transcript(
                segments, merge_same_speaker=d.merge_same_speaker,
                time_interval_seconds=d.time_interval_seconds,
                max_segment_duration=d.max_segment_duration,
                preserve_timestamps=d.preserve_timestamps)
        with timer.stage("chunk"):
            chunks = self.chunker.chunk_transcript(processed)
        duration = get_transcript_duration(processed)
        speakers = extract_speakers(processed)
        map_prompt = resolve_map_prompt(prompt_template, prompt_file)
        sys_prompt = resolve_system_prompt(system_prompt, system_prompt_file)
        reduce_prompt = resolve_reduce_prompt(aggregator_prompt, aggregator_prompt_file)
        metadata = {"duration": format_duration(duration),
                    "speakers": ", ".join(speakers), "num_chunks": len(chunks)}
        with timer.stage("map"):
            if chunks:
                chunks = self.executor.process_chunks(chunks, map_prompt,
                                                      summary_type, sys_prompt)
        with timer.stage("reduce"):
            agg = self.aggregator.aggregate(chunks, reduce_prompt, metadata)
        stats = {
            "summary": agg["final_summary"],
            "processing_time": time.time() - t_start,
            "num_input_segments": len(segments),
            "num_segments": len(processed),
            "num_chunks": len(chunks),
            "transcript_duration": duration,
            "transcript_duration_str": format_duration(duration),
            "speakers": speakers,
            "hierarchical": agg["hierarchical"],
            "reduce_levels": agg["levels"],
            "reduce_errors": agg["reduce_errors"],
            "stage_times": timer.report(),
            "engine_metrics": self.executor.engine.engine_metrics(),
            **self.executor.stats(),
        }
        logger.info("pipeline done: %d chunks, %.2fs total", len(chunks),
                    stats["processing_time"])
        return stats

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.engine.shutdown()
