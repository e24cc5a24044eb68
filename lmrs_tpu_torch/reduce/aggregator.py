"""Reduce stage: combine per-chunk summaries into one final summary (the
port of the reference's ``reduce/aggregator.py``, without the node cache
and the append-stable tree).  Single pass when the time-tagged summaries
fit ``max_tokens_per_batch``, else a recursive batch tree bounded by
``max_levels``; every call goes through the same engine as the map stage.
``reduce/streaming.py`` reuses its request formatting, batch-size math,
tokenizer and config.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Sequence

from lmrs_tpu_torch.config import ReduceConfig
from lmrs_tpu_torch.data.chunker import Chunk
from lmrs_tpu_torch.data.preprocessor import format_timestamp
from lmrs_tpu_torch.data.tokenizer import Tokenizer, get_tokenizer
from lmrs_tpu_torch.engine.api import GenerationRequest, degraded_reason
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.prompts import (DEFAULT_BATCH_REDUCE_PROMPT,
                                    DEFAULT_FINAL_REDUCE_PROMPT,
                                    DEFAULT_REDUCE_PROMPT, safe_format,
                                    shared_prefix_chars)

logger = logging.getLogger("lmrs_torch.reduce")


class ResultAggregator:
    """Single-pass or hierarchical reduce over chunk summaries."""

    def __init__(self, executor: MapExecutor, config: ReduceConfig | None = None,
                 tokenizer: Tokenizer | str = "approx"):
        self.executor = executor
        self.config = config or ReduceConfig()
        self.tokenizer = (get_tokenizer(tokenizer) if isinstance(tokenizer, str)
                          else tokenizer)
        self._wave_errors = 0

    def aggregate(self, processed_chunks: Sequence[Chunk],
                  prompt_template: str | None = None,
                  metadata: dict[str, Any] | None = None) -> dict[str, Any]:
        t0 = time.time()
        self._wave_errors = 0
        chunks = sorted(processed_chunks, key=lambda c: c.chunk_index)
        summaries = [
            f"[Time: {format_timestamp(c.start_time)} - {format_timestamp(c.end_time)}]\n"
            f"{c.summary or ''}"
            for c in chunks
        ]
        total_tokens = self._total_tokens(summaries)
        hierarchical = (self.config.hierarchical
                        and total_tokens > self.config.max_tokens_per_batch)
        logger.info("reduce: %d summaries, %d tokens -> %s", len(summaries),
                    total_tokens, "hierarchical" if hierarchical else "single-pass")
        if hierarchical:
            summary, levels = self._hierarchical(summaries, prompt_template, metadata)
        else:
            summary = self._reduce_wave(
                [(summaries, prompt_template or DEFAULT_REDUCE_PROMPT, metadata)])[0]
            levels = 1
        return {
            "final_summary": summary,
            "num_chunk_summaries": len(summaries),
            "hierarchical": hierarchical,
            "levels": levels,
            "aggregation_time": time.time() - t0,
            "reduce_errors": self._wave_errors,
            "final_error": summary.startswith("[Error aggregating summaries:"),
        }

    def _build_request(self, summaries: list[str], template: str,
                       metadata: dict[str, Any] | None,
                       request_id: int = 0) -> GenerationRequest:
        blocks = [f"SUMMARY {i + 1}:\n{'=' * 20}\n{s}"
                  for i, s in enumerate(summaries)]
        meta_str = ", ".join(f"{k}: {v}" for k, v in (metadata or {}).items()) or "n/a"
        prompt = safe_format(template, summaries="\n\n".join(blocks),
                             metadata=meta_str, num_summaries=len(summaries))
        return GenerationRequest(
            prompt=prompt, request_id=request_id,
            max_new_tokens=self.executor.config.max_tokens,
            temperature=self.config.temperature,
            seed=self.executor.config.seed,
            # prefix-cache hint: the reduce preamble repeats per tree node;
            # summaries/metadata/count all vary per request, so the shared
            # prefix ends at whichever placeholder the template puts first
            cache_prefix=shared_prefix_chars(
                template, "summaries", "metadata", "num_summaries"))

    def _reduce_wave(self, jobs: list[tuple[list[str], str, dict | None]]) -> list[str]:
        """One level's reduce calls as a single engine wave."""
        requests = [self._build_request(s, t, m, request_id=i)
                    for i, (s, t, m) in enumerate(jobs)]
        out = []
        for res in self.executor.run_requests(requests):
            # degraded_reason, not res.error: a shed or expired node carries
            # no error and may carry no text
            reason = degraded_reason(res)
            if reason is None:
                out.append(res.text)
            else:
                out.append(f"[Error aggregating summaries: {reason}]")
                self._wave_errors += 1
        return out

    def _hierarchical(self, summaries: list[str], prompt_template: str | None,
                      metadata: dict[str, Any] | None) -> tuple[str, int]:
        level = 0
        current = summaries
        while (len(current) > 1
               and self._total_tokens(current) > self.config.max_tokens_per_batch
               and level < self.config.max_levels):
            level += 1
            size = self._calculate_batch_size(current)
            batches = [current[i: i + size] for i in range(0, len(current), size)]
            logger.info("reduce level %d: %d summaries in %d batches of <=%d",
                        level, len(current), len(batches), size)
            n = len(batches)
            jobs = []
            for i, batch in enumerate(batches):
                meta = dict(metadata or {})
                meta.update({"batch": f"{i + 1}/{n}",
                             "position": f"{100.0 * i / n:.0f}%-"
                                         f"{100.0 * (i + 1) / n:.0f}% of the transcript"})
                jobs.append((batch, prompt_template or DEFAULT_BATCH_REDUCE_PROMPT, meta))
            current = self._reduce_wave(jobs)
        if len(current) == 1:
            return current[0], level
        final = self._reduce_wave(
            [(current, prompt_template or DEFAULT_FINAL_REDUCE_PROMPT, metadata)])[0]
        return final, level + 1

    def _calculate_batch_size(self, summaries: list[str]) -> int:
        total = self._total_tokens(summaries)
        avg = max(total // max(len(summaries), 1), 1)
        budget = self.config.max_tokens_per_batch - self.config.reserve_tokens
        return max(1, min(self.config.max_summaries_per_batch, budget // avg))

    def _total_tokens(self, summaries: list[str]) -> int:
        return sum(self.tokenizer.count(s) for s in summaries)
