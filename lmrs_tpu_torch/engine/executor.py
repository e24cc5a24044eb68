"""Map-stage executor (trimmed port of the reference's
``engine/executor.py``): chunks become requests, the engine runs them, and
results are written back onto the chunks.

Degrade-and-continue is kept: an engine-level exception turns the batch
into per-request error results (logged with its traceback and counted in
``failed_requests``) instead of aborting the pipeline.  Retries,
cancellation and deadlines belong to later slices.
"""

from __future__ import annotations

import logging
import time
from typing import Sequence

from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.data.chunker import Chunk
from lmrs_tpu_torch.engine.api import (Engine, GenerationRequest,
                                       GenerationResult)
from lmrs_tpu_torch.prompts import safe_format, shared_prefix_chars

logger = logging.getLogger("lmrs_torch.executor")


class MapExecutor:
    """Runs the map stage (and the reduce tree's request lists)."""

    def __init__(self, engine: Engine, config: EngineConfig | None = None):
        self.engine = engine
        self.config = config or EngineConfig()
        self.total_tokens_used = 0
        self.total_device_seconds = 0.0
        self.total_requests = 0
        self.failed_requests = 0

    def process_chunks(self, chunks: Sequence[Chunk], prompt_template: str,
                       summary_type: str = "summary",
                       system_prompt: str | None = None) -> list[Chunk]:
        """Summarize every chunk in place; returns chunks by chunk_index."""
        t0 = time.time()
        requests = [self.build_map_request(c, prompt_template, summary_type,
                                           system_prompt, request_id=i)
                    for i, c in enumerate(chunks)]
        failed = 0
        for chunk, res in zip(chunks, self.run_requests(requests)):
            if res.error is not None:
                chunk.summary = f"[Error processing chunk: {res.error}]"
                chunk.error = res.error
                failed += 1
            else:
                chunk.summary = res.text
            chunk.tokens_used = res.total_tokens
            chunk.device_seconds = res.device_seconds
        logger.info("map stage: %d chunks in %.2fs (%d failed)", len(chunks),
                    time.time() - t0, failed)
        return sorted(chunks, key=lambda c: c.chunk_index)

    def build_map_request(self, chunk: Chunk, prompt_template: str,
                          summary_type: str = "summary",
                          system_prompt: str | None = None,
                          request_id: int = 0) -> GenerationRequest:
        """One chunk -> one map request."""
        prompt = safe_format(prompt_template,
                             transcript=chunk.text_with_context,
                             summary_type=summary_type)
        return GenerationRequest(
            prompt=prompt, request_id=request_id,
            system_prompt=chunk.system_prompt or system_prompt,
            max_new_tokens=self.config.max_tokens,
            temperature=self.config.temperature, seed=self.config.seed,
            # prefix-cache hint: everything before the per-chunk transcript
            # substitution is the map preamble every chunk shares
            cache_prefix=shared_prefix_chars(
                prompt_template, "transcript", summary_type=summary_type))

    def run_requests(self, requests: list[GenerationRequest]) -> list[GenerationResult]:
        """One engine call for the whole list (the engine schedules
        internally) + accounting."""
        try:
            results = self.engine.generate_batch(requests)
        except Exception as e:  # noqa: BLE001 - degrade-and-continue
            logger.exception("engine batch failure")
            results = [GenerationResult(request_id=r.request_id,
                                        finish_reason="error", error=str(e))
                       for r in requests]
        for res in results:
            self.total_requests += 1
            if res.error is not None:
                self.failed_requests += 1
            else:
                self.total_tokens_used += res.total_tokens
                self.total_device_seconds += res.device_seconds
        return results

    def stats(self) -> dict:
        return {
            "total_tokens_used": self.total_tokens_used,
            "total_device_seconds": round(self.total_device_seconds, 4),
            "total_requests": self.total_requests,
            "failed_requests": self.failed_requests,
        }
