"""Reduce stage: combine per-chunk summaries into one final summary (the
port of the reference's ``reduce/aggregator.py``).  Single pass when the
time-tagged summaries fit ``max_tokens_per_batch``, else a recursive batch
tree bounded by ``max_levels``; ``ReduceConfig.stable_tree`` swaps in the
append-stable tree of live sessions.  Every call goes through the same
engine as the map stage.  A ``node_cache`` (durable jobs, live sessions)
answers tree nodes by content and records the ones computed.
``reduce/streaming.py`` reuses its request formatting, batch-size math,
tokenizer and config.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from typing import Any, Sequence

from lmrs_tpu_torch.config import ReduceConfig
from lmrs_tpu_torch.data.chunker import Chunk
from lmrs_tpu_torch.data.preprocessor import format_timestamp
from lmrs_tpu_torch.data.tokenizer import Tokenizer, get_tokenizer
from lmrs_tpu_torch.engine.api import GenerationRequest, degraded_reason
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.obs.trace import PID_PIPELINE, get_tracer
from lmrs_tpu_torch.prompts import (DEFAULT_BATCH_REDUCE_PROMPT,
                                    DEFAULT_FINAL_REDUCE_PROMPT,
                                    DEFAULT_REDUCE_PROMPT, safe_format,
                                    shared_prefix_chars)

logger = logging.getLogger("lmrs_torch.reduce")


def content_node_id(display: str, summaries: Sequence[str],
                    template: str | None,
                    metadata: dict | None = None) -> str:
    """A reduce node's identity: the positional name (``L<level>.B<batch>``,
    for logs and journal records) and a hash of the node's prompt inputs
    (children's text, template and metadata).  Caches key on the hash, so
    a leaf inserted before a subtree leaves that subtree addressable."""
    digest = hashlib.sha256(json.dumps(
        [template or "", metadata or {}, list(summaries)],
        sort_keys=True, separators=(",", ":"), ensure_ascii=False,
        default=str,
    ).encode("utf-8", "replace")).hexdigest()[:12]
    return f"{display}@{digest}"


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
                  metadata: dict[str, Any] | None = None,
                  node_cache: Any | None = None) -> dict[str, Any]:
        """Reduce the chunk summaries.  ``node_cache`` has
        ``lookup(node_id, summaries, template, metadata) -> str | None``
        and ``record(node_id, summaries, template, metadata, text)``: each
        node is offered to it before the engine runs it, and each node
        computed is recorded (error markers are not)."""
        t0 = time.time()
        self._wave_errors = 0
        chunks = sorted(processed_chunks, key=lambda c: c.chunk_index)
        summaries = [
            f"[Time: {format_timestamp(c.start_time)} - {format_timestamp(c.end_time)}]\n"
            f"{c.summary or ''}"
            for c in chunks
        ]
        total_tokens = self._total_tokens(summaries)
        stable = self.config.stable_tree
        if stable:
            # the shape depends on the leaf count alone (token totals grow
            # with every append and would reshape the tree)
            hierarchical = (self.config.hierarchical
                            and len(summaries) > self._stable_arity())
        else:
            hierarchical = (self.config.hierarchical
                            and total_tokens > self.config.max_tokens_per_batch)
        logger.info("reduce: %d summaries, %d tokens -> %s%s", len(summaries),
                    total_tokens, "hierarchical" if hierarchical else "single-pass",
                    " (stable tree)" if stable else "")
        if hierarchical and stable:
            summary, levels = self._hierarchical_stable(
                summaries, prompt_template, metadata, node_cache)
        elif hierarchical:
            summary, levels = self._hierarchical(summaries, prompt_template,
                                                 metadata, node_cache)
        else:
            summary = self._reduce_wave(
                [("final", summaries, prompt_template or DEFAULT_REDUCE_PROMPT,
                  metadata)], node_cache)[0]
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

    def _reduce_wave(self, jobs: list[tuple[str, list[str], str, dict | None]],
                     node_cache: Any | None = None) -> list[str]:
        """One level's reduce calls as a single engine wave.  ``jobs`` are
        ``(node_id, summaries, template, metadata)``; with a ``node_cache``
        only its misses reach the engine."""
        out: list[str | None] = [None] * len(jobs)
        idents: list[str | None] = [None] * len(jobs)
        misses: list[int] = []
        for i, (node_id, summaries, template, metadata) in enumerate(jobs):
            if node_cache is not None:
                idents[i] = content_node_id(node_id, summaries, template,
                                            metadata)
                text = node_cache.lookup(idents[i], summaries, template,
                                         metadata)
                if text is not None:
                    out[i] = text
                    continue
            misses.append(i)
        requests = [self._build_request(jobs[i][1], jobs[i][2], jobs[i][3],
                                        request_id=k)
                    for k, i in enumerate(misses)]
        results = self.executor.run_requests(requests) if requests else []
        for i, res in zip(misses, results):
            _node_id, summaries, template, metadata = jobs[i]
            # degraded_reason, not res.error: a shed or expired node carries
            # no error and may carry no text
            reason = degraded_reason(res)
            if reason is None:
                out[i] = res.text
                if node_cache is not None:
                    node_cache.record(idents[i], summaries, template,
                                      metadata, res.text)
            else:
                out[i] = f"[Error aggregating summaries: {reason}]"
                self._wave_errors += 1
        return out  # type: ignore[return-value]

    def _hierarchical(self, summaries: list[str], prompt_template: str | None,
                      metadata: dict[str, Any] | None,
                      node_cache: Any | None = None) -> tuple[str, int]:
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
                jobs.append((f"L{level}.B{i}", batch,
                             prompt_template or DEFAULT_BATCH_REDUCE_PROMPT, meta))
            t_level = time.time()
            current = self._reduce_wave(jobs, node_cache)
            self._trace_level(level, n, t_level)
        if len(current) == 1:
            return current[0], level
        t_final = time.time()
        final = self._reduce_wave(
            [(f"L{level + 1}.final", current,
              prompt_template or DEFAULT_FINAL_REDUCE_PROMPT, metadata)],
            node_cache)[0]
        self._trace_level(level + 1, 1, t_final)
        return final, level + 1

    @staticmethod
    def _trace_level(level: int, batches: int, t0: float) -> None:
        """One ``reduce_level`` span per tree level on the tracer's
        pipeline track: the per-level time the stage total cannot give."""
        tr = get_tracer()
        if tr:
            tr.complete("reduce_level", t0, time.time(), pid=PID_PIPELINE,
                        args={"level": level, "batches": batches})

    def _stable_arity(self) -> int:
        return max(2, self.config.max_summaries_per_batch)

    def _hierarchical_stable(self, summaries: list[str],
                             prompt_template: str | None,
                             metadata: dict[str, Any] | None,
                             node_cache: Any | None = None) -> tuple[str, int]:
        """The append-stable tree (``ReduceConfig.stable_tree``): batch i of
        a level always holds children [i*a, (i+1)*a) for the fixed arity a,
        batch nodes carry no metadata (a "batch i/n" would bake the leaf
        count into every prompt), the transcript metadata goes to the final
        node only, and the levels follow the leaf count.  Appending leaves
        then recomputes the last batch per level and the root; every other
        node answers from the cache."""
        arity = self._stable_arity()
        level = 0
        current = summaries
        while len(current) > arity and level < self.config.max_levels:
            level += 1
            batches = [current[i: i + arity]
                       for i in range(0, len(current), arity)]
            logger.info("reduce level %d (stable): %d summaries in %d batches "
                        "of <=%d", level, len(current), len(batches), arity)
            t_level = time.time()
            current = self._reduce_wave(
                [(f"L{level}.B{i}", batch,
                  prompt_template or DEFAULT_BATCH_REDUCE_PROMPT, None)
                 for i, batch in enumerate(batches)], node_cache)
            self._trace_level(level, len(batches), t_level)
        t_final = time.time()
        final = self._reduce_wave(
            [(f"L{level + 1}.final", current,
              prompt_template or DEFAULT_FINAL_REDUCE_PROMPT, metadata)],
            node_cache)[0]
        self._trace_level(level + 1, 1, t_final)
        return final, level + 1

    def _calculate_batch_size(self, summaries: list[str]) -> int:
        total = self._total_tokens(summaries)
        avg = max(total // max(len(summaries), 1), 1)
        budget = self.config.max_tokens_per_batch - self.config.reserve_tokens
        return max(1, min(self.config.max_summaries_per_batch, budget // avg))

    def _total_tokens(self, summaries: list[str]) -> int:
        return sum(self.tokenizer.count(s) for s in summaries)
