"""Streamed map -> reduce: the reduce tree rides the map stage's engine
stream (the port of the reference's ``reduce/streaming.py``).

The barrier path waits for every chunk summary before the first reduce
request; with a continuous-batching engine the slots then drain idle at
the map tail and refill for the reduce waves.  Here level-1 reduce batches
enter the SAME stream (``MapExecutor.run_requests_streaming`` over the
scheduler's ``on_result``/``submit`` hook) as soon as their member
summaries complete.  Semantics against ``ResultAggregator.aggregate``:

* the single-pass vs hierarchical decision is exact: the tree triggers
  only once the summaries completed so far exceed ``max_tokens_per_batch``;
  a map that finishes under budget gets the barrier path's single pass;
* the level-1 batch size is estimated when the tree triggers, from the
  summaries completed by then; batches stay contiguous ordered slices,
  token-split at submit time so none exceeds the budget;
* levels >= 2 have all their inputs and follow the barrier logic exactly
  (still in the same stream, overlapping the map tail);
* a full resume (nothing to map) goes through the barrier ``aggregate``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Sequence

from lmrs_tpu_torch.data.chunker import Chunk
from lmrs_tpu_torch.data.preprocessor import format_timestamp
from lmrs_tpu_torch.engine.api import degraded_reason
from lmrs_tpu_torch.obs.trace import PID_PIPELINE, get_tracer
from lmrs_tpu_torch.prompts import (DEFAULT_BATCH_REDUCE_PROMPT,
                                    DEFAULT_FINAL_REDUCE_PROMPT,
                                    DEFAULT_REDUCE_PROMPT)

logger = logging.getLogger("lmrs_torch.reduce.stream")


class StreamingMapReduce:
    """One-stream orchestration of the map stage + reduce tree."""

    def __init__(self, executor, aggregator):
        # the aggregator supplies prompt formatting, batch-size math, the
        # tokenizer and ReduceConfig: one source of truth with the barrier
        # path (reduce/aggregator.py)
        self.executor = executor
        self.agg = aggregator

    # ------------------------------------------------------------------ run

    def run(
        self,
        chunks: Sequence[Chunk],
        map_template: str,
        summary_type: str = "summary",
        system_prompt: str | None = None,
        reduce_template: str | None = None,
        metadata: dict[str, Any] | None = None,
        on_map_complete=None,
    ) -> dict[str, Any]:
        """Map every summary-less chunk and reduce; returns the aggregator's
        result dict plus ``map_seconds``/``reduce_tail_seconds``.

        ``on_map_complete(chunks)`` fires inside the stream the moment the
        last map summary lands — the pipeline's --save-chunks dump hooks in
        here so an interrupt during the reduce tail still leaves a
        resumable artifact (same checkpoint the barrier path writes
        between stages)."""
        t0 = time.time()
        ordered = sorted(chunks, key=lambda c: c.chunk_index)
        cfg = self.agg.config

        todo = [c for c in ordered if c.summary is None]
        if not todo:
            # nothing to map (full resume): the barrier path is exact here
            out = self.agg.aggregate(ordered, reduce_template, metadata)
            out["map_seconds"] = 0.0
            out["reduce_tail_seconds"] = out["aggregation_time"]
            return out

        def tagged(c: Chunk) -> str:
            return (f"[Time: {format_timestamp(c.start_time)} - "
                    f"{format_timestamp(c.end_time)}]\n{c.summary or ''}")

        # ---- state shared by the callbacks (single-threaded)
        st = {
            "pending_map": len(todo),
            # time-tagged summary tokens so far (resumed chunks count)
            "done_tokens": sum(self.agg.tokenizer.count(tagged(c))
                               for c in ordered if c.summary is not None),
            "done_count": len(ordered) - len(todo),
            "mode": "undecided",      # undecided | hierarchical | single
            "groups": [],              # level-1 groups (built on trigger)
            "pending_level": {},       # level -> outstanding request count
            "outputs": {},             # level -> list[(ordinal, text)]
            "all_l1_submitted": False,
            "submitted_groups": set(),
            "group_of": {},            # chunk_index -> group index
            "final": None,
            "levels": 0,
            "t_map_done": None,
            "next_rid": len(todo),
            "first_reduce_t": None,
        }
        chunk_by_rid: dict[int, Chunk] = {}
        reduce_meta: dict[int, tuple] = {}  # rid -> ("batch", level, ordinal) | ("final", level)
        budget = cfg.max_tokens_per_batch

        map_requests = []
        for i, c in enumerate(todo):
            map_requests.append(self.executor.build_map_request(
                c, map_template, summary_type, system_prompt, request_id=i))
            chunk_by_rid[i] = c

        # ---- reduce submission helpers

        def submit_reduce(submit, summaries, template, meta, kind) -> int:
            rid = st["next_rid"]
            st["next_rid"] += 1
            reduce_meta[rid] = kind
            if st["first_reduce_t"] is None:
                st["first_reduce_t"] = time.time()
            req = self.agg._build_request(summaries, template, meta, request_id=rid)
            submit([req])
            return rid

        def submit_group(submit, group_idx: int) -> None:
            if group_idx in st["submitted_groups"]:
                return
            st["submitted_groups"].add(group_idx)
            group = st["groups"][group_idx]
            n_groups = len(st["groups"])
            summaries = [tagged(c) for c in group]
            # token-split: contiguous sub-batches, each within the working
            # budget (same headroom the batch-size math reserves)
            cap = max(budget - cfg.reserve_tokens, 1)
            subs: list[list[str]] = [[]]
            acc = 0
            for s in summaries:
                n = self.agg.tokenizer.count(s)
                if subs[-1] and acc + n > cap:
                    subs.append([])
                    acc = 0
                subs[-1].append(s)
                acc += n
            lo = 100.0 * group_idx / n_groups
            hi = 100.0 * (group_idx + 1) / n_groups
            meta = dict(metadata or {})
            meta.update({"batch": f"{group_idx + 1}/{n_groups}",
                         "position": f"{lo:.0f}%-{hi:.0f}% of the transcript"})
            for si, sub in enumerate(subs):
                st["pending_level"][1] = st["pending_level"].get(1, 0) + 1
                submit_reduce(submit, sub,
                              reduce_template or DEFAULT_BATCH_REDUCE_PROMPT,
                              meta, ("batch", 1, (group_idx, si)))

        def maybe_trigger_hierarchical(submit) -> None:
            # cfg.hierarchical=False pins the barrier path's single-pass
            # choice (aggregator.py: hierarchical AND over-budget)
            if (not cfg.hierarchical or st["mode"] != "undecided"
                    or st["done_tokens"] <= budget):
                return
            st["mode"] = "hierarchical"
            avg = max(st["done_tokens"] // max(st["done_count"], 1), 1)
            bs = max(1, min(cfg.max_summaries_per_batch,
                            (budget - cfg.reserve_tokens) // avg))
            st["groups"] = [ordered[i: i + bs]
                            for i in range(0, len(ordered), bs)]
            for gi, group in enumerate(st["groups"]):
                for c in group:
                    st["group_of"][c.chunk_index] = gi
            logger.info("hierarchical reduce triggered mid-map: %d groups of "
                        "<=%d (est. avg %d tok)", len(st["groups"]), bs, avg)
            for gi, group in enumerate(st["groups"]):
                if all(c.summary is not None for c in group):
                    submit_group(submit, gi)

        def advance_level(submit, level: int) -> None:
            outs = [t for _, t in sorted(st["outputs"].get(level, []))]
            st["levels"] = max(st["levels"], level)
            if len(outs) == 1:
                st["final"] = outs[0]
                return
            total = self.agg._total_tokens(outs)
            # same bound as aggregator._hierarchical's `level < max_levels`
            if total <= budget or level + 1 > cfg.max_levels:
                st["pending_level"][level + 1] = 1
                submit_reduce(submit, outs,
                              reduce_template or DEFAULT_FINAL_REDUCE_PROMPT,
                              metadata, ("final", level + 1))
                return
            bs = self.agg._calculate_batch_size(outs)
            batches = [outs[i: i + bs] for i in range(0, len(outs), bs)]
            logger.info("reduce level %d: %d summaries in %d batches",
                        level + 1, len(outs), len(batches))
            for bi, batch in enumerate(batches):
                # the positional metadata the barrier path attaches to
                # every batch at every level
                lo = 100.0 * bi / len(batches)
                hi = 100.0 * (bi + 1) / len(batches)
                meta = dict(metadata or {})
                meta.update({"batch": f"{bi + 1}/{len(batches)}",
                             "position": f"{lo:.0f}%-{hi:.0f}% of the transcript"})
                st["pending_level"][level + 1] = st["pending_level"].get(level + 1, 0) + 1
                submit_reduce(submit, batch,
                              reduce_template or DEFAULT_BATCH_REDUCE_PROMPT,
                              meta, ("batch", level + 1, (bi, 0)))

        # ---- the stream callback

        def on_final(res, submit) -> None:
            rid = res.request_id
            if rid in chunk_by_rid:  # ------------------------- map result
                c = chunk_by_rid[rid]
                reason = degraded_reason(res)  # shed/deadline terminals
                if reason is not None:           # carry no error field
                    c.summary = f"[Error processing chunk: {reason}]"
                    c.error = reason
                else:
                    c.summary = res.text
                c.tokens_used = res.total_tokens
                c.device_seconds = res.device_seconds
                st["pending_map"] -= 1
                st["done_count"] += 1
                st["done_tokens"] += self.agg.tokenizer.count(tagged(c))
                maybe_trigger_hierarchical(submit)
                if st["mode"] == "hierarchical":
                    gi = st["group_of"][c.chunk_index]
                    if all(x.summary is not None for x in st["groups"][gi]):
                        submit_group(submit, gi)
                if st["pending_map"] == 0:
                    st["t_map_done"] = time.time()
                    if on_map_complete is not None:
                        try:
                            on_map_complete(ordered)
                        except Exception:
                            logger.exception("on_map_complete hook failed")
                    if st["mode"] == "undecided":
                        # never exceeded the budget: exact single-pass
                        st["mode"] = "single"
                        st["pending_level"][1] = 1
                        st["levels"] = 1
                        submit_reduce(submit, [tagged(c) for c in ordered],
                                      reduce_template or DEFAULT_REDUCE_PROMPT,
                                      metadata, ("final", 1))
                    else:
                        st["all_l1_submitted"] = True
                        if st["pending_level"].get(1, 0) == 0:
                            advance_level(submit, 1)
                return
            # ------------------------------------------------ reduce result
            kind = reduce_meta.pop(rid)
            text = (res.text if degraded_reason(res) is None
                    else f"[Error aggregating summaries: "
                         f"{degraded_reason(res)}]")
            if kind[0] == "final":
                st["final"] = text
                st["levels"] = max(st["levels"], kind[1])
                st["pending_level"][kind[1]] = 0
                return
            _, level, ordinal = kind
            st["outputs"].setdefault(level, []).append((ordinal, text))
            st["pending_level"][level] -= 1
            if st["pending_level"][level] == 0 and (
                    level > 1 or st["all_l1_submitted"]):
                advance_level(submit, level)

        self.executor.run_requests_streaming(map_requests, on_final)

        t_end = time.time()
        tr = get_tracer()
        if tr:
            # no barrier, so the spans OVERLAP: map_stage ends at the last
            # map summary, reduce_stream runs from the first reduce to the
            # end (the overlap window shows in Perfetto)
            tr.complete("map_stage", t0, st["t_map_done"] or t_end,
                        pid=PID_PIPELINE,
                        args={"chunks": len(map_requests), "streaming": True})
            if st["first_reduce_t"] is not None:
                tr.complete("reduce_stream", st["first_reduce_t"], t_end,
                            pid=PID_PIPELINE, tid=1,
                            args={"levels": max(st["levels"], 1)})
        if st["final"] is None:  # defensive: stream ended without a final
            logger.error("stream ended without a final summary; falling back "
                         "to barrier reduce")
            out = self.agg.aggregate(ordered, reduce_template, metadata)
            st["final"] = out["final_summary"]
            st["levels"] = out["levels"]
            st["mode"] = "hierarchical" if out["hierarchical"] else "single"
        t_map = (st["t_map_done"] or t_end) - t0
        return {
            "final_summary": st["final"],
            "num_chunk_summaries": len(ordered),
            "hierarchical": st["mode"] == "hierarchical",
            "levels": max(st["levels"], 1),
            "aggregation_time": t_end - (st["first_reduce_t"] or t_end),
            "map_seconds": t_map,
            "reduce_tail_seconds": t_end - (st["t_map_done"] or t_end),
        }
