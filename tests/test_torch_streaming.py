"""Port parity of the streaming reduce: ``lmrs_tpu.reduce.streaming
.StreamingMapReduce`` and ``lmrs_tpu_torch.reduce.streaming
.StreamingMapReduce`` over the scripted fake engine of
``test_torch_executor.py`` (slot-based stream, scripted completion order)
and each package's own executor, aggregator and chunker on the same
segments.  Held exactly: the final summary, ``hierarchical``, ``levels``,
the ordered list of prompts the stream admitted (map and reduce), where in
the stream ``on_map_complete`` fired, and the chunks' summaries.  No model,
no JAX compile."""

import pytest

from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.config import ReduceConfig as JReduceConfig
from lmrs_tpu.data.chunker import TranscriptChunker as JChunker
from lmrs_tpu.data.preprocessor import preprocess_transcript as j_preprocess
from lmrs_tpu.engine import api as japi
from lmrs_tpu.engine.executor import MapExecutor as JMapExecutor
from lmrs_tpu.prompts import DEFAULT_MAP_PROMPT as J_MAP_PROMPT
from lmrs_tpu.reduce.aggregator import ResultAggregator as JAggregator
from lmrs_tpu.reduce.streaming import StreamingMapReduce as JStreaming
from lmrs_tpu_torch.config import EngineConfig as TEngineConfig
from lmrs_tpu_torch.config import ReduceConfig as TReduceConfig
from lmrs_tpu_torch.data.chunker import TranscriptChunker as TChunker
from lmrs_tpu_torch.data.preprocessor import preprocess_transcript as t_preprocess
from lmrs_tpu_torch.engine import api as tapi
from lmrs_tpu_torch.engine.executor import MapExecutor as TMapExecutor
from lmrs_tpu_torch.prompts import DEFAULT_MAP_PROMPT as T_MAP_PROMPT
from lmrs_tpu_torch.reduce.aggregator import ResultAggregator as TAggregator
from lmrs_tpu_torch.reduce.streaming import StreamingMapReduce as TStreaming

from conftest import make_segments
from test_torch_executor import ScriptedEngine

PACKAGES = {
    "ref": (japi, JEngineConfig, JReduceConfig, JChunker, j_preprocess,
            JMapExecutor, JAggregator, JStreaming, J_MAP_PROMPT),
    "port": (tapi, TEngineConfig, TReduceConfig, TChunker, t_preprocess,
             TMapExecutor, TAggregator, TStreaming, T_MAP_PROMPT),
}
META = {"duration": "10m 0s", "speakers": "SPEAKER_00, SPEAKER_01"}


def _stream(pkg, n_segments, reduce_kw, eng_kw=None, resume=False,
            barrier=False):
    (api, ecfg, rcfg, chunker_cls, preprocess, ex_cls, agg_cls, smr_cls,
     map_prompt) = PACKAGES[pkg]
    eng = ScriptedEngine(api, **(eng_kw or {}))
    prompts: list[str] = []
    orig = eng.generate_batch

    def generate_batch(requests, on_result=None):
        # every admitted prompt, in admission order
        seen = {r.request_id: r.prompt for r in requests}

        def tap(res, submit):
            def submit_tap(more):
                seen.update((r.request_id, r.prompt) for r in more)
                submit(more)
            on_result(res, submit_tap)

        n0 = len(eng.streamed)
        if on_result is None:
            prompts.extend(seen.values())
            return orig(requests)
        out = orig(requests, on_result=tap)
        prompts.extend(seen[i] for i in eng.streamed[n0:])
        return out

    eng.generate_batch = generate_batch
    ex = ex_cls(eng, ecfg(retry_delay=0.0, retry_attempts=2, seed=0))
    agg = agg_cls(ex, rcfg(**reduce_kw))
    chunks = chunker_cls(max_tokens_per_chunk=150, overlap_tokens=0,
                         context_tokens=30).chunk_transcript(
        preprocess(make_segments(n_segments)))
    if resume:
        for c in chunks:
            c.summary = f"resumed summary of chunk {c.chunk_index}"
    fired = []
    if barrier:
        todo = [c for c in chunks if c.summary is None]
        if todo:
            ex.process_chunks(todo, map_prompt)
        out = agg.aggregate(chunks, None, META)
    else:
        out = smr_cls(ex, agg).run(
            chunks, map_prompt, "summary", None, None, META,
            on_map_complete=lambda cs: fired.append(
                (len(eng.streamed), len(cs))))
    return {"final": out["final_summary"],
            "hierarchical": out["hierarchical"], "levels": out["levels"],
            "prompts": prompts, "fired": fired,
            "summaries": [(c.chunk_index, c.summary, c.error) for c in chunks],
            "stats": ex.stats(), "events": eng.events}


CASES = {
    # the tree triggers mid-map; level 2 follows the barrier logic
    "hierarchical_mid_map": (60, dict(max_tokens_per_batch=300,
                                      reserve_tokens=100,
                                      max_summaries_per_batch=3), False),
    # a deep tree capped by max_levels
    "max_levels_cap": (60, dict(max_tokens_per_batch=200, reserve_tokens=50,
                                max_summaries_per_batch=2, max_levels=2),
                       False),
    # never over budget: the exact single pass
    "under_budget_single_pass": (30, dict(max_tokens_per_batch=6000), False),
    # over budget but hierarchical=False: single pass
    "hierarchical_off": (60, dict(max_tokens_per_batch=300,
                                  hierarchical=False), False),
    # the first chunk's map request fails every attempt: its error summary
    # is reduced
    "failed_map_request": (40, dict(max_tokens_per_batch=300,
                                    reserve_tokens=100), True),
}


def _eng_kw(case, pkg):
    if not CASES[case][2]:
        return None
    api, ecfg, _r, chunker_cls, preprocess, ex_cls, _a, _s, map_prompt = \
        PACKAGES[pkg]
    chunks = chunker_cls(max_tokens_per_chunk=150, overlap_tokens=0,
                         context_tokens=30).chunk_transcript(
        preprocess(make_segments(CASES[case][0])))
    prompt = ex_cls(None, ecfg()).build_map_request(chunks[0], map_prompt).prompt
    return dict(always_fail={prompt})


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_reduce_matches_reference(case):
    n, reduce_kw, _ = CASES[case]
    ref = _stream("ref", n, reduce_kw, _eng_kw(case, "ref"))
    port = _stream("port", n, reduce_kw, _eng_kw(case, "port"))
    assert port == ref
    assert port["fired"] and port["fired"][0][1] == len(port["summaries"])
    if case in ("hierarchical_mid_map", "max_levels_cap",
                "failed_map_request"):
        assert port["hierarchical"] and port["levels"] >= 2
    else:
        assert not port["hierarchical"] and port["levels"] == 1
    if case == "failed_map_request":
        assert port["summaries"][0][2] is not None
        assert port["stats"]["failed_requests"] == 1


def test_streaming_single_pass_equals_the_barrier_path():
    """Under budget, the stream's single pass is the barrier path's."""
    n, reduce_kw, _ = CASES["under_budget_single_pass"]
    stream = _stream("port", n, reduce_kw)
    barrier = _stream("port", n, reduce_kw, barrier=True)
    for key in ("final", "hierarchical", "levels", "summaries", "prompts"):
        assert stream[key] == barrier[key]


def test_streaming_reduce_overlaps_the_map_stage():
    """Level-1 reduce requests are admitted while map requests still run:
    the map requests are the stream's first ids, 0..n-1."""
    n, reduce_kw, _ = CASES["hierarchical_mid_map"]
    out = _stream("port", n, reduce_kw)
    n_map = len(out["summaries"])
    events = out["events"]
    last_map_finish = max(i for i, (kind, rid) in enumerate(events)
                          if kind == "finish" and rid < n_map)
    early = [rid for kind, rid in events[:last_map_finish]
             if kind == "admit" and rid >= n_map]
    assert early


@pytest.mark.parametrize("hier", [True, False])
def test_full_resume_goes_through_the_barrier_aggregate(hier):
    reduce_kw = dict(max_tokens_per_batch=120, reserve_tokens=20,
                     hierarchical=hier)
    ref = _stream("ref", 60, reduce_kw, resume=True)
    port = _stream("port", 60, reduce_kw, resume=True)
    assert port == ref
    assert port["fired"] == []  # nothing mapped
    assert not any("SUMMARY 1:" not in p for p in port["prompts"])
    barrier = _stream("port", 60, reduce_kw, resume=True, barrier=True)
    assert port["final"] == barrier["final"]


class DrainEngine(ScriptedEngine):
    """The scripted engine without a mid-run hook: a stream is delivered
    after each wave by the package's ``drain_with_callback``."""

    def generate_batch(self, requests, on_result=None):
        if on_result is None:
            return super().generate_batch(requests)
        return self.api.drain_with_callback(
            lambda reqs: super(DrainEngine, self).generate_batch(reqs),
            requests, on_result)


def test_post_hoc_streaming_matches_reference():
    """Engines without a mid-run hook run the same streaming reduce through
    ``drain_with_callback``: equal results in both packages, and equal to
    the barrier path's tree shape."""
    outs = {}
    n, reduce_kw, _ = CASES["hierarchical_mid_map"]
    for pkg in PACKAGES:
        (api, ecfg, rcfg, chunker_cls, preprocess, ex_cls, agg_cls, smr_cls,
         map_prompt) = PACKAGES[pkg]
        eng = DrainEngine(api)
        ex = ex_cls(eng, ecfg(retry_delay=0.0, seed=0))
        chunks = chunker_cls(max_tokens_per_chunk=150, overlap_tokens=0,
                             context_tokens=30).chunk_transcript(
            preprocess(make_segments(n)))
        out = smr_cls(ex, agg_cls(ex, rcfg(**reduce_kw))).run(
            chunks, map_prompt, "summary", None, None, META)
        outs[pkg] = (out["final_summary"], out["hierarchical"], out["levels"],
                     eng.call_prompts, ex.stats())
    assert outs["port"] == outs["ref"]
    assert outs["port"][1] and len(outs["port"][3]) >= 2  # waves, then reduce
