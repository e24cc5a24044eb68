"""Port parity of the pipeline layer: config fingerprints, the chunk-dump
format read both ways, resume rules, multi-transcript round-robin, and the
slice as a whole: the reference's ``TranscriptSummarizer`` (its executor a
``MapExecutor`` over the scripted fake engine of ``test_torch_executor.py``)
against the port's (``engine=`` the same fake engine) on the demo
transcript, with the streaming reduce on and off, then save and resume.
Held exactly; the stats dicts less timings and ``engine_metrics``.  The
``lmrs-torch`` CLI's save/resume flags run once on the CPU at the 2-layer
``bench-smoke`` model.  No JAX compile."""

import json
import logging
from pathlib import Path

import pytest

from lmrs_tpu import pipeline as jpipe
from lmrs_tpu.config import ChunkConfig as JChunkConfig
from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.config import PipelineConfig as JPipelineConfig
from lmrs_tpu.config import ReduceConfig as JReduceConfig
from lmrs_tpu.data.chunker import TranscriptChunker as JChunker
from lmrs_tpu.data.preprocessor import preprocess_transcript as j_preprocess
from lmrs_tpu.engine import api as japi
from lmrs_tpu.engine.executor import MapExecutor as JMapExecutor
from lmrs_tpu.jobs.journal import config_fingerprint as j_fingerprint
from lmrs_tpu.prompts import DEFAULT_MAP_PROMPT
from lmrs_tpu.utils.demo import load_demo_transcript as j_demo
from lmrs_tpu_torch import pipeline as tpipe
from lmrs_tpu_torch.config import ChunkConfig as TChunkConfig
from lmrs_tpu_torch.config import EngineConfig as TEngineConfig
from lmrs_tpu_torch.config import PipelineConfig as TPipelineConfig
from lmrs_tpu_torch.config import ReduceConfig as TReduceConfig
from lmrs_tpu_torch.data.chunker import TranscriptChunker as TChunker
from lmrs_tpu_torch.data.preprocessor import preprocess_transcript as t_preprocess
from lmrs_tpu_torch.engine import api as tapi
from lmrs_tpu_torch.engine.executor import MapExecutor as TMapExecutor
from lmrs_tpu_torch.utils.demo import load_demo_transcript as t_demo
from lmrs_tpu_torch.utils.fingerprint import config_fingerprint as t_fingerprint

from conftest import make_segments
from test_torch_executor import ScriptedEngine

FP_FIELDS = dict(map_prompt="Summarize {transcript}", system_prompt="",
                 summary_type="summary", backend="torch", model="bench-8b",
                 temperature=0.3, max_tokens=64, seed=0,
                 max_tokens_per_chunk=1400, overlap_tokens=200,
                 context_tokens=150, tokenizer="byte")


@pytest.mark.parametrize("fields", [
    FP_FIELDS, {**FP_FIELDS, "backend": "jax"}, {"unicode": "ünï ✓", "n": 1},
    {}])
def test_config_fingerprint_matches_reference(fields):
    assert t_fingerprint(**fields) == j_fingerprint(**fields)
    assert len(t_fingerprint(**fields)) == 16


def _chunks(pkg, n=40, seed=0):
    chunker, preprocess = ((JChunker, j_preprocess) if pkg == "ref"
                           else (TChunker, t_preprocess))
    chunks = chunker(max_tokens_per_chunk=150, overlap_tokens=0,
                     context_tokens=30).chunk_transcript(
        preprocess(make_segments(n, seed=seed)))
    for c in chunks:
        c.summary = f"summary {c.chunk_index}"
        c.tokens_used = 10 + c.chunk_index
    # one failed chunk and one never mapped: both stay to do on resume
    chunks[1].summary, chunks[1].error = "[Error processing chunk: x]", "x"
    chunks[2].summary = None
    return chunks


def _fresh(pkg, n=40, seed=0):
    out = _chunks(pkg, n, seed)
    for c in out:
        c.summary, c.error, c.tokens_used = None, None, 0
    return out


def test_dump_formats_have_the_same_keys(tmp_path):
    jpipe._dump_chunks(str(tmp_path / "j.json"), _chunks("ref"),
                       fingerprint="f")
    tpipe._dump_chunks(str(tmp_path / "t.json"), _chunks("port"),
                       fingerprint="f")
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert sorted(t) == sorted(j)
    assert [sorted(c) for c in t["chunks"]] == [sorted(c) for c in j["chunks"]]
    assert [{k: v for k, v in c.items()} for c in t["chunks"]] == j["chunks"]
    assert t["fingerprint"] == j["fingerprint"] == "f"


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_dump_resumes_across_packages(tmp_path, writer):
    path = str(tmp_path / "dump.json")
    (jpipe if writer == "ref" else tpipe)._dump_chunks(
        path, _chunks(writer), fingerprint="f")
    splits = {}
    for pkg, mod in (("ref", jpipe), ("port", tpipe)):
        chunks = _fresh(pkg)
        resumed, todo = mod._load_resume(path, chunks, fingerprint="f")
        splits[pkg] = ([(c.chunk_index, c.summary, c.tokens_used)
                        for c in resumed], [c.chunk_index for c in todo])
    assert splits["port"] == splits["ref"]
    assert splits["port"][1] == [1, 2]
    assert len(splits["port"][0]) == len(_chunks("port")) - 2


def test_mismatched_fingerprint_drops_the_dump(tmp_path, caplog):
    path = str(tmp_path / "dump.json")
    tpipe._dump_chunks(path, _chunks("port"), fingerprint="aaaa")
    chunks = _fresh("port")
    with caplog.at_level(logging.WARNING, logger="lmrs_torch.pipeline"):
        resumed, todo = tpipe._load_resume(path, chunks, fingerprint="bbbb")
    assert resumed == [] and todo == chunks
    assert all(c.summary is None for c in chunks)
    assert "fingerprint" in caplog.text
    # a dump without a fingerprint still loads (chunk identity only)
    tpipe._dump_chunks(path, _chunks("port"), fingerprint=None)
    resumed, _ = tpipe._load_resume(path, _fresh("port"), fingerprint="bbbb")
    assert resumed


@pytest.mark.parametrize("content", ["{not json", None])
def test_unreadable_dump_logs_and_keeps_every_chunk(tmp_path, caplog, content):
    path = tmp_path / "dump.json"
    if content is not None:
        path.write_text(content)
    chunks = _fresh("port")
    with caplog.at_level(logging.ERROR, logger="lmrs_torch.pipeline"):
        resumed, todo = tpipe._load_resume(str(path), chunks, fingerprint="f")
    assert resumed == [] and todo == chunks
    assert "could not resume" in caplog.text


def test_failed_dump_write_is_not_fatal(tmp_path, caplog):
    with caplog.at_level(logging.ERROR, logger="lmrs_torch.pipeline"):
        tpipe._dump_chunks(str(tmp_path / "missing" / "d.json"),
                           _chunks("port"), fingerprint="f")
    assert "could not save chunks" in caplog.text


def test_chunk_groups_interleave_like_the_reference():
    calls = {}
    for pkg, ex_cls, cfg_cls, api in (
            ("ref", JMapExecutor, JEngineConfig, japi),
            ("port", TMapExecutor, TEngineConfig, tapi)):
        eng = ScriptedEngine(api)
        groups = [_fresh(pkg, n, seed)[:k]
                  for seed, (n, k) in enumerate(((40, 5), (30, 2), (60, 4)))]
        ex_cls(eng, cfg_cls(retry_delay=0.0)).process_chunk_groups(
            groups, DEFAULT_MAP_PROMPT)
        # transcript index of each request, in queue order
        owner = [next(gi for gi, g in enumerate(groups)
                      if any(c.text_with_context in p for c in g))
                 for p in eng.call_prompts[0]]
        calls[pkg] = (eng.calls, eng.call_prompts, owner,
                      [[c.summary for c in g] for g in groups])
    assert calls["port"] == calls["ref"]
    assert calls["port"][0] == [list(range(11))]
    assert calls["port"][2] == [0, 1, 2, 0, 1, 2, 0, 2, 0, 2, 0]


# ------------------------------------------------------- the whole slice

def _summarizers(streaming):
    """(reference summarizer, port summarizer, their fake engines)."""
    kw = dict(max_tokens_per_batch=400, reserve_tokens=100,
              max_summaries_per_batch=4, streaming=streaming)
    jcfg = JPipelineConfig(
        chunk=JChunkConfig(max_tokens_per_chunk=300, overlap_tokens=50),
        engine=JEngineConfig(retry_delay=0.0, seed=0, max_tokens=64),
        reduce=JReduceConfig(**kw))
    tcfg = TPipelineConfig(
        chunk=TChunkConfig(max_tokens_per_chunk=300, overlap_tokens=50),
        engine=TEngineConfig(retry_delay=0.0, seed=0, max_tokens=64),
        reduce=TReduceConfig(**kw))
    jeng, teng = ScriptedEngine(japi), ScriptedEngine(tapi)
    ref = jpipe.TranscriptSummarizer(jcfg)
    ref._executor = JMapExecutor(jeng, jcfg.engine)
    port = tpipe.TranscriptSummarizer(tcfg, engine=teng)
    return ref, port, jeng, teng


TIMINGS = ("processing_time", "stage_times", "engine_metrics",
           "total_device_seconds")


def _comparable(stats):
    return {k: v for k, v in stats.items() if k not in TIMINGS}


@pytest.mark.parametrize("streaming", [False, True])
def test_whole_slice_matches_reference(tmp_path, streaming):
    assert t_demo(120) == j_demo(120)
    data = t_demo(120)
    ref, port, jeng, teng = _summarizers(streaming)
    a = ref.summarize(data, save_chunks=str(tmp_path / "j.json"))
    b = port.summarize(data, save_chunks=str(tmp_path / "t.json"))
    assert _comparable(b) == _comparable(a)
    assert b["hierarchical"] and b["reduce_levels"] >= 2
    assert b["num_resumed_chunks"] == 0 and b["failed_requests"] == 0
    assert sorted(b["stage_times"]) == sorted(a["stage_times"])
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert [c["summary"] for c in t["chunks"]] == [c["summary"] for c in j["chunks"]]
    # resume each package from its own dump: nothing is mapped again
    ref2, port2, jeng2, teng2 = _summarizers(streaming)
    a2 = ref2.summarize(data, resume_from=str(tmp_path / "j.json"))
    b2 = port2.summarize(data, resume_from=str(tmp_path / "t.json"))
    assert _comparable(b2) == _comparable(a2)
    assert b2["num_resumed_chunks"] == b2["num_chunks"] == b["num_chunks"]
    assert b2["summary"] == b["summary"]
    map_prompts = {r for r in teng.attempts if "SUMMARY 1:" not in r}
    assert map_prompts and not map_prompts & set(teng2.attempts)
    assert b2["total_requests"] == b["total_requests"] - b["num_chunks"]


def test_summarize_many_matches_reference():
    data = [t_demo(120), {"segments": t_demo(200)["segments"][120:]}]
    ref, port, jeng, teng = _summarizers(False)
    a = ref.summarize_many(data)
    b = port.summarize_many(data)
    assert [_comparable(s) for s in b] == [_comparable(s) for s in a]
    assert jeng.calls[0] == teng.calls[0]
    assert jeng.call_prompts[0] == teng.call_prompts[0]
    # the pooled queue alternates between the transcripts: the first two
    # map prompts come from transcripts 0 and 1
    first = teng.call_prompts[0]
    assert len(first) == sum(s["num_chunks"] for s in b)
    n0, n1 = b[0]["num_chunks"], b[1]["num_chunks"]
    assert [f"SECTION {i} of {n}]" in p for p, (i, n) in zip(
        first, [(1, n0), (1, n1), (2, n0), (2, n1)])] == [True] * 4
    assert all(s["summary"] for s in b)


def test_cli_save_then_resume_maps_nothing(tmp_path):
    from lmrs_tpu_torch.cli import main

    src = tmp_path / "t.json"
    src.write_text(json.dumps({"segments": make_segments(12)}))
    dump, out = tmp_path / "chunks.json", tmp_path / "s.txt"
    common = ["--input", str(src), "--output", str(out), "--model",
              "bench-smoke", "--tokenizer", "byte", "--device", "cpu",
              "--max-tokens", "4", "--max-tokens-per-chunk", "200",
              "--no-hierarchical", "--report", "-q"]
    assert main(common + ["--save-chunks", str(dump), "--stream-reduce",
                          "--max-concurrent-requests", "2"]) == 0
    first = json.loads(Path(str(out) + ".report.json").read_text())
    assert first["num_chunks"] >= 2 and first["failed_requests"] == 0
    assert len(json.loads(dump.read_text())["chunks"]) == first["num_chunks"]
    assert main(common + ["--resume-from", str(dump)]) == 0
    second = json.loads(Path(str(out) + ".report.json").read_text())
    assert second["num_resumed_chunks"] == second["num_chunks"]
    # the resumed run's engine saw the one single-pass reduce request only
    assert second["total_requests"] == 1
    assert second["engine_metrics"]["requests"] == 1
