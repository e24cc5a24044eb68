"""Port parity of the mock engine: the port's ``MockEngine`` against the
reference's on the same requests (the demo transcript's map prompts, stop
strings, ``fail_pattern``, deadlines, cancel), its ``engine_metrics`` and
``prefix_summary``, and ``TranscriptSummarizer`` with ``backend="mock"`` in
both packages.  Held exactly, the ``host_kv`` and ``kv_migrate`` blocks
included (both mocks run their default host tier).  Both run with the
cost ledger, SLO and anatomy switched off here (``tests/test_torch_obs_
serving.py`` holds those blocks) and fair-share QoS at both packages'
default (on).  No JAX compile, no sockets."""

import dataclasses
import time

import pytest

from lmrs_tpu import pipeline as jpipe
from lmrs_tpu.config import ChunkConfig as JChunkConfig
from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.config import PipelineConfig as JPipelineConfig
from lmrs_tpu.config import ReduceConfig as JReduceConfig
from lmrs_tpu.engine.api import GenerationRequest as JRequest
from lmrs_tpu.engine.mock import MockEngine as JMock
from lmrs_tpu_torch import pipeline as tpipe
from lmrs_tpu_torch.config import ChunkConfig as TChunkConfig
from lmrs_tpu_torch.config import EngineConfig as TEngineConfig
from lmrs_tpu_torch.config import PipelineConfig as TPipelineConfig
from lmrs_tpu_torch.config import ReduceConfig as TReduceConfig
from lmrs_tpu_torch.engine.api import GenerationRequest, make_engine
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.prompts import resolve_map_prompt
from lmrs_tpu_torch.utils.demo import load_demo_transcript
from lmrs_tpu_torch.utils.timing import StageTimer

# observability held elsewhere
REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0"}
RESULT_FIELDS = ("request_id", "text", "prompt_tokens", "completion_tokens",
                 "finish_reason", "stop_sequence", "error")


@pytest.fixture(autouse=True)
def ref_surfaces_off(monkeypatch):
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)


def ref_mock(**kw):
    return JMock(cost_ledger=False, slo=False, **kw)


def to_ref(req: GenerationRequest) -> JRequest:
    return JRequest(**{k: v for k, v in dataclasses.asdict(req).items()
                       if k != "trace_id"})


def fields(results) -> list[dict]:
    return [{f: getattr(r, f) for f in RESULT_FIELDS} for r in results]


def metrics(engine) -> dict:
    return engine.engine_metrics()


def map_requests(n_segments: int = 200) -> list[GenerationRequest]:
    """The demo transcript's map prompts, built by the port's pipeline."""
    summ = tpipe.TranscriptSummarizer(TPipelineConfig(
        chunk=TChunkConfig(max_tokens_per_chunk=300, overlap_tokens=50),
        engine=TEngineConfig(backend="mock")))
    _n, _p, chunks = summ._prep(load_demo_transcript(n_segments), StageTimer())
    return [summ.executor.build_map_request(c, resolve_map_prompt(),
                                            request_id=i)
            for i, c in enumerate(chunks)]


@pytest.mark.parametrize("kw", [{}, {"mixed_batch": False},
                                {"speculate_k": 4},
                                {"prefix_cache": False, "seed": 3}])
def test_map_prompts_match_reference(kw):
    reqs = map_requests()
    assert len(reqs) > 4
    port, ref = MockEngine(**kw), ref_mock(**kw)
    # two waves: the second one hits the emulated prefix cache
    for wave in (reqs[:5], reqs[5:]):
        got = port.generate_batch([dataclasses.replace(r) for r in wave])
        want = ref.generate_batch([to_ref(r) for r in wave])
        assert fields(got) == fields(want)
    assert metrics(port) == metrics(ref)
    assert port.prefix_summary() == ref.prefix_summary()
    assert port.prefix_summary(top_k=1) == ref.prefix_summary(top_k=1)
    if kw.get("prefix_cache", True):
        assert port.engine_metrics()["prefix_cache"]["hits"] > 0
    if kw.get("speculate_k"):
        assert port.engine_metrics()["spec_tree"]["dispatches"] > 0


@pytest.mark.parametrize("host_kv", [False, True])
def test_emulated_cache_evicts_like_reference(host_kv):
    """Past the resident budget the LRU preamble drops (host tier off) or
    spills to the emulated host pool, where a later hit restores it (the
    default, tier on)."""
    reqs = [GenerationRequest(prompt=f"preamble {i} " * 200 + "body",
                              request_id=i, cache_prefix=1500)
            for i in range(6)]
    reqs += [dataclasses.replace(reqs[0], request_id=6),
             dataclasses.replace(reqs[5], request_id=7)]
    kw = {} if host_kv else {"host_kv": False}
    port, ref = MockEngine(**kw), ref_mock(**kw)
    for r in reqs:  # one request a batch: an LRU walk per request
        assert fields(port.generate_batch([dataclasses.replace(r)])) == \
            fields(ref.generate_batch([to_ref(r)]))
    assert metrics(port) == metrics(ref)
    assert port.prefix_summary() == ref.prefix_summary()
    if host_kv:
        tier = metrics(port)["host_kv"]
        assert tier["spill_pages"] > 0 and tier["spilled_hits"] > 0
        assert any(r["spilled_tokens"] for r in port.prefix_summary())
    else:
        assert len(port.prefix_summary()) < 6


def test_stop_strings_and_fail_pattern_match_reference():
    base = map_requests(80)[0]
    text = MockEngine().generate_batch([dataclasses.replace(base)])[0].text
    mid = text[len(text) // 2: len(text) // 2 + 4]
    reqs = [dataclasses.replace(base, request_id=0, stop=(mid,)),
            dataclasses.replace(base, request_id=1, stop=("zzz", "Summary")),
            dataclasses.replace(base, request_id=2, stop=("", mid)),
            dataclasses.replace(base, request_id=3, prompt="FAIL " + base.prompt),
            dataclasses.replace(base, request_id=4, stop="- ")]
    port, ref = MockEngine(fail_pattern="FAIL"), ref_mock(fail_pattern="FAIL")
    got = port.generate_batch(reqs)
    assert fields(got) == fields(ref.generate_batch([to_ref(r) for r in reqs]))
    assert got[0].stop_sequence == mid and mid not in got[0].text
    assert got[3].finish_reason == "error" and got[3].error
    assert metrics(port) == metrics(ref)


def test_deadlines_and_cancel_match_reference():
    """Expired before any work: shed; expired during the emulated latency:
    deadline; cancelled before its turn: cancelled; the cancel set clears
    at the end of the batch."""
    def reqs():
        now = time.time()
        return [GenerationRequest(prompt="late " * 20, request_id=0,
                                  deadline_s=now - 1.0),
                GenerationRequest(prompt="tight " * 20, request_id=1,
                                  deadline_s=now + 0.05),
                GenerationRequest(prompt="gone " * 20, request_id=2),
                GenerationRequest(prompt="fine " * 20, request_id=3,
                                  deadline_s=now + 60.0)]

    outs = []
    for eng, conv in ((MockEngine(latency_s=0.1), dataclasses.replace),
                      (ref_mock(latency_s=0.1), to_ref)):
        eng.cancel(2)
        outs.append(fields(eng.generate_batch([conv(r) for r in reqs()])))
        assert eng.cancelled == set()
    assert outs[0] == outs[1]
    assert [o["finish_reason"] for o in outs[0]] == [
        "shed", "deadline", "cancelled", "stop"]


def test_streaming_hooks_match_reference():
    """One whole-text delta per result, and ``on_result`` submissions run
    as later waves (``drain_with_callback``)."""
    reqs = map_requests(80)[:3]
    got = {}
    for name, eng, conv, mk in (
            ("port", MockEngine(), dataclasses.replace, GenerationRequest),
            ("ref", ref_mock(), to_ref, JRequest)):
        deltas, order = [], []

        def on_result(res, submit, mk=mk, order=order):
            order.append(res.request_id)
            if res.request_id == 0:
                submit([mk(prompt="follow-up " + res.text, request_id=9)])

        res = eng.generate_batch([conv(r) for r in reqs], on_result=on_result,
                                 on_tokens=lambda rid, d: deltas.append((rid, d)))
        got[name] = (fields(res), deltas, order)
    assert got["port"] == got["ref"]
    results, deltas, order = got["port"]
    assert order == [0, 1, 2, 9]
    assert deltas == [(r["request_id"], r["text"]) for r in results]


def test_make_engine_builds_the_mock():
    eng = make_engine(TEngineConfig(backend="mock", seed=5, mixed_batch=False,
                                    speculate_k=2, prefix_cache=False))
    assert isinstance(eng, MockEngine)
    assert (eng.seed, eng.mixed_batch, eng.spec_k, eng.prefix_cache) == (
        5, False, 2, False)
    assert not getattr(eng, "schedules_internally", False)


def _summarizers(streaming):
    kw = dict(max_tokens_per_batch=400, reserve_tokens=100,
              max_summaries_per_batch=4, streaming=streaming)
    ref = jpipe.TranscriptSummarizer(JPipelineConfig(
        chunk=JChunkConfig(max_tokens_per_chunk=300, overlap_tokens=50),
        engine=JEngineConfig(backend="mock", retry_delay=0.0, seed=0,
                             max_tokens=64),
        reduce=JReduceConfig(**kw)))
    port = tpipe.TranscriptSummarizer(TPipelineConfig(
        chunk=TChunkConfig(max_tokens_per_chunk=300, overlap_tokens=50),
        engine=TEngineConfig(backend="mock", retry_delay=0.0, seed=0,
                             max_tokens=64),
        reduce=TReduceConfig(**kw)))
    return ref, port


TIMINGS = ("processing_time", "stage_times", "engine_metrics",
           "total_device_seconds")


def comparable(stats):
    return {k: v for k, v in stats.items() if k not in TIMINGS}


@pytest.mark.parametrize("streaming", [False, True])
def test_pipeline_backend_mock_matches_reference(streaming):
    data = load_demo_transcript(200)
    ref, port = _summarizers(streaming)
    a, b = ref.summarize(data), port.summarize(data)
    assert comparable(b) == comparable(a)
    assert b["hierarchical"] and b["failed_requests"] == 0
    assert b["engine_metrics"] == a["engine_metrics"]
    assert isinstance(port.executor.engine, MockEngine)


def test_cli_backend_mock_runs_the_pipeline(tmp_path, capsys):
    """``lmrs-torch --backend mock`` runs the whole pipeline on the CPU
    (no ``--device`` needed: the mock touches no device) and writes the
    summary the port's mock pipeline makes."""
    import json

    from lmrs_tpu_torch.cli import main

    data = load_demo_transcript(120)
    src = tmp_path / "t.json"
    src.write_text(json.dumps(data))
    out = tmp_path / "s.txt"
    assert main(["--input", str(src), "--output", str(out), "--backend",
                 "mock", "--report", "-q"]) == 0
    report = json.loads((tmp_path / "s.txt.report.json").read_text())
    want = tpipe.TranscriptSummarizer(TPipelineConfig(
        engine=TEngineConfig(backend="mock"))).summarize(data)
    assert out.read_text() == want["summary"]
    assert report["failed_requests"] == 0
    assert report["total_requests"] == want["total_requests"]
