"""Cancel, deadlines and admission shedding in the port's scheduler, on the
CPU: ``TorchEngine`` at the 2-layer model of ``test_torch_engine.py`` under
its default-path pressure (2 slots, a 9-page pool, 32-token prefill chunks,
mixed steps, the prefix cache, preemption), greedy.  Each case checks the
finish reason and whether text was kept by the reference scheduler's rules
(``_expire_queue_entry`` / ``_finish_slot``: shed and queued entries keep
nothing, a queued preemption continuation keeps its prior tokens, a live
slot keeps its output so far), that the pool's free pages are back (less
what the prefix cache holds) with a clean ``audit()``, and that the
requests left alone produce the texts of a run without the intervention
(those texts are held against the JAX loop by
``test_engine_default_path_matches_jax_loop``)."""

import time

import pytest

from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.engine.torch_engine import TorchEngine

from test_torch_engine import CFG, IdTokenizer

PREAMBLE = "You are summarizing. Keep facts and numbers!!!\n"
BODIES = ["alpha beta g", "the quick br", "x" * 12, "0123456789ab"]
MAX_NEW = 24
FAR = 3600.0


def make_engine():
    return TorchEngine(
        EngineConfig(max_batch_slots=2, page_size=16, num_pages=9,
                     decode_block=4, max_tokens=MAX_NEW, prefill_chunk=32,
                     mixed_token_budget=32, seed=0, retry_delay=0.0),
        TModelConfig(name="t", **CFG), device="cpu", tokenizer=IdTokenizer())


def make_requests(deadline=None):
    return [GenerationRequest(prompt=PREAMBLE + body, request_id=i,
                              temperature=0.0, cache_prefix=len(PREAMBLE),
                              max_new_tokens=MAX_NEW,
                              deadline_s=(time.time() + deadline
                                          if deadline is not None else None))
            for i, body in enumerate(BODIES)]


_CLEAN = {}


def clean_texts():
    """Texts of an untouched run (one engine per process)."""
    if not _CLEAN:
        eng = make_engine()
        _CLEAN["texts"] = [r.text for r in eng.generate_batch(make_requests())]
        _CLEAN["metrics"] = eng.engine_metrics()
    return _CLEAN["texts"]


def check_pool(engine):
    sched = engine._scheduler
    cached = sched._prefix_cache.cached_pages if sched._prefix_cache else 0
    assert sched.cache.allocator.free_count == sched.cache.num_pages - 1 - cached
    assert engine.audit() == []


def check_untouched(results, touched):
    clean = clean_texts()
    for r in results:
        if r.request_id not in touched:
            assert r.finish_reason in ("stop", "length")
            assert r.text == clean[r.request_id]


def test_clean_run_preempts_and_mixes():
    """The pressure the cases rely on: a preemption, mixed steps, prefix
    hits, and whole outputs to cut short."""
    clean_texts()
    m = _CLEAN["metrics"]
    assert m["preemptions"] >= 1 and m["mixed_batch"]["dispatches"] >= 1
    assert m["prefix_cache"]["hits"] >= 1
    assert m["cancelled"] == m["deadline"] == m["shed"] == 0
    assert all(len(t.split()) > 4 for t in _CLEAN["texts"])


def test_shed_at_admission():
    eng = make_engine()
    reqs = make_requests(deadline=FAR)
    reqs[3].deadline_s = time.time() - 1.0  # already passed: unmeetable
    out = eng.generate_batch(reqs)
    assert out[3].finish_reason == "shed"
    assert out[3].text == "" and out[3].completion_tokens == 0
    assert out[3].error is None
    assert eng.engine_metrics()["shed"] == 1
    check_pool(eng)
    check_untouched(out, {3})


def test_cancel_while_queued():
    eng = make_engine()
    seen = []

    def on_result(res, submit):
        seen.append(res.request_id)
        if len(seen) == 1:
            # 2 slots: request 3 still waits in the queue
            assert 3 not in eng._scheduler.live_tokens()
            eng.cancel(3)
    out = eng.generate_batch(make_requests(), on_result=on_result)
    assert out[3].finish_reason == "cancelled"
    assert out[3].text == "" and out[3].completion_tokens == 0
    assert eng.engine_metrics()["cancelled"] == 1
    check_pool(eng)
    check_untouched(out, {3})


def test_cancel_live_keeps_partial_text():
    eng = make_engine()
    clean = clean_texts()
    live = {}

    def on_result(res, submit):
        # cancel the first other request that holds a slot with output
        if not live:
            for rid, n in sorted(eng._scheduler.live_tokens().items()):
                if n and rid != res.request_id:
                    live[rid] = True
                    eng.cancel(rid)
                    break
    out = eng.generate_batch(make_requests(), on_result=on_result)
    (rid,) = live
    res = out[rid]
    assert res.finish_reason == "cancelled" and res.error is None
    assert 0 < res.completion_tokens < MAX_NEW
    assert res.text and clean[rid].startswith(res.text)
    check_pool(eng)
    check_untouched(out, {rid})


def test_deadline_in_flight_keeps_partial_text():
    eng = make_engine()
    clean = clean_texts()
    reqs = make_requests(deadline=FAR)
    hit = {}

    def on_result(res, submit):
        # the first other live request with output expires at the next
        # block boundary
        if not hit:
            for rid, n in sorted(eng._scheduler.live_tokens().items()):
                if n and rid != res.request_id:
                    hit[rid] = True
                    reqs[rid].deadline_s = time.time() - 1.0
                    break
    out = eng.generate_batch(reqs, on_result=on_result)
    (rid,) = hit
    res = out[rid]
    assert res.finish_reason == "deadline" and res.error is None
    assert 0 < res.completion_tokens < MAX_NEW
    assert res.text and clean[rid].startswith(res.text)
    assert eng.engine_metrics()["deadline"] == 1
    check_pool(eng)
    check_untouched(out, {rid})


def test_preempted_continuation_expires_with_prior_tokens():
    eng = make_engine()
    clean = clean_texts()
    sched = eng._scheduler
    victims = []
    preempt = sched._preempt

    def preempt_and_expire(b, slots, *args):
        # the victim's deadline passes while it waits as a continuation
        req = slots[b].req
        preempt(b, slots, *args)
        if not victims:
            victims.append(req.request_id)
            req.deadline_s = time.time() - 1.0
    sched._preempt = preempt_and_expire
    out = eng.generate_batch(make_requests(deadline=FAR))
    (rid,) = victims
    res = out[rid]
    assert res.finish_reason == "deadline" and res.error is None
    assert res.device_seconds == 0.0  # expired as a queue entry, not a slot
    assert 0 < res.completion_tokens < MAX_NEW
    assert res.text and clean[rid].startswith(res.text)
    check_pool(eng)
    check_untouched(out, {rid})


def test_exception_in_on_result_is_retried_by_the_executor():
    eng = make_engine()

    class RaiseOnce:
        """The engine, with an ``on_result`` hook that raises inside the
        scheduler loop the first time a result lands (slots still live)."""

        schedules_internally = True
        tokenizer = eng.tokenizer
        raised = 0

        def generate_batch(self, requests, on_result=None):
            def hook(res, submit):
                if not RaiseOnce.raised:
                    RaiseOnce.raised += 1
                    raise RuntimeError("scripted fault inside the loop")
            return eng.generate_batch(requests, on_result=hook)

        def engine_metrics(self):
            return eng.engine_metrics()

        def shutdown(self):
            pass

    ex = MapExecutor(RaiseOnce(), eng.cfg)
    out = ex.run_requests(make_requests())
    assert RaiseOnce.raised == 1
    assert ex.failed_requests == 0
    assert ex.total_requests == 2 * len(BODIES)  # every request retried
    check_pool(eng)
    check_untouched(out, set())


@pytest.fixture(autouse=True, scope="module")
def _warm():
    clean_texts()
