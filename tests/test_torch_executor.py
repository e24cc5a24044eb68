"""Port parity of the map executor: ``lmrs_tpu.engine.executor.MapExecutor``
and ``lmrs_tpu_torch.engine.executor.MapExecutor`` over the same scripted
fake engine and the same requests (``retry_delay=0`` unless the case times a
backoff).  Held exactly: each result's text, finish reason and error, the
engine calls (wave sizes, and ids less the run's epoch base), and
``stats()``.  No model, no JAX compile.

``ScriptedEngine`` is the fake engine the port's streaming and pipeline
tests share: deterministic text from a hash of the prompt, failures at
chosen (prompt, attempt) pairs, exceptions on chosen calls, the wave cap on
or off (``schedules_internally``), each package's own result class, and a
slot-based stream with a scripted completion order when ``on_result`` is
given."""

import hashlib
import time

import pytest

from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.engine import api as japi
from lmrs_tpu.engine.executor import MapExecutor as JMapExecutor
from lmrs_tpu_torch.config import EngineConfig as TEngineConfig
from lmrs_tpu_torch.engine import api as tapi
from lmrs_tpu_torch.engine.executor import MapExecutor as TMapExecutor

WORDS = ("the team reviewed latency budgets kernels hiring roadmap launch "
         "risks metrics owners dates decisions follow-ups").split()

PACKAGES = {"ref": (japi, JMapExecutor, JEngineConfig),
            "port": (tapi, TMapExecutor, TEngineConfig)}


def digest(text: str) -> int:
    return int(hashlib.sha256(text.encode("utf-8")).hexdigest()[:12], 16)


def fake_text(prompt: str) -> str:
    """Deterministic 'summary' of 8-39 words from a hash of the prompt."""
    h = digest(prompt)
    n = 8 + h % 32
    return " ".join(WORDS[(h >> (i % 40)) % len(WORDS)] for i in range(n))


class ScriptedEngine:
    """A scripted stand-in for an engine (see the module docstring).

    ``fail``: {(prompt, attempt)} pairs that come back as error results
    (attempts counted per prompt, from 1); ``always_fail``: prompts that
    fail on every attempt; ``raise_calls``: indices of ``generate_batch``
    calls that raise; ``on_call(n, requests)``: a hook run at the start of
    call n.  With ``on_result`` the call is a stream over ``slots`` slots:
    each request takes ``1 + digest(prompt) % 5`` ticks, requests admit in
    FIFO order, and those finishing on one tick are delivered in slot order;
    ``submit`` appends to the queue."""

    def __init__(self, api, internal=True, fail=(), always_fail=(),
                 raise_calls=(), on_call=None, slots=3):
        self.api = api
        self.schedules_internally = internal
        self.fail = set(fail)
        self.always_fail = set(always_fail)
        self.raise_calls = set(raise_calls)
        self.on_call = on_call
        self.slots = slots
        self.attempts: dict[str, int] = {}
        self.calls: list[list[int]] = []   # engine ids of each call
        self.call_prompts: list[list[str]] = []
        self.streamed: list[int] = []      # engine ids in admission order
        self.events: list[tuple] = []      # ("admit" | "finish", engine id)
        self.cancelled: set[int] = set()

    def _result(self, req):
        n = self.attempts[req.prompt] = self.attempts.get(req.prompt, 0) + 1
        if req.request_id in self.cancelled:
            return self.api.GenerationResult(
                request_id=req.request_id, finish_reason="cancelled")
        if (req.prompt, n) in self.fail or req.prompt in self.always_fail:
            return self.api.GenerationResult(
                request_id=req.request_id, finish_reason="error",
                error=f"scripted fault {n}")
        text = fake_text(req.prompt)
        return self.api.GenerationResult(
            request_id=req.request_id, text=text, prompt_tokens=len(req.prompt),
            completion_tokens=len(text.split()))

    def generate_batch(self, requests, on_result=None):
        call = len(self.calls)
        self.calls.append([r.request_id for r in requests])
        self.call_prompts.append([r.prompt for r in requests])
        if self.on_call is not None:
            self.on_call(call, requests)
        if call in self.raise_calls:
            raise RuntimeError(f"scripted engine fault on call {call}")
        if on_result is None:
            return [self._result(r) for r in requests]
        queue = list(requests)
        out = []
        live: list[list] = []  # [ticks left, request]

        def submit(more):
            queue.extend(more)

        while queue or live:
            while queue and len(live) < self.slots:
                req = queue.pop(0)
                self.streamed.append(req.request_id)
                self.events.append(("admit", req.request_id))
                live.append([1 + digest(req.prompt) % 5, req])
            for item in live:
                item[0] -= 1
            finished = [req for left, req in live if left <= 0]
            live = [item for item in live if item[0] > 0]
            for req in finished:
                self.events.append(("finish", req.request_id))
                res = self._result(req)
                out.append(res)
                on_result(res, submit)
        return out

    def cancel(self, request_id):
        self.cancelled.add(request_id)

    def engine_metrics(self):
        return {}

    def shutdown(self):
        pass


def requests(api, n=5, **kw):
    return [api.GenerationRequest(prompt=f"prompt {i}", request_id=i, **kw)
            for i in range(n)]


def view(results):
    return [(r.request_id, r.text, r.finish_reason, r.error) for r in results]


# ------------------------------------------------------------ batch path

def _case(name):
    """(engine kwargs, config kwargs, drive function) of a parity case; it
    gets (api, executor, engine) and returns what is compared."""
    def plain(api, ex, eng):
        return view(ex.run_requests(requests(api)))

    if name == "fail_once_then_succeed":
        return (dict(fail={("prompt 1", 1), ("prompt 3", 1)}),
                dict(retry_attempts=3), plain)
    if name == "fail_past_retry_attempts":
        return (dict(always_fail={"prompt 2"}, fail={("prompt 4", 1)}),
                dict(retry_attempts=3), plain)
    if name == "engine_exception_fails_the_batch":
        return dict(raise_calls={0}), dict(retry_attempts=2), plain
    if name == "engine_exception_past_retry_attempts":
        return dict(raise_calls={0, 1}), dict(retry_attempts=2), plain
    if name == "wave_cap_without_internal_scheduling":
        return (dict(internal=False, fail={("prompt 3", 1)}),
                dict(max_concurrent_requests=2, retry_attempts=3), plain)
    if name == "whole_queue_with_internal_scheduling":
        return dict(internal=True), dict(max_concurrent_requests=2), plain
    if name == "cancel_before_retry":
        # during the first call: request 1 (failing) and 4 are cancelled;
        # neither is retried
        def drive(api, ex, eng):
            eng.on_call = lambda n, reqs: (ex.cancel(1), ex.cancel(4)) if n == 0 else None
            return view(ex.run_requests(requests(api)))
        return dict(fail={("prompt 1", 1)}), dict(retry_attempts=3), drive
    if name == "deadline_expired_before_retry":
        # a failed request whose budget is gone finishes as "deadline"
        # and keeps its failure; the other failure is retried
        def drive(api, ex, eng):
            reqs = requests(api, deadline_s=time.time() + 3600)

            def expire(n, _reqs):
                if n == 0:
                    reqs[2].deadline_s = time.time() - 1.0
            eng.on_call = expire
            return view(ex.run_requests(reqs))
        return (dict(fail={("prompt 2", 1), ("prompt 0", 1)}),
                dict(retry_attempts=3), drive)
    if name == "deadline_clips_the_backoff":
        # retry_delay 30 s, budget 0.3 s: the backoff sleeps the budget,
        # then the request finishes as "deadline" with its error
        def drive(api, ex, eng):
            reqs = requests(api, n=2)
            reqs[0].deadline_s = time.time() + 0.3
            t0 = time.time()
            out = view(ex.run_requests(reqs))
            assert time.time() - t0 < 5.0
            return out
        return (dict(always_fail={"prompt 0"}, fail={("prompt 1", 1)}),
                dict(retry_attempts=3, retry_delay=30.0), drive)
    if name == "config_deadline_stamped":
        def drive(api, ex, eng):
            reqs = requests(api, n=3)
            out = view(ex.run_requests(reqs))
            assert all(r.deadline_s is not None for r in reqs)
            return out
        return dict(), dict(request_deadline_s=600.0), drive
    if name == "runs_take_new_epochs":
        def drive(api, ex, eng):
            return [view(ex.run_requests(requests(api, n=2))) for _ in range(3)]
        return dict(fail={("prompt 1", 2)}), dict(retry_attempts=3), drive
    raise KeyError(name)


BATCH_CASES = ["fail_once_then_succeed", "fail_past_retry_attempts",
               "engine_exception_fails_the_batch",
               "engine_exception_past_retry_attempts",
               "wave_cap_without_internal_scheduling",
               "whole_queue_with_internal_scheduling", "cancel_before_retry",
               "deadline_expired_before_retry", "deadline_clips_the_backoff",
               "config_deadline_stamped", "runs_take_new_epochs"]


def _run(pkg, eng_kw, cfg_kw, drive):
    api, ex_cls, cfg_cls = PACKAGES[pkg]
    cfg = cfg_cls(**{"retry_delay": 0.0, **cfg_kw})
    eng = ScriptedEngine(api, **eng_kw)
    ex = ex_cls(eng, cfg)
    out = drive(api, ex, eng)
    # ids less the epoch base of the run they were sent in (1 << 20 a run)
    calls = [[len(c)] + [i - (c[0] >> 20 << 20) if c else i for i in c]
             for c in eng.calls]
    return out, calls, ex.stats()


@pytest.mark.parametrize("case", BATCH_CASES)
def test_batch_path_matches_reference(case):
    eng_kw, cfg_kw, drive = _case(case)
    ref = _run("ref", eng_kw, cfg_kw, drive)
    port = _run("port", eng_kw, cfg_kw, drive)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]


def test_batch_outcomes_follow_the_reference_rules():
    """What the parity cases hold, read off the port alone."""
    eng_kw, cfg_kw, drive = _case("fail_past_retry_attempts")
    out, calls, stats = _run("port", eng_kw, cfg_kw, drive)
    by_id = {r[0]: r for r in out}
    assert by_id[2][2] == "error" and by_id[2][3].startswith("failed after 3 attempts")
    assert by_id[4][3] is None and stats["failed_requests"] == 1
    assert [c[0] for c in calls] == [5, 2, 1]
    out, calls, _ = _run("port", *_case("cancel_before_retry"))
    by_id = {r[0]: r for r in out}
    assert by_id[1][2] == "cancelled" and by_id[1][1] == ""
    # the engine saw the cancel inside the call and cut request 4 short
    assert by_id[4][2] == "cancelled" and by_id[4][3] is None
    assert len(calls) == 1  # nothing retried
    out, calls, _ = _run("port", *_case("wave_cap_without_internal_scheduling"))
    assert [c[0] for c in calls] == [2, 2, 1, 1]
    out, _, stats = _run("port", *_case("deadline_expired_before_retry"))
    by_id = {r[0]: r for r in out}
    assert by_id[2][2] == "deadline" and by_id[2][3] == "scripted fault 1"
    assert by_id[0][3] is None


@pytest.mark.parametrize("bad_id", [1 << 19, -1])
def test_request_id_out_of_range_is_refused(bad_id):
    for pkg in PACKAGES:
        api, ex_cls, cfg_cls = PACKAGES[pkg]
        ex = ex_cls(ScriptedEngine(api), cfg_cls(retry_delay=0.0))
        bad = [api.GenerationRequest(prompt="x", request_id=bad_id)]
        with pytest.raises(ValueError, match="request_ids must be in"):
            ex.run_requests(bad)
        with pytest.raises(ValueError, match="request_ids must be in"):
            ex.run_requests_streaming(bad, lambda res, submit: None)
    # the port's refused stream leaves no run live, so a later cancel is a
    # no-op (the reference registers before its try and leaves the flag up)
    ex.cancel(0)
    assert not ex._cancelled


def test_cancel_without_a_run_is_a_noop():
    for pkg in PACKAGES:
        api, ex_cls, cfg_cls = PACKAGES[pkg]
        eng = ScriptedEngine(api)
        ex = ex_cls(eng, cfg_cls(retry_delay=0.0))
        ex.cancel(3)
        assert not eng.cancelled
        out = ex.run_requests(requests(api, n=4))
        assert all(r.finish_reason == "stop" for r in out)


# -------------------------------------------------------- streaming path

def _stream_case(name):
    def drive(api, ex, eng):
        finals = []

        def on_final(res, submit):
            finals.append((res.request_id, res.text, res.finish_reason,
                           res.error))
            if res.request_id == 0:  # follow-up work rides the same stream
                submit([api.GenerationRequest(prompt="follow-up",
                                              request_id=100)])
            if name == "cancel_live_clone" and res.request_id == 3:
                ex.cancel(1)
        ex.run_requests_streaming(requests(api, n=6), on_final)
        return finals

    if name == "retries_resubmit_into_the_stream":
        return dict(fail={("prompt 1", 1), ("prompt 4", 1), ("prompt 4", 2),
                          ("follow-up", 1)}), dict(retry_attempts=3), drive
    if name == "retry_exhaustion_degrades":
        return dict(always_fail={"prompt 2"}), dict(retry_attempts=2), drive
    if name == "cancel_live_clone":
        return (dict(fail={("prompt 1", 1), ("prompt 1", 2)}),
                dict(retry_attempts=4), drive)
    if name == "stream_exception_finals_every_request":
        return dict(raise_calls={0}), dict(retry_attempts=3), drive
    raise KeyError(name)


STREAM_CASES = ["retries_resubmit_into_the_stream",
                "retry_exhaustion_degrades", "cancel_live_clone",
                "stream_exception_finals_every_request"]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_streaming_path_matches_reference(case):
    eng_kw, cfg_kw, drive = _stream_case(case)
    outs = {}
    for pkg in PACKAGES:
        api, ex_cls, cfg_cls = PACKAGES[pkg]
        eng = ScriptedEngine(api, **eng_kw)
        ex = ex_cls(eng, cfg_cls(retry_delay=0.0, **cfg_kw))
        finals = drive(api, ex, eng)
        outs[pkg] = (finals, eng.streamed, sorted(eng.cancelled), ex.stats())
    assert outs["port"] == outs["ref"]
    finals, streamed, cancelled, stats = outs["port"]
    ids = [f[0] for f in finals]
    assert len(ids) == len(set(ids))  # one final per caller id
    if case == "retries_resubmit_into_the_stream":
        assert stats["failed_requests"] == 0
        # clones sit just below the epoch base and are delivered under
        # their caller id
        assert sorted(i for i in streamed if i < 0) == [-4, -3, -2, -1]
        assert sorted(ids) == [0, 1, 2, 3, 4, 5, 100]
    if case == "cancel_live_clone":
        assert dict((f[0], f[2]) for f in finals)[1] == "cancelled"
        assert cancelled  # the live clone was chased into the engine
