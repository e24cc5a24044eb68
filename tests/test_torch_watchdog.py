"""Faults and hangs on the port: the dispatch watchdog, tail hedging and
the supervisor, against the JAX package's where both have the piece.

* ``DispatchWatchdog`` against the JAX package's: the same beat schedule
  on a fake monotonic clock gives the same EMA, ``timeout_s`` and
  ``stalled_for``, build-grace windows included.
* The port's ``TorchEngine`` (f32, 2 layers, on the CPU): armed by
  default on a dispatch thread; a ``scheduler.heartbeat`` stall mid-decode
  gives bounded ``wedged`` results, a ``watchdog`` postmortem, a
  fail-fast engine and ``/healthz`` 503 ``wedged: true``, and the engine
  re-arms with a clean audit once the stall drains; expired deadlines come
  back ``deadline``; ``LMRS_WATCHDOG=0`` runs inline and token-identical;
  the executor's retry completes after a transient wedge; a kernel build
  inside a run opens the grace window; the dispatch thread runs without
  grad mode, and an error raised there reaches the caller unchanged.
* Tail hedging over mock servers: a straggler duplicated and the first
  result winning (the loser's server cancels it), the ``router.hedge``
  site abandoning a hedge, failover on a fast primary failure, backend
  error results kept off the breaker, hedging off by default, and
  ``_hedge_delay_s`` equal to the JAX router's for the same walls.
* ``lmrs-serve-torch --supervise`` over ``--backend mock`` children: a
  SIGKILLed child respawns and its job resumes to the uninterrupted
  summary; a child whose ``/healthz`` turns 503 wedged (a CPU engine
  stalled by a plan file) is SIGKILLed and respawned.
* The device-side stall (a ``torch.cuda._sleep`` kernel on the engine's
  stream) is a card test: ``tests/test_torch_cuda.py``.

Thresholds are tenths of seconds; every HTTP call and subprocess has a
timeout of 30 s or less.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest, GenerationResult
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.serving.router import RouterEngine
from lmrs_tpu_torch.serving.server import EngineHTTPServer
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.testing.faults import FaultPlan

from test_torch_faults import CHAOS_CFG, NoEosTokenizer

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 30.0
ENGINE_KW = dict(max_tokens=64, max_batch_slots=2, seed=0, decode_block=4,
                 page_size=16, num_pages=20)
QUIET = ("LMRS_COST_LEDGER", "LMRS_SLO", "LMRS_ANATOMY", "LMRS_QOS",
         "LMRS_KV_MIGRATE")


@pytest.fixture(autouse=True)
def quiet_surfaces(monkeypatch):
    for k in QUIET:
        monkeypatch.setenv(k, "0")
    monkeypatch.delenv("LMRS_WATCHDOG_S", raising=False)
    monkeypatch.delenv("LMRS_WATCHDOG", raising=False)
    faults.uninstall()
    yield
    faults.uninstall()


def _req(rid, prompt="hang survival probe alpha bravo", max_new=8,
         deadline_s=None):
    return GenerationRequest(prompt=prompt, request_id=rid, temperature=0.0,
                             max_new_tokens=max_new, deadline_s=deadline_s)


def _stall_plan(occ: int, stall_s: float) -> FaultPlan:
    return FaultPlan(faults=[{"site": "scheduler.heartbeat", "at": [occ],
                              "action": "stall", "stall_s": stall_s}])


def _engine() -> TorchEngine:
    return TorchEngine(EngineConfig(**ENGINE_KW),
                       TModelConfig(name="wd", **CHAOS_CFG), device="cpu",
                       tokenizer=NoEosTokenizer())


@pytest.fixture(scope="module")
def wd_engine():
    # built with the reference-only surfaces off (an SLO postmortem written
    # inside a step would stretch it past the tests' tenths-of-a-second
    # thresholds)
    with pytest.MonkeyPatch.context() as mp:
        for k in QUIET:
            mp.setenv(k, "0")
        eng = _engine()
    for rid in (990, 991):  # warm the step EMA
        eng.generate_batch([_req(rid, prompt="warmup wedge probe")])
    yield eng
    eng.shutdown()


# ------------------------------------------------------------ the watchdog

class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


SCHEDULE = (("start", 0), ("beat", 0.02), ("beat", 0.03), ("beat", 0.025),
            ("grace_cold", 0.001), ("peek", 5.0), ("grace_end", 0.5),
            ("beat", 0.1), ("beat", 0.04), ("grace_cold", 0), ("peek", 2.0),
            ("beat", 3.0), ("beat", 0.05), ("peek", 7.0), ("end", 0),
            ("peek", 1.0))


@pytest.mark.parametrize("explicit", [None, "0.4"])
def test_dispatch_watchdog_matches_reference(monkeypatch, explicit):
    """The same schedule of beats, build graces and idle peeks on a fake
    clock: EMA, threshold and stall reading agree at every step but one.
    At a grace's end the port counts the silence from the build's end
    (a build longer than the threshold must not read as a wedge before
    the next beat); the reference counts it from the last beat."""
    from lmrs_tpu.engine.watchdog import DispatchWatchdog as JWatchdog
    from lmrs_tpu_torch.engine.watchdog import DispatchWatchdog

    if explicit:
        monkeypatch.setenv("LMRS_WATCHDOG_S", explicit)
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    port, ref = DispatchWatchdog(), JWatchdog()
    seen = []
    for op, dt in SCHEDULE:
        clock.t += dt
        for wd in (port, ref):
            {"start": wd.run_started, "beat": wd.beat, "end": wd.run_ended,
             "grace_cold": wd.grace_cold, "grace_end": wd.grace_end,
             "peek": lambda: None}[op]()
        a = (port.ema_step_s, port.timeout_s(), port.stalled_for())
        b = (ref.ema_step_s, ref.timeout_s(), ref.stalled_for())
        if op == "grace_end":
            assert a[:2] == b[:2] and a[2] == 0.0 and b[2] > 5.0
        else:
            assert a == b, (op, a, b)
        seen.append(a)
    # the graced windows never folded into the EMA, the open grace read 0
    assert seen[5][2] == 0.0 and seen[10][2] == 0.0
    assert seen[-1][2] == 0.0  # no run live


def test_watchdog_armed_by_default(wd_engine):
    assert wd_engine._runner is not None
    assert wd_engine._scheduler.watchdog is not None
    assert wd_engine._scheduler.watchdog.ema_step_s is not None
    assert not wd_engine.wedged()
    names = {t.name for t in threading.enumerate()}
    assert "lmrs-dispatch" in names


def _get_healthz(port: int):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=5) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_wedge_mid_decode_bounded_wedged_results(wd_engine, monkeypatch,
                                                 tmp_path):
    """A stall mid-decode: within a bounded wall the wedge is declared
    (postmortem, ``wedged`` results with the error marked, fail-fast,
    ``/healthz`` 503 ``wedged: true``); when the stall ends the abandoned
    run returns, the engine re-arms and the audit is clean."""
    from lmrs_tpu_torch.obs import validate_postmortem_file
    from lmrs_tpu_torch.serving.supervisor import Supervisor

    monkeypatch.setenv("LMRS_WATCHDOG_S", "0.5")
    monkeypatch.setenv("LMRS_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("LMRS_POSTMORTEM_MIN_S", "0")
    sched = wd_engine._scheduler
    fires = sched.metrics["watchdog_fires"]
    srv = EngineHTTPServer(wd_engine, port=0, batch_window_s=0.01)
    srv.start_background()
    try:
        assert _get_healthz(srv.port)[0] == 200
        t0 = time.time()
        with faults.injected(_stall_plan(3, 2.5)):
            out = wd_engine.generate_batch([_req(0), _req(1)])
        wall = time.time() - t0
        assert wall < 2.0, f"wedge delivery not bounded: {wall:.2f}s"
        assert [r.finish_reason for r in out] == ["wedged", "wedged"]
        assert all(r.error and "wedged" in r.error for r in out)
        assert sched.metrics["watchdog_fires"] == fires + 1
        assert sched.metrics["wedged_requests"] >= 2
        assert wd_engine.wedged()
        status, doc = _get_healthz(srv.port)
        assert status == 503 and doc["wedged"] is True
        sup = Supervisor(["--backend", "mock"], host="127.0.0.1",
                         port=srv.port)
        assert sup._poll_health() == (False, True)
        t1 = time.time()
        ff = wd_engine.generate_batch([_req(2)])[0]
        assert ff.finish_reason == "wedged" and time.time() - t1 < 0.5
        dumps = sorted(tmp_path.glob("postmortem-watchdog-*.json"))
        assert dumps, "the wedge wrote no postmortem"
        doc = validate_postmortem_file(dumps[0])
        assert doc["reason"] == "watchdog"
        assert doc["extra"]["stalled_s"] >= 0.5
        # the small threshold only while the stall is watched: a loaded
        # host's step may outlast it
        monkeypatch.delenv("LMRS_WATCHDOG_S")
        assert wd_engine._runner.wait_idle(30.0)
        assert not wd_engine.wedged()
        assert _get_healthz(srv.port)[0] == 200
        good = wd_engine.generate_batch([_req(3)])[0]
        assert good.finish_reason == "length" and good.error is None
        assert wd_engine.audit() == []
    finally:
        srv.shutdown()


def test_wedged_run_expired_deadlines_deliver_deadline(wd_engine,
                                                       monkeypatch):
    monkeypatch.setenv("LMRS_WATCHDOG_S", "0.5")
    before = wd_engine._scheduler.metrics["deadline_exceeded"]
    with faults.injected(_stall_plan(1, 2.0)):
        out = wd_engine.generate_batch(
            [_req(10, deadline_s=time.time() + 0.3, max_new=32)])
    assert out[0].finish_reason == "deadline", out[0]
    assert out[0].error is None
    assert wd_engine._scheduler.metrics["deadline_exceeded"] == before + 1
    monkeypatch.delenv("LMRS_WATCHDOG_S")
    assert wd_engine._runner.wait_idle(30.0)
    assert wd_engine.audit() == []


def test_watchdog_off_is_inline_and_token_identical(wd_engine, monkeypatch):
    """``LMRS_WATCHDOG=0``: no runner, no watchdog, dispatch on the caller
    thread; a heartbeat stall just holds the run, whose text equals the
    armed engine's."""
    want = wd_engine.generate_batch([_req(20)])[0]
    monkeypatch.setenv("LMRS_WATCHDOG", "0")
    eng = _engine()
    try:
        assert eng._runner is None and eng._scheduler.watchdog is None
        seen = []
        real_run = eng._scheduler.run

        def run(*a, **kw):
            seen.append(threading.current_thread() is threading.main_thread())
            return real_run(*a, **kw)

        eng._scheduler.run = run
        t0 = time.time()
        with faults.injected(_stall_plan(1, 0.5)):
            got = eng.generate_batch([_req(20)])[0]
        assert time.time() - t0 >= 0.5 and seen == [True]
        assert (got.text, got.finish_reason) == (want.text, want.finish_reason)
        assert eng._scheduler.metrics["watchdog_fires"] == 0
        assert eng.audit() == [] and not eng.wedged()
    finally:
        eng.shutdown()


def test_executor_retry_completes_after_transient_wedge(wd_engine,
                                                        monkeypatch):
    """A transient stall wedges the run; the executor's retries (one
    threshold-bounded call, so the threshold leaves room for a loaded
    host's steps) complete with the fault-free texts."""
    reqs = lambda: [_req(i, prompt=f"retry after wedge {i}")  # noqa: E731
                    for i in range(3)]
    ex = MapExecutor(wd_engine, EngineConfig(retry_attempts=6,
                                             retry_delay=1.0))
    baseline = [(r.request_id, r.text) for r in ex.run_requests(reqs())]
    monkeypatch.setenv("LMRS_WATCHDOG_S", "1.5")
    fires = wd_engine._scheduler.metrics["watchdog_fires"]
    t0 = time.time()
    with faults.injected(_stall_plan(2, 3.0)):
        out = ex.run_requests(reqs())
    assert time.time() - t0 < 15.0
    assert wd_engine._scheduler.metrics["watchdog_fires"] > fires
    assert [(r.request_id, r.text) for r in out] == baseline
    assert all(r.error is None for r in out)
    assert wd_engine._runner.wait_idle(30.0)
    assert wd_engine.audit() == []


def test_kernel_build_opens_the_grace_window(wd_engine, monkeypatch):
    """A kernel built at first use inside a run (a monkeypatched 2.5 s
    build, ``ops/kernels.load`` on the dispatch thread) runs in the grace
    window: no wedge at a 1.5 s threshold, and the window closes with the
    build."""
    from lmrs_tpu_torch.engine import scheduler as sched_mod
    from lmrs_tpu_torch.ops import kernels

    monkeypatch.setenv("LMRS_WATCHDOG_S", "1.5")
    wd = wd_engine._scheduler.watchdog
    during = []

    def slow_build(names):
        time.sleep(2.5)
        during.append(wd.stalled_for())
        return {}

    monkeypatch.setattr(kernels, "_lib_path",
                        lambda name: REPO / "build" / "no-such-lib.so")
    monkeypatch.setattr(kernels, "build_all", slow_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: object())
    real_forward = sched_mod.forward_paged
    calls = []

    def forward(*a, **kw):
        if not calls:
            kernels._loaded.pop("grace-probe", None)
            kernels.load("grace-probe")
        calls.append(1)
        return real_forward(*a, **kw)

    monkeypatch.setattr(sched_mod, "forward_paged", forward)
    fires = wd_engine._scheduler.metrics["watchdog_fires"]
    try:
        out = wd_engine.generate_batch([_req(30)])
    finally:
        kernels._loaded.pop("grace-probe", None)
    assert out[0].finish_reason == "length" and out[0].error is None
    assert during == [0.0]
    assert wd_engine._scheduler.metrics["watchdog_fires"] == fires
    assert wd._grace_until == 0.0  # closed by grace_end / the next beat
    # outside a run no watchdog is named on the thread: no grace
    assert getattr(kernels._build_watch, "wd", None) is None


def test_dispatch_thread_state_and_errors(wd_engine, monkeypatch):
    """The dispatch thread runs without grad mode (trained leaf tensors
    record no graph); an exception raised there reaches the caller as the
    same type, and the engine keeps serving."""
    from lmrs_tpu_torch.engine import scheduler as sched_mod

    class KernelError(RuntimeError):
        pass

    real_forward = sched_mod.forward_paged
    seen = []

    def forward(*a, **kw):
        seen.append((threading.current_thread().name,
                     torch.is_grad_enabled()))
        return real_forward(*a, **kw)

    monkeypatch.setattr(sched_mod, "forward_paged", forward)
    assert torch.is_grad_enabled()
    wd_engine.generate_batch([_req(40)])
    assert seen and all(s == ("lmrs-dispatch", False) for s in seen)

    def broken(*a, **kw):
        raise KernelError("launch failed (test)")

    monkeypatch.setattr(sched_mod, "forward_paged", broken)
    with pytest.raises(KernelError, match="launch failed"):
        wd_engine.generate_batch([_req(41)])
    monkeypatch.setattr(sched_mod, "forward_paged", real_forward)
    assert wd_engine.generate_batch([_req(42)])[0].error is None
    assert wd_engine.audit() == [] and not wd_engine.wedged()


def test_shutdown_engine_is_reusable():
    eng = _engine()
    want = eng.generate_batch([_req(50)])[0].text
    eng.shutdown()
    assert eng.generate_batch([_req(50)])[0].text == want
    eng.shutdown()


# --------------------------------------------------------- tail hedging

def _mock_server(latency_s=0.0, engine=None):
    srv = EngineHTTPServer(engine or MockEngine(latency_s=latency_s), port=0,
                           batch_window_s=0.01)
    srv.start_background()
    return srv


class CancelCounting(MockEngine):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.cancels = []

    def cancel(self, request_id):
        self.cancels.append(request_id)
        super().cancel(request_id)


def test_hedge_duplicates_straggler_first_result_wins(monkeypatch):
    """The primary straggles, the hedge leg on the fast sibling wins with
    the same text, the loser's server cancels its copy, the counters
    advance."""
    slow = _mock_server(engine=CancelCounting(latency_s=1.0))
    fast = _mock_server()
    router = RouterEngine([f"127.0.0.1:{slow.port}",
                           f"127.0.0.1:{fast.port}"], timeout_s=TIMEOUT)
    try:
        monkeypatch.setenv("LMRS_HEDGE_MS", "100")
        req = _req(0, prompt="hedge race alpha bravo charlie")
        t0 = time.time()
        res = router.generate_batch([req])[0]
        wall = time.time() - t0
        assert res.error is None and res.finish_reason == "stop"
        assert wall < 0.9, f"the hedge did not beat the straggler: {wall:.2f}s"
        assert res.text == MockEngine().generate_batch([req])[0].text
        assert router.engine_metrics()["hedge"] == {"hedges": 1, "wins": 1}
        prom = router.prometheus_metrics()
        assert "lmrs_router_hedges_total" in prom
        assert "lmrs_router_hedge_wins_total" in prom
        usage = router.usage_report()["router"]
        assert (usage["hedges"], usage["hedge_wins"]) == (1, 1)
        deadline = time.time() + 5
        while time.time() < deadline and not slow.engine.cancels:
            time.sleep(0.05)
        assert slow.engine.cancels, "the loser was not cancelled"
        # a streamed request never hedges
        got = router.generate_batch([_req(1, prompt="stream no hedge")],
                                    on_tokens=lambda rid, d: None)[0]
        assert got.error is None and router._hedges == 1
    finally:
        router.shutdown()
        slow.shutdown()
        fast.shutdown()


def test_hedge_fault_site_abandons_hedge(monkeypatch):
    slow = _mock_server(latency_s=0.4)
    fast = _mock_server()
    router = RouterEngine([f"127.0.0.1:{slow.port}",
                           f"127.0.0.1:{fast.port}"], timeout_s=TIMEOUT)
    try:
        monkeypatch.setenv("LMRS_HEDGE_MS", "100")
        with faults.injected(FaultPlan(faults=[
                {"site": "router.hedge", "at": [1], "max_fires": 1}])) as inj:
            res = router.generate_batch([_req(0)])[0]
        assert inj.fires == [("router.hedge", 1)]
        assert res.error is None
        assert router._hedges == 0 and router._hedge_wins == 0
    finally:
        router.shutdown()
        slow.shutdown()
        fast.shutdown()


def test_hedge_keeps_failover_on_fast_primary_failure(monkeypatch):
    import socket

    good = _mock_server()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    router = RouterEngine([f"127.0.0.1:{dead}", f"127.0.0.1:{good.port}"],
                          timeout_s=TIMEOUT)
    try:
        monkeypatch.setenv("LMRS_HEDGE_MS", "500")
        res = router.generate_batch([_req(0, prompt="failover")])[0]
        assert res.error is None and res.finish_reason == "stop"
        assert router._hedges == 0 and router._hedge_wins == 0
        assert not router.hosts[0].healthy
    finally:
        router.shutdown()
        good.shutdown()


def test_hedge_error_results_do_not_feed_breaker(monkeypatch):
    monkeypatch.setenv("LMRS_BREAKER_FAILURES", "2")
    monkeypatch.setenv("LMRS_HEDGE_MS", "50")
    srvs = [_mock_server(engine=MockEngine(fail_pattern="boomtrigger"))
            for _ in range(2)]
    router = RouterEngine([f"127.0.0.1:{s.port}" for s in srvs],
                          timeout_s=TIMEOUT)
    try:
        for i in range(3):
            res = router.generate_batch([_req(i, prompt="boomtrigger")])[0]
            assert res.finish_reason == "error"
        for h in router.hosts:
            assert h.breaker_state == "closed" and h.healthy, h.netloc
    finally:
        router.shutdown()
        for s in srvs:
            s.shutdown()


def test_hedge_off_by_default(monkeypatch):
    monkeypatch.delenv("LMRS_HEDGE_MS", raising=False)
    srvs = [_mock_server(latency_s=0.2), _mock_server()]
    router = RouterEngine([f"127.0.0.1:{s.port}" for s in srvs],
                          timeout_s=TIMEOUT)
    try:
        assert router.generate_batch([_req(0)])[0].error is None
        assert router.engine_metrics()["hedge"] == {"hedges": 0, "wins": 0}
    finally:
        router.shutdown()
        for s in srvs:
            s.shutdown()


def test_hedge_delay_matches_reference():
    from lmrs_tpu.serving.router import RouterEngine as JRouter

    port = RouterEngine(["127.0.0.1:1", "127.0.0.1:2"])
    ref = JRouter(["127.0.0.1:1", "127.0.0.1:2"])
    try:
        rng = random.Random(5)
        total = 0
        for n in (0, 5, 19, 20, 21, 100, 600):  # the pool keeps 512
            while total < n:
                dt = rng.expovariate(4.0)
                port._note_latency(dt)
                ref._note_latency(dt)
                total += 1
            for ms in (0.0, 50.0, 250.0, 4000.0):
                assert port._hedge_delay_s(ms) == ref._hedge_delay_s(ms)
    finally:
        port.shutdown()
        ref.shutdown()


# ------------------------------------------------------- the supervisor

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method, url, body=None, timeout=10.0):
    req = urllib.request.Request(
        url, method=method, headers={"Content-Type": "application/json"},
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


def _supervise(args, env_extra, log):
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "LMRS_SUPERVISE_POLL_S": "0.2", "LMRS_SUPERVISE_BACKOFF_S": "0.1",
           **env_extra}
    return subprocess.Popen(
        [sys.executable, "-m", "lmrs_tpu_torch.serving.cli", "--supervise",
         *args, "-q"], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=log)


def _wait(pred, what, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return
        except (OSError, ValueError):
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _healthy(base):
    try:
        return _http("GET", f"{base}/healthz", timeout=2)[0] == 200
    except urllib.error.HTTPError:
        return False


def _stop(sup, pidfile):
    """SIGTERM the supervisor (it forwards to its child and exits 0); a
    supervisor that does not stop is killed with the child in the
    pidfile."""
    sup.send_signal(signal.SIGTERM)
    try:
        assert sup.wait(timeout=TIMEOUT) == 0
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(timeout=TIMEOUT)
            try:
                child = int(pidfile.read_text() or 0)
                if child > 0:
                    os.kill(child, signal.SIGKILL)
            except (OSError, ValueError):
                pass


def test_supervised_sigkill_respawn_resumes_job(tmp_path):
    """SIGKILL the child named in the pidfile mid-job: the supervisor
    respawns it, the job resumes from its journal (journaled chunks not
    re-mapped) to the uninterrupted summary, and SIGTERM stops the
    supervisor cleanly."""
    from lmrs_tpu_torch.config import EngineConfig as ECfg
    from lmrs_tpu_torch.config import PipelineConfig
    from lmrs_tpu_torch.engine.api import make_engine
    from lmrs_tpu_torch.jobs import journal as tj
    from lmrs_tpu_torch.jobs.manager import JobManager

    from test_torch_jobs import job_transcript

    body = {"transcript": job_transcript(n=120),
            "params": {"max_tokens_per_chunk": 400}}
    jobs_dir, pidfile = tmp_path / "jobs", tmp_path / "child.pid"
    # the first child's journal appends are paced (a wide kill window);
    # the respawned child reads the emptied plan
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "journal.append", "every": 1, "action": "stall",
         "stall_s": 0.3}]}))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "sup.log", "wb")
    sup = _supervise(
        ["--backend", "mock", "--port", str(port), "--jobs-dir",
         str(jobs_dir)],
        {"LMRS_SUPERVISE_PIDFILE": str(pidfile),
         "LMRS_FAULT_PLAN": f"@{plan}"}, log)
    try:
        _wait(lambda: _healthy(base) and pidfile.exists(), "the child")
        pid1 = int(pidfile.read_text())
        _status, doc = _http("POST", f"{base}/v1/jobs", body)
        jid = doc["id"]
        wal = jobs_dir / f"{jid}.wal"
        _wait(lambda: sum(r["type"] == "chunk_done"
                          for r in tj.replay(wal)[0]) >= 2, "2 chunks")
        plan.write_text('{"faults": []}')
        os.kill(pid1, signal.SIGKILL)
        _wait(lambda: int(pidfile.read_text() or 0) not in (0, pid1),
              "the respawn")
        # read before the successor (unpaced) can resume the job
        state = tj.rebuild_state(tj.replay(wal)[0])
        assert state["done"] is None, "the kill landed after completion"
        _wait(lambda: _healthy(base), "the respawned child")
        _wait(lambda: _http("GET", f"{base}/v1/jobs/{jid}")[1]["status"]
              in ("done", "failed"), "the resumed job", timeout=60)
        final = _http("GET", f"{base}/v1/jobs/{jid}")[1]
    finally:
        _stop(sup, pidfile)
        log.close()
    assert not pidfile.exists()
    assert final["status"] == "done" and final["recovered"] is True
    assert final["progress"]["num_resumed_chunks"] >= 2
    cfg = PipelineConfig(engine=ECfg(backend="mock", max_tokens=4096))
    jm = JobManager(make_engine(cfg.engine), tmp_path / "clean", config=cfg,
                    start_worker=False)
    clean = jm.submit(body["transcript"], body["params"])
    jm.run_job(clean)
    jm.shutdown()
    assert final["result"]["summary"] == clean.result["summary"]


def test_supervisor_kills_a_wedged_child(tmp_path):
    """A CPU-engine child whose ``scheduler.heartbeat`` a plan file stalls
    past its watchdog threshold answers ``/healthz`` 503 wedged; the
    supervisor SIGKILLs and respawns it, and the respawned child (the plan
    file emptied) serves."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "scheduler.heartbeat", "at": [2], "action": "stall",
         "stall_s": 30.0}]}))
    pidfile = tmp_path / "child.pid"
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "sup.log", "wb")
    sup = _supervise(
        ["--device", "cpu", "--model", "bench-smoke", "--tokenizer", "byte",
         "--port", str(port), "--batch-slots", "2"],
        {"LMRS_SUPERVISE_PIDFILE": str(pidfile), "LMRS_WATCHDOG_S": "3",
         "LMRS_FAULT_PLAN": f"@{plan}"}, log)
    try:
        _wait(lambda: _healthy(base) and pidfile.exists(), "the child",
              timeout=60)
        pid1 = int(pidfile.read_text())

        def post():
            try:
                _http("POST", f"{base}/v1/chat/completions",
                      {"messages": [{"role": "user", "content": "wedge me"}],
                       "max_tokens": 16}, timeout=20)
            except (OSError, urllib.error.HTTPError):
                pass  # the child dies under the request

        threading.Thread(target=post, daemon=True).start()
        _wait(lambda: int(pidfile.read_text() or 0) not in (0, pid1),
              "the kill and respawn", timeout=60)
        # the respawned child reads an empty (disarmed) plan
        plan.write_text('{"faults": []}')
        _wait(lambda: _healthy(base), "the respawned child", timeout=60)
        status, doc = _http("POST", f"{base}/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "hi"}],
                             "max_tokens": 4}, timeout=20)
        assert status == 200 and doc["choices"][0]["finish_reason"]
    finally:
        _stop(sup, pidfile)
        log.close()
    err = (tmp_path / "sup.log").read_text()
    assert "engine wedged (watchdog-degraded)" in err, err[-2000:]
