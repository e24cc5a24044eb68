"""Port parity of the router: the port's ``RouterEngine`` over two port
servers (mock engines) against the reference's over two reference servers,
bound to the same two ports in turn, so round-robin and rendezvous
placement see the same host names.  Results and per-request host placement
must agree exactly, for a cold wave (rendezvous) and a warm one (placed on
the published radix summaries).  Also: a dead host that degrades and
recovers through a paced probe (fake clock), the circuit breaker, cancel
across the process boundary, both cross-package pairings (the port's router
over the reference's servers and the reverse), ``TranscriptSummarizer``
with ``backend="http"`` against ``backend="mock"`` in process, one
``lmrs-torch --backend http --hosts`` run, and every refused flag, route
and switch naming its slice.

Every HTTP call has a timeout of 10 s or less, every thread join one,
servers bind ``127.0.0.1`` and shut down in teardown."""

import dataclasses
import json
import socket
import threading
import time

import pytest

from lmrs_tpu.engine.api import GenerationRequest as JRequest
from lmrs_tpu.engine.mock import MockEngine as JMock
from lmrs_tpu.serving.router import RouterEngine as JRouter
from lmrs_tpu.serving.server import EngineHTTPServer as JServer
from lmrs_tpu_torch import pipeline as tpipe
from lmrs_tpu_torch.config import ChunkConfig, EngineConfig, PipelineConfig
from lmrs_tpu_torch.config import ReduceConfig
from lmrs_tpu_torch.engine.api import GenerationRequest, make_engine
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.serving.router import RouterEngine
from lmrs_tpu_torch.serving.server import EngineHTTPServer
from lmrs_tpu_torch.utils.demo import load_demo_transcript

from conftest import free_port

REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0",
           "LMRS_QOS": "0", "LMRS_KV_MIGRATE": "0"}
TIMEOUT = 10.0
FIELDS = ("request_id", "text", "prompt_tokens", "completion_tokens",
          "finish_reason", "error")
BODY = ("Transcript section: [00:01] The committee opened with the budget "
        "review for the coming year. [00:05] Several members raised the "
        "question of maintenance costs for the old building.")


@pytest.fixture(autouse=True)
def ref_surfaces_off(monkeypatch):
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)


class Fleet:
    """Servers of one package over mock engines; shut down together."""

    def __init__(self, pkg: str, ports=(0, 0), **mock_kw):
        self.servers = []
        for port in ports:
            if pkg == "port":
                srv = EngineHTTPServer(MockEngine(**mock_kw), port=port,
                                       batch_window_s=0.01)
            else:
                srv = JServer(JMock(cost_ledger=False,
                                    slo=False, qos=False, **mock_kw),
                              port=port, batch_window_s=0.01)
            srv.start_background()
            self.servers.append(srv)
        self.hosts = [f"127.0.0.1:{s.port}" for s in self.servers]

    def close(self):
        threads = [threading.Thread(target=s.shutdown) for s in self.servers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)


def make_router(pkg: str, hosts, **kw):
    return (RouterEngine if pkg == "port" else JRouter)(
        list(hosts), timeout_s=TIMEOUT, **kw)


def request(pkg: str, **kw):
    return (GenerationRequest if pkg == "port" else JRequest)(**kw)


def wave_requests(pkg: str, base: int) -> list:
    """A wave with shared preambles: two groups of map-like requests (a
    system prompt and a ``cache_prefix`` head) and two loners."""
    out = []
    for i in range(10):
        pre = ("Summarize the section below.\n" if i % 2 else
               "List the decisions in the section below.\n")
        out.append(request(pkg, prompt=f"{pre}{i}: {BODY}",
                           request_id=base + i, system_prompt="sys",
                           cache_prefix=len(pre), temperature=0.0,
                           stop=("members",) if i == 3 else ()))
    out += [request(pkg, prompt=f"loner {i} {BODY}", request_id=base + 10 + i)
            for i in range(2)]
    return out


def record_placement(router) -> list:
    """Wrap the router's ``_post`` to log (request id, host) per attempt."""
    log, inner = [], router._post

    def post(host, req, *a, **kw):
        log.append((req.request_id, host.netloc))
        return inner(host, req, *a, **kw)

    router._post = post
    return log


def fields(results) -> list[dict]:
    return [{f: getattr(r, f) for f in FIELDS} for r in results]


def run_fleet(router_pkg: str, server_pkg: str, ports) -> dict:
    """A cold wave, a summary refresh, a warm wave; what came back and
    where each request went."""
    fleet = Fleet(server_pkg, ports)
    router = make_router(router_pkg, fleet.hosts)
    log = record_placement(router)
    try:
        cold = router.generate_batch(wave_requests(router_pkg, 0))
        for h in router.hosts:  # the refresh, synchronously
            router._fetch_summary(h)
        warm = router.generate_batch(wave_requests(router_pkg, 100))
        metrics = router.engine_metrics()
    finally:
        router.shutdown()
        fleet.close()
    return {"results": fields(cold) + fields(warm),
            "placement": sorted(log),
            "served": [h.served for h in router.hosts],
            "prefix_route": {k: v for k, v in metrics["prefix_route"].items()
                             if k != "summary_age_s"}}


def test_router_results_and_placement_match_reference():
    ports = (free_port(), free_port())
    port = run_fleet("port", "port", ports)
    ref = run_fleet("ref", "ref", ports)
    assert port == ref
    assert all(r["error"] is None for r in port["results"])
    assert port["prefix_route"]["predicted"] > 0  # the warm wave
    assert min(port["served"]) > 0


@pytest.mark.parametrize("router_pkg,server_pkg", [("port", "ref"),
                                                   ("ref", "port")])
def test_cross_package_pairings_give_the_same_results(router_pkg, server_pkg):
    ports = (free_port(), free_port())
    crossed = run_fleet(router_pkg, server_pkg, ports)
    same = run_fleet("port", "port", ports)
    assert crossed["results"] == same["results"]
    assert crossed["placement"] == same["placement"]


@pytest.mark.parametrize("router_pkg,server_pkg", [("port", "port"),
                                                   ("port", "ref"),
                                                   ("ref", "port")])
def test_streamed_deltas_cross_the_wire(router_pkg, server_pkg):
    fleet = Fleet(server_pkg)
    router = make_router(router_pkg, fleet.hosts)
    try:
        deltas = {}
        res = router.generate_batch(
            wave_requests(router_pkg, 0)[:4],
            on_tokens=lambda rid, d: deltas.setdefault(rid, []).append(d))
    finally:
        router.shutdown()
        fleet.close()
    assert all(r.error is None for r in res)
    assert {r.request_id: r.text for r in res} == {
        rid: "".join(d) for rid, d in deltas.items()}


def test_probe_pacing_with_fake_clock():
    """A dead host draws at most one probe per ``probe_floor_s`` plus
    jitter, on an injectable clock (the reference's test, ported)."""
    clock = [100.0]
    router = RouterEngine(["127.0.0.1:1", "127.0.0.1:2"], probe_floor_s=5.0,
                          probe_jitter_s=2.0, clock=lambda: clock[0])
    try:
        for h in router.hosts:
            h.healthy = False
            h.probe = lambda: False  # stays dead; no network touched
        assert len(router._launch_probes()) == 2
        for _ in range(50):
            assert router._launch_probes() == []
        clock[0] += 4.99
        assert router._launch_probes() == []
        clock[0] += 5.0 + 2.0
        assert len(router._launch_probes()) == 2
        assert router._launch_probes() == []
        router.hosts[0].healthy = True
        clock[0] += 100.0
        assert router._launch_probes() == [router.hosts[1]]
    finally:
        router.shutdown()


def wait_for(pred, timeout=TIMEOUT) -> bool:
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def test_dead_host_degrades_and_recovers_through_a_probe():
    """A request placed on a dead host fails over to the live one and the
    dead host is marked unhealthy; once a server listens there and the
    fake clock passes the probe floor, the next wave's probe re-admits it
    and it serves again."""
    clock = [0.0]
    live = Fleet("port")
    dead_port = free_port()
    router = RouterEngine([live.hosts[0], f"127.0.0.1:{dead_port}"],
                          timeout_s=TIMEOUT, probe_floor_s=5.0,
                          probe_jitter_s=0.0, clock=lambda: clock[0],
                          prefix_route=False)
    revived = None
    try:
        res = router.generate_batch([GenerationRequest(
            prompt=f"{i} {BODY}", request_id=i) for i in range(4)])
        assert all(r.error is None for r in res)
        assert [h.healthy for h in router.hosts] == [True, False]
        assert router.hosts[0].served == 4 and router.hosts[1].failed >= 1
        em = router.engine_metrics()
        assert em["healthy_hosts"] == 1
        assert em["per_host"][1].get("metrics_unreachable")
        # the first probe goes out (and fails) with the next wave
        clock[0] += 0.5
        router.generate_batch([GenerationRequest(prompt="w", request_id=8)])
        assert router.hosts[1].next_probe_t == 5.5
        time.sleep(0.3)  # a refused connect returns at once
        revived = Fleet("port", (dead_port,))
        clock[0] += 1.0  # inside the probe floor: no probe
        router.generate_batch([GenerationRequest(prompt="x", request_id=9)])
        assert not router.hosts[1].healthy
        clock[0] += 10.0
        router.generate_batch([GenerationRequest(prompt="y", request_id=10)])
        assert wait_for(lambda: router.hosts[1].healthy)
        res = router.generate_batch([GenerationRequest(
            prompt=f"{i} {BODY}", request_id=20 + i) for i in range(4)])
        assert all(r.error is None for r in res)
        assert router.hosts[1].served > 0
    finally:
        router.shutdown()
        live.close()
        if revived is not None:
            revived.close()


def test_breaker_opens_and_the_canary_closes_it(monkeypatch):
    """Three consecutive failures open a host's breaker (it leaves the
    dispatch order though it still answers); after the cooldown the
    canary's one-token generation closes it, as in the reference."""
    from lmrs_tpu.serving.router import _Host as JHost
    from lmrs_tpu_torch.serving.router import _Host

    monkeypatch.setenv("LMRS_BREAKER_COOLDOWN_S", "5")
    fleet = Fleet("port")
    try:
        states = []
        for cls in (_Host, JHost):
            clock = [0.0]
            h = cls(fleet.hosts[0], clock=lambda: clock[0])
            seq = []
            for _ in range(3):
                h.note_failed()
                seq.append((h.breaker_state, h.healthy))
            seq.append(h.breaker_due())
            clock[0] += 5.0
            seq.append(h.breaker_due())
            seq.append(h.canary(timeout=TIMEOUT))
            seq.append((h.breaker_state, h.healthy, h.breaker_opens, h.failed))
            states.append(seq)
        assert states[0] == states[1]
        assert states[0][2] == ("open", False) and states[0][-1][:2] == (
            "closed", True)
    finally:
        fleet.close()


@pytest.mark.parametrize("stream", [False, True])
def test_cancel_crosses_the_process_boundary(stream):
    """``cancel(rid)`` hangs up the request's connection; the server's
    disconnect detection cancels it in its engine (the mock takes 1 s)."""
    fleet = Fleet("port", (0,), latency_s=1.0)
    engine = fleet.servers[0].engine
    log, inner = [], engine.cancel
    engine.cancel = lambda rid: (log.append(rid), inner(rid))
    router = RouterEngine(fleet.hosts, timeout_s=TIMEOUT)
    out = []
    kw = {"on_tokens": lambda rid, d: None} if stream else {}
    t = threading.Thread(target=lambda: out.extend(router.generate_batch(
        [GenerationRequest(prompt=BODY, request_id=7)], **kw)))
    try:
        t.start()
        # connected: the in-flight entry is the raw socket (hangup target)
        assert wait_for(lambda: isinstance(router._inflight.get(7),
                                           socket.socket))
        time.sleep(0.1)
        router.cancel(7)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert out[0].finish_reason == "cancelled"
        assert wait_for(lambda: log == [0])  # the server's own rid
        router.cancel(12345)  # unknown ids are a no-op
    finally:
        router.shutdown()
        fleet.close()


def test_prometheus_fleet_page():
    fleet = Fleet("port")
    router = RouterEngine(fleet.hosts + ["127.0.0.1:1"], timeout_s=TIMEOUT)
    try:
        router.generate_batch([GenerationRequest(prompt=f"{i} {BODY}",
                                                 request_id=i)
                               for i in range(6)])
        page = router.prometheus_metrics()
    finally:
        router.shutdown()
        fleet.close()
    types = [ln.split()[2] for ln in page.splitlines()
             if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))
    for host in fleet.hosts:
        assert f'lmrs_http_requests_total{{host="{host}"}}' in page
        assert f'lmrs_router_host_up{{host="{host}"}} 1' in page
    assert 'lmrs_router_host_up{host="127.0.0.1:1"} 0' in page
    assert 'lmrs_router_pool_size{pool="both"} 3' in page


# -------------------------------------------------- the pipeline over http

def pipeline_cfg(**engine_kw) -> PipelineConfig:
    return PipelineConfig(
        chunk=ChunkConfig(max_tokens_per_chunk=300, overlap_tokens=50),
        engine=EngineConfig(retry_delay=0.0, seed=0, max_tokens=64,
                            **engine_kw),
        reduce=ReduceConfig(max_tokens_per_batch=400, reserve_tokens=100,
                            max_summaries_per_batch=4))


TIMINGS = ("processing_time", "stage_times", "engine_metrics",
           "total_device_seconds")


def test_pipeline_over_http_equals_the_mock_in_process():
    data = load_demo_transcript(160)
    fleet = Fleet("port")
    try:
        http = tpipe.TranscriptSummarizer(pipeline_cfg(
            backend="http", hosts=tuple(fleet.hosts)))
        a = http.summarize(data)
        em = a["engine_metrics"]
        http.shutdown()
    finally:
        fleet.close()
    b = tpipe.TranscriptSummarizer(pipeline_cfg(backend="mock")).summarize(data)
    assert {k: v for k, v in a.items() if k not in TIMINGS} == \
        {k: v for k, v in b.items() if k not in TIMINGS}
    assert a["failed_requests"] == 0 and a["hierarchical"]
    assert em["hosts"] == 2 and sum(r["served"] for r in em["per_host"]) == \
        a["total_requests"]


def test_cli_backend_http_runs_the_pipeline(tmp_path, capsys):
    """``lmrs-torch --backend http --hosts live,dead``: every request is
    served by the live host, the dead one ends unhealthy, and the summary
    is the in-process mock's."""
    from lmrs_tpu_torch.cli import main

    data = load_demo_transcript(120)
    src = tmp_path / "t.json"
    src.write_text(json.dumps(data))
    out = tmp_path / "s.txt"
    fleet = Fleet("port", (0,))
    try:
        hosts = f"{fleet.hosts[0]},127.0.0.1:{free_port()}"
        rc = main(["--input", str(src), "--output", str(out), "--backend",
                   "http", "--hosts", hosts, "--report"])
    finally:
        fleet.close()
    assert rc == 0
    report = json.loads((tmp_path / "s.txt.report.json").read_text())
    em = report["engine_metrics"]
    assert report["failed_requests"] == 0
    assert em["per_host"][0]["served"] == report["total_requests"]
    assert em["per_host"][1]["served"] == 0
    assert not em["per_host"][1]["healthy"]
    assert "1/2 hosts healthy" in capsys.readouterr().out
    want = tpipe.TranscriptSummarizer(PipelineConfig(
        engine=EngineConfig(backend="mock"))).summarize(data)
    assert out.read_text() == want["summary"]


# ------------------------------------------------------- refused by name

def test_cli_backend_http_without_hosts_fails_like_reference(tmp_path, capsys,
                                                             monkeypatch):
    from lmrs_tpu.engine.api import make_engine as j_make_engine
    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu_torch.cli import main

    monkeypatch.delenv("LMRS_HOSTS", raising=False)
    with pytest.raises(ValueError) as ref:
        j_make_engine(JEngineConfig(backend="http"))
    with pytest.raises(ValueError) as port:
        make_engine(EngineConfig(backend="http"))
    assert str(port.value) == str(ref.value)
    with pytest.raises(SystemExit) as exc:
        main(["--input", str(tmp_path / "x.json"), "--backend", "http"])
    assert exc.value.code == 2
    assert str(ref.value) in capsys.readouterr().err


def test_make_engine_http_floors_the_socket_timeout(monkeypatch):
    monkeypatch.setenv("LMRS_HOSTS", "127.0.0.1:1, 127.0.0.1:2")
    cfg = EngineConfig(backend="http", request_timeout=30.0)
    assert cfg.hosts == ("127.0.0.1:1", "127.0.0.1:2")
    router = make_engine(cfg)
    try:
        assert isinstance(router, RouterEngine) and router.timeout_s == 600.0
        assert router.schedules_internally
    finally:
        router.shutdown()


@pytest.mark.parametrize("kw,match", [
    ({"backend": "jax"}, "backend 'torch'"),
    ({"backend": "openai"}, "'torch', 'mock' and 'http'"),
    ({"prefill_hosts": ("h:1",)}, None),
    ({"decode_hosts": ("h:1",)}, None)])
def test_config_refusals(kw, match):
    """Unknown backends are refused; role pools are accepted and form the
    router's pools."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            EngineConfig(**kw)
        return
    router = make_engine(EngineConfig(backend="http", **kw))
    try:
        role = "prefill" if "prefill_hosts" in kw else "decode"
        assert [h.netloc for h in router.pools[role]] == ["h:1"]
        assert router.pools["both"] == [] and not router._disagg_ready()
    finally:
        router.shutdown()


@pytest.mark.parametrize("var", ["LMRS_PREFILL_HOSTS", "LMRS_DECODE_HOSTS"])
def test_role_pool_environment_is_refused(monkeypatch, var):
    """``LMRS_PREFILL_HOSTS``/``LMRS_DECODE_HOSTS`` form the router's role
    pools behind ``--backend http`` (no ``--hosts`` needed)."""
    monkeypatch.setenv(var, "127.0.0.1:1, 127.0.0.1:2")
    cfg = EngineConfig(backend="http")
    field = var.removeprefix("LMRS_").lower()
    assert getattr(cfg, field) == ("127.0.0.1:1", "127.0.0.1:2")
    router = make_engine(cfg)
    try:
        role = field.split("_")[0]
        assert [h.role for h in router.hosts] == [role, role]
        assert set(router.pools) == {"both", "prefill", "decode"}
        assert len(router.pools[role]) == 2
    finally:
        router.shutdown()


def test_router_refusals(monkeypatch):
    """No refusal is left: add, drain and remove work (the last host is
    never removed), and the fleet placement blocks are in
    ``engine_metrics()``."""
    monkeypatch.setenv("LMRS_KV_MIGRATE", "0")
    router = RouterEngine(["127.0.0.1:1"])
    try:
        added = router.add_host("127.0.0.1:2")
        assert added.netloc == "127.0.0.1:2" and added.healthy
        assert router.add_host("http://127.0.0.1:2") is added
        assert router.drain_host("127.0.0.1:2") is True
        assert not added.healthy and added.draining
        assert router.drain_host("127.0.0.1:9") is False
        assert router.host_idle("127.0.0.1:2")
        assert router.remove_host("127.0.0.1:2") is True
        assert [h.netloc for h in router.hosts] == ["127.0.0.1:1"]
        assert router.remove_host("127.0.0.1:1") is False
        doc = router.engine_metrics()
        assert doc["slo_route"] == {"enabled": True, "penalized": 0,
                                    "states": {"127.0.0.1:1": 0}}
        assert doc["tenant_route"] == {"enabled": True, "routed": 0,
                                       "tenants": 0}
        # job and session forwarding came with A13, the fleet usage,
        # anatomy and stitched trace with A10, elasticity with A10b
        for name in ("usage_report", "anatomy_report", "stitched_trace",
                     "job_request", "session_request", "add_host",
                     "drain_host", "host_idle", "remove_host",
                     "migrations_pending"):
            assert callable(getattr(router, name))
        assert not hasattr(router, "slo_report")
    finally:
        router.shutdown()
    # tail hedging came with A10b's first half: the knob builds a router
    monkeypatch.setenv("LMRS_HEDGE_MS", "50")
    RouterEngine(["127.0.0.1:1"]).shutdown()


def test_server_fronting_a_router_refuses_jobs_and_sessions():
    """A server over a router: completions go through, and the job and
    session routes forward to the fleet, as in the reference.  The backend
    has neither API on, so the job submit comes back as the backend's own
    501 and the session list is an empty fleet list."""
    import http.client

    fleet = Fleet("port", (0,))
    router = RouterEngine(fleet.hosts, timeout_s=TIMEOUT)
    front = EngineHTTPServer(router, port=0, batch_window_s=0.01)
    front.start_background()
    try:
        for method, path, want in (("POST", "/v1/chat/completions", 200),
                                   ("POST", "/v1/jobs", 501),
                                   ("GET", "/v1/sessions", 200)):
            conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                              timeout=TIMEOUT)
            conn.request(method, path, body=json.dumps(
                {"messages": [{"role": "user", "content": BODY}],
                 "transcript": {"segments": []}})
                if method == "POST" else None)
            resp = conn.getresponse()
            text = resp.read().decode()
            conn.close()
            assert resp.status == want, (path, text)
            if path == "/v1/jobs":
                assert "job API disabled on this host" in text
            if path == "/v1/sessions":
                assert json.loads(text) == {"object": "list", "data": [],
                                            "hosts_unreachable": 0}
        assert router.hosts[0].served == 1
        assert router._jobs_forwarded == router._sessions_forwarded == 1
    finally:
        front.shutdown()
        router.shutdown()
        fleet.close()


def test_request_body_matches_reference():
    """The forwarded body is the reference's for the same request (the
    deadline re-derived as the remaining budget)."""
    from lmrs_tpu.serving.router import _request_body as j_body
    from lmrs_tpu_torch.serving.router import _request_body

    kw = dict(prompt="p", system_prompt="s", max_new_tokens=9,
              temperature=0.0, top_p=0.5, top_k=3, stop=("a", "b"), seed=2,
              cache_prefix=4, deadline_s=time.time() + 100.0)
    got = _request_body(GenerationRequest(**kw))
    want = j_body(JRequest(**kw))
    assert abs(got.pop("deadline_s") - want.pop("deadline_s")) < 1.0
    assert got == want
    bare = dataclasses.replace(GenerationRequest(prompt="p"))
    assert _request_body(bare) == j_body(JRequest(prompt="p"))
