"""Port parity, observability on the serving surface: the port's server and
router over the port's mock against the reference's over its mock, on
``GET /v1/usage``, ``GET /v1/anatomy``, ``GET /v1/trace`` and the
``/healthz`` ``slo`` block (KV migration off; ledger, SLO, anatomy and
fair-share QoS on in both packages); one cross-package pairing,
the reference's router over port servers; tenant minting at ingress and
the wire's ``usage.cost``; ``POST /v1/debug/profile`` and the merged
``/metrics`` text over the tiny CPU engine; and the job and session
``usage`` blocks and trace events in both packages.

Every HTTP call and thread join carries its own timeout; servers bind
``127.0.0.1`` and shut down in teardown."""

from __future__ import annotations

import http.client
import json
import threading
import time

import pytest

from lmrs_tpu import obs as j_obs
from lmrs_tpu.engine.mock import MockEngine as JMock
from lmrs_tpu.serving.router import RouterEngine as JRouter
from lmrs_tpu.serving.server import EngineHTTPServer as JServer
from lmrs_tpu_torch import obs as t_obs
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.serving.router import RouterEngine
from lmrs_tpu_torch.serving.server import EngineHTTPServer

TIMEOUT = 10.0
# KV migration (placement noise between runs)
OFF = {"LMRS_KV_MIGRATE": "0"}
BODY = ("Transcript section: [00:01] The committee opened with the budget "
        "review for the coming year. [00:05] Several members raised the "
        "question of maintenance costs for the old building.")
TOKEN_KEYS = ("requests", "prompt_tokens", "generated_tokens",
              "goodput_tokens", "wasted_tokens", "device_seconds",
              "prefill_device_seconds", "decode_device_seconds")


@pytest.fixture(autouse=True)
def _surfaces(monkeypatch):
    for k, v in OFF.items():
        monkeypatch.setenv(k, v)


PKG = {
    "ref": dict(server=JServer, router=JRouter, obs=j_obs,
                mock=lambda: JMock(seed=0)),
    "port": dict(server=EngineHTTPServer, router=RouterEngine, obs=t_obs,
                 mock=lambda: MockEngine(seed=0)),
}


def call(port: int, method: str, path: str, body=None, headers=None):
    """(status, parsed JSON or text) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read().decode()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw
    finally:
        conn.close()


def chat(port: int, i: int, tenant: str | None, trace: str):
    headers = {"X-LMRS-Trace": trace}
    if tenant:
        headers["X-LMRS-Tenant"] = tenant
    code, doc = call(port, "POST", "/v1/chat/completions",
                     {"messages": [{"role": "user",
                                    "content": f"{i}: {BODY}"}],
                      "max_tokens": 32, "temperature": 0.0}, headers)
    assert code == 200, doc
    return doc


def shutdown_all(servers) -> None:
    threads = [threading.Thread(target=s.shutdown) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)


def run_fleet(pkg: str) -> dict:
    """Two backends over mocks, a router, and a front server over the
    router, with the package's tracer on; six requests under two tenants
    (and one anonymous), one at a time so every wave is one request."""
    p = PKG[pkg]
    p["obs"].enable_tracing()
    backends = [p["server"](p["mock"](), port=0, batch_window_s=0.01)
                for _ in range(2)]
    for s in backends:
        s.start_background()
    router = p["router"]([f"127.0.0.1:{s.port}" for s in backends],
                         timeout_s=TIMEOUT)
    front = p["server"](router, port=0, batch_window_s=0.01)
    front.start_background()
    try:
        resps = [chat(front.port, i, [None, "alice", "bob"][i % 3],
                      f"tr-{i}") for i in range(6)]
        out = {"resps": resps}
        for path in ("/v1/usage", "/v1/anatomy", "/v1/trace"):
            code, out[path] = call(front.port, "GET", path)
            assert code == 200, (pkg, path, out[path])
        out["healthz"] = [call(s.port, "GET", "/healthz")[1]
                          for s in backends]
        out["hosts"] = [f"127.0.0.1:{s.port}" for s in backends]
        return out
    finally:
        shutdown_all([front, *backends])
        router.shutdown()
        p["obs"].disable_tracing()


@pytest.fixture(scope="module")
def fleets():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in OFF.items():
            mp.setenv(k, v)
        return {pkg: run_fleet(pkg) for pkg in ("ref", "port")}


def test_fleet_usage_matches_reference(fleets):
    ref, port = fleets["ref"]["/v1/usage"], fleets["port"]["/v1/usage"]
    assert port["fleet"] is True and port["unreachable"] == []
    assert set(port["tenants"]) == set(ref["tenants"]) == {
        "default", "alice", "bob"}
    for t in port["tenants"]:
        for k in TOKEN_KEYS:
            assert port["tenants"][t].get(k, 0) == pytest.approx(
                ref["tenants"][t].get(k, 0), abs=1e-9), (t, k)
    # the fleet totals are the sum of the hosts'
    for k in ("prompt_tokens", "generated_tokens", "requests"):
        assert port["totals"][k] == sum(h["totals"].get(k, 0)
                                        for h in port["per_host"])
        assert port["totals"][k] == ref["totals"][k]
    # the wire's usage.cost bills what /v1/usage rolls up
    resps = fleets["port"]["resps"]
    assert sum(r["usage"]["prompt_tokens"] for r in resps) == \
        port["totals"]["prompt_tokens"]
    for i, r in enumerate(resps):
        assert r["usage"]["cost"]["tenant"] == ["default", "alice",
                                                "bob"][i % 3]
        assert r["usage"]["cost"] == fleets["ref"]["resps"][i]["usage"]["cost"]


def test_fleet_anatomy_matches_reference(fleets):
    ref, port = fleets["ref"]["/v1/anatomy"], fleets["port"]["/v1/anatomy"]
    assert port["fleet"] is True and len(port["per_host"]) == 2
    drop = {"per_host", "unreachable"}
    assert ({k: v for k, v in port.items() if k not in drop}
            == {k: v for k, v in ref.items() if k not in drop})
    assert port["iterations"] == sum(h["iterations"]
                                     for h in port["per_host"]) == 6


def test_stitched_trace_validates_and_chains(fleets):
    for pkg in ("ref", "port"):
        doc = fleets[pkg]["/v1/trace"]
        events = t_obs.validate_trace_events(doc["traceEvents"])
        assert j_obs.validate_trace_events(events)
        assert {f"tr-{i}" for i in range(6)} <= set(doc["stitch"]["traces"])
        chains = t_obs.stitched_chains(events)
        for i in range(6):
            names = [e["name"] for e in chains[f"tr-{i}"]]
            assert "generate" in names and "finish" in names, (pkg, names)
    port = fleets["port"]["/v1/trace"]
    # the port's router adds its own ring as the first page, and a route
    # instant naming the host that took each leg
    assert port["stitch"]["hosts"][0] == "router"
    for i in range(6):
        routes = [e for e in t_obs.stitched_chains(port["traceEvents"])[
            f"tr-{i}"] if e["name"] == "route"]
        assert routes and routes[0]["args"]["host"] in fleets["port"]["hosts"]


def test_healthz_slo_block_matches_reference(fleets):
    for ref, port in zip(fleets["ref"]["healthz"], fleets["port"]["healthz"]):
        assert port["slo"]["state"] == ref["slo"]["state"] == "ok"
        assert port["slo"].keys() == ref["slo"].keys()
        assert port["slo"]["specs"].keys() == ref["slo"]["specs"].keys()


def test_reference_router_over_port_servers():
    """The cross-package pairing: the reference's router aggregates the
    port servers' usage and anatomy pages and stitches their traces."""
    t_obs.enable_tracing()
    backends = [EngineHTTPServer(MockEngine(seed=0), port=0,
                                 batch_window_s=0.01) for _ in range(2)]
    for s in backends:
        s.start_background()
    router = JRouter([f"127.0.0.1:{s.port}" for s in backends],
                     timeout_s=TIMEOUT)
    try:
        from lmrs_tpu.engine.api import GenerationRequest as JRequest

        out = router.generate_batch([
            JRequest(prompt=f"{i}: {BODY}", request_id=i, temperature=0.0,
                     max_new_tokens=32, tenant="carol", trace_id=f"x-{i}")
            for i in range(4)])
        assert all(r.error is None and r.usage for r in out)
        usage = router.usage_report()
        assert usage["unreachable"] == [] and set(usage["tenants"]) == {"carol"}
        assert usage["totals"]["requests"] == 4
        assert usage["totals"]["prompt_tokens"] == sum(r.prompt_tokens
                                                       for r in out)
        anatomy = router.anatomy_report()
        # one plain iteration a request, plus the mixed slices of any
        # wave that carried two
        assert anatomy["iterations"] >= 4 and len(anatomy["per_host"]) == 2
        assert anatomy["iterations"] == sum(h["iterations"]
                                            for h in anatomy["per_host"])
        doc = router.stitched_trace()
        j_obs.validate_trace_events(doc["traceEvents"])
        assert {f"x-{i}" for i in range(4)} <= set(doc["stitch"]["traces"])
    finally:
        shutdown_all(backends)
        router.shutdown()
        t_obs.disable_tracing()


def test_tenant_minting_at_ingress_matches_reference():
    """``X-LMRS-Tenant`` wins over the body's ``tenant``; anonymous traffic
    bills to ``default``; /v1/usage per tenant equals the responses'
    usage, in both packages."""
    docs = {}
    for pkg in ("ref", "port"):
        p = PKG[pkg]
        srv = p["server"](p["mock"](), port=0, batch_window_s=0.01)
        srv.start_background()
        try:
            resps = []
            for i, (hdr, body_t) in enumerate([("a", "b"), (None, "b"),
                                               (None, None), ("a", None)]):
                headers = {"X-LMRS-Tenant": hdr} if hdr else {}
                code, doc = call(srv.port, "POST", "/v1/chat/completions",
                                 {"messages": [{"role": "user",
                                                "content": f"{i}: {BODY}"}],
                                  "max_tokens": 32, "temperature": 0.0,
                                  **({"tenant": body_t} if body_t else {})},
                                 headers)
                assert code == 200
                resps.append(doc)
            code, usage = call(srv.port, "GET", "/v1/usage")
            assert code == 200
            docs[pkg] = (resps, usage)
        finally:
            shutdown_all([srv])
    resps, usage = docs["port"]
    assert [r["usage"]["cost"]["tenant"] for r in resps] == [
        "a", "b", "default", "a"]
    for t, roll in usage["tenants"].items():
        mine = [r["usage"] for r in resps if r["usage"]["cost"]["tenant"] == t]
        assert roll["prompt_tokens"] == sum(u["prompt_tokens"] for u in mine)
        assert roll["generated_tokens"] == sum(u["completion_tokens"]
                                               for u in mine)
    ref_usage = docs["ref"][1]
    assert usage["tenants"].keys() == ref_usage["tenants"].keys()
    for t in usage["tenants"]:
        for k in TOKEN_KEYS:
            assert usage["tenants"][t].get(k, 0) == pytest.approx(
                ref_usage["tenants"][t].get(k, 0), abs=1e-9)


def test_profile_metrics_and_anatomy_over_the_engine(tmp_path):
    """Over the tiny CPU engine: ``POST /v1/debug/profile`` starts one
    bounded capture (a second answers 409) whose Chrome trace lands in
    ``out_dir``; ``/metrics`` text carries the scheduler's instruments
    beside the server's; ``/v1/anatomy`` serves the scheduler's document;
    ``/v1/trace`` answers 409 until tracing is on."""
    from test_torch_obs import tiny_engine

    eng = tiny_engine()
    srv = EngineHTTPServer(eng, port=0, batch_window_s=0.01)
    srv.start_background()
    try:
        assert call(srv.port, "GET", "/v1/trace")[0] == 409
        code, doc = call(srv.port, "POST", "/v1/debug/profile",
                         {"duration_s": 1.0, "out_dir": str(tmp_path)})
        assert code == 200 and doc["status"] == "capturing"
        assert call(srv.port, "POST", "/v1/debug/profile",
                    {"duration_s": 1.0})[0] == 409
        code, doc = call(srv.port, "POST", "/v1/chat/completions",
                         {"messages": [{"role": "user", "content": "hi"}],
                          "max_tokens": 8, "temperature": 0.0})
        assert code == 200 and doc["usage"]["cost"]["tenant"] == "default"
        deadline = time.time() + TIMEOUT
        while not list(tmp_path.glob("lmrs-profile-*.json")):
            assert time.time() < deadline, "no profile written"
            time.sleep(0.1)
        time.sleep(0.2)  # let the exporter finish the file
        trace = json.loads(next(tmp_path.glob("lmrs-profile-*.json"))
                           .read_text())
        assert trace["traceEvents"]
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/metrics", headers={"Accept": "text/plain"})
        text = conn.getresponse().read().decode()
        conn.close()
        for fam in ("lmrs_decode_hbm_util_ratio", "lmrs_decode_tokens_total",
                    "lmrs_http_requests_total", "lmrs_slo_state"):
            assert f"# TYPE {fam}" in text, fam
        code, an = call(srv.port, "GET", "/v1/anatomy")
        assert code == 200 and an["iterations"] > 0
        code, hz = call(srv.port, "GET", "/healthz")
        assert hz["slo"]["state"] == "ok"
        t_obs.enable_tracing()
        try:
            assert call(srv.port, "POST", "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "yo"}],
                         "max_tokens": 4})[0] == 200
            code, doc = call(srv.port, "GET", "/v1/trace")
            assert code == 200
            names = {e["name"] for e in
                     t_obs.validate_trace_events(doc["traceEvents"])}
            assert {"enqueue", "first_token", "finish"} <= names
        finally:
            t_obs.disable_tracing()
        assert eng.audit() == []
    finally:
        shutdown_all([srv])


def jobs_and_sessions(pkg: str, tmp_path) -> dict:
    from test_torch_jobs import job_transcript, pipeline_config
    from test_torch_live import live_config

    if pkg == "port":
        from lmrs_tpu_torch.jobs import JobManager
        from lmrs_tpu_torch.live import SessionManager
    else:
        from lmrs_tpu.jobs import JobManager
        from lmrs_tpu.live import SessionManager
    o = PKG[pkg]["obs"]
    o.enable_tracing()
    try:
        jm = JobManager(PKG[pkg]["mock"](), tmp_path / pkg / "jobs",
                        config=pipeline_config(pkg), start_worker=False)
        job = jm.submit(job_transcript(), {"summary_type": "summary"})
        jm.run_job(job)
        job_doc = jm.status_doc(job)
        jm.shutdown()
        sm = SessionManager(PKG[pkg]["mock"](), tmp_path / pkg / "live",
                            config=live_config(pkg))
        s = sm.create()
        segs = job_transcript(12)["segments"]
        sm.append(s.session_id, segs[:6], refresh=True)
        sm.append(s.session_id, segs[6:], refresh=True)
        sess_doc = sm.status_doc(s)
        sm.shutdown()
        names = [e["name"] for e in o.get_tracer().events()
                 if e["pid"] == o.PID_PIPELINE and e["ph"] == "i"]
    finally:
        o.disable_tracing()
    return {"job": job_doc, "session": sess_doc, "events": names}


def test_job_and_session_usage_and_events_match_reference(tmp_path):
    ref = jobs_and_sessions("ref", tmp_path)
    port = jobs_and_sessions("port", tmp_path)
    for what in ("job", "session"):
        r, p = ref[what]["usage"], port[what]["usage"]
        assert p.keys() == r.keys()
        for k in TOKEN_KEYS:
            assert p.get(k, 0) == pytest.approx(r.get(k, 0), abs=1e-9), (
                what, k)
        assert p["requests"] > 0 and p["generated_tokens"] > 0
    assert port["job"]["tenant"].startswith("job:")
    assert port["events"] == ref["events"]
    assert port["events"][:2] == ["job_submit", "job_done"]
    assert port["events"][2:] == ["session_open", "session_append",
                                  "session_refresh", "session_append",
                                  "session_refresh"]
