"""Port parity, fleet enforcement: the port's ``fleet`` package, the QoS
hooks of its scheduler, mock, server and stamps, and its router's
placement and elasticity against the JAX package's on the same inputs.

* The policy: one seeded stream of usage events on a fake clock into both
  packages' ``QoSPolicy``; ``pick_index``, ``victim_key``, ``over_quota``,
  ``normalized_usage`` and ``report()`` held exactly.
* The scheduler's hooks: ``tests/test_torch_fleet_scheduler.py``.
* The mock's admission gate, the server's ingress parse, wave order and
  ``/v1/usage`` ``qos`` block: equal on both sides.
* The router's elasticity, SLO and tenant placement, drain-time
  migration and the autoscaler: the reference's cases (its
  ``tests/test_qos.py``) run against both packages on the same fakes,
  with ``_targets`` orders, fleet usage ``qos`` merges and ``tick()``
  outputs compared; one ``SupervisedHostPool`` child over the mock.
"""

from __future__ import annotations

import http.client
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

from lmrs_tpu.engine import api as j_api
from lmrs_tpu.engine.mock import MockEngine as JMock
from lmrs_tpu.fleet import autoscale as j_autoscale
from lmrs_tpu.fleet import qos as j_qos
from lmrs_tpu.obs.metrics import MetricsRegistry as JRegistry
from lmrs_tpu.serving import router as j_router
from lmrs_tpu.serving import server as j_server
from lmrs_tpu_torch.engine import api as t_api
from lmrs_tpu_torch.engine.mock import MockEngine as TMock
from lmrs_tpu_torch.fleet import autoscale as t_autoscale
from lmrs_tpu_torch.fleet import qos as t_qos
from lmrs_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from lmrs_tpu_torch.serving import router as t_router
from lmrs_tpu_torch.serving import server as t_server

PKGS = {
    "ref": SimpleNamespace(qos=j_qos, autoscale=j_autoscale, api=j_api,
                           Mock=JMock, Registry=JRegistry, router=j_router,
                           server=j_server),
    "port": SimpleNamespace(qos=t_qos, autoscale=t_autoscale, api=t_api,
                            Mock=TMock, Registry=TRegistry, router=t_router,
                            server=t_server),
}
TIMEOUT = 10.0


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def both(fn, *a, **kw):
    """``fn(pkg, ...)`` for the reference and the port; asserts the two
    records equal and returns the port's."""
    ref = fn(PKGS["ref"], *a, **kw)
    port = fn(PKGS["port"], *a, **kw)
    assert port == ref
    return port


def req(pkg, rid, tenant=None, klass=None, prompt="x"):
    return pkg.api.GenerationRequest(prompt=prompt, request_id=rid,
                                     temperature=0.0, max_new_tokens=8,
                                     tenant=tenant, qos_class=klass)


# ---------------------------------------------------------------- policy

TENANTS = ("acme", "bulk", "live", "gold", "default")


def drive_policy(pkg, seed: int) -> list:
    """A seeded stream of usage events, window expiries and rule calls on
    a fake clock; every answer the policy gives, in order."""
    rng = np.random.default_rng(seed)
    clk = Clock()
    reg = pkg.Registry()
    pol = pkg.qos.QoSPolicy(reg, enabled=True, clock=clk)
    out = []
    for step in range(40):
        clk.t += float(rng.uniform(0.0, 4.0))
        pairs = [(str(rng.choice(TENANTS)), float(rng.uniform(-0.1, 3.0)))
                 for _ in range(int(rng.integers(0, 4)))]
        pol.note_usage(pairs)
        reqs = [req(pkg, i, str(rng.choice(TENANTS + (None,))),
                    rng.choice(["batch", "interactive", None, "weird"]))
                for i in range(int(rng.integers(1, 8)))]
        out.append(("pick", pol.pick_index(reqs)))
        out.append(("victims", [pol.victim_key(r, float(k))
                                for k, r in enumerate(reqs)]))
        for t in TENANTS + (None,):
            out.append(("usage", t, pol.normalized_usage(t),
                        pol.over_quota(t)))
        if step % 7 == 0:
            pol.note_preempt()
        out.append(("report", pol.report()))
    out.append(("counters",
                reg.counter("lmrs_qos_reorders_total").value,
                reg.counter("lmrs_qos_preempt_victims_total").value,
                reg.gauge("lmrs_qos_window_device_seconds").value))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_policy_matches_reference(seed, monkeypatch):
    monkeypatch.setenv("LMRS_QOS_WINDOW_S", "20")
    monkeypatch.setenv("LMRS_QOS_WEIGHTS", "gold:4,acme:0.5,junk,bad:-1")
    rec = both(drive_policy, seed)
    assert any(r[0] == "pick" and r[1] for r in rec)


def test_policy_helpers_match_reference(monkeypatch):
    def helpers(pkg):
        q = pkg.qos
        monkeypatch.setenv("LMRS_QOS", "0")
        off = q.maybe_qos()
        monkeypatch.delenv("LMRS_QOS")
        on = q.maybe_qos()
        return (q.parse_weights(["gold:4", "silver:0.5", "junk", "bad:-1",
                                 "nan:x", ":2", "zero:0"]),
                [q.clean_qos_class(x) for x in (" Batch ", "INTERACTIVE",
                                                "weird", 7, None)],
                [q.class_rank(x) for x in (None, "batch", "interactive")],
                q.request_class(object()),
                q.request_class(req(pkg, 0, klass="batch")),
                off is None, on is not None and on.enabled,
                sorted(on.report()), q.qos_enabled(), q.DEFAULT_CLASS,
                q.CLASSES)

    rec = both(helpers)
    assert rec[0] == {"gold": 4.0, "silver": 0.5}


def test_ledger_observer_feeds_the_window_in_both():
    """The ledger's apportionment reaches the policy through the observer
    hook, conserved, in both packages."""
    def feed(pkg):
        from importlib import import_module

        ledger = import_module(pkg.api.__name__.replace("engine.api",
                                                        "obs.ledger"))
        led = ledger.CostLedger(enabled=True)
        pol = pkg.qos.QoSPolicy(enabled=True, clock=Clock())
        led.observer = pol.note_usage
        led.note_step(0.2, decode_rows=[(req(pkg, 0, "a"), 3, 1),
                                        (req(pkg, 1, "b"), 5, 1)])
        rep = pol.report()
        return (round(rep["window_device_seconds"], 9),
                {t: round(r["window_device_seconds"], 9)
                 for t, r in rep["tenants"].items()}, led.audit())

    total, per, audit = both(feed)
    assert audit == [] and abs(total - 0.2) < 1e-9 and set(per) == {"a", "b"}


# --------------------------------------------------------------- stamps

def test_tenant_stamp_qos_class_matches_reference(monkeypatch):
    class Sink:
        def __init__(self):
            self.seen = []

        def generate_batch(self, requests, on_result=None, on_tokens=None):
            self.seen.extend(requests)
            return []

    def stamp(pkg, armed: bool):
        monkeypatch.setenv("LMRS_QOS", "1" if armed else "0")
        sink = Sink()
        fac = pkg.api.TenantStampEngine(sink, "job", qos_class="batch")
        fac.generate_batch([req(pkg, 0), req(pkg, 1, klass="interactive"),
                            req(pkg, 2, tenant="t")])
        return [(r.tenant, r.qos_class) for r in sink.seen]

    assert both(stamp, True) == [("job", "batch"), ("job", "interactive"),
                                 ("t", "batch")]
    assert both(stamp, False) == [("job", None), ("job", "interactive"),
                                  ("t", None)]


# ----------------------------------------------------------------- mock

def gate_order(pkg, qos_on: bool) -> tuple:
    """A slots=1 mock's queue filled in a fixed arrival order while its
    only slot is held; the completion order is the admission order."""
    eng = pkg.Mock(seed=0, latency_s=0.02, slots=1, qos=qos_on)
    eng._admit_wait(req(pkg, 99, "noisy", "batch", prompt="blocker"))
    if qos_on:
        eng.qos.note_usage([("noisy", 5.0)])
    done: list[str] = []
    lock = threading.Lock()

    def run(tag, tenant, klass, rid):
        res = eng.generate_batch([req(pkg, rid, tenant, klass,
                                      prompt=f"req {tag}")])[0]
        assert res.error is None, res.error
        with lock:
            done.append(tag)

    threads = []
    for i, (tag, tenant, klass) in enumerate(
            [("b0", "noisy", "batch"), ("b1", "noisy", "batch"),
             ("quiet", "quiet", "interactive"), ("b2", "noisy", "batch")]):
        t = threading.Thread(target=run, args=(tag, tenant, klass, i),
                             daemon=True)
        t.start()
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            with eng._adm_cv:
                if len(eng._adm_queue) == i + 1:
                    break
            time.sleep(0.005)
        threads.append(t)
    eng._admit_release()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    rep = eng.qos_report()
    return done, {k: v for k, v in rep.items() if k != "tenants"}, \
        sorted(rep.get("tenants", {}))


@pytest.mark.parametrize("qos_on", [True, False])
def test_mock_gate_order_matches_reference(qos_on):
    done, rep, tenants = both(gate_order, qos_on)
    if qos_on:
        assert done == ["quiet", "b0", "b1", "b2"] and rep["enabled"]
    else:
        assert done == ["b0", "b1", "quiet", "b2"]
        assert rep == {"object": "qos", "enabled": False}


def test_mock_handoff_payload_carries_the_class():
    def export(pkg):
        eng = pkg.Mock(seed=0)
        r = req(pkg, 3, "acme", "batch", prompt="handoff me please")
        r.handoff_export = True
        res = eng.generate_batch([r])[0]
        return res.finish_reason, eng._pinned[3]["payload"].get("qos_class")

    assert both(export) == ("handoff", "batch")


# --------------------------------------------------------------- server

class Recording:
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def generate_batch(self, requests, on_result=None, on_tokens=None):
        self.seen.extend(requests)
        return super().generate_batch(requests, on_result=on_result,
                                      on_tokens=on_tokens)


def http_call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def chat(text="summarize this deterministic transcript please", **extra):
    return {"messages": [{"role": "user", "content": text}],
            "max_tokens": 16, **extra}


def ingress(pkg, armed: bool, monkeypatch) -> tuple:
    monkeypatch.setenv("LMRS_QOS", "1" if armed else "0")
    mock = type("Rec", (Recording, pkg.Mock), {})(seed=0)
    srv = pkg.server.EngineHTTPServer(mock, port=0, batch_window_s=0.01)
    srv.start_background()
    try:
        cases = [({}, {}), ({"X-LMRS-QoS-Class": "Batch"}, {}),
                 ({}, {"qos_class": "batch"}),
                 ({"X-LMRS-QoS-Class": "interactive"}, {"qos_class": "batch"}),
                 ({"X-LMRS-QoS-Class": "weird"}, {"qos_class": "nope"}),
                 ({"X-LMRS-Tenant": "acme"}, {"qos_class": "batch"})]
        statuses = [http_call(srv.port, "POST", "/v1/chat/completions",
                              chat(**body), headers)[0]
                    for headers, body in cases]
        status, usage = http_call(srv.port, "GET", "/v1/usage")
        return (statuses, [r.qos_class for r in mock.seen], status,
                usage.get("qos"))
    finally:
        srv.shutdown()


@pytest.mark.parametrize("armed", [True, False])
def test_server_ingress_and_usage_block_match_reference(armed, monkeypatch):
    statuses, classes, status, qos = both(ingress, armed, monkeypatch)
    assert statuses == [200] * 6 and status == 200
    if armed:
        assert classes == [None, "batch", "batch", "interactive", None,
                           "batch"]
        assert qos["enabled"] is True
        assert set(qos["tenants"]) == {"default", "acme"}
    else:
        assert classes == [None] * 6 and qos is None


def test_batcher_wave_order_matches_reference(monkeypatch):
    class Job:
        def __init__(self, r):
            self.request = r

    def order(pkg, armed: bool):
        monkeypatch.setenv("LMRS_QOS", "1" if armed else "0")
        b = pkg.server._Batcher(pkg.Mock(seed=0))
        try:
            if armed:
                b.engine.qos.note_usage([("noisy", 10.0), ("calm", 1.0)])
            jobs = [Job(req(pkg, 0, "noisy", "batch")),
                    Job(req(pkg, 1, "noisy", "batch")),
                    Job(req(pkg, 2, "calm", "batch")),
                    Job(req(pkg, 3, "quiet", "interactive"))]
            out = b._qos_order(jobs)
            return out is jobs, [j.request.request_id for j in out]
        finally:
            b.shutdown()

    assert both(order, False) == (True, [0, 1, 2, 3])
    assert both(order, True) == (False, [3, 2, 0, 1])


def test_router_forwards_the_class_on_the_wire():
    def body(pkg, klass):
        r = req(pkg, 0, "acme", klass)
        return pkg.router._request_body(r).get("qos_class", "absent")

    assert both(body, "batch") == "batch"
    assert both(body, None) == "absent"


# ------------------------------------------------- router fleet elasticity

def router_of(pkg, hosts, **kw):
    return pkg.router.RouterEngine(list(hosts), timeout_s=1.0, **kw)


def case_elasticity(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1", "127.0.0.1:2"])
    rec = []
    try:
        h3 = router.add_host("127.0.0.1:3")
        rec += [len(router.hosts), router.add_host("127.0.0.1:3") is h3,
                router.drain_host("127.0.0.1:3"), h3.healthy,
                router.drain_host("127.0.0.1:19"), router.add_host("127.0.0.1:3") is h3,
                h3.healthy]
        router.drain_host("127.0.0.1:3")
        h3.note_leg(+1)
        rec += [router.host_idle("127.0.0.1:3"), router.remove_host("127.0.0.1:3"),
                router.remove_host("127.0.0.1:3", force=True), len(router.hosts)]
        router._note_tenant_host(req(pkg, 0, "acme"), router.hosts[1])
        rec.append(router.remove_host("127.0.0.1:2"))
        with router._stats_lock:
            rec.append(sorted(router._tenant_hosts))
        rec += [router.remove_host("127.0.0.1:1", force=True),
                router.remove_host("127.0.0.1:20"),
                [h.netloc for h in router.hosts]]
        return rec
    finally:
        router.shutdown()


def case_tenant_lru_and_slo_gating(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1", "127.0.0.1:2"])
    rec = []
    name = lambda h: None if h is None else h.netloc  # noqa: E731
    try:
        r = req(pkg, 0, "acme")
        rec.append(name(router._tenant_pref(r, "full")))
        router._note_tenant_host(r, router.hosts[0])
        rec += [name(router._tenant_pref(r, "full")), router._tenant_routed]
        # a warn state withdraws the stickiness
        with router._summary_lock:
            router._summaries["127.0.0.1:1"] = {"at": router._clock(), "map": {},
                                         "slo": "warn",
                                         "slo_at": router._clock()}
        rec.append(name(router._tenant_pref(r, "full")))
        with router._summary_lock:
            router._summaries.pop("127.0.0.1:1")
        router.drain_host("127.0.0.1:1")
        rec.append(name(router._tenant_pref(r, "full")))
        router.add_host("127.0.0.1:1")
        rec.append(name(router._tenant_pref(r, "full")))
        router._note_tenant_host(r, router.hosts[0])
        rec += [name(router._tenant_pref(r, "full")),
                name(router._tenant_pref(req(pkg, 1), "full"))]
        router._tenant_hosts_max = 2
        for i, t in enumerate(("t0", "t1", "t2")):
            router._note_tenant_host(req(pkg, 2 + i, t), router.hosts[0])
        with router._stats_lock:
            rec.append(sorted(router._tenant_hosts))
        router._note_tenant_host(req(pkg, 5, "t1"), router.hosts[1])
        router._note_tenant_host(req(pkg, 6, "t3"), router.hosts[0])
        with router._stats_lock:
            rec.append(sorted(router._tenant_hosts))
        router.tenant_route = False
        rec.append(name(router._tenant_pref(r, "full")))
        return rec
    finally:
        router.shutdown()


def case_drain_purges_sticky_caches(pkg, monkeypatch) -> list:
    monkeypatch.setenv("LMRS_KV_MIGRATE", "0")
    router = router_of(pkg, ["127.0.0.1:1", "127.0.0.1:2"])
    try:
        router._note_tenant_host(req(pkg, 0, "acme"), router.hosts[0])
        router._pin_job("job-1", "127.0.0.1:1")
        router._pin_job("sess-1", "127.0.0.1:1")
        router._pin_job("keep", "127.0.0.1:2")
        with router._summary_lock:
            router._summaries["127.0.0.1:1"] = {"at": 0.0, "map": {}}
        rec = [router.drain_host("127.0.0.1:1")]
        with router._stats_lock:
            rec.append(sorted(router._tenant_hosts))
        with router._job_lock:
            rec.append(dict(router._job_hosts))
        with router._summary_lock:
            rec.append(sorted(router._summaries))
        rec += [router.migrations_pending("127.0.0.1:1"), router._kv_moves,
                router._kv_failures]
        return rec
    finally:
        router.shutdown()


def case_drain_migration_repins(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:9", "127.0.0.1:10"])
    try:
        router._pin_job("sess-1", "127.0.0.1:9")
        rec = [router.kv_migrate, router.drain_host("127.0.0.1:9")]
        deadline = time.time() + 15.0
        while router.migrations_pending("127.0.0.1:9") \
                and time.time() < deadline:
            time.sleep(0.02)
        rec += [router.migrations_pending("127.0.0.1:9"), router._kv_moves]
        with router._job_lock:
            rec.append(dict(router._job_hosts))
        return rec
    finally:
        router.shutdown()


def case_forced_remove_purges(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1", "127.0.0.1:2"])
    try:
        router._pin_job("j", "127.0.0.1:2")
        with router._kv_lock:
            router._kv_prefetched[("127.0.0.1:2", "k")] = 0.0
            router._kv_prefetched[("127.0.0.1:1", "k")] = 0.0
        rec = [router.remove_host("127.0.0.1:2", force=True)]
        with router._job_lock:
            rec.append(dict(router._job_hosts))
        with router._kv_lock:
            rec.append(sorted(router._kv_prefetched))
        return rec
    finally:
        router.shutdown()


def case_slo_targets(pkg) -> list:
    """``_targets`` orders under published SLO states: a stable sort, a
    critical sticky preference not fronted, stale states decayed, and the
    kill switch."""
    clk = Clock()
    hosts = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3", "127.0.0.1:4"]
    router = router_of(pkg, hosts, clock=clk)
    order = lambda **kw: [h.netloc for h in router._targets(**kw)]  # noqa: E731
    try:
        def publish(states):
            with router._summary_lock:
                for netloc, st in states.items():
                    router._summaries[netloc] = {
                        "at": clk.t, "map": {}, "slo": st, "slo_at": clk.t}

        rec = [order(start=1)]
        publish({"127.0.0.1:1": "critical", "127.0.0.1:2": "warn", "127.0.0.1:3": "ok"})
        rec += [order(start=0), order(start=2), router._slo_penalized,
                order(start=3, prefer=router.hosts[0]),
                order(start=3, prefer=router.hosts[1]),
                {h.netloc: router._slo_penalty(h) for h in router.hosts},
                router.engine_metrics()["slo_route"]["penalized"]]
        clk.t += router.summary_ttl_s + 1  # stale states decay to ok
        rec += [order(start=0), router._slo_penalized]
        publish({"127.0.0.1:2": "critical"})
        router.slo_route = False
        rec += [order(start=1), router._slo_penalized]
        return rec
    finally:
        router.shutdown()


class _UsageHost:
    """A canned ``/v1/usage`` and ``/healthz`` server."""

    def __init__(self, usage: dict, slo_state: str = "ok"):
        doc = json.dumps(usage).encode()
        health = json.dumps({"status": "ok", "prefix_summary": [],
                             "slo": {"enabled": True, "state": slo_state,
                                     "specs": {}}}).encode()

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                body = doc if self.path == "/v1/usage" else health
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.netloc = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def usage_doc(qos_rows: dict | None, window_s=60.0) -> dict:
    doc = {"object": "usage", "enabled": True, "tenants": {}, "totals": {}}
    if qos_rows is not None:
        doc["qos"] = {"object": "qos", "enabled": True, "window_s": window_s,
                      "window_device_seconds": 0.0,
                      "classes": ["interactive", "batch"],
                      "tenants": {t: {"weight": w,
                                      "window_device_seconds": s}
                                  for t, (w, s) in qos_rows.items()}}
    return doc


@pytest.fixture(scope="module")
def usage_hosts():
    hosts = [_UsageHost(usage_doc({"a": (1.0, 2.0), "b": (3.0, 1.0)})),
             _UsageHost(usage_doc({"a": (1.0, 4.0), "c": (2.0, 0.5)},
                                  window_s=30.0), slo_state="critical"),
             _UsageHost(usage_doc(None))]
    yield hosts
    for h in hosts:
        h.close()


def case_usage_qos_merge(pkg, netlocs) -> list:
    router = router_of(pkg, netlocs)
    try:
        doc = router.usage_report()
        off = router_of(pkg, netlocs[2:])
        try:
            off_doc = off.usage_report()
        finally:
            off.shutdown()
        return [doc.get("qos"), doc["router"], "qos" in off_doc,
                doc["unreachable"]]
    finally:
        router.shutdown()


def case_summary_slo_states(pkg, netlocs) -> list:
    """States read from real ``/healthz`` pages through the summary fetch,
    then the dispatch order they give."""
    router = router_of(pkg, netlocs)
    try:
        for h in router.hosts:
            router._fetch_summary(h)
        return [[router._slo_penalty(h) for h in router.hosts],
                [h.netloc == netlocs[1] for h in router._targets(1)]]
    finally:
        router.shutdown()


def test_router_elasticity_api_matches_reference():
    rec = both(case_elasticity)
    assert rec[:7] == [3, True, True, False, False, True, True]
    assert rec[7:11] == [False, False, True, 2]
    assert rec[-3:] == [False, False, ["127.0.0.1:1"]]


def test_router_tenant_lru_and_slo_gating_match_reference():
    rec = both(case_tenant_lru_and_slo_gating)
    assert rec[:5] == [None, "127.0.0.1:1", 1, None, None]
    assert rec[5:8] == [None, "127.0.0.1:1", None]
    assert rec[8] == ["t1", "t2"] and rec[9] == ["t1", "t3"]
    assert rec[10] is None


def test_router_drain_purges_sticky_caches_matches_reference(monkeypatch):
    rec = both(case_drain_purges_sticky_caches, monkeypatch)
    assert rec == [True, [], {"keep": "127.0.0.1:2"}, [], False, 0, 0]


def test_router_drain_migration_repins_to_sibling_matches_reference():
    rec = both(case_drain_migration_repins)
    assert rec == [True, True, False, 0, {"sess-1": "127.0.0.1:10"}]


def test_router_forced_remove_purges_pins_and_marks_matches_reference():
    rec = both(case_forced_remove_purges)
    assert rec == [True, {}, [("127.0.0.1:1", "k")]]


def test_router_slo_targets_match_reference():
    rec = both(case_slo_targets)
    assert rec[0] == ["127.0.0.1:2", "127.0.0.1:3", "127.0.0.1:4", "127.0.0.1:1"]
    # ok hosts first in rotation order, then warn, then critical
    assert rec[1] == ["127.0.0.1:3", "127.0.0.1:4", "127.0.0.1:2", "127.0.0.1:1"]
    assert rec[4][0] == "127.0.0.1:4"  # a critical preference is not fronted
    assert rec[5][0] == "127.0.0.1:2"  # a warn preference is
    assert rec[6] == {"127.0.0.1:1": 2, "127.0.0.1:2": 1, "127.0.0.1:3": 0, "127.0.0.1:4": 0}
    assert rec[8] == ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3", "127.0.0.1:4"]
    assert rec[10] == ["127.0.0.1:2", "127.0.0.1:3", "127.0.0.1:4", "127.0.0.1:1"]


def test_router_fleet_usage_qos_merge_matches_reference(usage_hosts):
    netlocs = [h.netloc for h in usage_hosts]
    qos, router, off_has_qos, unreachable = both(case_usage_qos_merge,
                                                 netlocs)
    assert qos["fleet"] is True and qos["window_s"] == 60.0
    assert qos["tenants"]["a"]["window_device_seconds"] == 6.0
    assert qos["tenants"]["b"]["weight"] == 3.0
    assert set(router) >= {"slo_penalized", "tenant_routed"}
    assert off_has_qos is False and unreachable == []


def test_router_reads_published_slo_states_like_reference(usage_hosts):
    netlocs = [h.netloc for h in usage_hosts]
    penalties, last = both(case_summary_slo_states, netlocs)
    assert penalties == [0, 2, 0] and last == [False, False, True]


def case_drain_moves_warm_kv(pkg) -> list:
    """Two servers over mocks: a preamble warmed on one host, the host
    drained, its page set moved to the sibling over ``/v1/kv``; the rerun
    on the sibling is a prefix hit with the warm host's text, and the
    drained host is removed."""
    servers = [pkg.server.EngineHTTPServer(pkg.Mock(seed=0), port=0,
                                           batch_window_s=0.01)
               for _ in range(2)]
    for s in servers:
        s.start_background()
    netlocs = [f"127.0.0.1:{s.port}" for s in servers]
    router = router_of(pkg, netlocs)
    router.timeout_s = TIMEOUT
    pre = "List the decisions in the section below.\n"

    def one(rid):
        return router.generate_batch([pkg.api.GenerationRequest(
            prompt=pre + "[00:01] The committee approved the budget.",
            system_prompt="sys", cache_prefix=len(pre), request_id=rid,
            temperature=0.0)])[0]

    try:
        warm = one(0)
        engines = {n: s.engine for n, s in zip(netlocs, servers)}
        warm_host = next(n for n, e in engines.items() if e.prefix_summary())
        sibling = next(n for n in netlocs if n != warm_host)
        rec = [warm.error, router.drain_host(warm_host)]
        deadline = time.time() + TIMEOUT
        while router.migrations_pending(warm_host) \
                and time.time() < deadline:
            time.sleep(0.02)
        rec += [router.migrations_pending(warm_host), router._kv_moves,
                router._kv_failures,
                engines[sibling].engine_metrics().get("kv_migrate")]
        hits = engines[sibling].engine_metrics().get(
            "prefix_cache", {}).get("hits", 0)
        rerun = one(1)
        rec += [rerun.text == warm.text,
                engines[sibling].engine_metrics()["prefix_cache"]["hits"]
                - hits, router.host_idle(warm_host),
                router.remove_host(warm_host),
                router.remove_host(sibling, force=True),
                router.engine_metrics()["kv_migrate"]["moves"]]
        return rec
    finally:
        router.shutdown()
        for s in servers:
            s.shutdown()


def test_router_drain_moves_warm_kv_to_the_sibling_like_reference():
    rec = both(case_drain_moves_warm_kv)
    assert rec[:5] == [None, True, False, 1, 0]
    assert rec[5]["imports"] == 1 and rec[5]["tokens_imported"] > 0
    assert rec[6:] == [True, 1, True, True, False, 1]


@pytest.mark.parametrize("site", ["migrate.export", "migrate.import"])
def test_migrate_fault_sites_fire_in_the_mock_like_reference(site):
    """Both sites fire where the reference fires them, before any state
    changes: an export or import under the fault raises and the caches
    are as they were."""
    from lmrs_tpu.testing import faults as j_faults
    from lmrs_tpu_torch.testing import faults as t_faults

    def fire(pkg):
        plane = j_faults if pkg is PKGS["ref"] else t_faults
        src, dst = pkg.Mock(seed=0), pkg.Mock(seed=0)
        pre = "Summarize the section below.\n"
        src.generate_batch([pkg.api.GenerationRequest(
            prompt=pre + "[00:01] A vote.", system_prompt="sys",
            cache_prefix=len(pre), request_id=0)])
        key = src.prefix_summary()[0]["hash"]
        payload = src.kv_export(key) if site == "migrate.import" else None
        with plane.injected(plane.FaultPlan(seed=1, faults=[
                {"site": site, "at": [1], "max_fires": 1}])) as inj:
            try:
                if site == "migrate.export":
                    src.kv_export(key)
                else:
                    dst.kv_import(payload)
                raised = None
            except plane.InjectedFault as e:
                raised = type(e).__name__
            fires = list(inj.fires)
        return (raised, fires, dst.prefix_summary(),
                src.engine_metrics().get("kv_migrate"))

    raised, fires, dst_rows, exports = both(fire)
    assert raised == "InjectedFault" and fires == [(site, 1)]
    assert dst_rows == []


# ------------------------------------------------------------ autoscaler

def scaler(pkg, router, spawn, **kw):
    return pkg.autoscale.Autoscaler(router, spawn, enabled=True,
                                    interval_s=1.0, **kw)


def case_scales_up_on_burn(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1"])
    try:
        router._slo_penalty = lambda h: 1
        clk = Clock()
        reg = pkg.Registry()
        seq = itertools.count()
        a = scaler(pkg, router, lambda: f"127.0.0.1:{9001 + next(seq)}", clock=clk,
                   registry=reg, min_hosts=1, max_hosts=3, cooldown_ticks=2,
                   drain_timeout_s=10.0)
        ticks = [a.tick()]
        for _ in range(5):
            clk.t += 1
            ticks.append(a.tick())
        return [ticks, len(router.hosts),
                reg.counter("lmrs_autoscale_scale_ups_total").value,
                reg.gauge("lmrs_autoscale_pool_size").value, a.report()]
    finally:
        router.shutdown()


def case_drains_then_removes(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1"])
    try:
        router._slo_penalty = lambda h: 1
        clk = Clock()
        reg = pkg.Registry()
        removed: list[str] = []
        a = scaler(pkg, router, lambda: "127.0.0.1:9001", remove_cb=removed.append,
                   clock=clk, registry=reg, min_hosts=1, max_hosts=2,
                   cooldown_ticks=1, drain_timeout_s=5.0)
        ticks = [a.tick()]
        router._slo_penalty = lambda h: 0
        clk.t += 1
        ticks.append(a.tick())
        deadline = time.time() + 15.0
        while router.migrations_pending("127.0.0.1:9001") \
                and time.time() < deadline:
            time.sleep(0.02)
        for _ in range(2):
            clk.t += 1
            ticks.append(a.tick())
        return [ticks, removed, len(router.hosts),
                reg.counter("lmrs_autoscale_drains_total").value,
                reg.counter("lmrs_autoscale_scale_downs_total").value]
    finally:
        router.shutdown()


def case_holds_removal_while_migrating(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1"])
    try:
        router._slo_penalty = lambda h: 1
        clk = Clock()
        a = scaler(pkg, router, lambda: "127.0.0.1:9001", clock=clk, min_hosts=1,
                   max_hosts=2, cooldown_ticks=1, drain_timeout_s=4.0)
        ticks = [a.tick()]
        router._slo_penalty = lambda h: 0
        clk.t += 1
        ticks.append(a.tick())
        router.migrations_pending = lambda n: n == "127.0.0.1:9001"
        clk.t += 1
        ticks.append(a.tick())
        clk.t += 5
        ticks.append(a.tick())
        return [ticks, len(router.hosts)]
    finally:
        router.shutdown()


def case_force_removes_wedged_drain(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1"])
    try:
        router._slo_penalty = lambda h: 1
        clk = Clock()
        a = scaler(pkg, router, lambda: "127.0.0.1:9001", clock=clk, min_hosts=1,
                   max_hosts=2, cooldown_ticks=1, drain_timeout_s=3.0)
        ticks = [a.tick()]
        router._slo_penalty = lambda h: 0
        clk.t += 1
        ticks.append(a.tick())
        next(h for h in router.hosts
             if h.netloc == "127.0.0.1:9001").note_leg(+1)
        clk.t += 1
        ticks.append(a.tick())
        clk.t += 5
        ticks.append(a.tick())
        return [ticks, len(router.hosts)]
    finally:
        router.shutdown()


def case_never_drains_operator_capacity(pkg) -> list:
    router = router_of(pkg, ["127.0.0.1:1", "127.0.0.1:2"])
    try:
        clk = Clock()
        a = scaler(pkg, router, lambda: None, clock=clk, min_hosts=1,
                   max_hosts=4, cooldown_ticks=1)
        ticks = [a.tick()]
        clk.t += 1
        ticks.append(a.tick())
        return [ticks, len(router.hosts)]
    finally:
        router.shutdown()


def case_kill_switch(pkg, monkeypatch) -> list:
    router = router_of(pkg, ["127.0.0.1:1"])
    try:
        monkeypatch.delenv("LMRS_AUTOSCALE", raising=False)
        rec = [pkg.autoscale.maybe_autoscaler(router, lambda: None) is None]
        monkeypatch.setenv("LMRS_AUTOSCALE", "0")
        rec.append(pkg.autoscale.maybe_autoscaler(router, lambda: None)
                   is None)
        monkeypatch.setenv("LMRS_AUTOSCALE", "1")
        a = pkg.autoscale.maybe_autoscaler(router, lambda: None)
        rec.append(a is not None and a.enabled)
        router._slo_penalty = lambda h: 2
        off = pkg.autoscale.Autoscaler(router, lambda: "127.0.0.1:9001",
                                       clock=Clock(), enabled=False,
                                       interval_s=1.0, min_hosts=1,
                                       max_hosts=4)
        rec += [off.tick(), len(router.hosts)]
        return rec
    finally:
        monkeypatch.delenv("LMRS_AUTOSCALE", raising=False)
        router.shutdown()


def case_failed_spawn_is_a_degraded_tick(pkg) -> list:
    """A spawn that raises a transport error leaves the tick degraded (no
    action) and the loop alive, in both packages."""
    router = router_of(pkg, ["127.0.0.1:1"])
    try:
        router._slo_penalty = lambda h: 2

        def spawn():
            raise ConnectionRefusedError("no child")

        a = scaler(pkg, router, spawn, clock=Clock(), min_hosts=1,
                   max_hosts=2, cooldown_ticks=1)
        return [a.tick(), len(router.hosts)]
    finally:
        router.shutdown()


def test_autoscaler_scales_up_on_burn_with_cooldown_matches_reference():
    ticks, size, ups, pool, report = both(case_scales_up_on_burn)
    assert ticks[0]["actions"] == ["spawned:127.0.0.1:9001"]
    assert ticks[1]["actions"] == []
    assert size == 3 and ups == 2.0 and pool == 3.0
    assert report["pool"] == 3 and len(report["spawned"]) == 2


def test_autoscaler_drains_then_removes_matches_reference():
    ticks, removed, size, drains, downs = both(case_drains_then_removes)
    assert ticks[1]["actions"] == ["draining:127.0.0.1:9001"]
    assert ticks[2]["actions"] == ["removed:127.0.0.1:9001"]
    assert ticks[3]["actions"] == []
    assert removed == ["127.0.0.1:9001"] and size == 1
    assert drains == downs == 1.0


def test_autoscaler_holds_removal_while_kv_migrates_matches_reference():
    ticks, size = both(case_holds_removal_while_migrating)
    assert not any(x.startswith("removed") for x in ticks[2]["actions"])
    assert ticks[3]["actions"] == ["removed:127.0.0.1:9001"] and size == 1


def test_autoscaler_force_removes_wedged_drain_matches_reference():
    ticks, size = both(case_force_removes_wedged_drain)
    assert ticks[3]["actions"] == ["removed:127.0.0.1:9001:forced"] and size == 1


def test_autoscaler_never_drains_operator_capacity_matches_reference():
    ticks, size = both(case_never_drains_operator_capacity)
    assert ticks[1]["actions"] == [] and size == 2


def test_autoscaler_kill_switch_matches_reference(monkeypatch):
    rec = both(case_kill_switch, monkeypatch)
    assert rec == [True, True, True,
                   {"enabled": False, "pool": 1, "actions": []}, 1]


def test_autoscaler_failed_spawn_matches_reference():
    tick, size = both(case_failed_spawn_is_a_degraded_tick)
    assert tick["actions"] == [] and size == 1


def test_autoscaler_tick_loop_survives_a_transport_error():
    """The port's loop catches the transport's failures by type and goes
    on; the next tick runs."""
    router = router_of(PKGS["port"], ["127.0.0.1:1"])
    calls = []

    def boom():
        calls.append(1)
        raise OSError("transient")

    a = t_autoscale.Autoscaler(router, lambda: None, enabled=True,
                               interval_s=0.1)
    a.tick = boom
    try:
        a.start()
        deadline = time.time() + 5.0
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert len(calls) >= 2
    finally:
        a.stop()
        router.shutdown()


def test_supervised_host_pool_serves_and_stops():
    """One ``lmrs-serve-torch --supervise`` child over the mock, spawned
    by the pool: it joins a router, serves a request, drains and is
    removed; the supervisor exits 0 on its termination."""
    pool = t_autoscale.SupervisedHostPool(startup_timeout_s=60.0)
    router = router_of(PKGS["port"], ["127.0.0.1:9"])
    try:
        url = pool.spawn()
        assert url is not None
        h = router.add_host(url)
        router.hosts[0].healthy = False
        res = router.generate_batch([t_api.GenerationRequest(
            prompt="Transcript: [00:01] The committee met. [00:02] It "
                   "agreed.", request_id=1, max_new_tokens=8)])[0]
        assert res.error is None and res.text
        assert router.drain_host(h.netloc) and router.host_idle(h.netloc)
        router.hosts[0].healthy = True
        assert router.remove_host(h.netloc)
        proc = pool._procs[h.netloc]
        pool.remove(h.netloc)
        assert proc.wait(timeout=30) == 0
    finally:
        pool.shutdown()
        router.shutdown()
