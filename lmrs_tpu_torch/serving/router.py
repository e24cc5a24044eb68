"""An Engine over running ``lmrs-serve-torch`` servers (the port of the
reference's ``serving/router.py``): ``lmrs-torch --backend http --hosts
h:p,...`` fans the pipeline's requests over them.

* **Engine protocol**: the executor, the pipeline and the server itself
  compose with ``RouterEngine`` unchanged (a server can front a router).
* **One thread per in-flight request**, ``http.client`` only: each server
  micro-batches and admission-controls itself, so the router only
  dispatches.
* **Cancel = hang up**: ``cancel(rid)`` shuts the request's socket down; the
  server's disconnect detection cancels it and frees its slot and pages.
* **Degrade and continue**: a failed request retries once on the next
  host, then comes back as an error result.  Only a connection-phase
  failure condemns a host; ``LMRS_BREAKER_FAILURES`` consecutive failures
  of any kind open its circuit breaker, and after
  ``LMRS_BREAKER_COOLDOWN_S`` one canary generation may close it.  Each
  wave launches paced ``/healthz`` probes at unhealthy hosts, so a
  restarted server comes back.
* **Prefix-aware placement** (``LMRS_PREFIX_ROUTE``, default on): a request
  with a shared preamble goes first to the host whose ``/healthz`` radix
  summary predicts the deepest hit, else to a rendezvous-hash host, with
  each wave's same-preamble group given only its fair share of one host.
* **Prefetch spread** (``LMRS_KV_MIGRATE``, default on): when a group
  spreads past a host whose summary predicts a hit, the siblings about to
  serve the rest pull the warm page set from it over ``/v1/kv`` (export
  there, import here), deduplicated per (sibling, preamble) within a
  summary TTL; a leg that fails leaves the sibling cold.
* **Role pools** (``prefill_hosts``/``decode_hosts``, from
  ``LMRS_PREFILL_HOSTS``/``LMRS_DECODE_HOSTS``): while both pools have a
  healthy host, a request's prefill leg (``"handoff": true``) goes to the
  prefill pool, which answers with a ticket, and its decode leg follows
  the ticket on the decode pool (a failed decode leg retries a sibling).
  A flow that cannot complete falls back to a colocated re-prefill on any
  host (counted in the ``handoff`` block) — unless deltas already
  streamed, when the failure surfaces instead.

* **Job and session forwarding** (``job_request`` / ``session_request``,
  called by a front server without managers of its own): a job submit
  hashes its body onto the host ring, a session create rendezvous-hashes
  its id (an existing session's host wins), and the returned id pins
  follow-up calls to that host; an unknown id scans the fleet and
  re-pins.  Jobs and sessions share one bounded pin cache.

* **Fleet observability**: ``usage_report()`` (every host's ``/v1/usage``
  merged by ``obs.merge_usage``: per-tenant fleet rollups sum to the fleet
  totals), ``anatomy_report()`` (``obs.merge_anatomy`` over every host's
  ``/v1/anatomy``, each host's document beside it) and
  ``stitched_trace()`` (every host's ``/v1/trace`` clock-aligned and merged
  by ``obs.stitch_traces``), served by a fronting server as its own
  ``/v1/usage``, ``/v1/anatomy`` and ``/v1/trace``.  With tracing on in
  the router's process, each forwarded leg records a ``route`` instant
  (the host that took it) on the request's trace track, and the stitched
  trace carries the router's own ring as its first page (``router``), so
  a request reads router → host on one timeline.  Completions forward the
  tenant (``X-LMRS-Tenant``) and bring back the ledger's ``usage.cost``.

* **Tail hedging** (``LMRS_HEDGE_MS`` > 0, read per request; off by
  default): a NON-streamed request whose primary leg has not answered
  within the hedge delay (the p99 of successful non-streamed walls once 20
  exist, floored at the knob) is duplicated to the next host; the first
  non-error result wins and the loser is hung up (its server's disconnect
  detection cancels it).  A primary that fails fast still gets its
  sibling, as a plain failover leg.  Counted in ``engine_metrics()
  ["hedge"]``, ``lmrs_router_hedges_total`` / ``lmrs_router_hedge_wins_
  total`` and the fleet usage's ``router`` block.

* **SLO placement** (``LMRS_SLO_ROUTE``, default on): each host's
  ``/healthz`` ``slo`` state rides the summary cache, and the dispatch
  order sinks warn and critical hosts as a graded penalty (a stable sort,
  so an ok fleet keeps its rotation); a critical host is never fronted by
  a sticky preference.  Counted in ``engine_metrics()["slo_route"]`` and
  ``lmrs_router_slo_penalized_total``.
* **Tenant placement** (``LMRS_TENANT_ROUTE``, default on): with no prefix
  opinion, a tenant's request goes first to the host that last served it
  (a bounded LRU), while that host is healthy and its SLO state ok.
  Counted in ``engine_metrics()["tenant_route"]`` and
  ``lmrs_router_tenant_routed_total``.
* **Elasticity**: ``add_host(url, role)`` joins a server at run time,
  ``drain_host(netloc)`` takes it out of the dispatch order (its legs in
  flight finish; its tenant, job and session pins are released) and,
  with ``LMRS_KV_MIGRATE`` armed, moves its hottest warm page sets to the
  least-loaded healthy sibling over ``/v1/kv`` and re-pins its jobs and
  sessions there (``migrations_pending(netloc)`` until done);
  ``host_idle(netloc)`` reads its legs in flight and
  ``remove_host(netloc, force=False)`` completes the exit (never the last
  host).  ``fleet/autoscale.py`` drives these calls.
* **QoS forwarding**: a request's ``qos_class`` rides the body to the
  server's fair-share admission; the fleet usage merges every host's
  ``qos`` block over the fleet's sums.

Fault-injection sites (``testing/faults.py``): ``router.connect`` (a
connect-phase failure, as a dead host), ``router.probe`` (a failed
``/healthz`` probe), ``router.recv`` (a mid-stream SSE fault or stall) and
``router.hedge`` (a hedge launch abandoned or delayed).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import random
import socket
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from urllib.parse import urlsplit

from lmrs_tpu_torch.engine.api import (GenerationRequest, GenerationResult,
                                       drain_with_callback, preamble_key,
                                       remaining_budget)
from lmrs_tpu_torch.obs import (MetricsRegistry, add_label_to_exposition,
                                get_tracer, merge_anatomy, merge_expositions,
                                new_trace_id, stitch_traces)
from lmrs_tpu_torch.obs.ledger import merge_usage, totals_from_tenants
from lmrs_tpu_torch.obs.slo import state_rank
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.utils.env import env_bool, env_float, env_int

logger = logging.getLogger("lmrs_torch.router")


def _request_body(req: GenerationRequest) -> dict:
    body: dict = {
        "messages": ([{"role": "system", "content": req.system_prompt}]
                     if req.system_prompt else [])
        + [{"role": "user", "content": req.prompt}],
        "max_tokens": req.max_new_tokens,
        "temperature": req.temperature,
        "top_p": req.top_p,
    }
    if req.stop:
        body["stop"] = list(req.stop)
    if req.top_k:
        body["top_k"] = req.top_k
    if req.seed is not None:
        body["seed"] = req.seed
    if req.deadline_s is not None:
        # the REMAINING budget, re-derived at send time: wall-clock never
        # crosses a host boundary, and a retry forwards less budget
        body["deadline_s"] = max(0.0, remaining_budget(req))
    if req.cache_prefix is not None:
        # the hint caps what the server's prefix cache takes and keys the
        # summary this router places on
        body["cache_prefix"] = int(req.cache_prefix)
    if req.qos_class is not None:
        # fair-share admission runs on the server: the class must cross
        # the wire (None while QoS is off, so that wire is unchanged)
        body["qos_class"] = req.qos_class
    return body


class _HostConnectError(ConnectionError):
    """Connection-phase failure: the HOST is down (marks it unhealthy), as
    opposed to a failure on an established connection."""


class _Host:
    """One backend server.  ``role`` is its pool ("prefill" | "decode" |
    "both"): a routing policy, every host can serve a whole request.
    Health is the connect-phase belief (``_down``) AND a circuit breaker
    (closed | open | half_open) AND not draining: see the module
    docstring.  ``healthy = True`` force-closes the first two."""

    def __init__(self, url: str, role: str = "both", clock=time.monotonic):
        u = urlsplit(url if "//" in url else f"http://{url}")
        self.netloc = u.netloc or u.path  # tolerate bare host:port
        self.role = role
        self.clock = clock
        self._down = False
        self.breaker_state = "closed"
        self.breaker_opened_t = 0.0
        # a draining host leaves the dispatch order like an open breaker
        # but is never probed back: its legs in flight finish, nothing new
        # lands, and remove_host() completes the exit once it is idle
        self.draining = False
        self._count_lock = threading.Lock()
        self.served = 0           # guarded-by: _count_lock
        self.failed = 0           # guarded-by: _count_lock
        self.inflight = 0         # request legs on this host  guarded-by: _count_lock
        self.consec_failures = 0  # guarded-by: _count_lock
        self.breaker_opens = 0    # guarded-by: _count_lock
        # earliest clock time of the next recovery probe
        self.next_probe_t = 0.0

    @property
    def healthy(self) -> bool:
        """Not condemned, not draining and the breaker closed (a half-open
        host gets only its canary)."""
        return (not self._down and not self.draining
                and self.breaker_state == "closed")

    def note_leg(self, delta: int) -> None:
        """Legs in flight (drain-until-idle needs an exact count)."""
        with self._count_lock:
            self.inflight += delta

    @healthy.setter
    def healthy(self, value: bool) -> None:
        if value:
            self._down = False
            self.breaker_state = "closed"
            with self._count_lock:
                self.consec_failures = 0
        else:
            self._down = True

    def note_served(self) -> None:
        with self._count_lock:
            self.served += 1
            self.consec_failures = 0

    def note_failed(self) -> None:
        threshold = env_int("LMRS_BREAKER_FAILURES", 3, lo=0)
        opened = False
        with self._count_lock:
            self.failed += 1
            self.consec_failures += 1
            if (threshold and self.consec_failures >= threshold
                    and self.breaker_state == "closed"):
                opened = True
                self.breaker_opens += 1
        if opened:
            self.breaker_state = "open"
            self.breaker_opened_t = self.clock()
            logger.warning("host %s: breaker OPEN after %d consecutive "
                           "failures", self.netloc, threshold)

    def reopen_breaker(self) -> None:
        """A half-open canary failed: back to open, cooldown restarts."""
        if self.breaker_state != "closed":
            self.breaker_state = "open"
            self.breaker_opened_t = self.clock()

    def breaker_due(self) -> bool:
        """An open breaker whose cooldown has elapsed (canary due)."""
        if self.breaker_state != "open":
            return False
        cooldown = env_float("LMRS_BREAKER_COOLDOWN_S", 5.0, lo=0.1)
        return self.clock() - self.breaker_opened_t >= cooldown

    def canary(self, timeout: float = 10.0) -> bool:
        """Half-open probe: ONE greedy token through the real request path
        (a wedged server still answers /healthz).  Success closes the
        breaker, failure re-opens it for another cooldown."""
        self.breaker_state = "half_open"
        conn = None
        try:
            conn = http.client.HTTPConnection(self.netloc, timeout=timeout)
            conn.request("POST", "/v1/chat/completions",
                         body=json.dumps({
                             "messages": [{"role": "user",
                                           "content": "breaker canary"}],
                             "max_tokens": 1, "temperature": 0.0}),
                         headers={"Content-Type": "application/json"})
            ok = conn.getresponse().status == 200
        except Exception:  # noqa: BLE001 - still down
            ok = False
        finally:
            if conn is not None:
                conn.close()
        if ok:
            logger.info("host %s: canary succeeded, breaker CLOSED",
                        self.netloc)
            self.healthy = True
        else:
            self.reopen_breaker()
        return ok

    def connect(self, timeout: float) -> http.client.HTTPConnection:
        # injection site: a connection-phase fault, raised as the host-down
        # class, so it takes the unhealthy-marking + failover path of a
        # dead backend
        faults.fire("router.connect", _HostConnectError)
        return http.client.HTTPConnection(self.netloc, timeout=timeout)

    def probe(self) -> bool:
        """GET /healthz; clears the connect-phase condemnation when the
        host answers (an open breaker closes only through its canary)."""
        conn = None
        try:
            # its own injection site and connection: probes run on pool
            # threads and must not consume the request path's
            # ``router.connect`` occurrences
            faults.fire("router.probe", _HostConnectError)
            conn = http.client.HTTPConnection(self.netloc, timeout=2.0)
            conn.request("GET", "/healthz")
            ok = conn.getresponse().status == 200
        except Exception:  # noqa: BLE001 - still down
            ok = False
        finally:
            if conn is not None:
                conn.close()
        if ok:
            self._down = False
        return ok


class RouterEngine:
    """Engine-protocol fan-out over N ``lmrs-serve-torch`` servers."""

    schedules_internally = True  # each server admission-controls itself

    def __init__(self, hosts: list[str], timeout_s: float = 600.0,
                 probe_floor_s: float = 5.0, probe_jitter_s: float = 2.5,
                 clock=time.monotonic, prefix_route: bool | None = None,
                 summary_ttl_s: float | None = None,
                 prefill_hosts: list[str] = (), decode_hosts: list[str] = (),
                 slo_route: bool | None = None):
        self.hosts = ([_Host(h, clock=clock) for h in hosts]
                      + [_Host(h, "prefill", clock=clock)
                         for h in prefill_hosts]
                      + [_Host(h, "decode", clock=clock)
                         for h in decode_hosts])
        if not self.hosts:
            raise ValueError("RouterEngine needs at least one backend host")
        self.pools: dict[str, list[_Host]] = {
            role: [h for h in self.hosts if h.role == role]
            for role in ("both", "prefill", "decode")}
        self._stats_lock = threading.Lock()
        # handoff flows followed, decode legs retried, flows degraded to a
        # colocated re-prefill
        self._handoffs = 0           # guarded-by: _stats_lock
        self._handoff_retries = 0    # guarded-by: _stats_lock
        self._handoff_fallbacks = 0  # guarded-by: _stats_lock
        # the /v1/kv prefetch spread; disarmed, no /v1/kv call is made and
        # the kv_migrate keys are omitted
        self.kv_migrate = env_bool("LMRS_KV_MIGRATE", True)
        self._kv_lock = threading.Lock()
        # draining hosts whose warm page sets are being moved to a sibling
        self._kv_migrating: set[str] = set()  # guarded-by: _kv_lock
        # (sibling netloc, preamble) -> last attempt, bounded
        self._kv_prefetched: dict[tuple[str, str], float] = {}  # guarded-by: _kv_lock
        self._kv_prefetched_max = 256
        self._kv_moves = 0       # guarded-by: _stats_lock
        self._kv_prefetches = 0  # guarded-by: _stats_lock
        self._kv_failures = 0    # guarded-by: _stats_lock
        # per-recv socket timeout: must exceed the worst-case SILENT wait
        # (a non-streamed generation sends nothing until it completes)
        self.timeout_s = timeout_s
        # recovery probes space >= probe_floor_s apart per host plus a
        # jitter in [0, probe_jitter_s); ``clock`` is injectable for tests
        self.probe_floor_s = probe_floor_s
        self.probe_jitter_s = probe_jitter_s
        self._clock = clock
        self._probe_rng = random.Random(0x90BE)
        self._probe_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, 4 * len(self.hosts)),
            thread_name_prefix="lmrs-router")
        # rid -> the live HTTPConnection (before connect) or its RAW socket
        # (after: getresponse() detaches the socket for Connection: close
        # responses such as SSE, so it is pinned here for cancel())
        self._inflight: dict[int, object] = {}  # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        # the live waves' cancel sets: a cancel lands in every wave live at
        # cancel time, and a wave created later never sees it
        self._wave_cancel_sets: list[set[int]] = []  # guarded-by: _stats_lock
        # the round-robin base advances ACROSS waves (single-request waves
        # would otherwise all land on hosts[0])
        self._rr_base = 0  # guarded-by: _stats_lock
        self.prefix_route = (env_bool("LMRS_PREFIX_ROUTE", True)
                             if prefix_route is None else bool(prefix_route))
        self.summary_ttl_s = (env_float("LMRS_PREFIX_SUMMARY_TTL", 10.0,
                                        lo=0.5, hi=300.0)
                              if summary_ttl_s is None
                              else float(summary_ttl_s))
        # netloc -> {"at": clock, "map": {hash -> summary row}}
        self._summaries: dict[str, dict] = {}  # guarded-by: _summary_lock
        self._summary_inflight: set[str] = set()  # guarded-by: _summary_lock
        self._summary_lock = threading.Lock()
        self._prefix_routed = 0     # guarded-by: _stats_lock
        self._prefix_predicted = 0  # guarded-by: _stats_lock
        self._prefix_fallback = 0   # guarded-by: _stats_lock
        # SLO placement: the summary cache carries each host's published
        # burn state, and the dispatch order sinks degraded hosts (ok <
        # warn < critical); LMRS_SLO_ROUTE=0 keeps the plain order
        self.slo_route = (env_bool("LMRS_SLO_ROUTE", True)
                          if slo_route is None else bool(slo_route))
        self._slo_penalized = 0     # guarded-by: _stats_lock
        # tenant placement: tenant -> the host that last served it, a
        # bounded LRU (a cache, not the truth); the weakest preference,
        # consulted only when prefix placement has none
        self.tenant_route = env_bool("LMRS_TENANT_ROUTE", True)
        self._tenant_hosts: dict[str, str] = {}  # guarded-by: _stats_lock
        self._tenant_hosts_max = 1024
        self._tenant_routed = 0     # guarded-by: _stats_lock
        # job and session forwarding: id -> backend netloc.  A cache, not
        # the truth (the journals live with the backends): bounded, oldest
        # pin evicted, an evicted or unknown id re-scans the fleet
        self._job_hosts: dict[str, str] = {}  # guarded-by: _job_lock
        self._job_hosts_max = 4096
        self._job_lock = threading.Lock()
        self._jobs_forwarded = 0      # guarded-by: _stats_lock
        self._sessions_forwarded = 0  # guarded-by: _stats_lock
        # tail hedging (LMRS_HEDGE_MS): hedge legs launched and won, and
        # the successful non-streamed walls the hedge delay's p99 reads
        self._hedges = 0       # guarded-by: _stats_lock
        self._hedge_wins = 0   # guarded-by: _stats_lock
        self._lat_s: deque[float] = deque(maxlen=512)  # guarded-by: _stats_lock

    def _count(self, attr: str) -> None:
        with self._stats_lock:
            setattr(self, attr, getattr(self, attr) + 1)

    # ------------------------------------------------------------------ API

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None, on_tokens=None) -> list[GenerationResult]:
        if on_result is not None:
            return drain_with_callback(
                lambda reqs: self._wave(reqs, on_tokens), requests, on_result)
        return self._wave(requests, on_tokens)

    def cancel(self, request_id: int) -> None:
        """Abort a request by hanging up its connection; unknown ids
        (cancels between waves included) are a no-op.  A non-streamed
        cancel loses its partial text; a streamed one keeps the deltas
        already received."""
        with self._stats_lock:
            for wave in self._wave_cancel_sets:
                wave.add(request_id)
        with self._inflight_lock:
            # hedge and failover legs register under ("hedge", rid): a
            # cancel after the primary leg ended must still reach them
            targets = [self._inflight.get(request_id),
                       self._inflight.get(("hedge", request_id))]
        for target in targets:
            self._hangup(target)

    @staticmethod
    def _hangup(target) -> None:
        """shutdown(), not close(): while a thread reads the response,
        close() is deferred and no FIN reaches the server."""
        if target is None:
            return
        try:
            if isinstance(target, socket.socket):
                target.shutdown(socket.SHUT_RDWR)
            else:
                target.close()
        except OSError:
            pass

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def engine_metrics(self) -> dict:
        per = []
        for h in self.hosts:
            row = {"host": h.netloc, "role": h.role, "healthy": h.healthy,
                   "breaker": h.breaker_state,
                   "served": h.served, "failed": h.failed}
            conn = None
            try:
                conn = h.connect(timeout=2.0)
                conn.request("GET", "/metrics")
                row["metrics"] = json.loads(conn.getresponse().read())
            except Exception as e:  # noqa: BLE001 - best effort, not silent
                logger.debug("metrics fetch failed for %s: %s: %s",
                             h.netloc, type(e).__name__, e)
                row["metrics_unreachable"] = True
            finally:
                if conn is not None:
                    conn.close()
            per.append(row)
        with self._summary_lock:
            now = self._clock()
            ages = {netloc: round(now - s["at"], 1)
                    for netloc, s in self._summaries.items()}
        doc = {"hosts": len(self.hosts),
               "healthy_hosts": sum(h.healthy for h in self.hosts),
               "pools": {role: {"size": len(pool),
                                "healthy": sum(h.healthy for h in pool)}
                         for role, pool in self.pools.items() if pool},
               "handoff": {"handoffs": self._handoffs,
                           "retries": self._handoff_retries,
                           "fallbacks": self._handoff_fallbacks},
               "hedge": {"hedges": self._hedges,
                         "wins": self._hedge_wins},
               "prefix_route": {"enabled": self.prefix_route,
                                "routed": self._prefix_routed,
                                "predicted": self._prefix_predicted,
                                "fallback": self._prefix_fallback,
                                "summary_age_s": ages},
               "slo_route": {"enabled": self.slo_route,
                             "penalized": self._slo_penalized,
                             "states": {h.netloc: self._slo_penalty(h)
                                        for h in self.hosts}},
               "tenant_route": {"enabled": self.tenant_route,
                                "routed": self._tenant_routed,
                                "tenants": len(self._tenant_hosts)},
               "per_host": per}
        if self.kv_migrate:
            doc["kv_migrate"] = {"enabled": True, "moves": self._kv_moves,
                                 "prefetches": self._kv_prefetches,
                                 "failures": self._kv_failures}
        return doc

    def prometheus_metrics(self) -> str:
        """The fleet page: each healthy server's Prometheus page relabeled
        ``host=<netloc>`` (scraped concurrently under one 3 s deadline),
        the router's per-host series and pool gauges, and its placement
        counters, merged with one header a family."""

        def scrape(h: _Host) -> str | None:
            conn = None
            try:
                conn = h.connect(timeout=2.0)
                conn.request("GET", "/metrics",
                             headers={"Accept": "text/plain"})
                resp = conn.getresponse()
                body = resp.read().decode("utf-8", "replace")
                if (resp.status == 200
                        and "text/plain" in resp.getheader("Content-Type", "")):
                    return body
            except Exception as e:  # noqa: BLE001 - scrape is best effort
                logger.debug("prometheus scrape failed for %s: %s: %s",
                             h.netloc, type(e).__name__, e)
            finally:
                if conn is not None:
                    conn.close()
            return None

        futures = {h: self._pool.submit(scrape, h)
                   for h in self.hosts if h.healthy}
        deadline = time.time() + 3.0
        bodies: dict[str, str | None] = {}
        for h, fut in futures.items():
            try:
                bodies[h.netloc] = fut.result(
                    timeout=max(0.0, deadline - time.time()))
            except Exception:  # noqa: BLE001 - timeout / pool saturation
                bodies[h.netloc] = None
        pages: list[str] = []
        for h in self.hosts:
            body = bodies.get(h.netloc)
            if body is not None:
                pages.append(add_label_to_exposition(body, "host", h.netloc))
            reg = MetricsRegistry()
            reg.gauge("lmrs_router_host_up",
                      "1 when the router considers the host healthy "
                      "(request-path belief)").set(float(h.healthy))
            reg.gauge("lmrs_router_host_scrape_ok",
                      "1 when this scrape fetched the host's metrics "
                      "page").set(float(body is not None))
            reg.counter("lmrs_router_host_served_total",
                        "requests completed on this host").inc(h.served)
            reg.counter("lmrs_router_host_failed_total",
                        "requests failed on this host").inc(h.failed)
            reg.gauge("lmrs_router_breaker_state",
                      "circuit-breaker state for this host "
                      "(0=closed, 1=open, 2=half_open)").set(
                {"closed": 0.0, "open": 1.0,
                 "half_open": 2.0}.get(h.breaker_state, 0.0))
            reg.counter("lmrs_router_breaker_opens_total",
                        "times this host's breaker opened "
                        "(consecutive-failure threshold crossed)"
                        ).inc(h.breaker_opens)
            reg.gauge("lmrs_router_host_slo_state",
                      "the host's last published SLO burn-rate state "
                      "(0=ok/unknown, 1=warn, 2=critical)").set(
                float(self._slo_penalty(h)))
            pages.append(add_label_to_exposition(
                reg.render_prometheus(), "host", h.netloc))
        for role, pool in self.pools.items():
            if not pool:  # a colocated fleet reports one "both" pool
                continue
            reg = MetricsRegistry()
            reg.gauge("lmrs_router_pool_size",
                      "backend hosts in this role pool").set(len(pool))
            reg.gauge("lmrs_router_pool_healthy",
                      "healthy hosts in this role pool").set(
                sum(h.healthy for h in pool))
            pages.append(add_label_to_exposition(reg.render_prometheus(),
                                                 "pool", role))
        reg = MetricsRegistry()
        reg.counter("lmrs_handoff_total",
                    "prefill→decode handoff tickets followed by the "
                    "router").inc(self._handoffs)
        reg.counter("lmrs_handoff_retries_total",
                    "failed decode-leg attempts (retried or degraded)"
                    ).inc(self._handoff_retries)
        reg.counter("lmrs_handoff_fallbacks_total",
                    "handoff flows degraded to colocated re-prefill"
                    ).inc(self._handoff_fallbacks)
        reg.counter("lmrs_router_hedges_total",
                    "hedge legs launched for straggling requests "
                    "(LMRS_HEDGE_MS tail hedging)").inc(self._hedges)
        reg.counter("lmrs_router_hedge_wins_total",
                    "hedged requests whose duplicate leg answered first "
                    "(the loser was hung up)").inc(self._hedge_wins)
        reg.counter("lmrs_router_jobs_forwarded_total",
                    "durable-job API calls forwarded to backends"
                    ).inc(self._jobs_forwarded)
        reg.counter("lmrs_router_sessions_forwarded_total",
                    "live-session API calls forwarded to backends "
                    "(sticky by session id)").inc(self._sessions_forwarded)
        reg.counter("lmrs_router_prefix_routed_total",
                    "requests placed sticky-by-prefix (summary-predicted "
                    "or rendezvous)").inc(self._prefix_routed)
        reg.counter("lmrs_router_prefix_hit_predicted_total",
                    "prefix placements backed by a fresh radix summary "
                    "predicting a hit").inc(self._prefix_predicted)
        reg.counter("lmrs_router_prefix_fallback_total",
                    "prefix-eligible requests that degraded to plain "
                    "load/health ordering").inc(self._prefix_fallback)
        reg.counter("lmrs_router_slo_penalized_total",
                    "dispatch orders whose first choice was demoted by a "
                    "published SLO state (LMRS_SLO_ROUTE)"
                    ).inc(self._slo_penalized)
        reg.counter("lmrs_router_tenant_routed_total",
                    "requests placed sticky on the tenant's last-served "
                    "host (LMRS_TENANT_ROUTE)").inc(self._tenant_routed)
        if self.kv_migrate:
            reg.counter("lmrs_kv_migrate_moves_total",
                        "KV page sets moved off draining hosts over the "
                        "/v1/kv export/import wire").inc(self._kv_moves)
            reg.counter("lmrs_kv_migrate_prefetches_total",
                        "predicted prefixes prefetched into spread "
                        "siblings ahead of wave traffic"
                        ).inc(self._kv_prefetches)
            reg.counter("lmrs_kv_migrate_failures_total",
                        "KV migration legs (move or prefetch) that failed; "
                        "the preamble re-prefills cold").inc(self._kv_failures)
        pages.append(reg.render_prometheus())
        return merge_expositions(pages)

    # ------------------------------------------------------- job forwarding

    def job_request(self, method: str, path: str, body: dict | None,
                    trace_id: str | None = None,
                    tenant: str | None = None) -> tuple[int, dict]:
        """Forward one /v1/jobs call to the backend fleet (the front
        server's ``_job_http`` delegates here when it has no local
        JobManager).  Placement is STICKY: a submit hashes its transcript
        onto the host ring — so a duplicate POST (client retry after a
        crash) lands on the same backend and converges on the same
        content-addressed journal — and the returned job id pins follow-up
        GET/DELETE traffic to that host.  Unknown ids scan the fleet
        (rebuilding the stickiness cache after a router restart: the
        journals live with the backends, not here)."""
        with self._stats_lock:
            self._jobs_forwarded += 1
        if method == "POST":
            digest = int(hashlib.sha256(
                json.dumps(body or {}, sort_keys=True).encode()
            ).hexdigest(), 16)
            ring = sorted(self.hosts, key=lambda h: h.netloc)
            start = digest % len(ring)
            last: tuple[int, dict] = (503, {"error": {
                "message": "no backend accepted the job",
                "type": "job_error"}})
            for k in range(len(ring)):
                host = ring[(start + k) % len(ring)]
                if not host.healthy and k < len(ring) - 1:
                    continue  # same optimism as _targets: try someone
                try:
                    status, payload = self._job_call(host, method, path,
                                                     body, trace_id,
                                                     tenant=tenant)
                except Exception as e:  # noqa: BLE001 - next host
                    host.note_failed()
                    last = (502, {"error": {
                        "message": f"{host.netloc}: {type(e).__name__}: {e}",
                        "type": "job_error"}})
                    continue
                if status == 501:  # backend has no jobs_dir: keep looking
                    last = (status, payload)
                    continue
                jid = payload.get("id") if isinstance(payload, dict) else None
                if jid:
                    self._pin_job(jid, host.netloc)
                return status, payload
            return last
        # Fleet scans run CONCURRENTLY on the dispatch pool: sequential
        # probing would hold the HTTP handler thread one connect timeout
        # per partitioned host (connect HANGS rather than refuses there);
        # gathered, the whole scan is bounded by the slowest single host.
        if method == "GET" and path.rstrip("/") == "/v1/jobs":
            futures = [self._pool.submit(self._job_call_safe, h, method,
                                         path, None)
                       for h in self.hosts]
            data: list = []
            errors = 0
            for host, fut in zip(self.hosts, futures):
                status, payload = fut.result()
                if status == 200:
                    for doc in payload.get("data", []):
                        if doc.get("id"):
                            self._pin_job(doc["id"], host.netloc)
                        data.append(doc)
                elif status == 502:
                    errors += 1
            return 200, {"object": "list", "data": data,
                         "hosts_unreachable": errors}
        # GET/DELETE /v1/jobs/<id>: sticky host alone first (the common
        # case pays no fleet cost), then a concurrent fleet scan —
        # rebuilding stickiness after a router restart
        jid = path.split("/v1/jobs/", 1)[-1].strip("/")
        with self._job_lock:
            pinned = self._job_hosts.get(jid)
        if pinned is not None:
            host = next((h for h in self.hosts if h.netloc == pinned), None)
            if host is not None:
                status, payload = self._job_call_safe(host, method, path,
                                                      None)
                if status not in (404, 501, 502):
                    return status, payload
        ordered = sorted(self.hosts,
                         key=lambda h: (not h.healthy, h.netloc))
        futures = [self._pool.submit(self._job_call_safe, h, method, path,
                                     None)
                   for h in ordered]
        results = [f.result() for f in futures]
        last = (404, {"error": {"message": f"no job {jid} on any backend",
                                "type": "job_error"}})
        for host, (status, payload) in zip(ordered, results):
            if status in (404, 501):
                continue
            if status == 502:
                last = (status, payload)
                continue
            self._pin_job(jid, host.netloc)
            return status, payload
        return last

    # -------------------------------------------- live-session forwarding

    def session_request(self, method: str, path: str, body: dict | None,
                        trace_id: str | None = None,
                        tenant: str | None = None) -> tuple[int, dict]:
        """Forward one /v1/sessions call (the front server's
        ``_session_http`` delegates here when it has no local
        SessionManager).  Placement is STICKY BY SESSION ID — stronger
        than load balancing wants, and on purpose: a session's journal
        lives on one backend, and so does the warm radix prefix tree its
        refresh traffic keeps hitting (the shared map/reduce preambles +
        the transcript prefix).  Bouncing a session between hosts would
        both orphan its journal and cold-start its cache on every hop.

        Creates rendezvous-hash onto the host ring (a client-supplied
        session_id lands deterministically, so a duplicate create
        converges host-side); follow-up traffic routes to the pinned
        host, and an unknown id fleet-scans to rebuild stickiness after
        a router restart — the journals live with the backends, not
        here."""
        with self._stats_lock:
            self._sessions_forwarded += 1
        if method == "POST" and path.rstrip("/") == "/v1/sessions":
            key = (body or {}).get("session_id")
            # a client-supplied id may already live somewhere (create
            # retry, router restart): the existing backend must win, or a
            # fleet-membership change would fork the session onto a
            # second journal that silently misses the earlier segments
            ring: list[_Host] = []
            if key:
                existing = self._locate_session(key)
                if existing is not None:
                    ring = [existing]
                if not ring:
                    # TRUE rendezvous (highest-random-weight over (key,
                    # host)): membership changes move only ~1/N of ids,
                    # unlike modulo-on-the-sorted-list which reshuffles
                    # every placement
                    ring = sorted(
                        self.hosts,
                        key=lambda h: hashlib.sha256(
                            f"{key}|{h.netloc}".encode()).hexdigest(),
                        reverse=True)
            if not ring:
                # anonymous create (server mints the id): nothing stable
                # to hash — hashing the (constant) body would pile every
                # default-params session onto one backend, so place by
                # load/health instead; the returned id pins follow-ups
                ring = sorted(self.hosts,
                              key=lambda h: (not h.healthy, h.served,
                                             h.netloc))
            last: tuple[int, dict] = (503, {"error": {
                "message": "no backend accepted the session",
                "type": "session_error"}})
            for k, host in enumerate(ring):
                if not host.healthy and k < len(ring) - 1:
                    continue
                try:
                    status, payload = self._job_call(host, method, path,
                                                     body, trace_id,
                                                     tenant=tenant)
                except Exception as e:  # noqa: BLE001 - next host
                    host.note_failed()
                    last = (502, {"error": {
                        "message": f"{host.netloc}: {type(e).__name__}: {e}",
                        "type": "session_error"}})
                    continue
                if status == 501:  # backend has no live_dir: keep looking
                    last = (status, payload)
                    continue
                sid = (payload.get("id")
                       if isinstance(payload, dict) else None)
                if sid:
                    self._pin_job(sid, host.netloc)
                return status, payload
            return last
        if method == "GET" and path.split("?", 1)[0].rstrip("/") \
                == "/v1/sessions":
            futures = [self._pool.submit(self._job_call_safe, h, method,
                                         path, None)
                       for h in self.hosts]
            data: list = []
            errors = 0
            for host, fut in zip(self.hosts, futures):
                status, payload = fut.result()
                if status == 200:
                    for doc in payload.get("data", []):
                        if doc.get("id"):
                            self._pin_job(doc["id"], host.netloc)
                        data.append(doc)
                elif status == 502:
                    errors += 1
            return 200, {"object": "list", "data": data,
                         "hosts_unreachable": errors}
        # /v1/sessions/<id>[/sub]: the REAL call goes to the pinned host
        # directly (the jobs pattern — no validation pre-flight doubling
        # every hot-path append's round trips); only a MISS there (404 =
        # session not on that backend, 501 = API off) falls back to a
        # concurrent fleet scan by session STATUS and re-forwards.  A 502
        # (timeout, connection fault) on a MUTATING call is surfaced, not
        # retried: the backend may well have journaled the append before
        # the fault, and a blind re-forward would duplicate segments in
        # the transcript forever.  Refresh-bearing calls run real engine
        # work, so they get the router's generation timeout, not the 10 s
        # control-plane one.
        from urllib.parse import parse_qs, urlsplit

        sid = path.split("/v1/sessions/", 1)[-1].split("?", 1)[0] \
                  .strip("/").split("/")[0]
        # "does this call run engine work?": appends/refreshes/deletes,
        # plus a summary GET whose refresh param the BACKEND would treat
        # as true (same truthiness rule as server._session_http — the
        # two sides must agree or a ?refresh=true would run minutes of
        # refresh under the 10 s control-plane timeout)
        q = parse_qs(urlsplit(path).query)
        wants_refresh = q.get("refresh", ["0"])[-1] not in ("0", "false", "")
        heavy = method in ("POST", "DELETE") or wants_refresh
        tmo = self.timeout_s if heavy else 10.0
        # a 502 on a HEAVY call is surfaced, never blindly re-forwarded:
        # the backend may have journaled the append / started the refresh
        # before the fault, and a retry would duplicate the work (or the
        # transcript)
        rescan_on = (404, 501) if heavy else (404, 501, 502)
        with self._job_lock:
            pinned = self._job_hosts.get(sid)
        if pinned is not None:
            host = next((h for h in self.hosts if h.netloc == pinned), None)
            if host is not None:
                status, payload = self._job_call_safe(host, method, path,
                                                      body, trace_id,
                                                      timeout=tmo)
                if status == 502:
                    # the health signal must degrade whether or not we
                    # rescan — these ARE request-path failures
                    host.note_failed()
                if status not in rescan_on:
                    return status, payload
        host = self._locate_session(sid)
        if host is None:
            return 404, {"error": {
                "message": f"no session {sid} on any backend",
                "type": "session_error"}}
        status, payload = self._job_call_safe(host, method, path, body,
                                              trace_id, timeout=tmo)
        if status == 502:
            host.note_failed()
        return status, payload

    def _locate_session(self, sid: str) -> _Host | None:
        """The backend holding ``sid``: a concurrent fleet scan (GET
        status) that re-pins on a hit — how stickiness survives a router
        restart (callers try the pinned host's real call first)."""
        ordered = sorted(self.hosts,
                         key=lambda h: (not h.healthy, h.netloc))
        futures = [self._pool.submit(self._job_call_safe, h, "GET",
                                     f"/v1/sessions/{sid}", None)
                   for h in ordered]
        for host, fut in zip(ordered, futures):
            status, _payload = fut.result()
            if status == 200:
                self._pin_job(sid, host.netloc)
                return host
        return None

    def _job_call_safe(self, host: _Host, method: str, path: str,
                       body: dict | None,
                       trace_id: str | None = None,
                       timeout: float = 10.0) -> tuple[int, dict]:
        """_job_call with exceptions folded into a 502 tuple (scan legs
        run on the pool; a raise there would surface at .result())."""
        try:
            return self._job_call(host, method, path, body, trace_id,
                                  timeout=timeout)
        except Exception as e:  # noqa: BLE001 - aggregate what answers
            return 502, {"error": {
                "message": f"{host.netloc}: {type(e).__name__}: {e}",
                "type": "job_error"}}

    def _pin_job(self, jid: str, netloc: str) -> None:
        """Record job->host stickiness, bounded: oldest pins evict past
        ``_job_hosts_max`` (an evicted id just pays one fleet re-scan)."""
        with self._job_lock:
            self._job_hosts[jid] = netloc
            while len(self._job_hosts) > self._job_hosts_max:
                self._job_hosts.pop(next(iter(self._job_hosts)))

    def _job_call(self, host: _Host, method: str, path: str,
                  body: dict | None,
                  trace_id: str | None = None,
                  timeout: float = 10.0,
                  tenant: str | None = None) -> tuple[int, dict]:
        """One forwarded job/session call, on a bare connection (like
        probes).  The default timeout is short because job calls are
        control-plane (submit returns immediately, GET is a status read)
        and a sequential fleet scan must not hold an HTTP handler thread
        30 s per partitioned host; session calls that run ENGINE work
        (appends with refresh, explicit refreshes) pass the router's
        generation timeout instead."""
        conn = http.client.HTTPConnection(host.netloc, timeout=timeout)
        headers = {"Content-Type": "application/json"}
        if trace_id:
            headers["X-LMRS-Trace"] = trace_id
        if tenant:
            headers["X-LMRS-Tenant"] = tenant
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            try:
                payload = json.loads(raw) if raw else {}
            except ValueError:
                payload = {"error": {"message": raw.decode("utf-8",
                                                           "replace")[:200]}}
            return resp.status, payload
        finally:
            conn.close()

    # ------------------------------------------------ fleet observability

    @staticmethod
    def _trace_route(req: GenerationRequest, host: "_Host") -> None:
        """A ``route`` instant on the request's trace track: which host
        took this leg (the router's side of the stitched chain)."""
        tr = get_tracer()
        if tr and req.trace_id:
            tr.instant("route", tid=tr.track_for(req.trace_id),
                       args={"host": host.netloc, "role": host.role})

    def _pull_pages(self, path: str) -> tuple[list[tuple[str, dict]],
                                              list[str]]:
        """GET ``path`` from every host concurrently (control plane: bare
        connections, short timeouts, the dispatch pool); returns the
        (netloc, document) pages that answered 200 and the netlocs that
        did not."""
        def fetch(h: _Host):
            conn = None
            try:
                conn = http.client.HTTPConnection(h.netloc, timeout=5.0)
                conn.request("GET", path)
                resp = conn.getresponse()
                if resp.status != 200:
                    logger.debug("%s from %s: HTTP %d", path, h.netloc,
                                 resp.status)
                    return None
                return json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 - best-effort per host
                logger.debug("%s fetch failed for %s: %s: %s", path,
                             h.netloc, type(e).__name__, e)
                return None
            finally:
                if conn is not None:
                    conn.close()

        futures = [(h, self._pool.submit(fetch, h)) for h in self.hosts]
        pages: list[tuple[str, dict]] = []
        unreachable: list[str] = []
        for h, fut in futures:
            try:
                doc = fut.result(timeout=10.0)
            except Exception:  # noqa: BLE001 - pool saturation or timeout
                doc = None
            if isinstance(doc, dict):
                pages.append((h.netloc, doc))
            else:
                unreachable.append(h.netloc)
        return pages, unreachable

    def usage_report(self) -> dict:
        """Fleet ``GET /v1/usage``: every host's per-tenant rollups merged
        by the one merge rule (``merge_usage``), so the per-tenant fleet
        rollups sum to the fleet totals; hosts down or ledger-less are
        listed in ``unreachable``.  The hosts' ``qos`` blocks merge into
        one: windowed device-seconds summed per tenant, weights their
        largest, shares recomputed over the fleet's sums (omitted when
        every host has QoS off)."""
        pages, unreachable = self._pull_pages("/v1/usage")
        tenants: dict[str, dict] = {}
        per_host: list[dict] = []
        enabled = False
        qos_burn: dict[str, float] = {}
        qos_weight: dict[str, float] = {}
        qos_window = 0.0
        qos_on = False
        for netloc, doc in pages:
            enabled = enabled or bool(doc.get("enabled"))
            per_host.append({"host": netloc,
                             "totals": doc.get("totals") or {}})
            for t, roll in (doc.get("tenants") or {}).items():
                merge_usage(tenants.setdefault(t, {}), roll)
            q = doc.get("qos")
            if isinstance(q, dict) and q.get("enabled"):
                qos_on = True
                qos_window = max(qos_window, float(q.get("window_s") or 0.0))
                for t, row in (q.get("tenants") or {}).items():
                    qos_burn[t] = (qos_burn.get(t, 0.0)
                                   + float(row.get("window_device_seconds")
                                           or 0.0))
                    qos_weight[t] = max(qos_weight.get(t, 0.0),
                                        float(row.get("weight") or 1.0))
        with self._stats_lock:
            router = {"hedges": self._hedges,
                      "hedge_wins": self._hedge_wins,
                      "handoff_retries": self._handoff_retries,
                      "slo_penalized": self._slo_penalized,
                      "tenant_routed": self._tenant_routed}
        doc = {"object": "usage", "enabled": enabled, "fleet": True,
               "tenants": tenants, "totals": totals_from_tenants(tenants),
               "per_host": per_host, "unreachable": unreachable,
               "router": router}
        if qos_on:
            total = sum(qos_burn.values())
            wsum = sum(qos_weight.get(t, 1.0) for t in qos_burn) or 1.0
            qt = {}
            for t, s in sorted(qos_burn.items()):
                w = qos_weight.get(t, 1.0)
                fair = total * w / wsum
                qt[t] = {"weight": w,
                         "window_device_seconds": round(s, 6),
                         "share": round(s / total, 4) if total > 0 else 0.0,
                         "fair_share": round(w / wsum, 4),
                         "over_quota": bool(len(qos_burn) > 1 and s > fair)}
            doc["qos"] = {"object": "qos", "enabled": True, "fleet": True,
                          "window_s": qos_window,
                          "window_device_seconds": round(total, 6),
                          "tenants": qt}
        return doc

    def anatomy_report(self) -> dict:
        """Fleet ``GET /v1/anatomy``: ``merge_anatomy`` over every host's
        document (additive totals exact, per-class percentiles
        iteration-weighted estimates), each host's document in
        ``per_host``."""
        pages, unreachable = self._pull_pages("/v1/anatomy")
        merged = merge_anatomy([doc for _, doc in pages])
        merged.update({"fleet": True,
                       "per_host": [{"host": n, **doc} for n, doc in pages],
                       "unreachable": unreachable})
        return merged

    def stitched_trace(self) -> dict:
        """Every host's ``GET /v1/trace`` page, clock-aligned and merged
        into one Perfetto document (``stitch_traces``), with the router's
        own ring first (as ``router``) when tracing is on here; hosts down
        or not tracing are listed in ``stitch.unreachable``."""
        pages, unreachable = self._pull_pages("/v1/trace")
        tr = get_tracer()
        if tr is not None:
            pages.insert(0, ("router", tr.payload(host="router")))
        merged = stitch_traces(pages)
        merged["stitch"]["unreachable"] = unreachable
        return merged

    # ---------------------------------------------------- fleet elasticity

    def add_host(self, url: str, role: str = "both") -> _Host:
        """Admit a server into the fleet at run time (the autoscaler's
        scale-up, or an operator).  Idempotent by netloc: re-adding a host
        clears its drain flag and returns it.  A new host enters healthy;
        one that never came up costs one failover leg through the
        breaker."""
        h = _Host(url, role, clock=self._clock)
        for existing in self.hosts:
            if existing.netloc == h.netloc:
                existing.draining = False
                return existing
        # list appends are atomic and dispatch only iterates, so a wave
        # sees the fleet before or after the join, never a torn list
        self.hosts.append(h)
        self.pools.setdefault(h.role, []).append(h)
        logger.info("fleet: host %s joined (role %s, %d hosts)",
                    h.netloc, h.role, len(self.hosts))
        return h

    def drain_host(self, netloc: str) -> bool:
        """Begin a graceful exit: the host leaves the dispatch order (not
        ``healthy``) but keeps its legs in flight, and no probe re-admits
        it.  Its tenant pins, summary and job/session pins are released
        now, so it stops attracting placement; with ``LMRS_KV_MIGRATE``
        armed its warm page sets move to a sibling, which inherits the
        released job/session pins.  False for an unknown netloc."""
        for h in self.hosts:
            if h.netloc != netloc:
                continue
            h.draining = True
            with self._summary_lock:
                self._summaries.pop(netloc, None)
                self._summary_inflight.discard(netloc)
            with self._stats_lock:
                for t, n in list(self._tenant_hosts.items()):
                    if n == netloc:
                        del self._tenant_hosts[t]
            with self._job_lock:
                pinned = [j for j, n in self._job_hosts.items()
                          if n == netloc]
                for j in pinned:
                    del self._job_hosts[j]
            logger.info("fleet: host %s draining (%d legs in flight, "
                        "%d pins released)", netloc, h.inflight,
                        len(pinned))
            if self.kv_migrate:
                self._start_kv_migration(h, pinned)
            return True
        return False

    def host_idle(self, netloc: str) -> bool:
        """No request legs in flight on the host (the drain-complete
        signal the autoscaler polls); True for an unknown netloc."""
        for h in self.hosts:
            if h.netloc == netloc:
                return h.inflight == 0
        return True

    def remove_host(self, netloc: str, force: bool = False) -> bool:
        """Complete a drain: drop the host from the fleet and every routing
        structure.  False while legs are in flight (unless ``force``), for
        an unknown netloc, and for the last host of the fleet."""
        for h in list(self.hosts):
            if h.netloc != netloc:
                continue
            if h.inflight and not force:
                return False
            if len(self.hosts) <= 1:
                logger.warning("fleet: refusing to remove last host %s",
                               netloc)
                return False
            self.hosts.remove(h)
            for pool in self.pools.values():
                if h in pool:
                    pool.remove(h)
            with self._summary_lock:
                self._summaries.pop(netloc, None)
                self._summary_inflight.discard(netloc)
            with self._stats_lock:
                for t, n in list(self._tenant_hosts.items()):
                    if n == netloc:
                        del self._tenant_hosts[t]
            # job and session pins too: a forced remove (no drain first)
            # must not leave clients pinned to a host that is gone
            with self._job_lock:
                for j, n in list(self._job_hosts.items()):
                    if n == netloc:
                        del self._job_hosts[j]
            with self._kv_lock:
                for key in [k for k in self._kv_prefetched
                            if k[0] == netloc]:
                    del self._kv_prefetched[key]
            logger.info("fleet: host %s removed (%d hosts remain)",
                        netloc, len(self.hosts))
            return True
        return False

    # --------------------------------------------- drain-time KV migration

    def migrations_pending(self, netloc: str) -> bool:
        """A drain's KV migration off ``netloc`` is still running (the
        autoscaler holds its removal until it clears or times out)."""
        with self._kv_lock:
            return netloc in self._kv_migrating

    def _start_kv_migration(self, src: _Host, pinned: list[str]) -> None:
        """Queue the migration of ``src``'s warm KV on the pool, one per
        netloc at a time (a second drain call must not race a copy)."""
        with self._kv_lock:
            if src.netloc in self._kv_migrating:
                return
            self._kv_migrating.add(src.netloc)
        self._pool.submit(self._migrate_host_kv, src, pinned)

    def _migrate_host_kv(self, src: _Host, pinned: list[str]) -> None:
        """Move the draining host's hottest preambles (at most 8, resident
        tokens weighing twice spilled ones) to one healthy sibling over
        ``/v1/kv``, then re-pin the drained host's jobs and sessions there
        (pool thread).  A failure leaves the preamble to re-prefill cold
        wherever placement sends it; a torch or CUDA error raises."""
        moved = 0
        try:
            dst = self._kv_sibling(src)
            if dst is None:
                logger.info("fleet: no healthy sibling for %s; its KV "
                            "stays (re-prefill on demand)", src.netloc)
                return
            rows = self._fetch_kv_rows(src)
            rows.sort(key=lambda e: -(2 * int(e.get("resident_tokens") or 0)
                                      + int(e.get("spilled_tokens") or 0)))
            for ent in rows[:8]:
                if self._kv_move(src, dst, str(ent["hash"])):
                    moved += 1
            with self._job_lock:
                for jid in pinned:
                    self._job_hosts[jid] = dst.netloc
                while len(self._job_hosts) > self._job_hosts_max:
                    self._job_hosts.pop(next(iter(self._job_hosts)))
            logger.info("fleet: migrated %d KV page sets %s -> %s "
                        "(%d pins re-homed)", moved, src.netloc,
                        dst.netloc, len(pinned))
        except (OSError, http.client.HTTPException, ValueError,
                faults.InjectedFault):
            logger.warning("fleet: KV migration off %s failed after %d "
                           "moves", src.netloc, moved, exc_info=True)
            self._count("_kv_failures")
        finally:
            with self._kv_lock:
                self._kv_migrating.discard(src.netloc)

    def _kv_sibling(self, src: _Host) -> _Host | None:
        """Where a drained host's KV lands: the least-served healthy host
        other than ``src`` (role membership is policy: a migrated preamble
        is useful wherever follow-up traffic goes)."""
        healthy = [h for h in self.hosts if h is not src and h.healthy]
        if not healthy:
            return None
        return sorted(healthy, key=lambda h: (h.served, h.netloc))[0]

    def _fetch_kv_rows(self, src: _Host) -> list[dict]:
        """The draining host's current prefix summary, fetched directly
        (its cached copy went at the drain); none from a host that does
        not answer."""
        conn = None
        try:
            conn = http.client.HTTPConnection(src.netloc, timeout=5.0)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            if resp.status != 200:
                return []
            doc = json.loads(resp.read())
        except (OSError, http.client.HTTPException, ValueError) as e:
            logger.debug("KV summary fetch failed for %s: %s: %s",
                         src.netloc, type(e).__name__, e)
            return []
        finally:
            if conn is not None:
                conn.close()
        return [ent for ent in (doc.get("prefix_summary") or ())
                if isinstance(ent, dict) and ent.get("hash")]

    def _kv_move(self, src: _Host, dst: _Host, preamble: str) -> bool:
        """One page-set move: export on ``src`` (404: cold or busy, 501:
        the wire is off there; neither is a failure), then a pull-import on
        ``dst``, which fetches the blob and acks the ticket (an unacked
        ticket is reclaimed by ``src``'s orphan sweep)."""
        status, doc = self._kv_call(src, "/v1/kv/export",
                                    {"preamble": preamble})
        if status != 200 or not doc.get("ticket"):
            if status not in (404, 501):
                self._count("_kv_failures")
            return False
        status, _ = self._kv_call(dst, "/v1/kv/import",
                                  {"ticket": doc["ticket"],
                                   "source": src.netloc})
        if status == 200:
            self._count("_kv_moves")
            return True
        self._count("_kv_failures")
        return False

    # ------------------------------------------------------------- dispatch

    def _wave(self, requests: list[GenerationRequest],
              on_tokens) -> list[GenerationResult]:
        cancelled: set[int] = set()
        with self._stats_lock:
            self._wave_cancel_sets.append(cancelled)
            base = self._rr_base
            self._rr_base += len(requests)
        # paced recovery probes and summary refreshes ride the wave on the
        # pool; placement is planned per wave
        self._launch_probes()
        self._refresh_summaries()
        prefers = self._plan_prefix_placement(
            requests, "prefill" if self._disagg_ready() else "full")
        try:
            futures = [self._pool.submit(self._one, base + i, req, on_tokens,
                                         cancelled, prefers[i])
                       for i, req in enumerate(requests)]
            return [f.result() for f in futures]
        finally:
            with self._stats_lock:
                self._wave_cancel_sets.remove(cancelled)

    def _launch_probes(self) -> list[_Host]:
        """Submit a recovery attempt for each unavailable host whose pacing
        window has elapsed (an open breaker only once its cooldown is
        over); returns the hosts probed.  The next-probe stamp is claimed
        under a lock, so racing waves never double-probe a host."""
        now = self._clock()
        probed: list[_Host] = []
        with self._probe_lock:
            for host in self.hosts:
                if host.healthy or now < host.next_probe_t:
                    continue
                if host.draining:
                    continue  # a deliberate exit: nothing re-admits it
                if (not host._down and host.breaker_state == "open"
                        and not host.breaker_due()):
                    continue  # cooldown running: no canary yet
                if host.breaker_state == "half_open":
                    continue  # a canary is already in flight
                host.next_probe_t = (now + self.probe_floor_s
                                     + self._probe_rng.random()
                                     * self.probe_jitter_s)
                probed.append(host)
        for host in probed:
            self._pool.submit(self._recover_host, host)
        return probed

    def _recover_host(self, host: _Host) -> None:
        """/healthz first when the host is condemned, then the canary when
        its breaker's cooldown has elapsed."""
        if host._down and not host.probe():
            return
        if host.breaker_state == "open" and host.breaker_due():
            host.canary()

    def _role_pool(self, role: str) -> list[_Host]:
        """The hosts eligible for ``role``: "full" (a colocated request)
        draws from every host; "prefill"/"decode" from that pool, else the
        "both" pool."""
        if role == "full":
            return self.hosts
        return self.pools.get(role) or self.pools["both"] or self.hosts

    def _targets(self, start: int, role: str = "full",
                 prefer: _Host | None = None) -> list[_Host]:
        """Hosts of ``role`` in round-robin order from ``start``, healthy
        first (every host of it when none is healthy: a transient fault
        must not brick the fleet), sunk by published SLO state under
        ``slo_route``; ``prefer`` goes to the front unless its state is
        critical."""
        pool = self._role_pool(role)
        n = len(pool)
        order = [pool[(start + k) % n] for k in range(n)]
        out = [h for h in order if h.healthy] or order
        if self.slo_route:
            # a stable sort: an ok fleet keeps its rotation, and a degraded
            # host sinks in the failover order instead of vanishing (it
            # still serves when every host is degraded)
            penalties = {h.netloc: self._slo_penalty(h) for h in out}
            if any(penalties.values()):
                first = out[0]
                out = sorted(out, key=lambda h: penalties[h.netloc])
                if out and out[0] is not first:
                    with self._stats_lock:
                        self._slo_penalized += 1
            # prefix warmth never outranks a host burning its SLOs
            if prefer is not None and penalties.get(prefer.netloc, 0) >= 2:
                prefer = None
        if prefer is not None and prefer in out:
            out = [prefer] + [h for h in out if h is not prefer]
        return out

    def _tenant_pref(self, req: GenerationRequest,
                     role: str) -> _Host | None:
        """The host that last served this request's tenant, while it is
        healthy and its published SLO state ok; else no opinion."""
        if not self.tenant_route or not req.tenant:
            return None
        with self._stats_lock:
            netloc = self._tenant_hosts.get(req.tenant)
        if netloc is None:
            return None
        for h in self._role_pool(role):
            if h.netloc == netloc:
                if h.healthy and self._slo_penalty(h) == 0:
                    with self._stats_lock:
                        self._tenant_routed += 1
                    return h
                return None
        return None

    def _note_tenant_host(self, req: GenerationRequest,
                          host: _Host) -> None:
        """Record a served request's host as its tenant's warm host (an
        LRU: a re-insert moves to the back, the oldest evicts)."""
        if not self.tenant_route or not req.tenant:
            return
        with self._stats_lock:
            self._tenant_hosts.pop(req.tenant, None)
            self._tenant_hosts[req.tenant] = host.netloc
            while len(self._tenant_hosts) > self._tenant_hosts_max:
                self._tenant_hosts.pop(next(iter(self._tenant_hosts)))

    def _slo_penalty(self, host: _Host) -> int:
        """The host's placement penalty from its last published SLO state
        (0 ok or unknown, 1 warn, 2 critical); a state older than the
        summary TTL decays to 0 (a host that stopped publishing is not
        penalized on old news)."""
        with self._summary_lock:
            s = self._summaries.get(host.netloc)
            if s is None or (self._clock() - s.get("slo_at", s["at"])
                             > self.summary_ttl_s):
                return 0
            return state_rank(s.get("slo"))

    # ------------------------------------------------- prefix-aware routing

    def _refresh_summaries(self) -> None:
        """Queue a ``/healthz`` summary fetch for every healthy host whose
        summary is older than half the TTL (prefix or SLO placement on);
        never blocks a wave."""
        if not (self.prefix_route or self.slo_route):
            return
        now = self._clock()
        due: list[_Host] = []
        with self._summary_lock:
            for h in self.hosts:
                if not h.healthy or h.netloc in self._summary_inflight:
                    continue
                s = self._summaries.get(h.netloc)
                if s is None or now - s["at"] >= self.summary_ttl_s / 2:
                    self._summary_inflight.add(h.netloc)
                    due.append(h)
        for host in due:
            self._pool.submit(self._fetch_summary, host)

    def _fetch_summary(self, host: _Host) -> None:
        """One summary fetch (pool thread).  A failed fetch keeps the last
        map and stamps the time, so a dark host is re-fetched at the
        normal cadence, not hammered."""
        doc = None
        conn = None
        try:
            conn = http.client.HTTPConnection(host.netloc, timeout=2.0)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            if resp.status == 200:
                doc = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 - control-plane best effort
            logger.debug("summary fetch failed for %s: %s: %s",
                         host.netloc, type(e).__name__, e)
        finally:
            if conn is not None:
                conn.close()
        smap: dict[str, dict] | None = None
        slo_state: str | None = None
        if isinstance(doc, dict):
            smap = {str(ent["hash"]): ent
                    for ent in doc.get("prefix_summary") or ()
                    if isinstance(ent, dict) and ent.get("hash")}
            slo = doc.get("slo")
            if isinstance(slo, dict) and slo.get("enabled"):
                slo_state = str(slo.get("state") or "ok")
        with self._summary_lock:
            now = self._clock()
            slo_at = now
            if smap is None:
                # a failed fetch keeps the last map (stale warmth is still
                # the best guess) but the SLO state keeps its last
                # success's stamp, so its penalty decays
                prev = self._summaries.get(host.netloc)
                smap = prev["map"] if prev else {}
                slo_state = (prev or {}).get("slo")
                slo_at = (prev or {}).get("slo_at", 0.0)
            self._summaries[host.netloc] = {"at": now, "map": smap,
                                            "slo": slo_state,
                                            "slo_at": slo_at}
            self._summary_inflight.discard(host.netloc)

    def _prefix_target(self, req: GenerationRequest, role: str = "full"
                       ) -> tuple[_Host | None, bool, bool]:
        """``(host, predicted, eligible)`` for one request: among healthy
        hosts, the one whose fresh summary predicts the deepest hit
        (resident tokens weigh twice spilled ones), else a rendezvous hash
        of (preamble, host); not eligible without a shared preamble."""
        if not self.prefix_route:
            return None, False, False
        key = preamble_key(req.system_prompt, req.prompt, req.cache_prefix)
        if key is None:
            return None, False, False
        healthy = [h for h in self._role_pool(role) if h.healthy]
        if not healthy:
            return None, False, True
        now = self._clock()
        with self._summary_lock:
            views = {h.netloc: self._summaries.get(h.netloc) for h in healthy}
        best, best_score = None, 0
        for h in healthy:
            s = views[h.netloc]
            if s is None or now - s["at"] > self.summary_ttl_s:
                continue  # stale: this host predicts nothing
            ent = s["map"].get(key)
            if not ent:
                continue
            try:
                score = (2 * int(ent.get("resident_tokens") or 0)
                         + int(ent.get("spilled_tokens") or 0))
            except (TypeError, ValueError):
                continue
            if score > best_score:
                best, best_score = h, score
        if best is not None:
            return best, True, True
        best = max(healthy, key=lambda h: hashlib.sha256(
            f"{key}|{h.netloc}".encode()).digest())
        return best, False, True

    def _plan_prefix_placement(self, requests: list[GenerationRequest],
                               role: str = "full") -> list[_Host | None]:
        """Group the wave by preamble key and give each group's sticky
        host its fair share, ``ceil(group / healthy hosts)`` members; the
        rest spread through the rotation (counted as fallback).  A group
        that spreads past a host predicted warm prefetches the preamble
        into the siblings (``_kv_prefetch_spread``)."""
        out: list[_Host | None] = [None] * len(requests)
        if not self.prefix_route:
            return out
        healthy_n = max(1, sum(h.healthy for h in self._role_pool(role)))
        groups: dict[str, list[int]] = {}
        for idx, req in enumerate(requests):
            key = preamble_key(req.system_prompt, req.prompt,
                               req.cache_prefix)
            if key is not None:
                groups.setdefault(key, []).append(idx)
        for key, members in groups.items():
            prefer, predicted, eligible = self._prefix_target(
                requests[members[0]], role)
            share = -(-len(members) // healthy_n)
            if (self.kv_migrate and predicted and prefer is not None
                    and share < len(members)):
                self._kv_prefetch_spread(prefer, key, role)
            for k, idx in enumerate(members):
                sticky = prefer if k < share else None
                out[idx] = sticky
                if not eligible:
                    continue
                with self._stats_lock:
                    if sticky is not None:
                        self._prefix_routed += 1
                        self._prefix_predicted += predicted
                    else:
                        self._prefix_fallback += 1
        return out

    # ------------------------------------------------ the /v1/kv spread

    def _kv_call(self, host: _Host, path: str, body: dict) -> tuple[int, dict]:
        """One control-plane POST; a transport failure reads as 502."""
        conn = None
        try:
            conn = http.client.HTTPConnection(host.netloc, timeout=30.0)
            conn.request("POST", path, body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            try:
                doc = json.loads(raw) if raw else {}
            except ValueError:
                doc = {}
            return resp.status, doc
        except (OSError, http.client.HTTPException) as e:
            return 502, {"error": {"message": f"{host.netloc}: "
                                              f"{type(e).__name__}: {e}"}}
        finally:
            if conn is not None:
                conn.close()

    def _kv_prefetch_spread(self, warm: _Host, key: str, role: str) -> None:
        """A wave's preamble group is about to spread past its warm host:
        the siblings that serve the rest pull the page set from it now
        instead of re-prefilling it.  Deduplicated per (sibling, preamble)
        within a summary TTL; queued on the pool, so placement never waits
        on a copy."""
        now = self._clock()
        targets: list[_Host] = []
        with self._kv_lock:
            for h in self._role_pool(role):
                if h is warm or not h.healthy:
                    continue
                k = (h.netloc, key)
                if now - self._kv_prefetched.get(k, -1e9) < self.summary_ttl_s:
                    continue
                self._kv_prefetched[k] = now
                targets.append(h)
            while len(self._kv_prefetched) > self._kv_prefetched_max:
                self._kv_prefetched.pop(next(iter(self._kv_prefetched)))
        for h in targets:
            self._pool.submit(self._kv_prefetch_one, warm, h, key)

    def _kv_prefetch_one(self, src: _Host, dst: _Host, key: str) -> None:
        """One prefetch leg (pool thread): export on ``src`` (404: cold or
        busy, nothing to do), then a pull-import on ``dst``, which fetches
        the blob and acks the ticket.  A failed leg leaves ``dst`` cold."""
        status, doc = self._kv_call(src, "/v1/kv/export", {"preamble": key})
        if status != 200 or not doc.get("ticket"):
            return
        status, _ = self._kv_call(dst, "/v1/kv/import",
                                  {"ticket": doc["ticket"],
                                   "source": src.netloc})
        self._count("_kv_prefetches" if status == 200 else "_kv_failures")

    # ------------------------------------------------------ request paths

    def _disagg_ready(self) -> bool:
        """Both role pools have members and a healthy host each; anything
        less serves colocated."""
        if not (self.pools["prefill"] and self.pools["decode"]):
            return False
        return (any(h.healthy for h in self.pools["prefill"])
                and any(h.healthy for h in self.pools["decode"]))

    def _one(self, i: int, req: GenerationRequest, on_tokens,
             cancelled: set[int], prefer: _Host | None = None
             ) -> GenerationResult:
        # trace ingress for engine-protocol callers: every forward, retry
        # and handoff leg resends the id, so one request is one trace
        if req.trace_id is None:
            req.trace_id = new_trace_id()
        if prefer is None:
            # no prefix opinion: tenant placement, the weakest preference
            prefer = self._tenant_pref(
                req, "prefill" if self._disagg_ready() else "full")
        if self._disagg_ready():
            res = self._one_disagg(i, req, on_tokens, cancelled, prefer)
            if res is not None:
                return res
            # the two-tier flow degraded (no ticket, decode pool dark,
            # ticket gone): re-prefill colocated on any host
            self._count("_handoff_fallbacks")
            logger.warning("request %d: handoff degraded; re-prefilling "
                           "colocated", req.request_id)
            prefer = None
        # tail hedging, read per request (a live router can be flipped):
        # non-streamed only, since a duplicated stream would double every
        # delta the client already holds
        hedge_ms = env_float("LMRS_HEDGE_MS", 0.0, lo=0.0)
        if hedge_ms > 0 and on_tokens is None and len(self.hosts) > 1:
            return self._one_hedged(i, req, cancelled, prefer, hedge_ms)
        return self._one_colocated(i, req, on_tokens, cancelled, prefer)

    def _one_colocated(self, i: int, req: GenerationRequest, on_tokens,
                       cancelled: set[int], prefer: _Host | None = None
                       ) -> GenerationResult:
        rid = req.request_id
        last_err = "no healthy backend"
        for attempt, host in enumerate(self._targets(i, "full", prefer)[:2]):
            if rid in cancelled:
                return GenerationResult(request_id=rid,
                                        finish_reason="cancelled")
            rem = remaining_budget(req)
            if rem is not None and rem <= 0:
                # no budget left for a second host
                return GenerationResult(request_id=rid,
                                        finish_reason="deadline")
            streamed = [0]  # deltas already forwarded for this request
            try:
                t_leg = time.time()
                res = self._post(host, req, on_tokens, streamed, cancelled)
                if on_tokens is None:
                    # the hedge delay's pool holds non-streamed walls only
                    # (SSE walls are client-paced)
                    self._note_latency(time.time() - t_leg)
                host.note_served()
                host.healthy = True
                self._note_tenant_host(req, host)
                return res
            except Exception as e:  # noqa: BLE001 - degrade per request
                if rid in cancelled:  # the hangup WE caused
                    return GenerationResult(request_id=rid,
                                            finish_reason="cancelled")
                host.note_failed()
                if isinstance(e, _HostConnectError):
                    host.healthy = False
                last_err = f"{host.netloc}: {type(e).__name__}: {e}"
                logger.warning("request %d failed on %s (attempt %d): %s",
                               rid, host.netloc, attempt + 1, last_err)
                if streamed[0]:
                    # a retry would replay deltas already forwarded
                    break
        return GenerationResult(request_id=rid, finish_reason="error",
                                error=last_err)

    # ------------------------------------------------------- tail hedging

    def _note_latency(self, dt: float) -> None:
        """One successful non-streamed completion wall (the hedge delay's
        p99 sample pool)."""
        with self._stats_lock:
            self._lat_s.append(dt)

    def _hedge_delay_s(self, hedge_ms: float) -> float:
        """How long the primary leg may run before the hedge launches: the
        p99 of the observed walls once 20 exist (a hedge chases tail
        stragglers only), floored at ``LMRS_HEDGE_MS``."""
        base = hedge_ms / 1000.0
        with self._stats_lock:
            lat = sorted(self._lat_s)
        if len(lat) >= 20:
            return max(base, lat[int(0.99 * (len(lat) - 1))])
        return base

    def _one_hedged(self, i: int, req: GenerationRequest,
                    cancelled: set[int], prefer: _Host | None,
                    hedge_ms: float) -> GenerationResult:
        """Colocated dispatch with tail hedging: the primary leg runs on
        the first-choice host; if it has not answered within the hedge
        delay, a duplicate leg launches on the next host.  The first
        non-error result wins; every other leg is hung up (the server's
        disconnect detection cancels it and frees its slot and pages).  A
        primary that fails fast still gets the sibling, as a plain failover
        leg (no hedge counted), so arming the knob never costs the
        two-host availability of ``_one_colocated``.  A backend-answered
        error result does not feed the breaker."""
        rid = req.request_id
        rem = remaining_budget(req)
        if rem is not None and rem <= 0:
            return GenerationResult(request_id=rid, finish_reason="deadline")
        targets = self._targets(i, "full", prefer)
        primary = targets[0]
        sibling = targets[1] if len(targets) > 1 else None
        # the losers' abort mark, set before the hangup: a loser still
        # before connect (its in-flight target a socketless connection
        # whose close does nothing) aborts itself at _post's re-check
        aborted: set[int] = set()

        class _Either:
            __slots__ = ()

            def __contains__(_self, x) -> bool:
                return x in cancelled or x in aborted

        leg_cancel = _Either()

        def leg(host: _Host, key) -> GenerationResult:
            t0 = time.time()
            res = self._post(host, req, None, [0], leg_cancel,
                             inflight_key=key)
            self._note_latency(time.time() - t0)
            return res

        def spawn(host: _Host, key) -> Future:
            # a daemon thread a leg, not the dispatch pool: _one already
            # runs on a pool thread, and legs queued behind a saturated
            # wave would deadlock it
            fut: Future = Future()

            def run_leg():
                if not fut.set_running_or_notify_cancel():
                    return
                try:
                    fut.set_result(leg(host, key))
                except BaseException as e:  # noqa: BLE001 - future carries
                    fut.set_exception(e)

            threading.Thread(target=run_leg, daemon=True,
                             name=f"lmrs-hedge-{rid}").start()
            return fut

        legs: dict = {}  # future -> (host, in-flight key, is_hedge)
        fut_p = spawn(primary, rid)
        legs[fut_p] = (primary, rid, False)
        delay_s = self._hedge_delay_s(hedge_ms)
        _done, running = futures_wait({fut_p}, timeout=delay_s)
        if running and sibling is not None and rid not in cancelled:
            try:
                # injection site: "raise" abandons this hedge (the primary
                # continues alone: hedging is an optimization), "stall"
                # delays its launch
                faults.fire("router.hedge")
            except faults.InjectedFault:
                logger.warning("hedge launch for %d abandoned", rid,
                               exc_info=True)
            else:
                fut_h = spawn(sibling, ("hedge", rid))
                legs[fut_h] = (sibling, ("hedge", rid), True)
                self._count("_hedges")
                logger.info("request %d: hedged to %s after %.0f ms",
                            rid, sibling.netloc, delay_s * 1e3)
        winner: GenerationResult | None = None
        error_res: GenerationResult | None = None
        last_err = "no healthy backend"
        pending = set(legs)
        while pending and winner is None:
            done, pending = futures_wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                host, _key, is_hedge = legs[f]
                try:
                    res = f.result()
                except Exception as e:  # noqa: BLE001 - per-leg degrade
                    if rid in cancelled:
                        winner = GenerationResult(request_id=rid,
                                                  finish_reason="cancelled")
                        break
                    host.note_failed()
                    if isinstance(e, _HostConnectError):
                        host.healthy = False
                    last_err = f"{host.netloc}: {type(e).__name__}: {e}"
                    logger.warning("hedge leg for %d failed on %s: %s",
                                   rid, host.netloc, last_err)
                    # this leg died: with no other leg running and the
                    # sibling never tried, launch it as a plain failover
                    if (not pending and sibling is not None
                            and not any(h is sibling
                                        for h, _k, _x in legs.values())
                            and rid not in cancelled):
                        fut_f = spawn(sibling, ("hedge", rid))
                        legs[fut_f] = (sibling, ("hedge", rid), False)
                        pending = {fut_f}
                    continue
                if res.finish_reason != "error":
                    host.note_served()
                    host.healthy = True
                    self._note_tenant_host(req, host)
                    if is_hedge:
                        self._count("_hedge_wins")
                    winner = res
                    break
                # a backend-answered error: the host served it, so it feeds
                # neither the breaker nor a failover; it is the outcome
                # unless another leg wins outright
                host.note_served()
                error_res = res
                last_err = res.error or "backend error"
        # hang up the losers: abort mark first, then the socket
        if winner is not None and any(not f.done() for f in legs):
            aborted.add(rid)
        for f, (_host, key, _h) in legs.items():
            if not f.done():
                with self._inflight_lock:
                    target = self._inflight.get(key)
                self._hangup(target)
        if winner is not None:
            return winner
        if error_res is not None:
            return error_res
        return GenerationResult(request_id=rid, finish_reason="error",
                                error=last_err)

    def _one_disagg(self, i: int, req: GenerationRequest, on_tokens,
                    cancelled: set[int], prefer: _Host | None = None
                    ) -> GenerationResult | None:
        """The two-tier flow: the prefill pool mints a ticket, the decode
        pool follows it.  None falls back to a colocated re-prefill (no
        ticket, decode attempts exhausted, ticket gone) — except once
        deltas have streamed, when the failure surfaces.  A dead decode
        host never acks; the prefill side's orphan sweep reclaims its
        pins."""
        rid = req.request_id
        ticket = None
        for host in self._targets(i, "prefill", prefer)[:2]:
            if rid in cancelled:
                return GenerationResult(request_id=rid,
                                        finish_reason="cancelled")
            rem = remaining_budget(req)
            if rem is not None and rem <= 0:
                return GenerationResult(request_id=rid,
                                        finish_reason="deadline")
            try:
                kind, out = self._post_prefill(host, req, cancelled)
            except Exception as e:  # noqa: BLE001 - degrade per host
                if rid in cancelled:
                    return GenerationResult(request_id=rid,
                                            finish_reason="cancelled")
                host.note_failed()
                if isinstance(e, _HostConnectError):
                    host.healthy = False
                logger.warning("prefill leg for %d failed on %s: %s: %s",
                               rid, host.netloc, type(e).__name__, e)
                continue
            host.healthy = True
            if kind == "result":
                if out.finish_reason == "error":
                    host.note_failed()
                    continue
                # a terminal first token: the prefill answer is the whole
                # completion
                host.note_served()
                if on_tokens is not None and out.text:
                    on_tokens(rid, out.text)
                return out
            ticket = out
            host.note_served()
            break
        if ticket is None:
            return None
        self._count("_handoffs")
        extra = {"handoff": {"ticket": ticket["ticket"],
                             "source": ticket["source"]}}
        streamed = [0]
        for host in self._targets(i + 1, "decode")[:2]:
            if rid in cancelled:
                return GenerationResult(request_id=rid,
                                        finish_reason="cancelled")
            rem = remaining_budget(req)
            if rem is not None and rem <= 0:
                # the budget ran out between the legs: the first token is
                # real output, kept as a deadline result
                first = str(ticket.get("first_text") or "")
                if first and on_tokens is not None and not streamed[0]:
                    on_tokens(rid, first)
                return GenerationResult(
                    request_id=rid, text=first,
                    prompt_tokens=int(ticket.get("prompt_tokens", 0) or 0),
                    completion_tokens=int(ticket.get("completion_tokens",
                                                     0) or 0),
                    finish_reason="deadline")
            try:
                res = self._post(host, req, on_tokens, streamed, cancelled,
                                 body_extra=extra)
            except Exception as e:  # noqa: BLE001 - degrade per host
                if rid in cancelled:
                    return GenerationResult(request_id=rid,
                                            finish_reason="cancelled")
                host.note_failed()
                if isinstance(e, _HostConnectError):
                    host.healthy = False
                self._count("_handoff_retries")
                logger.warning("decode leg for %d failed on %s: %s: %s",
                               rid, host.netloc, type(e).__name__, e)
                if streamed[0]:
                    return GenerationResult(
                        request_id=rid, finish_reason="error",
                        error=f"{host.netloc}: {type(e).__name__}: {e}")
                continue
            if res.finish_reason == "error":
                # a marked handoff failure (410, duplicate, transfer,
                # import): try a sibling while the ticket may live
                host.note_failed()
                self._count("_handoff_retries")
                logger.warning("decode leg for %d rejected on %s: %s",
                               rid, host.netloc, res.error)
                if streamed[0]:
                    return res
                continue
            host.note_served()
            host.healthy = True
            return res
        return None if not streamed[0] else GenerationResult(
            request_id=rid, finish_reason="error",
            error="handoff decode attempts exhausted mid-stream")

    def _post_prefill(self, host: _Host, req: GenerationRequest,
                      cancelled: set[int]):
        """POST the prefill leg (``"handoff": true``, never streamed):
        ``("ticket", desc)`` with ``source`` set to the answering host, or
        ``("result", GenerationResult)`` when the first token was terminal
        (or the leg failed)."""
        body = _request_body(req)
        body["handoff"] = True
        rid = req.request_id
        timeout = self.timeout_s
        rem = remaining_budget(req)
        if rem is not None:
            timeout = max(1.0, min(timeout, rem + 5.0))
        conn = host.connect(timeout)
        host.note_leg(+1)
        with self._inflight_lock:
            self._inflight[rid] = conn
        try:
            try:
                conn.connect()
            except OSError as e:
                raise _HostConnectError(str(e)) from e
            with self._inflight_lock:
                self._inflight[rid] = conn.sock
            headers = {"Content-Type": "application/json"}
            if req.trace_id:
                headers["X-LMRS-Trace"] = req.trace_id
            if req.tenant:
                headers["X-LMRS-Tenant"] = req.tenant
            self._trace_route(req, host)
            conn.request("POST", "/v1/chat/completions",
                         body=json.dumps(body), headers=headers)
            if rid in cancelled:
                raise ConnectionAbortedError("cancelled during connect")
            resp = conn.getresponse()
            if resp.status != 200:
                return "result", GenerationResult(
                    request_id=rid, finish_reason="error",
                    error=self._error_message(resp))
            data = json.loads(resp.read())
            if "handoff" in data:
                desc = dict(data["handoff"])
                desc.setdefault("source", host.netloc)
                return "ticket", desc
            choice = data["choices"][0]
            usage = data.get("usage") or {}
            return "result", GenerationResult(
                request_id=rid, text=choice["message"]["content"],
                prompt_tokens=int(usage.get("prompt_tokens", 0)),
                completion_tokens=int(usage.get("completion_tokens", 0)),
                finish_reason=choice.get("finish_reason") or "stop",
                usage=usage.get("cost") or None)
        finally:
            host.note_leg(-1)
            with self._inflight_lock:
                self._inflight.pop(rid, None)
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _post(self, host: _Host, req: GenerationRequest, on_tokens,
              streamed: list[int], cancelled: set[int],
              body_extra: dict | None = None,
              inflight_key=None) -> GenerationResult:
        body = _request_body(req)
        if body_extra:
            body.update(body_extra)
        if on_tokens is not None:
            body["stream"] = True
            body["stream_options"] = {"include_usage": True}
        timeout = self.timeout_s
        rem = remaining_budget(req)
        if rem is not None:
            # wait no longer than the budget plus slack for the server's
            # own deadline result
            timeout = max(1.0, min(timeout, rem + 5.0))
        conn = host.connect(timeout)
        host.note_leg(+1)
        rid = req.request_id
        # a hedge leg registers under its own key, so two legs of one rid
        # never clobber each other's hangup target
        key = rid if inflight_key is None else inflight_key
        with self._inflight_lock:
            self._inflight[key] = conn
        try:
            try:
                conn.connect()  # explicit: a connect failure = host down
            except OSError as e:
                raise _HostConnectError(str(e)) from e
            with self._inflight_lock:
                self._inflight[key] = conn.sock
            headers = {"Content-Type": "application/json"}
            if req.trace_id:
                headers["X-LMRS-Trace"] = req.trace_id
            if req.tenant:
                headers["X-LMRS-Tenant"] = req.tenant
            self._trace_route(req, host)
            conn.request("POST", "/v1/chat/completions",
                         body=json.dumps(body), headers=headers)
            # a cancel that closed the socketless conn before connect()
            # left no hangup behind: re-check now that the socket exists
            if rid in cancelled:
                raise ConnectionAbortedError("cancelled during connect")
            resp = conn.getresponse()
            if resp.status != 200:
                return GenerationResult(request_id=rid, finish_reason="error",
                                        error=self._error_message(resp))
            if on_tokens is not None:
                return self._read_sse(resp, req, on_tokens, streamed,
                                      cancelled)
            data = json.loads(resp.read())
            choice = data["choices"][0]
            usage = data.get("usage") or {}
            return GenerationResult(
                request_id=rid,
                text=choice["message"]["content"],
                prompt_tokens=int(usage.get("prompt_tokens", 0)),
                completion_tokens=int(usage.get("completion_tokens", 0)),
                finish_reason=choice.get("finish_reason") or "stop",
                usage=usage.get("cost") or None)
        finally:
            host.note_leg(-1)
            with self._inflight_lock:
                self._inflight.pop(key, None)
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _error_message(resp) -> str:
        try:
            data = json.loads(resp.read())
            return (data.get("error") or {}).get("message",
                                                 f"HTTP {resp.status}")
        except Exception:  # noqa: BLE001 - malformed error body
            return f"HTTP {resp.status}"

    def _read_sse(self, resp, req: GenerationRequest, on_tokens,
                  streamed: list[int], cancelled: set[int]) -> GenerationResult:
        """Consume a chat.completion.chunk stream, forwarding content
        deltas; the terminal chunk carries finish_reason and usage.  A
        cancel's hangup keeps the deltas received; any other stream that
        ends before [DONE] is a failure (the SSE body has no length, so a
        dead server reads as a clean EOF)."""
        rid = req.request_id
        text_parts: list[str] = []
        finish = "stop"
        usage: dict = {}
        done_seen = False
        try:
            for raw in resp:
                # injection site: a mid-stream fault ("raise": a worker
                # dying mid-response, no retry once deltas went out;
                # "stall": a backend gone slow)
                faults.fire("router.recv", OSError)
                line = raw.decode("utf-8", "replace").strip()
                if not line.startswith("data:"):
                    continue
                data = line[5:].strip()
                if data == "[DONE]":
                    done_seen = True
                    break
                evt = json.loads(data)
                if "error" in evt:
                    return GenerationResult(
                        request_id=rid, finish_reason="error",
                        error=evt["error"].get("message", "?"))
                choice = evt["choices"][0]
                piece = (choice.get("delta") or {}).get("content")
                if piece:
                    text_parts.append(piece)
                    streamed[0] += 1
                    on_tokens(rid, piece)
                if choice.get("finish_reason"):
                    finish = choice["finish_reason"]
                if evt.get("usage"):
                    usage = evt["usage"]
        except OSError:
            if rid not in cancelled:
                raise
            finish = "cancelled"
            done_seen = True
        if not done_seen:
            if rid in cancelled:
                finish = "cancelled"
            else:
                raise ConnectionResetError(
                    "SSE stream ended before [DONE] "
                    f"({len(text_parts)} deltas received)")
        return GenerationResult(
            request_id=rid, text="".join(text_parts),
            prompt_tokens=int(usage.get("prompt_tokens", 0)),
            completion_tokens=int(usage.get("completion_tokens",
                                            len(text_parts))),
            finish_reason=finish, usage=usage.get("cost") or None)
