"""Elastic pool autoscaling on the SLO/ledger substrate (a copy of the
reference's ``fleet/autoscale.py``).

A control loop (default OFF — ``LMRS_AUTOSCALE=1`` arms it) over a live
:class:`~lmrs_tpu_torch.serving.router.RouterEngine`.  Each tick reads the
signals the router already maintains — per-host published SLO burn
states (obs/slo.py, cached from ``/healthz`` summaries), per-host
in-flight leg counts, and the fleet's request throughput (served-counter
deltas smoothed into a short-horizon EWMA forecast) — and resizes the
pool:

* **scale up** when the burning fraction of the healthy fleet reaches
  half (hosts converting overload into deadline misses need relief
  BEFORE breakers start opening) or the average in-flight depth exceeds
  the high watermark while the forecast is still rising;
* **scale down** when the forecast has idled below the low-rate
  watermark with zero burn and zero in-flight work — and only ever a
  host this autoscaler spawned: operator-configured capacity is never
  torn down.  The victim DRAINS first (``router.drain_host``: it leaves
  the dispatch order but keeps its in-flight legs), is polled idle
  across ticks, then removed and torn down; a drain that cannot go idle
  within the timeout is force-removed so a wedged victim cannot pin the
  loop.

Spawning and teardown are **injectable callbacks**: production passes
:class:`SupervisedHostPool` (each scale-up launches one ``lmrs-serve-torch
--supervise`` child, so new capacity arrives under the supervisor's
watchdog/respawn umbrella — serving/supervisor.py); tests pass fakes.
The loop only touches the router's public elasticity surface
(``add_host`` / ``drain_host`` / ``host_idle`` / ``remove_host``), so it
composes identically with mock fleets and real pods.

Kill-switch contract: with ``LMRS_AUTOSCALE=0`` (the default)
:func:`maybe_autoscaler` returns None and nothing in the serving path
changes — the knob is opt-in because resizing spawns PROCESSES.
"""

from __future__ import annotations

import http.client
import logging
import socket
import subprocess
import sys
import threading
import time

from lmrs_tpu_torch.obs.trace import get_tracer
from lmrs_tpu_torch.testing.faults import InjectedFault
from lmrs_tpu_torch.utils.env import env_bool, env_float, env_int

logger = logging.getLogger("lmrs_torch.fleet.autoscale")

# what a spawn or a tick may meet from the transport, a child's start-up or
# a payload: a degraded tick, never a dead loop.  A torch or CUDA error is
# none of these and raises
_FLEET_ERRORS = (OSError, http.client.HTTPException, ValueError,
                 InjectedFault)


def autoscale_enabled() -> bool:
    """The ``LMRS_AUTOSCALE`` master switch (default OFF: scaling spawns
    processes, so it is opt-in unlike the pure-bookkeeping QoS knobs)."""
    return env_bool("LMRS_AUTOSCALE", False)


class Autoscaler:
    """The control loop.  ``tick()`` makes at most one scaling decision
    and is directly callable (tests drive it with a fake clock);
    ``start()`` runs it on a daemon thread every ``interval_s``."""

    def __init__(self, router, spawn_cb, remove_cb=None,
                 clock=time.monotonic, registry=None,
                 enabled: bool | None = None,
                 interval_s: float | None = None,
                 min_hosts: int | None = None,
                 max_hosts: int | None = None,
                 role: str = "both",
                 up_inflight: float = 4.0,
                 down_rate_rps: float = 0.1,
                 ewma_alpha: float = 0.5,
                 cooldown_ticks: int = 3,
                 drain_timeout_s: float = 60.0):
        self.enabled = (autoscale_enabled() if enabled is None
                        else bool(enabled))
        self.router = router
        self.spawn_cb = spawn_cb          # () -> url | None
        self.remove_cb = remove_cb        # (netloc) -> None
        self.clock = clock
        self.interval_s = (env_float("LMRS_AUTOSCALE_INTERVAL_S", 10.0,
                                     lo=0.1)
                           if interval_s is None else float(interval_s))
        self.min_hosts = (env_int("LMRS_AUTOSCALE_MIN", 1, lo=1)
                          if min_hosts is None else int(min_hosts))
        self.max_hosts = (env_int("LMRS_AUTOSCALE_MAX", 8, lo=1)
                          if max_hosts is None else int(max_hosts))
        self.role = role
        self.up_inflight = float(up_inflight)
        self.down_rate_rps = float(down_rate_rps)
        self.ewma_alpha = float(ewma_alpha)
        self.cooldown_ticks = int(cooldown_ticks)
        self.drain_timeout_s = float(drain_timeout_s)
        # forecast + loop state: tick() runs on ONE thread (the loop or
        # a test), so these need no lock; the router calls we make are
        # individually thread-safe
        self._last_served: int | None = None
        self._last_t: float | None = None
        self._ewma_rps: float | None = None
        self._ticks_since_action = self.cooldown_ticks  # first tick may act
        self._draining: dict[str, float] = {}  # netloc -> drain start t
        self._spawned: set[str] = set()        # netlocs we created
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._c_up = self._c_down = self._c_drain = None
        self._g_pool = self._g_rps = None
        if registry is not None and self.enabled:
            self._c_up = registry.counter(
                "lmrs_autoscale_scale_ups_total",
                "hosts the autoscaler spawned into the fleet")
            self._c_down = registry.counter(
                "lmrs_autoscale_scale_downs_total",
                "hosts the autoscaler removed after a completed drain")
            self._c_drain = registry.counter(
                "lmrs_autoscale_drains_total",
                "scale-down drains the autoscaler started")
            self._g_pool = registry.gauge(
                "lmrs_autoscale_pool_size",
                "fleet hosts currently in the dispatch order "
                "(draining hosts excluded)")
            self._g_rps = registry.gauge(
                "lmrs_autoscale_forecast_rps",
                "EWMA short-horizon forecast of fleet request throughput",
                unit="seconds")

    # ------------------------------------------------------------- signals

    def _forecast(self, now: float) -> float:
        """Fold the served-counter delta since the last tick into the
        EWMA throughput forecast (requests/second)."""
        served = sum(h.served for h in self.router.hosts)
        if self._last_served is None or self._last_t is None:
            self._last_served, self._last_t = served, now
            return 0.0
        dt = max(now - self._last_t, 1e-6)
        rate = max(0, served - self._last_served) / dt
        self._last_served, self._last_t = served, now
        self._ewma_rps = (rate if self._ewma_rps is None
                          else self.ewma_alpha * rate
                          + (1.0 - self.ewma_alpha) * self._ewma_rps)
        if self._g_rps is not None:
            self._g_rps.set(self._ewma_rps)
        return self._ewma_rps

    # ---------------------------------------------------------------- loop

    def tick(self) -> dict:
        """One control decision.  Returns a summary of what it saw and
        did (the test/observability surface)."""
        now = self.clock()
        actions: list[str] = []
        tr = get_tracer()
        # 1. advance in-progress drains first: an idle victim completes
        #    its exit, a wedged one is force-removed at the timeout —
        #    either way the slot frees before any new decision
        for netloc, since in list(self._draining.items()):
            idle = self.router.host_idle(netloc)
            # a drain-triggered KV migration (router.migrations_pending,
            # LMRS_KV_MIGRATE) holds the removal like in-flight legs do:
            # force-removing mid-copy would tear warm pages off the pod
            # while a sibling is still pulling them.  The drain timeout
            # backstops a wedged migration exactly as it does a wedged
            # leg — getattr keeps fake routers in tests working.
            migrating = getattr(self.router, "migrations_pending",
                                lambda _n: False)(netloc)
            if ((not idle or migrating)
                    and now - since < self.drain_timeout_s):
                continue
            if self.router.remove_host(netloc, force=not idle):
                self._draining.pop(netloc, None)
                self._spawned.discard(netloc)
                if self.remove_cb is not None:
                    self.remove_cb(netloc)
                if self._c_down is not None:
                    self._c_down.inc()
                actions.append(f"removed:{netloc}"
                               + ("" if idle else ":forced"))
                if tr:
                    # fleet-drift contract (trace.py): every autoscaler
                    # resize is an auditable instant on the trace
                    tr.instant("autoscale_action",
                               args={"action": "removed", "host": netloc,
                                     "forced": not idle})
        rps = self._forecast(now)
        hosts = [h for h in self.router.hosts if not h.draining]
        healthy = [h for h in hosts if h.healthy]
        burning = sum(1 for h in healthy
                      if self.router._slo_penalty(h) >= 1)
        inflight = sum(h.inflight for h in hosts)
        avg_inflight = inflight / len(healthy) if healthy else 0.0
        size = len(hosts)
        self._ticks_since_action += 1
        if self._g_pool is not None:
            self._g_pool.set(size)
        if not self.enabled:
            return {"enabled": False, "pool": size, "actions": actions}
        # 2. at most one resize per tick, paced by the cooldown so one
        #    burst cannot staircase the fleet up before new capacity
        #    even absorbs traffic
        if self._ticks_since_action >= self.cooldown_ticks:
            want_up = (size < self.max_hosts
                       and ((healthy and 2 * burning >= len(healthy))
                            or avg_inflight > self.up_inflight))
            want_down = (size > self.min_hosts
                         and burning == 0 and inflight == 0
                         and self._ewma_rps is not None
                         and self._ewma_rps < self.down_rate_rps)
            if want_up:
                url = None
                try:
                    url = self.spawn_cb()
                except _FLEET_ERRORS:  # a failed spawn is a degraded
                    # tick, never a dead loop
                    logger.warning("autoscale spawn failed", exc_info=True)
                if url:
                    h = self.router.add_host(url, self.role)
                    self._spawned.add(h.netloc)
                    self._ticks_since_action = 0
                    if self._c_up is not None:
                        self._c_up.inc()
                    actions.append(f"spawned:{h.netloc}")
                    if tr:
                        tr.instant("autoscale_action",
                                   args={"action": "spawned",
                                         "host": h.netloc})
                    logger.info("autoscale UP -> %s (burning %d/%d, "
                                "inflight %.1f/host, forecast %.2f rps)",
                                h.netloc, burning, len(healthy),
                                avg_inflight, rps)
            elif want_down:
                victim = next((h for h in hosts
                               if h.netloc in self._spawned
                               and h.netloc not in self._draining), None)
                if victim is not None and self.router.drain_host(
                        victim.netloc):
                    self._draining[victim.netloc] = now
                    self._ticks_since_action = 0
                    if self._c_drain is not None:
                        self._c_drain.inc()
                    actions.append(f"draining:{victim.netloc}")
                    if tr:
                        tr.instant("autoscale_action",
                                   args={"action": "draining",
                                         "host": victim.netloc})
                    logger.info("autoscale DOWN: draining %s "
                                "(forecast %.2f rps)", victim.netloc, rps)
        return {"enabled": True, "pool": size, "healthy": len(healthy),
                "burning": burning, "inflight": inflight,
                "forecast_rps": round(rps, 3),
                "draining": sorted(self._draining), "actions": actions}

    def report(self) -> dict:
        """Observability snapshot (no side effects, no decisions)."""
        hosts = [h for h in self.router.hosts if not h.draining]
        return {"object": "autoscale", "enabled": self.enabled,
                "pool": len(hosts),
                "min": self.min_hosts, "max": self.max_hosts,
                "forecast_rps": round(self._ewma_rps or 0.0, 3),
                "spawned": sorted(self._spawned),
                "draining": sorted(self._draining)}

    def start(self) -> "Autoscaler":
        if self._thread is None and self.enabled:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="lmrs-autoscale")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except _FLEET_ERRORS:  # the loop survives a transient
                # router or transport error; the next tick retries
                logger.warning("autoscale tick failed", exc_info=True)


class SupervisedHostPool:
    """Production spawn/remove callbacks: each scale-up launches one
    ``lmrs-serve-torch --supervise`` child (serving/cli.py) on a freshly
    bound port, waits for its ``/healthz``, and hands the URL to the
    autoscaler; scale-down terminates the supervisor (which takes its
    child down with it).  Pass ``pool.spawn`` / ``pool.remove`` as the
    Autoscaler callbacks."""

    def __init__(self, base_argv=("--backend", "mock"),
                 host: str = "127.0.0.1", startup_timeout_s: float = 30.0):
        self.base_argv = list(base_argv)
        self.host = host
        self.startup_timeout_s = float(startup_timeout_s)
        self._procs: dict[str, object] = {}  # netloc -> Popen
        self._lock = threading.Lock()

    @staticmethod
    def _free_port(host: str) -> int:
        with socket.socket() as s:
            s.bind((host, 0))
            return s.getsockname()[1]

    def _wait_healthy(self, netloc: str) -> bool:
        deadline = time.monotonic() + self.startup_timeout_s
        while time.monotonic() < deadline:
            conn = None
            try:
                conn = http.client.HTTPConnection(netloc, timeout=2.0)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    return True
            except OSError:
                pass
            finally:
                if conn is not None:
                    conn.close()
            time.sleep(0.25)
        return False

    def spawn(self) -> str | None:
        port = self._free_port(self.host)
        netloc = f"{self.host}:{port}"
        argv = [sys.executable, "-m", "lmrs_tpu_torch.serving.cli",
                "--supervise", "--host", self.host, "--port", str(port),
                "--quiet", *self.base_argv]
        try:
            proc = subprocess.Popen(argv)
        except OSError:
            logger.warning("supervised spawn exec failed", exc_info=True)
            return None
        if not self._wait_healthy(netloc):
            logger.warning("spawned host %s never became healthy; "
                           "terminating", netloc)
            proc.terminate()
            return None
        with self._lock:
            self._procs[netloc] = proc
        return f"http://{netloc}"

    def remove(self, netloc: str) -> None:
        with self._lock:
            proc = self._procs.pop(netloc, None)
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:  # a stubborn supervisor
            proc.kill()
            proc.wait()

    def shutdown(self) -> None:
        with self._lock:
            netlocs = list(self._procs)
        for netloc in netlocs:
            self.remove(netloc)


def maybe_autoscaler(router, spawn_cb, remove_cb=None,
                     registry=None, **kw) -> Autoscaler | None:
    """The wiring-site factory: a live (not yet started) autoscaler, or
    None when ``LMRS_AUTOSCALE`` is off — callers guard on ``is not
    None`` so the disarmed serving path is byte-for-byte unchanged."""
    if not autoscale_enabled():
        return None
    return Autoscaler(router, spawn_cb, remove_cb=remove_cb,
                      registry=registry, enabled=True, **kw)
