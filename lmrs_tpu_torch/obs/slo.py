"""Fleet SLO engine: declarative objectives -> burn-rate health states.

The serving stack's health signals were binary (breaker open/closed,
wedged 503) while its promises are statistical: TTFT p95, steady-state
block-gap p95, deadline-miss rate, error/wedge rate, goodput tokens/s.
``SLOEngine`` evaluates declarative :class:`SLOSpec` objectives over TWO
sliding windows — a fast window that reacts and a slow window that
confirms — into one graded state ``ok | warn | critical`` per spec and
for the host:

* **burn rate** = observed / target for latency percentiles and failure
  rates (target / observed for the goodput floor) — 1.0 means the
  objective is being consumed exactly at its budget;
* a spec breaches only when BOTH windows burn (the classic
  multi-window rule: the fast window catches it quickly, the slow
  window keeps a single bad second from paging);
* the host state is the worst spec state, with **flap damping**:
  upgrades (toward worse) apply immediately, downgrades must hold for
  ``hold_s`` — a host oscillating across the threshold reads as
  degraded, not as a strobe;
* a transition INTO ``critical`` fires a flight-recorder postmortem
  (reason ``"slo"``, obs/flight.py) so the window that breached is
  captured, not inferred later.

Consumers: ``/healthz`` exports the evaluation (the router's SLO-aware
placement penalty reads it — serving/router.py), ``lmrs_slo_*`` metrics
ride the engine registry, and ``metrics_report()``/bench detail carry
the same doc.  ``LMRS_SLO=0`` disables the engine entirely (every feed
is a no-op, the report pins ``ok``); router-side consumption has its own
``LMRS_SLO_ROUTE`` kill switch.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

from lmrs_tpu_torch.utils.env import env_bool, env_float, env_str

logger = logging.getLogger("lmrs_torch.obs.slo")

STATES = ("ok", "warn", "critical")
_STATE_RANK = {s: i for i, s in enumerate(STATES)}


def state_rank(state: str | None) -> int:
    """Numeric severity of a state string; unknown/absent reads as ok
    (0) — a host that publishes nothing must not be penalized for it."""
    return _STATE_RANK.get(state or "ok", 0)


def worst_state(states) -> str:
    """The worst of an iterable of state strings (``ok`` when empty)."""
    best = 0
    for s in states:
        best = max(best, state_rank(s))
    return STATES[best]


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``kind``:
      * ``latency_p95`` — ``target`` is a p95 ceiling in ms over the
        spec's sample series;
      * ``rate`` — ``target`` is a failure-fraction ceiling over the
        window's finished requests;
      * ``throughput_min`` — ``target`` is a tokens/s floor (0 disables
        the spec: a floor only means something for a sized deployment).
    """

    name: str
    kind: str
    target: float


DEFAULT_SPECS: tuple[SLOSpec, ...] = (
    SLOSpec("ttft_p95_ms", "latency_p95", 2000.0),
    SLOSpec("block_gap_p95_ms", "latency_p95", 1500.0),
    SLOSpec("deadline_miss_rate", "rate", 0.05),
    SLOSpec("error_rate", "rate", 0.05),
    SLOSpec("goodput_tok_s", "throughput_min", 0.0),
)


def specs_from_env() -> tuple[SLOSpec, ...]:
    """DEFAULT_SPECS with ``LMRS_SLO_SPEC`` JSON overrides applied —
    ``{"ttft_p95_ms": 150, "goodput_tok_s": 40}`` retargets by spec
    name.  Unknown names and non-finite values warn and are ignored (the
    env contract: bad values keep defaults, never crash serving)."""
    raw = env_str("LMRS_SLO_SPEC")
    specs = {s.name: s for s in DEFAULT_SPECS}
    if raw:
        try:
            overrides = json.loads(raw)
            if not isinstance(overrides, dict):
                raise ValueError("want a JSON object of name -> target")
            import math

            for name, target in overrides.items():
                # per-item: one bad value must not abort the loop with
                # earlier overrides half-applied (warn-and-ignore, like
                # unknown names)
                try:
                    t = float(target)
                except (ValueError, TypeError):
                    t = float("nan")
                if name not in specs or not math.isfinite(t):
                    logger.warning("LMRS_SLO_SPEC: ignoring %r=%r "
                                   "(unknown spec or bad target)",
                                   name, target)
                    continue
                specs[name] = SLOSpec(name, specs[name].kind, t)
        except (ValueError, TypeError) as e:
            logger.warning("LMRS_SLO_SPEC unparseable (%s); using "
                           "defaults", e)
    return tuple(specs.values())


class SLOEngine:
    """Sliding-window evaluator over the serving stream's own samples.

    Fed from the measurement sites the metrics already ride (TTFT
    samples, block-gap samples, finished results); evaluation is pulled
    by the report surfaces and throttled-pushed from ``note_result`` so
    a critical breach fires its postmortem near the breach, not at the
    next scrape.  ``clock`` is injectable (tests drive window decay and
    damping deterministically)."""

    def __init__(self, registry=None, specs: tuple[SLOSpec, ...] | None = None,
                 fast_s: float | None = None, slow_s: float | None = None,
                 hold_s: float | None = None, critical_burn: float = 2.0,
                 min_events: int = 4, clock=time.monotonic,
                 enabled: bool | None = None, metrics_cb=None):
        self.enabled = (env_bool("LMRS_SLO", True) if enabled is None
                        else bool(enabled))
        self.specs = specs if specs is not None else specs_from_env()
        self.fast_s = (env_float("LMRS_SLO_FAST_S", 60.0, lo=1.0)
                       if fast_s is None else float(fast_s))
        self.slow_s = (env_float("LMRS_SLO_SLOW_S", 600.0, lo=1.0)
                       if slow_s is None else float(slow_s))
        self.slow_s = max(self.slow_s, self.fast_s)
        # downgrade dwell: a state must hold this long after its last
        # trigger before it may relax (flap damping)
        self.hold_s = self.fast_s if hold_s is None else float(hold_s)
        self.critical_burn = float(critical_burn)
        self.min_events = int(min_events)
        self.clock = clock
        self._metrics_cb = metrics_cb  # postmortem metrics snapshot
        self._lock = threading.Lock()
        # serializes whole evaluations so two concurrent pulls can't
        # interleave their state-machine publishes; the sample lock
        # (self._lock) is only ever taken INSIDE it, never around it —
        # the scheduler's feed path (observe_*/note_result appends) must
        # never wait behind a health probe's window sort
        self._eval_lock = threading.Lock()
        # sample series, (t, value) pairs trimmed to the slow window
        self._ttft: deque = deque()    # guarded-by: _lock
        self._gaps: deque = deque()    # guarded-by: _lock
        # (t, miss, err, goodput_tokens) per finished request
        self._events: deque = deque()  # guarded-by: _lock
        self._state = "ok"             # guarded-by: _lock
        self._state_since = clock()    # guarded-by: _lock
        self._last_eval = 0.0          # guarded-by: _lock
        # guarded-by: _lock
        self._last_doc: dict = {"enabled": self.enabled, "state": "ok",
                                "raw_state": "ok", "specs": {}}
        self._g_state = self._g_warn = self._g_crit = None
        self._c_evals = self._c_crit = None
        # no registration when disabled: the kill switch promises NO
        # lmrs_slo_* series, not series pinned at ok (CostLedger rule)
        if registry is not None and self.enabled:
            g, c = registry.gauge, registry.counter
            self._g_state = g("lmrs_slo_state",
                              "host SLO burn-rate state "
                              "(0=ok, 1=warn, 2=critical)")
            self._g_warn = g("lmrs_slo_specs_warn",
                             "SLO specs currently in warn")
            self._g_crit = g("lmrs_slo_specs_critical",
                             "SLO specs currently in critical")
            self._c_evals = c("lmrs_slo_evaluations_total",
                              "SLO window evaluations performed")
            self._c_crit = c("lmrs_slo_critical_transitions_total",
                             "transitions into the critical state "
                             "(each fires an 'slo' postmortem)")

    # --------------------------------------------------------------- feeds

    def observe_ttft(self, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._ttft.append((self.clock(), seconds * 1e3))

    def observe_gap(self, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gaps.append((self.clock(), seconds * 1e3))

    def note_result(self, finish_reason: str, tokens: int = 0,
                    error: str | None = None) -> None:
        """One finished request: deadline outcomes count against the
        miss-rate spec, errors/wedges against the error-rate spec, and
        usable completion tokens toward the goodput floor."""
        if not self.enabled:
            return
        miss = finish_reason in ("deadline", "shed")
        err = error is not None or finish_reason in ("error", "wedged")
        goodput = 0 if (miss or err) else max(0, int(tokens))
        with self._lock:
            now = self.clock()
            self._events.append((now, miss, err, goodput))
            # throttled in-line evaluation: a critical breach must fire
            # its postmortem near the breach, not at the next scrape
            due = now - self._last_eval >= max(1.0, self.fast_s / 8.0)
        if due:
            self._fire_postmortem(self._evaluate(now))

    # ---------------------------------------------------------- evaluation

    def _trim_locked(self, now: float) -> None:  # holds-lock: _lock
        """Caller holds self._lock."""
        horizon = now - self.slow_s
        for series in (self._ttft, self._gaps, self._events):
            while series and series[0][0] < horizon:
                series.popleft()

    @staticmethod
    def _p95(values: list[float]) -> float:
        if not values:
            return 0.0
        vs = sorted(values)
        return vs[min(len(vs) - 1, int(round(0.95 * (len(vs) - 1))))]

    @staticmethod
    def _window(series, now: float, span: float) -> list:
        return [row for row in series if row[0] >= now - span]

    def _spec_burn(self, spec: SLOSpec, snap: dict, now: float,
                   span: float) -> tuple:
        """(burn, observed) for one spec over one window of ``snap`` (a
        sample snapshot taken under the lock — the math runs outside
        it).  No data (or a volume below ``min_events`` — for every
        kind) burns 0 — an idle host is a healthy host, and one bad
        request out of one is a sample, not a rate."""
        if spec.kind == "latency_p95":
            series = (snap["ttft"] if spec.name.startswith("ttft")
                      else snap["gaps"])
            vals = [v for _, v in self._window(series, now, span)]
            if len(vals) < self.min_events or spec.target <= 0:
                return 0.0, 0.0
            if len(vals) < 20:
                # below 1/(1-0.95) samples the p95 order statistic IS the
                # max, so one cold-compile/GC outlier would drive the host
                # critical at startup — drop the single worst sample until
                # the window has the volume to vote it in (a genuinely
                # degraded host's samples are ALL slow, so it still burns)
                vals.remove(max(vals))
                if not vals:
                    return 0.0, 0.0
            obs = self._p95(vals)
            return obs / spec.target, obs
        events = self._window(snap["events"], now, span)
        if spec.kind == "rate":
            if len(events) < self.min_events or spec.target <= 0:
                return 0.0, 0.0
            idx = 1 if spec.name.startswith("deadline") else 2
            obs = sum(1 for e in events if e[idx]) / len(events)
            return obs / spec.target, obs
        # throughput_min: tokens/s over the TRAFFIC span, not the fixed
        # window — a freshly-started host (4 full-speed requests, 5 s of
        # life) or a bursty-but-healthy one must not read as below the
        # floor just because the 60 s window is mostly empty; target
        # 0 = off
        if spec.target <= 0 or len(events) < self.min_events:
            return 0.0, 0.0
        span_eff = max(min(span, now - events[0][0]), 1.0)
        obs = sum(e[3] for e in events) / span_eff
        return spec.target / max(obs, 1e-9), obs

    def _evaluate(self, now: float) -> dict | None:
        """One full evaluation: snapshot the sample series under the
        lock, run the window math OUTSIDE it (scans + p95 sorts over the
        slow window are O(n log n) — every /healthz probe pulls this,
        and the scheduler's feed path must never wait behind it), then
        publish the state transition under the lock again.  Whole
        evaluations serialize on ``_eval_lock`` so two concurrent pulls
        can't interleave their publishes.  Returns the postmortem
        payload when this evaluation transitioned INTO critical (the
        caller dumps it — the flight recorder writes files), else
        None."""
        with self._eval_lock:
            with self._lock:
                self._trim_locked(now)
                self._last_eval = now
                snap = {"ttft": list(self._ttft), "gaps": list(self._gaps),
                        "events": list(self._events)}
            spec_docs: dict[str, dict] = {}
            n_warn = n_crit = 0
            for spec in self.specs:
                burn_f, obs_f = self._spec_burn(spec, snap, now, self.fast_s)
                burn_s, obs_s = self._spec_burn(spec, snap, now, self.slow_s)
                eff = min(burn_f, burn_s)  # both windows must burn
                if eff >= self.critical_burn:
                    state = "critical"
                    n_crit += 1
                elif eff >= 1.0:
                    state = "warn"
                    n_warn += 1
                else:
                    state = "ok"
                spec_docs[spec.name] = {
                    "kind": spec.kind, "target": spec.target, "state": state,
                    "burn_fast": round(burn_f, 3),
                    "burn_slow": round(burn_s, 3),
                    "observed_fast": round(obs_f, 3),
                    "observed_slow": round(obs_s, 3),
                }
            raw = worst_state(d["state"] for d in spec_docs.values())
            with self._lock:
                prev = self._state
                if state_rank(raw) >= state_rank(prev):
                    # upgrades (and re-triggers at the same level) stamp
                    # the dwell clock: damping measures time since the
                    # last trigger
                    if state_rank(raw) > state_rank(prev) or raw != "ok":
                        self._state_since = now
                    self._state = raw
                elif now - self._state_since >= self.hold_s:
                    self._state = raw
                    self._state_since = now
                self._last_doc = {
                    "enabled": True, "state": self._state, "raw_state": raw,
                    "fast_window_s": self.fast_s,
                    "slow_window_s": self.slow_s,
                    "specs": spec_docs,
                }
                doc = dict(self._last_doc)
            if self._g_state is not None:
                self._g_state.set(float(state_rank(doc["state"])))
                self._g_warn.set(float(n_warn))
                self._g_crit.set(float(n_crit))
                self._c_evals.inc()
            if doc["state"] == "critical" and prev != "critical":
                if self._c_crit is not None:
                    self._c_crit.inc()
                return doc
            return None

    def _fire_postmortem(self, doc: dict | None) -> None:
        if doc is None:
            return
        from lmrs_tpu_torch.obs.flight import dump_postmortem

        metrics = {}
        if self._metrics_cb is not None:
            try:
                metrics = self._metrics_cb()
            except Exception:  # noqa: BLE001 - the recorder is best-effort
                logger.debug("slo postmortem metrics callback failed",
                             exc_info=True)
        dump_postmortem("slo", metrics=metrics, extra=doc)

    def report(self) -> dict:
        """Evaluate now and return the SLO doc — the ``slo`` block of
        ``/healthz``, ``metrics_report()``, and bench detail."""
        if not self.enabled:
            return {"enabled": False, "state": "ok", "specs": {}}
        self._fire_postmortem(self._evaluate(self.clock()))
        with self._lock:
            return dict(self._last_doc)

    @property
    def state(self) -> str:
        return self.report()["state"]
