"""Fair-share admission, priority classes, and preemption policy (a copy
of the reference's ``fleet/qos.py``).

The policy enforces quotas in the ledger's own currency — device-seconds
over a sliding window (``LMRS_QOS_WINDOW_S``) — never request counts:
a tenant streaming one 8k-token summarize bill equals a tenant firing
eighty 100-token probes, which is exactly the point.  Three cooperating
rules, all deterministic given the same usage window:

* **admission** (deficit-weighted round-robin): among the queue's head
  window the scheduler admits the best entry by ``(class rank, windowed
  device-seconds / weight, FIFO order)`` — an under-served tenant's
  normalized usage is lower, so it wins ties against a flooding one;
* **classes**: ``interactive`` (live sessions, default for unlabeled
  ingress) outranks ``batch`` (job fan-out) categorically — a
  live-session refresh never queues behind a map wave by luck;
* **preemption**: under page pressure the victim is the WORST active
  decode slot by ``(batch first, highest normalized usage, youngest)``
  — over-quota bulk work pays for the pool before anyone else does.

Weights come from ``LMRS_QOS_WEIGHTS`` (``tenantA:4,tenantB:1``;
unlisted tenants weigh 1).  Fair share is self-normalizing: a tenant is
over quota when its share of the window's total usage exceeds its share
of the active tenants' total weight — no capacity estimate needed.

``LMRS_QOS=0`` disables everything: :func:`maybe_qos` returns None and
the scheduler keeps today's FIFO admission and youngest-victim
preemption byte-for-byte (the policy is pure host bookkeeping — it
touches no RNG and no dispatch, so armed-vs-off differs only in
ORDER under contention, never in any request's tokens).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from lmrs_tpu_torch.utils.env import env_bool, env_float, env_list

logger = logging.getLogger("lmrs_torch.fleet.qos")

# priority classes, best first; anything unlabeled resolves to the first
# (interactive) so QoS can never demote traffic that predates the label
CLASSES = ("interactive", "batch")
DEFAULT_CLASS = "interactive"

# fold target for usage events from requests that carried no tenant —
# mirrors obs/ledger.py DEFAULT_TENANT without importing the ledger
_DEFAULT_TENANT = "default"


def qos_enabled() -> bool:
    """The ``LMRS_QOS`` master switch (default armed — with uniform
    traffic the policy degenerates to FIFO anyway)."""
    return env_bool("LMRS_QOS", True)


def clean_qos_class(raw) -> str | None:
    """Validate a wire-supplied class label (header or body field):
    a known class lowercased, else None — garbage must degrade to the
    default class, never crash ingress or mint label cardinality."""
    if isinstance(raw, str):
        low = raw.strip().lower()
        if low in CLASSES:
            return low
    return None


def class_rank(qos_class: str | None) -> int:
    """Admission rank of a class label (lower admits first); None and
    unknown labels rank as ``interactive``."""
    return 1 if qos_class == "batch" else 0


def request_class(req) -> str:
    """A request's effective class: its stamped ``qos_class`` when valid,
    else ``interactive`` (getattr-guarded — dict-shaped fakes in tests
    and old pickled requests carry no field)."""
    return clean_qos_class(getattr(req, "qos_class", None)) or DEFAULT_CLASS


def parse_weights(items) -> dict[str, float]:
    """``tenantA:4,tenantB:0.5`` pairs -> weight map; malformed or
    non-positive entries are dropped with one warning (a typo'd weight
    must not zero a tenant's quota)."""
    out: dict[str, float] = {}
    for item in items:
        name, sep, val = item.rpartition(":")
        try:
            w = float(val)
        except ValueError:
            w = float("nan")
        if not sep or not name or not (w > 0):
            logger.warning("LMRS_QOS_WEIGHTS: ignoring malformed entry %r "
                           "(want tenant:weight, weight > 0)", item)
            continue
        out[name] = w
    return out


class QoSPolicy:
    """Sliding-window fair-share state + the three policy rules.

    Thread contract: the scheduler thread calls ``pick_index`` /
    ``victim_key`` between dispatches; the ledger observer
    (``note_usage``) fires from whichever thread finished a dispatch
    note; HTTP handlers read ``report()`` — ONE lock covers the window
    state (pure in-memory math, nothing blocking runs under it)."""

    def __init__(self, registry=None, enabled: bool | None = None,
                 clock=None):
        self.enabled = qos_enabled() if enabled is None else bool(enabled)
        self.window_s = env_float("LMRS_QOS_WINDOW_S", 60.0, lo=1.0)
        self.weights = parse_weights(env_list("LMRS_QOS_WEIGHTS"))
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        # (t, tenant, device_seconds) usage events, oldest first, expired
        # off the left edge past window_s (guarded-by: _lock)
        self._events: deque[tuple[float, str, float]] = deque()
        self._usage: dict[str, float] = {}  # windowed sums (guarded-by: _lock)
        self._c_reorders = self._c_preempts = None
        self._g_window = None
        if registry is not None and self.enabled:
            self._c_reorders = registry.counter(
                "lmrs_qos_reorders_total",
                "admissions where fair-share picked a non-head queue entry")
            self._c_preempts = registry.counter(
                "lmrs_qos_preempt_victims_total",
                "preemption victims chosen by QoS policy (over-quota bulk "
                "first) instead of youngest-slot order")
            self._g_window = registry.gauge(
                "lmrs_qos_window_device_seconds",
                "total windowed device-seconds the fair-share policy is "
                "currently normalizing over", unit="seconds")

    # ------------------------------------------------------------ usage feed

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def note_usage(self, pairs) -> None:
        """Absorb ``(tenant, device_seconds)`` pairs from one ledger
        apportionment (the CostLedger observer hook — fired OUTSIDE the
        ledger lock, so the two locks never nest)."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            for tenant, s in pairs:
                s = float(s)
                if s <= 0.0:
                    continue
                tenant = tenant or _DEFAULT_TENANT
                self._events.append((now, tenant, s))
                self._usage[tenant] = self._usage.get(tenant, 0.0) + s
            self._expire_locked(now)
            if self._g_window is not None:
                self._g_window.set(sum(self._usage.values()))

    def _expire_locked(self, now: float) -> None:  # holds-lock: _lock
        cut = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < cut:
            _, tenant, s = ev.popleft()
            left = self._usage.get(tenant, 0.0) - s
            if left <= 1e-12:
                self._usage.pop(tenant, None)
            else:
                self._usage[tenant] = left

    def _usage_snapshot(self) -> dict[str, float]:
        with self._lock:
            self._expire_locked(self.clock())
            return dict(self._usage)

    def normalized_usage(self, tenant: str | None) -> float:
        """Windowed device-seconds / weight — the deficit the admission
        and preemption rules compare (0 for a tenant idle all window)."""
        tenant = tenant or _DEFAULT_TENANT
        with self._lock:
            self._expire_locked(self.clock())
            return self._usage.get(tenant, 0.0) / self.weight(tenant)

    # --------------------------------------------------------- policy rules

    def pick_index(self, reqs) -> int:
        """Admission rule over the queue's head window: index of the
        entry to admit next — best ``(class rank, normalized windowed
        usage, FIFO position)``.  With one tenant and one class every
        key ties and FIFO wins: armed QoS on uniform traffic IS FIFO."""
        usage = self._usage_snapshot()
        best_i, best_key = 0, None
        for i, req in enumerate(reqs):
            tenant = getattr(req, "tenant", None) or _DEFAULT_TENANT
            key = (class_rank(request_class(req)),
                   usage.get(tenant, 0.0) / self.weight(tenant), i)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_i and self._c_reorders is not None:
            self._c_reorders.inc()
        return best_i

    def victim_key(self, req, t_start: float):
        """Preemption rule: sort key where the MAX is the victim —
        batch before interactive, over-quota before under-served,
        youngest last (ties degrade to today's youngest-slot rule)."""
        tenant = getattr(req, "tenant", None) or _DEFAULT_TENANT
        return (class_rank(request_class(req)) == 1,
                self.normalized_usage(tenant), t_start)

    def note_preempt(self) -> None:
        if self._c_preempts is not None:
            self._c_preempts.inc()

    def over_quota(self, tenant: str | None) -> bool:
        """Self-normalizing quota check: the tenant's share of windowed
        usage exceeds its share of the ACTIVE tenants' total weight.
        A lone tenant is never over quota (its fair share is 100%)."""
        tenant = tenant or _DEFAULT_TENANT
        usage = self._usage_snapshot()
        total = sum(usage.values())
        if total <= 0.0 or tenant not in usage or len(usage) < 2:
            return False
        wsum = sum(self.weight(t) for t in usage)
        fair = total * self.weight(tenant) / wsum
        return usage[tenant] > fair

    # -------------------------------------------------------------- reports

    def report(self) -> dict:
        """The ``qos`` block of ``GET /v1/usage``: per-tenant windowed
        burn against configured weight, for chargeback."""
        if not self.enabled:
            return {"object": "qos", "enabled": False}
        usage = self._usage_snapshot()
        total = sum(usage.values())
        wsum = sum(self.weight(t) for t in usage) or 1.0
        tenants = {}
        for t, s in sorted(usage.items()):
            fair = total * self.weight(t) / wsum
            tenants[t] = {
                "weight": self.weight(t),
                "window_device_seconds": round(s, 6),
                "share": round(s / total, 4) if total > 0 else 0.0,
                "fair_share": round(self.weight(t) / wsum, 4),
                "over_quota": bool(len(usage) > 1 and s > fair),
            }
        return {"object": "qos", "enabled": True,
                "window_s": self.window_s,
                "window_device_seconds": round(total, 6),
                "classes": list(CLASSES), "tenants": tenants}


def maybe_qos(registry=None, clock=None) -> QoSPolicy | None:
    """The wiring-site factory: a live policy, or None when ``LMRS_QOS=0``
    — callers guard every hook on ``is not None`` so the disarmed path
    stays byte-for-byte today's code."""
    if not qos_enabled():
        return None
    return QoSPolicy(registry, enabled=True, clock=clock)
