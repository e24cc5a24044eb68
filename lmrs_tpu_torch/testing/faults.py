"""Deterministic, seed-driven fault-injection plane (a copy of the
reference's ``testing/faults.py``): named injection sites threaded through
the port's real code paths, each firing by a seeded plan.

=========================== =============================================
site                        effect when fired
=========================== =============================================
``kv_cache.allocate``       ``OutOfPages`` from the page allocator: the
                            back-pressure path under synthetic pressure
``scheduler.step``          exception at a scheduler loop iteration: the
                            dispatch-failure recovery path
``scheduler.heartbeat``     beside the watchdog's heartbeat; a ``stall``
                            plan wedges the loop as a hung card would
``engine.batch``            ``RuntimeError`` from ``generate_batch``:
                            the executor/server degrade-and-retry path
``prefix_cache.insert``     exception inside radix-tree adoption: the
                            caching-is-an-optimization degrade path
``prefix.spill``            a spill capture fails: the victim's pages
                            free uncached (evict means gone)
``prefix.prefetch``         a spilled segment's restore fails: the match
                            truncates there, the rest re-prefills
``kv.disk_read``            a disk-tier read fails (``DiskReadError``):
                            the entry drops, the segment re-prefills
``handoff.export``          page-set capture at pin time fails: the
                            request errors marked, the router re-prefills
``handoff.import``          the decode-side page scatter (or the mock's
                            state resume) fails: marked error, pool clean
``handoff.transfer``        the prefill→decode payload read dies
                            MID-PAYLOAD: a marked import failure
``handoff.ack``             the import ack vanishes on the wire: pages
                            stay pinned until the orphan sweep
``journal.append``          a journal append fails (``OSError``): the
                            job degrades to non-durable progress
``journal.fsync``           a journal fsync fails (``OSError``)
``jobs.recover``            recovery of one job fails (``OSError``): it
                            registers ``failed``, the others recover
``server.client_disconnect``the server's disconnect probe reports the
                            client gone: the cancel propagation path
``router.connect``          connection-phase failure at a backend host:
                            unhealthy marking + failover
``router.probe``            /healthz recovery-probe failure
``router.recv``             mid-stream fault (or stall) while reading a
                            backend SSE response
``router.hedge``            a tail-hedge launch is abandoned (or delayed)
=========================== =============================================

Determinism: every site keeps an occurrence counter, and probabilistic
triggers draw from a per-site ``random.Random(f"{seed}:{site}")`` stream
(string seeding is stable across processes), so one ``(FaultPlan, code
path)`` pair always fires the same faults at the same occurrences.

No cost when disabled: the module-level ``fire``/``check`` entry points
test one global against ``None`` and return.  A plan is installed only
through ``install`` / ``injected`` / the ``LMRS_FAULT_PLAN`` environment
variable (read once at import) / ``EngineConfig.fault_plan`` (applied by
``make_engine``).  Standard library only.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

logger = logging.getLogger("lmrs_torch.faults")


class InjectedFault(RuntimeError):
    """Raised by a fired injection site (unless the site's callers specify
    a more meaningful type, e.g. ``OutOfPages`` at ``kv_cache.allocate``)."""


@dataclass
class FaultSpec:
    """One trigger rule for one site.  A spec fires at an occurrence when
    ANY of its conditions matches: ``at`` (explicit 1-based occurrence
    indices), ``every`` (each Nth occurrence), or ``p`` (per-occurrence
    probability on the site's seeded stream).  ``max_fires`` caps total
    fires (0 = unlimited); ``stall_s`` sleeps before acting; ``action``
    "raise" (default) raises at the site, "stall" only sleeps.

    Specs are immutable descriptions: all mutable evaluation state
    (occurrence counters, fire counts, RNG streams) lives on the
    FaultInjector, so one plan object can be installed any number of
    times and every installation replays identically."""

    site: str
    p: float = 0.0
    at: tuple[int, ...] = ()
    every: int = 0
    max_fires: int = 0
    stall_s: float = 0.0
    action: str = "raise"

    def __post_init__(self) -> None:
        if self.action not in ("raise", "stall"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if not (self.p or self.at or self.every):
            raise ValueError(
                f"fault spec for {self.site!r} has no trigger (p/at/every)")
        self.at = tuple(self.at)


class FaultPlan:
    """A seed plus a list of :class:`FaultSpec`.  Constructable from JSON
    (the ``LMRS_FAULT_PLAN`` wire format)::

        {"seed": 7, "faults": [
            {"site": "kv_cache.allocate", "p": 0.3, "max_fires": 4},
            {"site": "scheduler.step", "at": [3]},
            {"site": "router.recv", "every": 2, "stall_s": 0.05,
             "action": "stall"}]}

    ``from_spec`` additionally accepts ``@/path/to/plan.json``.
    """

    def __init__(self, seed: int = 0, faults: list | tuple = ()):
        self.seed = seed
        self.faults = [f if isinstance(f, FaultSpec) else FaultSpec(**f)
                       for f in faults]

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse a plan from JSON text, or from a file via ``@path``."""
        text = spec.strip()
        if text.startswith("@"):
            with open(text[1:], "r", encoding="utf-8") as fh:
                text = fh.read()
        data = json.loads(text)
        return cls(seed=int(data.get("seed", 0)),
                   faults=data.get("faults", ()))


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at the named sites.  Thread-safe:
    sites fire from scheduler, HTTP handler, and router dispatch threads
    concurrently; a lock guards the counters so occurrence numbering (and
    with it determinism under a single-threaded caller) stays exact."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._occurrences: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._fired = [0] * len(plan.faults)  # per-spec, injector-owned
        # (site, occurrence) pairs that fired — chaos-test introspection
        self.fires: list[tuple[str, int]] = []

    def _rng(self, site: str) -> random.Random:
        # string seeding: stable across processes (unlike hash())
        if site not in self._rngs:
            self._rngs[site] = random.Random(f"{self.plan.seed}:{site}")
        return self._rngs[site]

    def _trigger(self, site: str) -> FaultSpec | None:
        """Count one occurrence of ``site`` and return the spec that fires
        on it, if any.  The probabilistic draw happens exactly once per
        occurrence per spec (even when another condition already matched)
        so adding an ``at`` to a plan cannot shift later ``p`` draws."""
        with self._lock:
            n = self._occurrences.get(site, 0) + 1
            self._occurrences[site] = n
            hit: FaultSpec | None = None
            for idx, spec in enumerate(self.plan.faults):
                if spec.site != site:
                    continue
                # the draw is consumed BEFORE the max_fires check so a
                # spent spec cannot shift later draws on its site's stream
                draw = self._rng(site).random() if spec.p else 1.0
                if spec.max_fires and self._fired[idx] >= spec.max_fires:
                    continue
                fires = (n in spec.at
                         or (spec.every and n % spec.every == 0)
                         or (spec.p and draw < spec.p))
                if fires and hit is None:
                    self._fired[idx] += 1
                    hit = spec
            if hit is not None:
                self.fires.append((site, n))
            return hit

    def fire(self, site: str, exc: type = InjectedFault) -> None:
        """Raise ``exc`` (after any configured stall) when the plan fires
        at this occurrence of ``site``; no-op otherwise."""
        spec = self._trigger(site)
        if spec is None:
            return
        logger.debug("injected fault at %s (occurrence %d, action=%s)",
                     site, self._occurrences[site], spec.action)
        if spec.stall_s:
            time.sleep(spec.stall_s)
        if spec.action == "raise":
            raise exc(f"injected fault at {site} "
                      f"(occurrence {self._occurrences[site]})")

    def check(self, site: str) -> bool:
        """Boolean form for sites that signal instead of raise (e.g. the
        server's client-disconnect probe).  Stalls still apply."""
        spec = self._trigger(site)
        if spec is None:
            return False
        if spec.stall_s:
            time.sleep(spec.stall_s)
        return spec.action == "raise"

    def occurrences(self, site: str) -> int:
        with self._lock:
            return self._occurrences.get(site, 0)


# --------------------------------------------------------- module plumbing

_active: FaultInjector | None = None
_active_spec: str | None = None  # the spec string the injector came from


def active() -> FaultInjector | None:
    """The installed injector, or None (the disabled fast path)."""
    return _active


def fire(site: str, exc: type = InjectedFault) -> None:
    """Module-level injection point — the ONE call production code makes.
    Disabled (no plan installed): a global load + None test, nothing else."""
    inj = _active
    if inj is not None:
        inj.fire(site, exc)


def check(site: str) -> bool:
    """Boolean injection point (see :meth:`FaultInjector.check`)."""
    inj = _active
    return False if inj is None else inj.check(site)


def install(plan: FaultPlan | FaultInjector) -> FaultInjector:
    """Install a plan process-globally (replacing any previous one, with
    fresh evaluation state) and return its injector."""
    global _active, _active_spec
    inj = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    _active = inj
    _active_spec = None  # object installs are not spec-keyed
    logger.info("fault plan installed: seed=%d, %d specs",
                inj.plan.seed, len(inj.plan.faults))
    return inj


def install_spec(spec: str) -> FaultInjector | None:
    """Install from the JSON / ``@path`` wire format (``LMRS_FAULT_PLAN``,
    ``EngineConfig.fault_plan``).  Empty spec uninstalls and returns None.
    IDEMPOTENT per spec string: re-arming the same spec (every
    ``make_engine`` call re-applies the env-derived config knob) keeps the
    live injector — occurrence counters and ``max_fires`` state survive,
    so "fire once" means once per PROCESS, not once per engine built."""
    global _active_spec
    if not spec.strip():
        uninstall()
        return None
    if _active is not None and spec == _active_spec:
        return _active
    inj = install(FaultPlan.from_spec(spec))
    _active_spec = spec
    return inj


def uninstall() -> None:
    global _active, _active_spec
    _active = None
    _active_spec = None


@contextmanager
def injected(plan: FaultPlan):
    """Scoped install for tests: ``with injected(plan) as inj: ...``"""
    inj = install(plan)
    try:
        yield inj
    finally:
        uninstall()


# Environment knob: importing this module with LMRS_FAULT_PLAN set arms the
# plane for the whole process (every call site imports this module, so the
# env var alone reaches server/router/engine without config plumbing).
def _install_from_env() -> None:
    from lmrs_tpu_torch.utils.env import env_str

    spec = env_str("LMRS_FAULT_PLAN")
    if spec:
        try:
            install_spec(spec)
        except (ValueError, OSError, json.JSONDecodeError, TypeError) as e:
            raise ValueError(f"bad LMRS_FAULT_PLAN: {e}") from e


_install_from_env()
