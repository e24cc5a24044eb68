"""Per-request cost ledger: who consumed the device, exactly (a copy of
the reference's ``obs/ledger.py``).

The roofline attribution and the exact mixed-step split (``obs/perf.py``)
tell you how fast the hardware ran; this module extends the same
apportionment ONE level down, to the individual rows inside each dispatch, so every
request accumulates an honest device-time bill:

* each dispatch's measured wall is first split between its prefill and
  decode phases by their own roofline times (the exact-split rule
  ``note_mixed_step`` established — the two phases share one kernel
  launch and cannot be timed apart host-side), then each phase's share
  is apportioned to its participating rows by per-row work (prefill
  FLOPs / emitted decode tokens);
* per request the ledger accumulates: phase-split device-seconds,
  prompt/generated token attribution, tokens saved (prefix-cache hits,
  host-KV prefetch, accepted speculation), KV page-seconds (pages held
  x dispatch wall), host-pool byte-seconds (bytes prefetched x request
  residency), queue wait, and wedge counts;
* entries key on request id plus the ``tenant`` aggregation label
  (``X-LMRS-Tenant``, minted at ingress and propagated like the trace
  id — jobs and live sessions default it to their own identity, so
  ``GET /v1/usage`` rolls up per job/session for free).

**Conservation is an auditable invariant**, not a hope:
``audit()`` checks that the per-request device-seconds (live entries +
finished rollups) sum to the dispatch walls the ledger was fed (within
float epsilon — each wall's row shares are remainder-corrected so the
per-dispatch sum is exact) and that attributed tokens equal dispatched
tokens EXACTLY (integers are never split).  ``scheduler.audit()``
carries both checks, so every chaos/fuzz arm that audits also proves
the bill adds up.

``LMRS_COST_LEDGER=0`` disables the ledger: every note is a no-op,
results carry no ``usage`` block, and generated tokens are byte-for-byte
identical (the ledger is pure host bookkeeping — it touches no RNG and
no dispatch).
"""

from __future__ import annotations

import logging
import threading

from lmrs_tpu_torch.utils.env import env_bool, env_int

logger = logging.getLogger("lmrs_torch.obs.ledger")

DEFAULT_TENANT = "default"

# past LMRS_COST_TENANTS_MAX distinct labels, new tenants' rollups fold
# into this aggregate bucket (jobs/sessions mint one label each, and the
# rollup map lives as long as the scheduler — cardinality must be capped)
OVERFLOW_TENANT = "other"

_SAVED_KINDS = ("prefix_cache", "host_kv_prefetch", "speculation")

# per-request / per-tenant accumulator fields (one list so the entry,
# the rollup, and the merge can never drift apart)
_FIELDS = ("prefill_device_seconds", "decode_device_seconds",
           "queue_wait_seconds", "kv_page_seconds",
           "host_pool_byte_seconds", "prompt_tokens", "generated_tokens",
           "tokens_saved_prefix_cache", "tokens_saved_host_kv_prefetch",
           "tokens_saved_speculation", "goodput_tokens", "wasted_tokens",
           "wedges")


def _zero() -> dict:
    return {f: 0.0 if "seconds" in f else 0 for f in _FIELDS}


def totals_from_tenants(tenants: dict) -> dict:
    """Fold per-tenant rollups into one totals doc — the ONE fold shared
    by the ledger's host report, the replicated engine's replica merge,
    and the router's fleet aggregation, so totals computed at any level
    agree with the sum of their parts."""
    totals: dict = {}
    for roll in tenants.values():
        merge_usage(totals, roll)
    totals.pop("requests", None)
    totals["requests"] = sum(r.get("requests", 0) for r in tenants.values())
    return totals


def merge_usage(into: dict, usage: dict) -> dict:
    """Accumulate one usage doc (a result's ``usage`` block, or another
    rollup) into ``into`` — the ONE merge rule shared by the ledger's
    tenant rollups, the job/session rollups, and the router's fleet
    aggregation, so totals computed at any level agree."""
    for f in _FIELDS:
        v = usage.get(f, 0)
        if v:
            into[f] = into.get(f, 0) + v
    into["requests"] = into.get("requests", 0) + usage.get("requests", 1)
    into["device_seconds"] = round(
        into.get("prefill_device_seconds", 0.0)
        + into.get("decode_device_seconds", 0.0), 9)
    return into


class _Entry:
    __slots__ = ("tenant", "vals", "attr_prefill_tokens",
                 "attr_decode_tokens", "t_open", "pool_bytes")

    def __init__(self, tenant: str, t_open: float):
        self.tenant = tenant
        self.vals = _zero()
        # token-conservation counters: tokens attributed to this entry by
        # note_step (compared exactly against the ledger's dispatch total)
        self.attr_prefill_tokens = 0
        self.attr_decode_tokens = 0
        self.t_open = t_open
        # host-pool meter: bytes prefetched for this request (charged as
        # byte-seconds at finish, bytes x residency)
        self.pool_bytes = 0.0


class CostLedger:
    """Request-cost accounting on the continuous scheduler (module doc).

    Thread contract: the scheduler thread feeds dispatch notes; HTTP
    handler threads read ``usage_report()``; the watchdog's wedge sweep
    finishes entries from the caller thread while the scheduler thread
    is stuck — ONE lock covers all ledger state (pure in-memory math,
    nothing blocking runs under it)."""

    def __init__(self, registry=None, enabled: bool | None = None,
                 clock=None):
        import time

        self.enabled = (env_bool("LMRS_COST_LEDGER", True)
                        if enabled is None else bool(enabled))
        self.max_tenants = env_int("LMRS_COST_TENANTS_MAX", 512, lo=1)
        self.clock = clock or time.time
        # usage observer (fleet/qos.py fair-share window): called with the
        # (tenant, device_seconds) pairs of each apportioned dispatch,
        # AFTER _lock is released — the two locks never nest, so the
        # policy may read the ledger from its own callers freely
        self.observer = None
        self._lock = threading.Lock()
        self._entries: dict[int, _Entry] = {}   # guarded-by: _lock
        self._tenants: dict[str, dict] = {}     # guarded-by: _lock
        # conservation totals (guarded-by: _lock)
        self._wall_seconds = 0.0
        self._step_tokens = 0
        self._finished = 0
        self._c = {}
        if registry is not None and self.enabled:
            c = registry.counter
            self._c = {
                "prefill_s": c("lmrs_cost_prefill_device_seconds_total",
                               "device seconds attributed to prefill rows",
                               "seconds"),
                "decode_s": c("lmrs_cost_decode_device_seconds_total",
                              "device seconds attributed to decode rows",
                              "seconds"),
                "queue_s": c("lmrs_cost_queue_wait_seconds_total",
                             "queue wait attributed across requests",
                             "seconds"),
                "page_s": c("lmrs_cost_kv_page_seconds_total",
                            "KV page-seconds (pages held x dispatch wall)",
                            "page-seconds"),
                "pool_bs": c("lmrs_cost_host_pool_byte_seconds_total",
                             "host-pool byte-seconds (prefetched bytes x "
                             "request residency)", "byte-seconds"),
                "saved": c("lmrs_cost_tokens_saved_total",
                           "prompt/draft tokens saved across all sources",
                           "tokens"),
                "finished": c("lmrs_cost_requests_finished_total",
                              "requests whose cost entry was finalized"),
                "goodput": c("lmrs_cost_goodput_tokens_total",
                             "completion tokens of usable outcomes",
                             "tokens"),
                "wasted": c("lmrs_cost_wasted_tokens_total",
                            "completion tokens of failed/cancelled/wedged "
                            "outcomes", "tokens"),
                "overflow": c("lmrs_cost_tenants_overflow_total",
                              "finished requests whose tenant rollup "
                              "folded into the aggregate bucket past "
                              "LMRS_COST_TENANTS_MAX"),
            }

    # ----------------------------------------------------------- entry feed

    def _entry_locked(self, req) -> _Entry:  # holds-lock: _lock
        """Caller holds self._lock."""
        rid = req.request_id
        e = self._entries.get(rid)
        if e is None:
            tenant = getattr(req, "tenant", None) or DEFAULT_TENANT
            e = self._entries[rid] = _Entry(tenant, self.clock())
        return e

    def note_queue_wait(self, req, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            e = self._entry_locked(req)
            e.vals["queue_wait_seconds"] += max(0.0, seconds)
        c = self._c.get("queue_s")
        if c is not None:
            c.inc(max(0.0, seconds))

    def note_saved(self, req, prefix_tokens: int = 0,
                   prefetched_tokens: int = 0, spec_tokens: int = 0,
                   prefetched_bytes: float = 0.0) -> None:
        """Tokens this request never had to pay device time for: prefix
        cache hits (resident), host-KV prefetch restores, accepted
        speculation drafts.  ``prefetched_bytes`` opens the host-pool
        byte-seconds meter (charged at finish, bytes x residency)."""
        if not self.enabled:
            return
        with self._lock:
            e = self._entry_locked(req)
            e.vals["tokens_saved_prefix_cache"] += max(0, int(prefix_tokens))
            e.vals["tokens_saved_host_kv_prefetch"] += max(
                0, int(prefetched_tokens))
            e.vals["tokens_saved_speculation"] += max(0, int(spec_tokens))
            if prefetched_bytes > 0:
                e.pool_bytes += prefetched_bytes
        c = self._c.get("saved")
        if c is not None:
            saved = (max(0, int(prefix_tokens))
                     + max(0, int(prefetched_tokens))
                     + max(0, int(spec_tokens)))
            if saved:
                c.inc(saved)

    def note_step(self, wall_s: float, decode_rows=(), prefill_rows=(),
                  decode_cost_s: float = 0.0,
                  prefill_cost_s: float = 0.0) -> None:
        """Apportion ONE dispatch wall to its rows.

        ``decode_rows``: ``(req, tokens_emitted, pages_held)`` per live
        decode row; ``prefill_rows``: ``(req, tokens, flops)`` per
        prefill row in the fused/sequenced wave.  The wall splits between
        the phases proportionally to their roofline times
        (``decode_cost_s`` = model bytes / peak bw, ``prefill_cost_s`` =
        model FLOPs / peak FLOPs — the exact-split rule); with no
        roofline estimate the split degrades to per-row token counts
        across both phases.  Within a phase, rows share by their own work
        (emitted tokens / per-row FLOPs), remainder-corrected so the
        per-dispatch sum is EXACT."""
        if not self.enabled or wall_s <= 0:
            return
        decode_rows = [r for r in decode_rows if r[0] is not None]
        prefill_rows = [r for r in prefill_rows if r[0] is not None]
        if not decode_rows and not prefill_rows:
            return
        # ---- phase split -------------------------------------------------
        if decode_rows and prefill_rows:
            dc, pc = max(decode_cost_s, 0.0), max(prefill_cost_s, 0.0)
            if dc + pc > 0:
                decode_wall = wall_s * dc / (dc + pc)
            else:  # no roofline estimate: split by token counts
                dtok = sum(max(1, int(t)) for _, t, _ in decode_rows)
                ptok = sum(max(1, int(t)) for _, t, _ in prefill_rows)
                decode_wall = wall_s * dtok / (dtok + ptok)
            prefill_wall = wall_s - decode_wall
        elif decode_rows:
            decode_wall, prefill_wall = wall_s, 0.0
        else:
            decode_wall, prefill_wall = 0.0, wall_s
        page_s = 0.0
        tenant_s: dict[str, float] = {}  # this dispatch's per-tenant bill
        with self._lock:
            self._wall_seconds += wall_s
            self._apportion_locked(decode_wall, decode_rows, "decode",
                                   tenant_s)
            self._apportion_locked(prefill_wall, prefill_rows, "prefill",
                                   tenant_s)
            # KV page-seconds bill on the FULL dispatch wall: the pages
            # are resident for the whole kernel launch, including a fused
            # step's prefill share (the module-doc / metrics-catalog
            # definition — NOT the phase-split share billed above)
            for req, _tok, pages in decode_rows:
                pages = max(0, int(pages))
                if pages:
                    charge = pages * wall_s
                    self._entry_locked(req).vals["kv_page_seconds"] += charge
                    page_s += charge
        if self._c:
            self._c["decode_s"].inc(decode_wall)
            self._c["prefill_s"].inc(prefill_wall)
            if page_s:
                self._c["page_s"].inc(page_s)
        obs = self.observer
        if obs is not None and tenant_s:
            obs(tenant_s.items())

    def _apportion_locked(self, wall: float, rows, phase: str,
                          tenant_s: dict | None = None) -> None:
        """Caller holds self._lock."""  # holds-lock: _lock
        if not rows:
            return
        field = f"{phase}_device_seconds"
        # weights: per-row work; an all-zero dispatch (every row emitted
        # nothing) splits evenly so the wall is still conserved
        weights = [max(0.0, float(r[2] if phase == "prefill" else r[1]))
                   for r in rows]
        total_w = sum(weights)
        if total_w <= 0:
            weights = [1.0] * len(rows)
            total_w = float(len(rows))
        spent = 0.0
        for i, row in enumerate(rows):
            req, tokens = row[0], max(0, int(row[1]))
            share = (wall - spent if i == len(rows) - 1
                     else wall * weights[i] / total_w)
            spent += share
            e = self._entry_locked(req)
            e.vals[field] += share
            if tenant_s is not None and share > 0:
                tenant_s[e.tenant] = tenant_s.get(e.tenant, 0.0) + share
            self._step_tokens += tokens
            if phase == "decode":
                e.attr_decode_tokens += tokens
            else:
                e.attr_prefill_tokens += tokens

    # ----------------------------------------------------------- lifecycle

    def finish(self, req, res) -> dict | None:
        """Finalize a request's entry against its terminal result:
        returns the ``usage`` doc (attached to ``GenerationResult.usage``
        and surfaced on the wire) and rolls the entry into its tenant's
        cumulative totals.  Requests that never touched a dispatch (shed,
        cancelled-in-queue) finalize a zero-cost entry — every outcome is
        billed to someone.  None when the ledger is disabled."""
        if not self.enabled:
            return None
        # goodput = tokens of outcomes the caller ASKED to end this way
        # (stop/length/handoff, no error); everything else — cancelled,
        # deadline, shed, wedged, errors — is wasted device work even
        # when partial text was kept (the docs' wasted definition, and
        # the same classification the SLO goodput numerator uses, so the
        # two surfaces can never disagree about the same traffic)
        usable = (res.error is None
                  and res.finish_reason in ("stop", "length", "handoff"))
        overflowed = False
        with self._lock:
            e = self._entries.pop(res.request_id, None)
            if e is None:
                e = _Entry(getattr(req, "tenant", None) or DEFAULT_TENANT,
                           self.clock())
            v = e.vals
            v["prompt_tokens"] = int(res.prompt_tokens)
            v["generated_tokens"] = int(res.completion_tokens)
            if e.pool_bytes:
                v["host_pool_byte_seconds"] += e.pool_bytes * max(
                    0.0, self.clock() - e.t_open)
            if usable:
                v["goodput_tokens"] = int(res.completion_tokens)
            else:
                v["wasted_tokens"] = int(res.completion_tokens)
            if res.finish_reason == "wedged":
                v["wedges"] = 1
            self._finished += 1
            # conservation: the attributed tokens leave with the entry,
            # so park them in the tenant rollup's hidden counters
            roll = self._tenants.get(e.tenant)
            if roll is None:
                if len(self._tenants) >= self.max_tenants \
                        and e.tenant != OVERFLOW_TENANT:
                    # cardinality cap: fold into the aggregate bucket —
                    # conservation keeps holding because the hidden token
                    # counters travel with whichever rollup is billed
                    if OVERFLOW_TENANT not in self._tenants:
                        logger.warning(
                            "cost ledger tenant cardinality cap (%d) "
                            "reached; new tenants roll up under %r "
                            "(raise LMRS_COST_TENANTS_MAX to widen)",
                            self.max_tenants, OVERFLOW_TENANT)
                    roll = self._tenants.setdefault(OVERFLOW_TENANT,
                                                    _zero())
                    overflowed = True
                else:
                    roll = self._tenants[e.tenant] = _zero()
            roll.setdefault("_attr_prefill_tokens", 0)
            roll.setdefault("_attr_decode_tokens", 0)
            roll["_attr_prefill_tokens"] += e.attr_prefill_tokens
            roll["_attr_decode_tokens"] += e.attr_decode_tokens
            # roll up the UNROUNDED values (rounding per request would
            # drift the conservation audit past its epsilon); the wire
            # usage doc is rounded for presentation only
            merge_usage(roll, {f: v[f] for f in _FIELDS})
            usage = {
                "tenant": e.tenant,
                **{f: (round(v[f], 6) if isinstance(v[f], float) else v[f])
                   for f in _FIELDS},
                "device_seconds": round(v["prefill_device_seconds"]
                                        + v["decode_device_seconds"], 6),
            }
        if self._c:
            self._c["finished"].inc()
            if overflowed:
                self._c["overflow"].inc()
            if usage["goodput_tokens"]:
                self._c["goodput"].inc(usage["goodput_tokens"])
            if usage["wasted_tokens"]:
                self._c["wasted"].inc(usage["wasted_tokens"])
            if usage["host_pool_byte_seconds"]:
                self._c["pool_bs"].inc(usage["host_pool_byte_seconds"])
        return usage

    @property
    def finished_count(self) -> int:
        with self._lock:
            return self._finished

    # -------------------------------------------------------------- reports

    def usage_report(self) -> dict:
        """The ``GET /v1/usage`` document: per-tenant cumulative rollups
        plus host totals (internal conservation counters stripped)."""
        if not self.enabled:
            return {"object": "usage", "enabled": False, "tenants": {},
                    "totals": {}}
        with self._lock:
            tenants = {
                t: {k: v for k, v in roll.items() if not k.startswith("_")}
                for t, roll in self._tenants.items()}
            live = len(self._entries)
        return {"object": "usage", "enabled": True, "tenants": tenants,
                "totals": totals_from_tenants(tenants),
                "live_requests": live}

    def report(self, before: dict | None = None) -> dict:
        """The ``cost`` block of ``metrics_report()`` / bench detail.
        With ``before`` (a prior ``report()``), the work fields window to
        the delta — same convention as ``_mixed_report``."""
        if not self.enabled:
            return {"enabled": False}
        with self._lock:
            wall = self._wall_seconds
            finished = self._finished
            tenants = len(self._tenants)
        doc = self.usage_report()
        tot = doc["totals"]
        b = (before or {})
        bt = b.get("totals", {})
        out = {
            "enabled": True,
            "requests_finished": finished - b.get("requests_finished", 0),
            "tenants": tenants,
            "attributed_wall_seconds": round(
                wall - b.get("attributed_wall_seconds_raw", 0.0), 6),
            "attributed_wall_seconds_raw": wall,
            "totals": {
                k: (round(tot.get(k, 0) - bt.get(k, 0), 6)
                    if isinstance(tot.get(k, 0), float)
                    else tot.get(k, 0) - bt.get(k, 0))
                for k in ("device_seconds", "prefill_device_seconds",
                          "decode_device_seconds", "goodput_tokens",
                          "wasted_tokens", "queue_wait_seconds",
                          "kv_page_seconds")},
            "totals_raw": tot,
        }
        return out

    # ---------------------------------------------------------------- audit

    def audit(self) -> list[str]:
        """Conservation invariants (joins ``scheduler.audit()``):

        * Σ per-request device-seconds (live entries + finished tenant
          rollups) == Σ dispatch walls fed to ``note_step`` within ε;
        * Σ attributed tokens == Σ dispatched tokens EXACTLY.
        """
        if not self.enabled:
            return []
        with self._lock:
            attr_s = sum(e.vals["prefill_device_seconds"]
                         + e.vals["decode_device_seconds"]
                         for e in self._entries.values())
            attr_tok = sum(e.attr_prefill_tokens + e.attr_decode_tokens
                           for e in self._entries.values())
            for roll in self._tenants.values():
                attr_s += (roll.get("prefill_device_seconds", 0.0)
                           + roll.get("decode_device_seconds", 0.0))
                attr_tok += (roll.get("_attr_prefill_tokens", 0)
                             + roll.get("_attr_decode_tokens", 0))
            wall, toks = self._wall_seconds, self._step_tokens
        out: list[str] = []
        eps = 1e-6 + 1e-9 * max(wall, 1.0)
        if abs(attr_s - wall) > eps:
            out.append(f"cost ledger device-seconds not conserved: "
                       f"attributed {attr_s:.9f}s != dispatched "
                       f"{wall:.9f}s (eps {eps:.2e})")
        if attr_tok != toks:
            out.append(f"cost ledger token attribution not conserved: "
                       f"attributed {attr_tok} != dispatched {toks}")
        return out
