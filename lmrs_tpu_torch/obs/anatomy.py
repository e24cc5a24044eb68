"""Step-anatomy profiler and ragged-span bucket economics (a copy of the
reference's ``obs/anatomy.py``).

The live attribution (``obs/perf.py``) and the cost ledger measure
dispatch walls; this module names every microsecond between two
dispatches on the host side of a scheduler iteration:

* ``StepAnatomy.seg(name)`` is a nestable context timer.  Entering an
  inner segment PAUSES the outer one (elapsed time is attributed to the
  outer segment first), so segments never overlap and their per-iteration
  sum can never exceed the iteration wall.  The difference is tracked as
  an explicit ``residual``, audited like the ledger:
  ``wall == seg_sum + residual`` must reconcile within eps in
  ``scheduler.audit()``.
* ``iter_begin()`` / ``iter_end(cls)`` / ``iter_abort()`` bound one
  scheduler iteration.  ``iter_end`` folds the iteration's record into
  the cumulative totals (and the per-class reservoir for p50/p95);
  ``iter_abort`` DISCARDS the open record: an iteration killed by a
  dispatch fault contributes nothing, so the audit identity survives the
  fault recovery by construction.
* Bucket economics for the ragged-span family: per (query-token buffer,
  pow2 page window) key the profiler counts dispatches and real vs padded
  span tokens (padding-waste ratio).  The port's buffer is not a pow2
  bucket: each span is aligned up to the kernel's query tile and the
  buffer holds at least 16 tokens (``ops/paged_attention.pack_spans``),
  so the padding is that alignment.  ``note_compile`` keeps the
  reference's compile-seconds entry so the report keys match, but the
  port has no XLA compile to count: its kernels are built once, before
  any dispatch, so nothing calls it and ``compile_ms`` stays 0.

On by default; ``LMRS_ANATOMY=0`` swaps in ``NULL_ANATOMY``, which
registers NO metrics and no-ops every call.  Overhead when on is a handful
of ``time.time()`` calls and dict adds per iteration; trace spans are
only formatted when a tracer is armed.
"""

from __future__ import annotations

import time
from collections import deque

from lmrs_tpu_torch.obs.flight import dump_postmortem
from lmrs_tpu_torch.obs.metrics import MetricsRegistry, log_buckets
from lmrs_tpu_torch.obs.trace import get_tracer
from lmrs_tpu_torch.utils.env import env_bool, env_float, env_int

# the named host segments of one scheduler iteration, in loop order:
#   admit    — fault/heartbeat/sweep bookkeeping + admission & QoS pick
#   plan     — span/operand/page-table build (host-side numpy plumbing)
#   draft    — spec draft+reseed plumbing (seed_history, stale reseeds)
#   dispatch — the jitted device call (compile time lands here, cold keys)
#   fetch    — result transfer (device_get / _timed_get)
#   finish   — emitted-token sweep + perf/ledger/SLO notes + slot finish
#   io       — journal/session delivery (on_result callbacks)
SEGMENTS: tuple[str, ...] = ("admit", "plan", "draft", "dispatch",
                             "fetch", "finish", "io")
_SEG_SET = frozenset(SEGMENTS)

# iteration step classes (the decode_split/serving_latency split axis)
CLASSES: tuple[str, ...] = ("plain", "mixed", "spec", "prefill")

# host-overhead histogram: 1 µs (an idle-ish pass) .. 10 s (a compile)
_HOST_US_BUCKETS = log_buckets(1.0, 1e7, per_decade=3)


def anatomy_enabled() -> bool:
    """The ``LMRS_ANATOMY`` kill switch (default on)."""
    return env_bool("LMRS_ANATOMY", True)


def slow_step_ms() -> float:
    """Slow-step postmortem threshold in ms; 0 disables.  Read per
    iteration (not cached) so tests can arm it without rebuilding the
    engine — same convention as ``perf.slow_step_threshold_s``."""
    return env_float("LMRS_ANATOMY_SLOW_MS", 0.0, lo=0.0)


def reservoir_size() -> int:
    """Per-class percentile reservoir depth (``LMRS_ANATOMY_RESERVOIR``)."""
    return env_int("LMRS_ANATOMY_RESERVOIR", 512, lo=16)


class _Seg:
    """One ``with anatomy.seg(name):`` activation.  Stack-based with
    pause semantics: entering attributes the elapsed slice to the
    enclosing segment, exiting resumes it — re-entrant on the same name
    and exception-safe (an unwind closes every frame on the way out)."""

    __slots__ = ("a", "name")

    def __init__(self, a: "StepAnatomy", name: str):
        self.a = a
        self.name = name

    def __enter__(self):
        a = self.a
        if not a._open:
            return self
        t = a._clock()
        st = a._stack
        if st:
            p = st[-1]
            a._cur[p[0]] += t - p[2]  # pause the enclosing segment
        st.append([self.name, t, t])  # [name, t_enter, t_resume]
        return self

    def __exit__(self, exc_type, exc, tb):
        a = self.a
        st = a._stack
        if not a._open or not st:
            return False
        t = a._clock()
        e = st.pop()
        a._cur[e[0]] += t - e[2]
        if st:
            st[-1][2] = t  # resume the enclosing segment
        if a._tr is not None:
            a._tr.complete("anatomy." + e[0], e[1], t)
        return False


class _NullSeg:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SEG = _NullSeg()


class StepAnatomy:
    """Conservation-audited per-iteration host-segment profiler + ragged
    bucket economics (module docstring).  One instance per scheduler run
    context; NOT thread-safe by design — only the scheduler loop thread
    touches the iteration lifecycle, matching every other per-run
    accumulator in the scheduler."""

    enabled = True

    def __init__(self, registry: MetricsRegistry, *, metrics_cb=None,
                 clock=time.time):
        self._clock = clock
        self._metrics_cb = metrics_cb
        self._tr = None
        # iteration lifecycle state
        self._open = False
        self._stack: list[list] = []
        self._cur: dict[str, float] = {}
        self._t_iter = 0.0
        # cumulative totals (floats keep sign for the audit identity;
        # counter incs are clamped at 0 because Counter refuses decrements)
        self._iters = 0
        self._aborted = 0
        self._wall = 0.0
        self._residual = 0.0
        self._segs = {s: 0.0 for s in SEGMENTS}
        self._host_us = 0.0  # sum of (wall - dispatch - fetch) in µs
        # per-class percentile reservoirs: cls -> deque[(wall, segs tuple)]
        cap = reservoir_size()
        self._res: dict[str, deque] = {c: deque(maxlen=cap) for c in CLASSES}
        self._cls_iters = {c: 0 for c in CLASSES}
        # bucket economics: (tpb, w) -> {dispatches, real, padded, compile_s}
        self._buckets: dict[tuple[int, int], dict] = {}

        c, g, h = (registry.counter, registry.gauge, registry.histogram)
        self._c_iters = c("lmrs_anatomy_iterations_total",
                          "scheduler iterations profiled by the anatomy")
        self._c_aborted = c("lmrs_anatomy_aborted_iterations_total",
                            "iterations discarded mid-flight (fault unwind)")
        self._c_wall = c("lmrs_anatomy_wall_seconds_total",
                         "summed iteration wall time", unit="s")
        self._c_residual = c("lmrs_anatomy_residual_seconds_total",
                             "iteration wall not covered by any segment",
                             unit="s")
        self._c_slow = c("lmrs_anatomy_slow_steps_total",
                         "iterations over LMRS_ANATOMY_SLOW_MS")
        self._seg_c = {
            "admit": c("lmrs_anatomy_admit_seconds_total",
                       "admission/QoS-pick + sweep host time", unit="s"),
            "plan": c("lmrs_anatomy_plan_seconds_total",
                      "span/operand/plan build host time", unit="s"),
            "draft": c("lmrs_anatomy_draft_seconds_total",
                       "spec draft+reseed plumbing host time", unit="s"),
            "dispatch": c("lmrs_anatomy_dispatch_seconds_total",
                          "jitted device dispatch call time", unit="s"),
            "fetch": c("lmrs_anatomy_fetch_seconds_total",
                       "device result fetch time", unit="s"),
            "finish": c("lmrs_anatomy_finish_seconds_total",
                        "finish sweep + ledger/SLO note host time",
                        unit="s"),
            "io": c("lmrs_anatomy_io_seconds_total",
                    "journal/session delivery host time", unit="s"),
        }
        self._h_host_us = h("lmrs_anatomy_host_us_step", _HOST_US_BUCKETS,
                            "per-iteration host overhead (wall - dispatch "
                            "- fetch)", unit="us")
        self._c_b_disp = c("lmrs_rpa_bucket_dispatches_total",
                           "ragged-span dispatches across all buckets")
        self._c_b_real = c("lmrs_rpa_bucket_real_tokens_total",
                           "real span tokens dispatched (pre-padding)")
        self._c_b_pad = c("lmrs_rpa_bucket_padded_tokens_total",
                          "padding tokens added by pow2 bucketing")
        self._c_b_compile = c("lmrs_rpa_bucket_compile_seconds_total",
                              "cold-key dispatch wall (compile) time",
                              unit="s")

    # ------------------------------------------------------------- lifecycle

    def iter_begin(self) -> None:
        if self._open:  # defensive: a lost iter_end must not leak forever
            self.iter_abort()
        self._tr = get_tracer()
        self._stack = []
        self._cur = {s: 0.0 for s in SEGMENTS}
        self._t_iter = self._clock()
        self._open = True

    def seg(self, name: str):
        """Context timer for one named segment (see ``SEGMENTS``)."""
        if name not in _SEG_SET:
            raise ValueError(f"unknown anatomy segment {name!r} "
                             f"(want one of {SEGMENTS})")
        return _Seg(self, name)

    def iter_end(self, cls: str) -> None:
        """Fold the open iteration into the totals under step class
        ``cls`` — the only place cumulative state advances, so a caller
        that aborts instead contributes exactly nothing."""
        if not self._open:
            return
        # defensively close dangling frames (a seg left open by a caller
        # bug still participates in conservation rather than vanishing)
        t = self._clock()
        while self._stack:
            e = self._stack.pop()
            self._cur[e[0]] += t - e[2]
            if self._stack:
                self._stack[-1][2] = t
        wall = t - self._t_iter
        seg_sum = sum(self._cur.values())
        residual = wall - seg_sum
        self._open = False

        self._iters += 1
        self._wall += wall
        self._residual += residual
        self._c_iters.inc()
        self._c_wall.inc(max(wall, 0.0))
        self._c_residual.inc(max(residual, 0.0))
        host_us = max(wall - self._cur["dispatch"] - self._cur["fetch"],
                      0.0) * 1e6
        self._host_us += host_us
        self._h_host_us.observe(host_us)
        for s in SEGMENTS:
            self._segs[s] += self._cur[s]
            self._seg_c[s].inc(max(self._cur[s], 0.0))
        if cls not in self._res:  # unknown class: fold under "plain"
            cls = "plain"
        self._cls_iters[cls] += 1
        self._res[cls].append(
            (wall, tuple(self._cur[s] for s in SEGMENTS), residual))

        thresh = slow_step_ms()
        if thresh > 0.0 and wall * 1e3 > thresh:
            self._c_slow.inc()
            dump_postmortem("slow_step", metrics=(
                self._metrics_cb() if self._metrics_cb else None),
                extra={"anatomy": {
                    "class": cls,
                    "wall_ms": round(wall * 1e3, 3),
                    "threshold_ms": thresh,
                    "segments_ms": {s: round(self._cur[s] * 1e3, 3)
                                    for s in SEGMENTS},
                    "residual_ms": round(residual * 1e3, 3)}})

    def iter_abort(self) -> None:
        """Discard the open iteration (fault unwind / stop request).
        Idempotent — the scheduler calls it from ``finally``."""
        if not self._open:
            return
        self._open = False
        self._stack = []
        self._aborted += 1
        self._c_aborted.inc()

    def iter_discard(self) -> None:
        """Close the open iteration WITHOUT counting it anywhere — the
        run-exit pass (the loop's "all work done" break) is bookkeeping,
        not a step, and must pollute neither the totals nor the aborted
        count chaos arms assert on."""
        self._open = False
        self._stack = []

    # ------------------------------------------------------ bucket economics

    def note_bucket(self, tpb: int, w: int, real_tokens: int) -> None:
        """One ragged-span dispatch on bucket (``tpb`` query tokens in the
        packed buffer, ``w`` pow2 page window) that carried
        ``real_tokens`` real span tokens — the rest of the bucket is
        padding."""
        rec = self._buckets.setdefault((int(tpb), int(w)), {
            "dispatches": 0, "real": 0, "padded": 0, "compile_s": 0.0})
        pad = max(int(tpb) - int(real_tokens), 0)
        rec["dispatches"] += 1
        rec["real"] += int(real_tokens)
        rec["padded"] += pad
        self._c_b_disp.inc()
        self._c_b_real.inc(max(int(real_tokens), 0))
        self._c_b_pad.inc(pad)

    def note_compile(self, tpb: int, w: int, seconds: float) -> None:
        """Cold-key dispatch wall for a bucket — the compile cost the pow2
        family pays to keep the bucket count finite.  Kept so the report
        keys match the reference's; the port compiles nothing between
        dispatches (its kernels are built before the first one), so no
        caller feeds it and ``compile_ms`` stays 0."""
        rec = self._buckets.setdefault((int(tpb), int(w)), {
            "dispatches": 0, "real": 0, "padded": 0, "compile_s": 0.0})
        rec["compile_s"] += max(float(seconds), 0.0)
        self._c_b_compile.inc(max(float(seconds), 0.0))

    # --------------------------------------------------------------- reading

    def snapshot(self) -> dict:
        """Window anchor for ``report(before=...)`` (bench/serving_latency
        delta their measurement window off this, same convention as the
        scheduler's raw ``metrics`` snapshot)."""
        return {"iters": self._iters, "aborted": self._aborted,
                "wall": self._wall, "residual": self._residual,
                "host_us": self._host_us,
                "segs": dict(self._segs)}

    def audit(self) -> list[str]:
        """Conservation check over the CUMULATIVE totals (safe to call
        mid-iteration: totals only advance at ``iter_end``).  Violations
        are returned as strings for ``scheduler.audit()`` to aggregate."""
        violations: list[str] = []
        seg_sum = sum(self._segs.values())
        eps = 1e-6 * max(1, self._iters) + 1e-9
        drift = abs(self._wall - (seg_sum + self._residual))
        if drift > eps:
            violations.append(
                f"anatomy conservation: |wall - (segments + residual)| = "
                f"{drift:.3e}s over {self._iters} iterations (eps {eps:.3e})")
        if self._residual < -eps:
            violations.append(
                f"anatomy residual is negative: {self._residual:.3e}s "
                f"(segments overlap — pause bookkeeping broken)")
        for s, v in self._segs.items():
            if v < -eps:
                violations.append(f"anatomy segment {s} went negative: {v}")
        for key, rec in self._buckets.items():
            if rec["real"] + rec["padded"] != rec["dispatches"] * key[0]:
                violations.append(
                    f"anatomy bucket {key[0]}x{key[1]}: real+padded "
                    f"({rec['real']}+{rec['padded']}) != dispatches*bucket "
                    f"({rec['dispatches']}*{key[0]})")
        return violations

    def report(self, before: dict | None = None, *,
               rtt: tuple | None = None) -> dict:
        """The ``anatomy`` block (``metrics_report()`` / ``/v1/anatomy`` /
        bench detail).  Top-level totals window off ``before`` (a
        ``snapshot()``); per-class percentiles and bucket economics stay
        cumulative, like the rpa block's compile shapes.  ``rtt`` is
        ``(rtt_s | None, age_s | None)`` from ``DispatchAttribution.
        rtt_sample()`` — a STALE sample is reported but never subtracted
        from the fetch split."""
        b = before or {}
        iters = self._iters - b.get("iters", 0)
        wall = self._wall - b.get("wall", 0.0)
        residual = self._residual - b.get("residual", 0.0)
        host_us = self._host_us - b.get("host_us", 0.0)
        b_segs = b.get("segs", {})
        segs_ms = {s: round((self._segs[s] - b_segs.get(s, 0.0)) * 1e3, 3)
                   for s in SEGMENTS}

        classes: dict[str, dict] = {}
        for cls in CLASSES:
            rs = self._res[cls]
            if not rs:
                continue
            walls = sorted(r[0] for r in rs)
            p50: dict[str, float] = {}
            p95: dict[str, float] = {}
            for i, s in enumerate(SEGMENTS):
                vals = sorted(r[1][i] for r in rs)
                p50[s] = round(_pct(vals, 50) * 1e6, 1)
                p95[s] = round(_pct(vals, 95) * 1e6, 1)
            p50["wall"] = round(_pct(walls, 50) * 1e6, 1)
            p95["wall"] = round(_pct(walls, 95) * 1e6, 1)
            classes[cls] = {"iterations": self._cls_iters[cls],
                            "p50_us": p50, "p95_us": p95}

        buckets: dict[str, dict] = {}
        tot_real = tot_pad = 0
        for (tpb, w), rec in sorted(self._buckets.items()):
            span = rec["real"] + rec["padded"]
            buckets[f"{tpb}x{w}"] = {
                "dispatches": rec["dispatches"],
                "real_tokens": rec["real"],
                "padded_tokens": rec["padded"],
                "pad_waste": round(rec["padded"] / span, 4) if span else 0.0,
                "compile_ms": round(rec["compile_s"] * 1e3, 1),
            }
            tot_real += rec["real"]
            tot_pad += rec["padded"]

        rtt_s, rtt_age = (rtt if rtt is not None else (None, None))
        out = {
            "object": "anatomy",
            "enabled": True,
            "iterations": iters,
            "aborted_iterations": self._aborted - b.get("aborted", 0),
            "wall_ms": round(wall * 1e3, 3),
            "residual_ms": round(residual * 1e3, 3),
            "segments_ms": segs_ms,
            "host_overhead_us_step": (round(host_us / iters, 1)
                                      if iters > 0 else None),
            "classes": classes,
            "buckets": buckets,
            "rpa_pad_waste_ratio": (
                round(tot_pad / (tot_real + tot_pad), 4)
                if (tot_real + tot_pad) else None),
        }
        if rtt_s is not None:
            stale = rtt_age is None or rtt_age > 2.0 * rtt_resample_s()
            out["rtt_ms"] = round(rtt_s * 1e3, 3)
            out["rtt_stale"] = stale
            if not stale and iters > 0:
                # pure device-wait estimate: fetch minus one host RTT per
                # iteration, floored at 0 — only derived from a FRESH rtt
                fetch_s = (self._segs["fetch"]
                           - b_segs.get("fetch", 0.0))
                out["device_wait_us_step"] = round(
                    max(fetch_s / iters - rtt_s, 0.0) * 1e6, 1)
        return out


def merge_anatomy(docs: list[dict]) -> dict:
    """Merge per-engine ``anatomy`` documents into one fleet view (the
    router's ``GET /v1/anatomy`` and the replicated engine's metrics
    block).  Additive totals sum exactly (iterations, walls, segments,
    bucket token counts — the same one-merge-rule discipline as
    ``merge_usage``); per-class percentiles cannot be merged exactly, so
    they are iteration-weighted means — close under balanced load and
    explicitly an estimate, which is why per-host raw docs travel next to
    the merged view on the router surface."""
    live = [d for d in docs if d and d.get("enabled")]
    if not live:
        return {"object": "anatomy", "enabled": False}
    iters = sum(int(d.get("iterations") or 0) for d in live)
    segs_ms = {s: round(sum(float((d.get("segments_ms") or {}).get(s, 0.0))
                            for d in live), 3) for s in SEGMENTS}
    hosts_us = [(float(d["host_overhead_us_step"]),
                 int(d.get("iterations") or 0)) for d in live
                if d.get("host_overhead_us_step") is not None]
    w_iters = sum(n for _, n in hosts_us)
    classes: dict[str, dict] = {}
    for cls in CLASSES:
        per = [(d["classes"][cls], int(d["classes"][cls]["iterations"]))
               for d in live if cls in (d.get("classes") or {})]
        n_cls = sum(n for _, n in per)
        if not n_cls:
            continue
        keys = (*SEGMENTS, "wall")
        classes[cls] = {
            "iterations": n_cls,
            "p50_us": {k: round(sum(c["p50_us"].get(k, 0.0) * n
                                    for c, n in per) / n_cls, 1)
                       for k in keys},
            "p95_us": {k: round(sum(c["p95_us"].get(k, 0.0) * n
                                    for c, n in per) / n_cls, 1)
                       for k in keys},
        }
    buckets: dict[str, dict] = {}
    tot_real = tot_pad = 0
    for d in live:
        for key, rec in (d.get("buckets") or {}).items():
            m = buckets.setdefault(key, {
                "dispatches": 0, "real_tokens": 0, "padded_tokens": 0,
                "pad_waste": 0.0, "compile_ms": 0.0})
            m["dispatches"] += int(rec.get("dispatches") or 0)
            m["real_tokens"] += int(rec.get("real_tokens") or 0)
            m["padded_tokens"] += int(rec.get("padded_tokens") or 0)
            m["compile_ms"] = round(
                m["compile_ms"] + float(rec.get("compile_ms") or 0.0), 1)
    for m in buckets.values():
        span = m["real_tokens"] + m["padded_tokens"]
        m["pad_waste"] = round(m["padded_tokens"] / span, 4) if span else 0.0
        tot_real += m["real_tokens"]
        tot_pad += m["padded_tokens"]
    return {
        "object": "anatomy",
        "enabled": True,
        "iterations": iters,
        "aborted_iterations": sum(int(d.get("aborted_iterations") or 0)
                                  for d in live),
        "wall_ms": round(sum(float(d.get("wall_ms") or 0.0)
                             for d in live), 3),
        "residual_ms": round(sum(float(d.get("residual_ms") or 0.0)
                                 for d in live), 3),
        "segments_ms": segs_ms,
        "host_overhead_us_step": (
            round(sum(v * n for v, n in hosts_us) / w_iters, 1)
            if w_iters else None),
        "classes": classes,
        "buckets": dict(sorted(buckets.items())),
        "rpa_pad_waste_ratio": (
            round(tot_pad / (tot_real + tot_pad), 4)
            if (tot_real + tot_pad) else None),
    }


def rtt_resample_s() -> float:
    """RTT re-sample cadence (``LMRS_RTT_RESAMPLE_S``) — also
    the staleness horizon the anatomy report guards with (2x cadence)."""
    return env_float("LMRS_RTT_RESAMPLE_S", 300.0, lo=1.0)


def _pct(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (no numpy on the
    report path — /v1/anatomy serves from the HTTP thread)."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class NullAnatomy:
    """The ``LMRS_ANATOMY=0`` object: registers no metrics, every call is
    a no-op, ``seg`` hands back one shared null context — the scheduler
    keeps one unconditional code path while the kill switch restores the
    exact pre-anatomy metrics shape and wire format."""

    enabled = False

    def iter_begin(self) -> None:
        pass

    def seg(self, name: str):
        return _NULL_SEG

    def iter_end(self, cls: str) -> None:
        pass

    def iter_abort(self) -> None:
        pass

    def iter_discard(self) -> None:
        pass

    def note_bucket(self, tpb: int, w: int, real_tokens: int) -> None:
        pass

    def note_compile(self, tpb: int, w: int, seconds: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def audit(self) -> list[str]:
        return []

    def report(self, before: dict | None = None, *,
               rtt: tuple | None = None) -> dict:
        return {"object": "anatomy", "enabled": False}


NULL_ANATOMY = NullAnatomy()


def maybe_anatomy(registry: MetricsRegistry, *, metrics_cb=None,
                  clock=time.time):
    """``StepAnatomy`` when armed, the shared ``NULL_ANATOMY`` otherwise
    (so the disabled path allocates nothing per engine)."""
    if not anatomy_enabled():
        return NULL_ANATOMY
    return StepAnatomy(registry, metrics_cb=metrics_cb, clock=clock)
