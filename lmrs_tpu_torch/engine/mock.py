"""Deterministic no-device engine (the port of the reference's
``engine/mock.py``): the CPU arm of the pipeline, the HTTP server and the
router, with ``lmrs-torch --backend mock`` and ``lmrs-serve-torch
--backend mock``.

Each result is a deterministic extractive sketch of the prompt (first,
middle and last content sentences plus the timestamps), so reduce logic has
real text to work on.  The mock keeps the reference's knob surface and
accounting, emulated from token counts: the mixed-batch and ragged-span
counters, tree speculation's counters, an emulated prefix cache with its
host spill tier (on whenever the cache is, as in the reference) and its
published radix summary, the disaggregated handoff (the "KV state" is the
completion text, pinned and resumed through the same ticket lifecycle) and
the ``/v1/kv`` page-set export and import (the page set is the emulated
prefix entry), and the observability surface: the cost ledger, the SLO
engine and the step anatomy, deterministically emulated from token counts
at ``EMU_SECONDS_PER_TOKEN`` (never wall clocks, so two arms running the
same traffic give identical usage and anatomy documents), a minimal trace
chain (``generate`` then ``finish``, the handoff instants), and the
fair-share QoS admission gate (``slots > 0`` bounds the requests running
at once across handler threads; waiting tickets are admitted in the
policy's order, FIFO under ``LMRS_QOS=0``).
"""

from __future__ import annotations

import hashlib
import re
import threading
import time

from lmrs_tpu_torch.data.tokenizer import ApproxTokenizer
from lmrs_tpu_torch.engine.api import (GenerationRequest, GenerationResult,
                                       apply_stop_sequences,
                                       drain_with_callback, preamble_key,
                                       preamble_text)
from lmrs_tpu_torch.fleet.qos import maybe_qos
from lmrs_tpu_torch.obs.anatomy import CLASSES, SEGMENTS, _pct, anatomy_enabled
from lmrs_tpu_torch.obs.ledger import CostLedger
from lmrs_tpu_torch.obs.slo import SLOEngine
from lmrs_tpu_torch.obs.trace import get_tracer, req_tid
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.testing.faults import InjectedFault
from lmrs_tpu_torch.utils.env import env_bool, env_int
from lmrs_tpu_torch.utils.perf_model import pow2_bucket

_TS_RE = re.compile(r"\[(?:\d+:)?\d{2}:\d{2}\]")


def _mock_tid(tr, req: GenerationRequest) -> int:
    """The request's trace track, by the scheduler's rule: its propagated
    trace id's when it carries one, else the request id's."""
    return (tr.track_for(req.trace_id) if req.trace_id
            else req_tid(req.request_id))


class MockEngine:
    """Offline deterministic engine.  ``fail_pattern``: a substring whose
    presence in a prompt fails that request (the fault injection hook);
    ``latency_s``: seconds each request "takes"."""

    # the handoff runs here: the pinned "KV state" is the completion text
    supports_handoff = True

    # the emulated cache geometry: this many preamble tokens stay resident
    # (LRU) before entries spill to the emulated host pool, each token
    # claiming this many host bytes against ``host_kv_gb``, in pages of
    # this many tokens
    EMU_RESIDENT_TOKENS = 2048
    EMU_BYTES_PER_TOKEN = 1024
    EMU_PAGE_TOKENS = 128
    # the emulated device time of one token: the ledger and the anatomy
    # derive every second from token counts at this rate
    EMU_SECONDS_PER_TOKEN = 1e-6

    def __init__(self, seed: int = 0, latency_s: float = 0.0,
                 fail_pattern: str | None = None,
                 handoff_ttl_s: float = 60.0,
                 mixed_batch: bool | None = None,
                 mixed_token_budget: int = 256,
                 prefix_cache: bool = True,
                 host_kv: bool | None = None,
                 host_kv_gb: float = 1.0,
                 speculate_k: int = 0,
                 cost_ledger: bool | None = None,
                 slo: bool | None = None,
                 slots: int = 0,
                 qos: bool | None = None):
        self.seed = seed
        self.latency_s = latency_s
        self.fail_pattern = fail_pattern
        self.handoff_ttl_s = handoff_ttl_s
        # mixed-batch emulation: requests admitted behind the first of a
        # batch are accounted as budget-clipped prefill slices riding the
        # earlier rows' decode steps.  LMRS_MIXED=0 or a False config
        # disarms, as in the scheduler; the text never changes
        self.mixed_batch = (env_bool("LMRS_MIXED", True)
                            and (mixed_batch is None or bool(mixed_batch)))
        self.mixed_token_budget = max(32, int(mixed_token_budget))
        # the emulated prefix cache (LMRS_PREFIX_CACHE=0 or False disarms)
        self.prefix_cache = (env_bool("LMRS_PREFIX_CACHE", True)
                             and bool(prefix_cache))
        # the host tier composes as in the scheduler: the env or the config
        # disarms it, and it needs the prefix cache and a budget
        self.host_kv = (self.prefix_cache
                        and env_bool("LMRS_HOST_KV", True)
                        and (host_kv is None or bool(host_kv))
                        and host_kv_gb > 0)
        self.host_kv_budget_bytes = int(max(0.0, host_kv_gb) * 2**30)
        self._prefix_lock = threading.Lock()
        # key -> {"tokens", "tier" ("resident"|"spilled"), "tick"}
        self._prefix: dict[str, dict] = {}  # guarded-by: _prefix_lock
        self._prefix_tick = 0           # guarded-by: _prefix_lock
        self._prefix_queries = 0        # guarded-by: _prefix_lock
        self._prefix_hits = 0           # guarded-by: _prefix_lock
        self._prefix_tokens_reused = 0  # guarded-by: _prefix_lock
        self._spilled_hits = 0          # guarded-by: _prefix_lock
        self._tokens_prefetched = 0     # guarded-by: _prefix_lock
        self._spill_pages = 0           # guarded-by: _prefix_lock
        self._prefetch_pages = 0        # guarded-by: _prefix_lock
        self._host_dropped_pages = 0    # guarded-by: _prefix_lock
        self._migrate_exports = 0       # guarded-by: _prefix_lock
        self._migrate_imports = 0       # guarded-by: _prefix_lock
        self._migrate_tokens = 0        # guarded-by: _prefix_lock
        self._mixed_lock = threading.Lock()
        self._mixed_dispatches = 0   # guarded-by: _mixed_lock
        self._mixed_piggybacked = 0  # guarded-by: _mixed_lock
        self._mixed_fill_sum = 0.0   # guarded-by: _mixed_lock
        # the ragged-span knob (LMRS_RPA) and its accounting
        self.rpa = env_bool("LMRS_RPA", True) and self.mixed_batch
        self._rpa_span_tokens = 0      # guarded-by: _mixed_lock
        self._rpa_dispatches = 0       # guarded-by: _mixed_lock
        self._rpa_shapes: set = set()  # guarded-by: _mixed_lock
        # tree speculation's gates and report keys, emulated: a request
        # accepts its full chain depth a step when it carries a draft hint,
        # half of it otherwise
        self.spec_k = max(0, int(speculate_k))
        self.spec_width = env_int("LMRS_SPEC_TREE_WIDTH", 2, lo=1, hi=8)
        while (self.spec_width > 1
               and 1 + self.spec_k * (self.spec_width + 1) > 32):
            self.spec_width -= 1
        self.spec_tree = (self.spec_k > 0 and self.rpa
                          and 1 + self.spec_k * (self.spec_width + 1) <= 32
                          and env_bool("LMRS_SPEC_TREE", True))
        self.spec_adaptive = (self.spec_tree
                              and env_bool("LMRS_SPEC_ADAPTIVE", True))
        self._spec_dispatches = 0  # guarded-by: _mixed_lock
        self._spec_rows = 0        # guarded-by: _mixed_lock
        self._spec_nodes_sum = 0   # guarded-by: _mixed_lock
        self._spec_depth_sum = 0   # guarded-by: _mixed_lock
        self._spec_accepted = 0    # guarded-by: _mixed_lock
        # the draft hints of the requests generated, in generation order
        # (recorded whether or not speculation is armed: tests assert the
        # live layer's previous summary reached the engine)
        self.draft_hints: list[str] = []
        self._tok = ApproxTokenizer()
        # the step anatomy, emulated: segments from token counts, so wall
        # equals the segment sum (residual 0); LMRS_ANATOMY=0 disarms
        self._an_lock = threading.Lock()
        self._an_segs = {s: 0.0 for s in SEGMENTS}  # guarded-by: _an_lock
        self._an_cls: dict[str, list] = {c: [] for c in CLASSES}
        self._an_buckets: dict[tuple[int, int], dict] = {}
        # the cost ledger and the SLO engine, with the scheduler's switches
        # (LMRS_COST_LEDGER=0, LMRS_SLO=0, or a False argument, disarm).
        # The ledger's clock is frozen: residency meters read 0, so usage
        # sums are reproducible (the mock bills work, never wall time)
        cl_on = (env_bool("LMRS_COST_LEDGER", True)
                 and (cost_ledger is None or bool(cost_ledger)))
        slo_on = env_bool("LMRS_SLO", True) and (slo is None or bool(slo))
        self.ledger = CostLedger(enabled=cl_on, clock=lambda: 0.0)
        self.slo = SLOEngine(enabled=slo_on)
        # rid -> prompt tokens the emulated cache served: never billed as
        # prefill, as on the scheduler
        self._billing_saved: dict[int, int] = {}  # guarded-by: _prefix_lock
        # ids cancel() was called for: generation is instantaneous, so the
        # hook records them (tests read it) and a request of the current
        # batch not yet generated comes back "cancelled"
        self.cancelled: set[int] = set()
        # rid -> {"payload", "deadline_t"} of pinned handoffs; handler
        # threads release while generate_batch pins
        self._pinned: dict[int, dict] = {}  # guarded-by: _pinned_lock
        self._pinned_lock = threading.Lock()
        # the fair-share admission gate (fleet/qos.py): slots=0 (the
        # default) runs every generate_batch call at once, no gate; slots>0
        # bounds the requests running at once across handler threads, and
        # waiting tickets are admitted FIFO with QoS off and in the
        # policy's order (class, windowed usage, arrival) with it armed
        self.qos = maybe_qos() if (qos is None or bool(qos)) else None
        if self.qos is not None:
            # the ledger fires the observer after releasing its own lock
            self.ledger.observer = self.qos.note_usage
        self.slots = max(0, int(slots))
        self._adm_cv = threading.Condition()
        self._adm_queue: list = []  # waiting (seq, req) tickets  guarded-by: _adm_cv
        self._adm_seq = 0           # guarded-by: _adm_cv
        self._adm_running = 0       # guarded-by: _adm_cv

    def _adm_pick_locked(self):
        """Next ticket to admit: FIFO by arrival with QoS off, the policy's
        pick with it armed.  The queue stays in arrival order, so a list
        index is the FIFO rank ``pick_index`` breaks ties by."""
        # holds-lock: _adm_cv
        if self.qos is None:
            return self._adm_queue[0]
        return self._adm_queue[self.qos.pick_index(
            [t[1] for t in self._adm_queue])]

    def _admit_wait(self, req: GenerationRequest) -> None:
        """Block until a run slot is free and this request is the admission
        policy's pick.  A no-op with slots=0."""
        if self.slots <= 0:
            return
        with self._adm_cv:
            ticket = (self._adm_seq, req)
            self._adm_seq += 1
            self._adm_queue.append(ticket)
            while not (self._adm_running < self.slots
                       and self._adm_pick_locked() is ticket):
                # a timed wait: a lost wakeup only delays
                self._adm_cv.wait(timeout=0.2)
            self._adm_queue.remove(ticket)
            self._adm_running += 1
            # another slot may still be free for the next pick
            self._adm_cv.notify_all()

    def _admit_release(self) -> None:
        if self.slots <= 0:
            return
        with self._adm_cv:
            self._adm_running -= 1
            self._adm_cv.notify_all()

    def qos_report(self) -> dict:
        """The fair-share window (the scheduler's shape; the ``qos`` block
        of ``GET /v1/usage``)."""
        if self.qos is None:
            return {"object": "qos", "enabled": False}
        return self.qos.report()

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None, on_tokens=None) -> list[GenerationResult]:
        # no start-of-batch clear of the cancel set (a cancel may race the
        # batch boundary), a full clear at the end, as the scheduler does
        def one(req: GenerationRequest) -> GenerationResult:
            self._admit_wait(req)
            try:
                return one_admitted(req)
            finally:
                self._admit_release()

        def one_admitted(req: GenerationRequest) -> GenerationResult:
            tr = get_tracer()
            t0 = time.time()
            if req.draft_hint is not None:
                self.draft_hints.append(req.draft_hint)
            res = self._one(req)
            self._bill(req, res)
            if self.spec_tree and res.completion_tokens:
                # the plain iteration carries the prompt; the emulated
                # spec steps carry the decoded tokens
                self._note_anatomy("plain", dispatch_tokens=res.prompt_tokens,
                                   fetch_tokens=0)
                self._note_spec(req, res.completion_tokens)
            else:
                # one emulated iteration a request: dispatch carries the
                # prompt, fetch the completion
                self._note_anatomy("plain", dispatch_tokens=res.prompt_tokens,
                                   fetch_tokens=res.completion_tokens)
            self.slo.observe_ttft(time.time() - t0)
            self.slo.note_result(res.finish_reason, res.completion_tokens,
                                 res.error)
            if tr:  # a minimal chain: the mock has no queue or slots (the
                # track is resolved after _one, so an imported handoff's
                # trace id takes effect)
                tid = _mock_tid(tr, req)
                tr.complete("generate", t0, time.time(), tid=tid,
                            args={"completion_tokens": res.completion_tokens})
                tr.instant("cancel" if res.finish_reason == "cancelled"
                           else "finish", tid=tid,
                           args={"reason": res.finish_reason})
            if on_tokens is not None and res.text:
                # no incremental decode here: one delta per result
                on_tokens(res.request_id, res.text)
            return res

        # injection site: an engine-level batch fault (callers degrade it to
        # per-request error results)
        faults.fire("engine.batch")
        self._note_mixed_batch(requests)
        try:
            if on_result is not None:
                return drain_with_callback(
                    lambda reqs: [one(r) for r in reqs], requests, on_result)
            return [one(r) for r in requests]
        finally:
            self.cancelled.clear()

    def _note_mixed_batch(self, requests: list[GenerationRequest]) -> None:
        """Requests admitted behind the first of a batch count as chunked
        prefills riding the earlier rows' decode steps, slice-clipped to the
        step budget: the scheduler's dispatch, piggyback and fill
        counters."""
        if not self.mixed_batch or len(requests) < 2:
            return
        n_decode = len(requests) - 1  # rows decoding while the rest admit
        slice_cap = max(16, self.mixed_token_budget - n_decode)
        with self._mixed_lock:
            for req in requests[1:]:
                remaining = self._tok.count(req.prompt)
                while remaining > 0:
                    c = min(remaining, slice_cap)
                    self._mixed_dispatches += 1
                    self._mixed_piggybacked += c
                    self._mixed_fill_sum += min(
                        (n_decode + c) / self.mixed_token_budget, 1.0)
                    if self.rpa:
                        total = n_decode + c
                        self._rpa_dispatches += 1
                        self._rpa_span_tokens += total
                        bucket = pow2_bucket(total, 16)
                        self._rpa_shapes.add(bucket)
                        self._note_rpa_bucket(bucket, total)
                    # each slice is one "mixed" iteration: dispatch carries
                    # the span, fetch the decode tokens
                    self._note_anatomy("mixed", dispatch_tokens=n_decode + c,
                                       fetch_tokens=n_decode)
                    remaining -= c

    def _note_spec(self, req: GenerationRequest,
                   completion_tokens: int) -> None:
        """Tree-speculation accounting for one generated request: each step
        accepts ``k`` drafts with a draft hint, else ``max(1, k // 2)``, and
        emits one more token."""
        k, width = self.spec_k, self.spec_width
        acc = k if req.draft_hint else max(1, k // 2)
        steps = -(-completion_tokens // (1 + acc))
        with self._mixed_lock:
            self._spec_dispatches += steps
            self._spec_rows += steps
            self._spec_nodes_sum += steps * (1 + width * k)
            self._spec_depth_sum += steps * acc
            self._spec_accepted += steps * acc
        # each step is one "spec" iteration: dispatch carries the tree
        # span, fetch the emitted tokens
        for _ in range(steps):
            self._note_anatomy("spec", dispatch_tokens=1 + width * k,
                               fetch_tokens=1 + acc)

    def _note_anatomy(self, cls: str, *, dispatch_tokens: int,
                      fetch_tokens: int) -> None:
        """One emulated scheduler iteration: one-token admit, plan and
        finish segments plus token-count dispatch and fetch, at
        ``EMU_SECONDS_PER_TOKEN`` (wall == segment sum exactly)."""
        if not anatomy_enabled():
            return
        spt = self.EMU_SECONDS_PER_TOKEN
        segs = {s: 0.0 for s in SEGMENTS}
        segs["admit"] = segs["plan"] = segs["finish"] = spt
        segs["dispatch"] = max(0, int(dispatch_tokens)) * spt
        segs["fetch"] = max(0, int(fetch_tokens)) * spt
        with self._an_lock:
            for s in SEGMENTS:
                self._an_segs[s] += segs[s]
            self._an_cls[cls].append(
                (sum(segs.values()), tuple(segs[s] for s in SEGMENTS)))

    def _note_rpa_bucket(self, tpb: int, real_tokens: int) -> None:
        """Bucket economics of one emulated span dispatch: real and padded
        tokens, and an emulated compile cost (bucket x
        ``EMU_SECONDS_PER_TOKEN``) on a shape's first sight."""
        if not anatomy_enabled():
            return
        pages = -(-max(1, int(real_tokens)) // self.EMU_PAGE_TOKENS)
        w = pow2_bucket(pages, 4)
        with self._an_lock:
            first = (tpb, w) not in self._an_buckets
            rec = self._an_buckets.setdefault((tpb, w), {
                "dispatches": 0, "real": 0, "padded": 0, "compile_s": 0.0})
            rec["dispatches"] += 1
            rec["real"] += int(real_tokens)
            rec["padded"] += max(tpb - int(real_tokens), 0)
            if first:
                rec["compile_s"] = tpb * self.EMU_SECONDS_PER_TOKEN

    def anatomy_report(self) -> dict:
        """The ``GET /v1/anatomy`` document, in the scheduler's shape,
        derived from token counts."""
        if not anatomy_enabled():
            return {"object": "anatomy", "enabled": False}
        with self._an_lock:
            segs = dict(self._an_segs)
            cls_recs = {c: list(rs) for c, rs in self._an_cls.items()}
            bucket_recs = {k: dict(v) for k, v in self._an_buckets.items()}
        iters = sum(len(rs) for rs in cls_recs.values())
        wall = sum(segs.values())  # residual 0 by construction
        host = wall - segs["dispatch"] - segs["fetch"]
        classes: dict[str, dict] = {}
        for cls in CLASSES:
            rs = cls_recs[cls]
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
            classes[cls] = {"iterations": len(rs),
                            "p50_us": p50, "p95_us": p95}
        buckets: dict[str, dict] = {}
        tot_real = tot_pad = 0
        for (tpb, w), rec in sorted(bucket_recs.items()):
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
        return {
            "object": "anatomy",
            "enabled": True,
            "iterations": iters,
            "aborted_iterations": 0,
            "wall_ms": round(wall * 1e3, 3),
            "residual_ms": 0.0,
            "segments_ms": {s: round(segs[s] * 1e3, 3) for s in SEGMENTS},
            "host_overhead_us_step": (round(host * 1e6 / iters, 1)
                                      if iters > 0 else None),
            "classes": classes,
            "buckets": buckets,
            "rpa_pad_waste_ratio": (
                round(tot_pad / (tot_real + tot_pad), 4)
                if (tot_real + tot_pad) else None),
        }

    def _bill(self, req: GenerationRequest, res: GenerationResult) -> None:
        """The ledger entry of one finished request: prompt tokens bill as
        prefill, completion tokens as decode, at ``EMU_SECONDS_PER_TOKEN``
        each (pages of ``EMU_PAGE_TOKENS``); tokens the emulated cache
        served bill nothing, as on the scheduler."""
        if not self.ledger.enabled:
            return
        spt = self.EMU_SECONDS_PER_TOKEN
        with self._prefix_lock:
            saved = self._billing_saved.pop(res.request_id, 0)
        billed = max(0, res.prompt_tokens - saved)
        if billed:
            self.ledger.note_step(billed * spt,
                                  prefill_rows=[(req, billed, float(billed))],
                                  prefill_cost_s=1.0)
        if res.completion_tokens:
            pages = -(-(res.prompt_tokens + res.completion_tokens)
                      // self.EMU_PAGE_TOKENS)
            self.ledger.note_step(
                res.completion_tokens * spt,
                decode_rows=[(req, res.completion_tokens, pages)],
                decode_cost_s=1.0)
        res.usage = self.ledger.finish(req, res)

    def usage_report(self) -> dict:
        """The ``GET /v1/usage`` document (the scheduler's shape)."""
        return self.ledger.usage_report()

    def slo_report(self) -> dict:
        """The ``/healthz`` ``slo`` block."""
        return self.slo.report()

    def _note_prefix(self, req: GenerationRequest) -> None:
        """Emulated prefix cache and host tier for one generated request:
        the first sight of a preamble inserts it resident, a later one is a
        hit (tokens reused += its tokens), and a hit on a SPILLED entry also
        counts a prefetch and promotes it.  Past ``EMU_RESIDENT_TOKENS``
        the LRU resident entries spill (tier armed) or drop, and the host
        pool drops LRU entries past ``host_kv_gb``."""
        if not self.prefix_cache:
            return
        key = preamble_key(req.system_prompt, req.prompt, req.cache_prefix)
        if key is None:
            return
        tokens = self._tok.count(preamble_text(
            req.system_prompt, req.prompt, req.cache_prefix))
        pages = -(-tokens // self.EMU_PAGE_TOKENS)
        with self._prefix_lock:
            self._prefix_tick += 1
            self._prefix_queries += 1
            ent = self._prefix.get(key)
            if ent is not None:
                self._prefix_hits += 1
                self._prefix_tokens_reused += ent["tokens"]
                spilled = ent["tier"] == "spilled"
                if spilled:
                    self._spilled_hits += 1
                    self._tokens_prefetched += ent["tokens"]
                    self._prefetch_pages += pages
                    ent["tier"] = "resident"
                self.ledger.note_saved(
                    req, prefix_tokens=0 if spilled else ent["tokens"],
                    prefetched_tokens=ent["tokens"] if spilled else 0,
                    prefetched_bytes=(ent["tokens"] * self.EMU_BYTES_PER_TOKEN
                                      if spilled else 0.0))
                if self.ledger.enabled:  # popped by _bill
                    self._billing_saved[req.request_id] = (
                        self._billing_saved.get(req.request_id, 0)
                        + ent["tokens"])
            else:
                ent = {"tokens": tokens, "tier": "resident", "tick": 0}
                self._prefix[key] = ent
            ent["tick"] = self._prefix_tick
            self._enforce_emulated_budgets()

    def _enforce_emulated_budgets(self) -> None:  # holds-lock: _prefix_lock
        """Spill (or drop) LRU resident entries past the resident budget,
        then drop LRU spilled entries past the host budget."""
        def lru(tier: str):
            cands = [(e["tick"], k) for k, e in self._prefix.items()
                     if e["tier"] == tier]
            return min(cands)[1] if cands else None

        def tier_sum(tier: str, per_token: int) -> int:
            return sum(e["tokens"] * per_token for e in self._prefix.values()
                       if e["tier"] == tier)

        while tier_sum("resident", 1) > self.EMU_RESIDENT_TOKENS:
            key = lru("resident")
            ent = self._prefix[key]
            if (self.host_kv and ent["tokens"] * self.EMU_BYTES_PER_TOKEN
                    <= self.host_kv_budget_bytes):
                ent["tier"] = "spilled"
                self._spill_pages += -(-ent["tokens"] // self.EMU_PAGE_TOKENS)
            else:
                del self._prefix[key]
        while (tier_sum("spilled", self.EMU_BYTES_PER_TOKEN)
               > self.host_kv_budget_bytes):
            ent = self._prefix.pop(lru("spilled"))
            self._host_dropped_pages += -(-ent["tokens"]
                                          // self.EMU_PAGE_TOKENS)

    def prefix_summary(self, top_k: int = 16) -> list[dict]:
        """The emulated radix summary (the router's placement feed), in the
        scheduler's row shape."""
        if not self.prefix_cache:
            return []
        with self._prefix_lock:
            rows = sorted(self._prefix.items(),
                          key=lambda kv: -kv[1]["tick"])[:top_k]
            out = []
            for key, ent in rows:
                res = ent["tier"] == "resident"
                pages = -(-ent["tokens"] // self.EMU_PAGE_TOKENS)
                out.append({"hash": key, "depth_tokens": ent["tokens"],
                            "tick": ent["tick"],
                            "resident_tokens": ent["tokens"] if res else 0,
                            "resident_pages": pages if res else 0,
                            "spilled_tokens": 0 if res else ent["tokens"],
                            "spilled_pages": 0 if res else pages})
        return out

    # ------------------------------------------------- page-set migration
    # the mock's "page set" is the emulated prefix entry: a migrated
    # preamble counts as a prefix hit on the importing host

    def kv_export(self, preamble: str) -> dict | None:
        """Wire payload for one warm preamble, or None (cache off, cold);
        the exporting cache keeps its entry."""
        if not self.prefix_cache:
            return None
        faults.fire("migrate.export")
        with self._prefix_lock:
            ent = self._prefix.get(preamble)
            if ent is None:
                return None
            self._migrate_exports += 1
            return {"kind": "kv_pageset", "version": 1, "emu": True,
                    "preamble": preamble, "tokens": ent["tokens"],
                    "seed": self.seed}

    def kv_import(self, payload: dict) -> int:
        """Install a migrated page set as a warm resident entry.  A paged
        engine's payload, or a mock of another seed (other completion
        bytes), raises ``ValueError``."""
        if not self.prefix_cache:
            raise RuntimeError("prefix cache disabled")
        if payload.get("kind") != "kv_pageset" or not payload.get("emu"):
            raise ValueError("not an emulated kv_pageset payload")
        if payload.get("seed", self.seed) != self.seed:
            raise ValueError("mock seed mismatch: emulated KV bytes differ")
        key = payload["preamble"]
        tokens = int(payload["tokens"])
        if not key or tokens <= 0:
            raise ValueError("malformed kv_pageset payload")
        faults.fire("migrate.import")
        with self._prefix_lock:
            self._prefix_tick += 1
            self._prefix[key] = {"tokens": tokens, "tier": "resident",
                                 "tick": self._prefix_tick}
            self._migrate_imports += 1
            self._migrate_tokens += tokens
            self._enforce_emulated_budgets()
        return tokens

    # ---------------------------------------- disaggregated handoff hooks

    def export_handoff(self, request_id: int) -> dict:
        """Wire payload of a pinned handoff (``KeyError`` when unknown or
        released: the ticket's 410)."""
        with self._pinned_lock:
            return self._pinned[request_id]["payload"]

    def release_handoff(self, request_id: int, orphaned: bool = False) -> int:
        with self._pinned_lock:
            return 1 if self._pinned.pop(request_id, None) else 0

    def sweep_handoffs(self, now: float | None = None) -> int:
        now = time.time() if now is None else now
        with self._pinned_lock:
            expired = [r for r, rec in self._pinned.items()
                       if rec["deadline_t"] <= now]
            for r in expired:
                self._pinned.pop(r)
        return len(expired)

    def pinned_handoffs(self) -> dict[int, int]:
        with self._pinned_lock:
            return {r: 1 for r in self._pinned}

    def shutdown(self) -> None:
        pass

    def cancel(self, request_id: int) -> None:
        """Recorded; a request of the current batch not yet generated when
        its id lands here comes back ``finish_reason="cancelled"``."""
        self.cancelled.add(request_id)

    def engine_metrics(self) -> dict:
        """The blocks the reference's mock reports, each only once work
        flowed through it ({} before any)."""
        out: dict = {}
        with self._mixed_lock:
            d, p, f = (self._mixed_dispatches, self._mixed_piggybacked,
                       self._mixed_fill_sum)
            rd, rt, rs = (self._rpa_dispatches, self._rpa_span_tokens,
                          len(self._rpa_shapes))
            sd, sr, sn, sdep, sacc = (
                self._spec_dispatches, self._spec_rows, self._spec_nodes_sum,
                self._spec_depth_sum, self._spec_accepted)
        if d:
            out["mixed_batch"] = {
                "enabled": self.mixed_batch,
                "token_budget": self.mixed_token_budget,
                "dispatches": d,
                "fill_ratio": round(f / d, 3),
                "prefill_tokens_piggybacked": p,
            }
        if rd:
            out["rpa"] = {"enabled": self.rpa, "dispatches": rd,
                          "span_tokens": rt, "compile_shapes": rs}
        if sd:
            out["spec_accepted_tokens"] = sacc
            out["spec_tree"] = {
                "enabled": self.spec_tree,
                "width": self.spec_width,
                "adaptive": self.spec_adaptive,
                "dispatches": sd,
                "mean_nodes": round(sn / sr, 3) if sr else 0.0,
                "mean_accept_depth": round(sdep / sr, 3) if sr else 0.0,
                "accept_per_step": round(sacc / sr, 3) if sr else 0.0,
            }
        with self._prefix_lock:
            if self._prefix_queries:
                out["prefix_cache"] = {
                    "hit_rate": round(
                        self._prefix_hits / self._prefix_queries, 3),
                    "hits": self._prefix_hits,
                    "queries": self._prefix_queries,
                    "tokens_reused": self._prefix_tokens_reused,
                    "prefill_tokens_saved": self._prefix_tokens_reused,
                    "spilled_hits": self._spilled_hits,
                    "tokens_prefetched": self._tokens_prefetched,
                }
                out["host_kv"] = {
                    "enabled": self.host_kv,
                    "budget_gb": round(self.host_kv_budget_bytes / 2**30, 3),
                    "spilled_hits": self._spilled_hits,
                    "tokens_prefetched": self._tokens_prefetched,
                    "spill_pages": self._spill_pages,
                    "prefetch_pages": self._prefetch_pages,
                    "dropped_pages_total": self._host_dropped_pages,
                }
            if self._migrate_exports or self._migrate_imports:
                out["kv_migrate"] = {
                    "exports": self._migrate_exports,
                    "imports": self._migrate_imports,
                    "tokens_imported": self._migrate_tokens,
                }
        # the cost and anatomy blocks once work flowed; no slo block here:
        # engine_metrics stays deterministic for identical traffic, and SLO
        # burns are wall-clock-fed (consumers read slo_report())
        if self.ledger.enabled and self.ledger.finished_count:
            out["cost"] = self.ledger.report()
        if anatomy_enabled():
            an = self.anatomy_report()
            if an.get("iterations"):
                out["anatomy"] = an
        return out

    def _one(self, req: GenerationRequest) -> GenerationResult:
        def expired() -> bool:
            return (req.deadline_s is not None
                    and time.time() >= req.deadline_s)

        # expired before any work: shed; during the emulated latency:
        # deadline (work was spent)
        if expired():
            return GenerationResult(request_id=req.request_id,
                                    finish_reason="shed")
        if self.latency_s:
            time.sleep(self.latency_s)
            if expired():
                return GenerationResult(request_id=req.request_id,
                                        finish_reason="deadline")
        if req.request_id in self.cancelled:
            return GenerationResult(request_id=req.request_id,
                                    finish_reason="cancelled")
        if self.fail_pattern and self.fail_pattern in req.prompt:
            return GenerationResult(request_id=req.request_id,
                                    finish_reason="error",
                                    error="mock: injected failure")
        if req.handoff_state is not None:
            # decode role: resume from the TRANSFERRED state — the payload's
            # text comes back, never recomputed, so the result proves the
            # handoff carried the prefill side's state.  The handoff.import
            # site degrades per request: a marked import failure
            try:
                faults.fire("handoff.import")
            except InjectedFault as e:
                return GenerationResult(
                    request_id=req.request_id, finish_reason="error",
                    error=f"handoff import failed: {type(e).__name__}: {e}")
            state = req.handoff_state
            if not req.trace_id and isinstance(state.get("trace_id"), str):
                req.trace_id = state["trace_id"]
            if not req.tenant and isinstance(state.get("tenant"), str):
                req.tenant = state["tenant"]
            tr = get_tracer()
            if tr:
                tr.instant("handoff_import", tid=_mock_tid(tr, req),
                           args={"pages": 0,  # the state is pageless text
                                 "kv_len": int(state.get("prompt_tokens", 0))})
            text = state["text"]
            return GenerationResult(
                request_id=req.request_id, text=text,
                prompt_tokens=int(state.get("prompt_tokens", 0)),
                completion_tokens=self._tok.count(text),
                finish_reason=str(state.get("finish_reason", "stop")),
                stop_sequence=state.get("stop_sequence"))
        # prefix accounting for every request that "prefills" here
        self._note_prefix(req)
        text, stop_hit = apply_stop_sequences(
            self._extractive_sketch(req.prompt), req.stop)
        prompt_tokens = self._tok.count(req.prompt)
        if req.handoff_export:
            # prefill role: emit the first "token" (up to the first space)
            # and pin the whole completion as the transferable state; a
            # completion that IS its first token returns whole
            cut = text.find(" ")
            first = text if cut < 0 else text[:cut + 1]
            if first != text:
                try:
                    faults.fire("handoff.export")
                except InjectedFault as e:
                    return GenerationResult(
                        request_id=req.request_id, finish_reason="error",
                        error=f"handoff export failed: "
                              f"{type(e).__name__}: {e}")
                payload = {"text": text, "prompt_tokens": prompt_tokens,
                           "stop_sequence": stop_hit, "finish_reason": "stop"}
                if req.trace_id:
                    payload["trace_id"] = req.trace_id
                if req.tenant:
                    payload["tenant"] = req.tenant
                if req.qos_class:
                    payload["qos_class"] = req.qos_class
                with self._pinned_lock:
                    self._pinned[req.request_id] = {
                        "payload": payload,
                        "deadline_t": time.time() + self.handoff_ttl_s}
                tr = get_tracer()
                if tr:  # the stitcher's skew anchor on the prefill side
                    tr.instant("handoff_export", tid=_mock_tid(tr, req),
                               args={"pages": 0, "kv_len": prompt_tokens})
                return GenerationResult(
                    request_id=req.request_id, text=first,
                    prompt_tokens=prompt_tokens,
                    completion_tokens=self._tok.count(first),
                    finish_reason="handoff")
        return GenerationResult(
            request_id=req.request_id,
            text=text,
            prompt_tokens=prompt_tokens,
            completion_tokens=self._tok.count(text),
            finish_reason="stop",
            stop_sequence=stop_hit,
        )

    def _extractive_sketch(self, prompt: str) -> str:
        """First/middle/last content sentences + every timestamp, capped;
        deterministic in (prompt, seed)."""
        body = prompt
        for marker in ("Transcript section:", "Partial summaries:",
                       "Intermediate summaries:"):
            if marker in body:
                body = body.split(marker, 1)[-1]
        sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+", body)
                     if len(s.strip()) > 30]
        stamps = _TS_RE.findall(body)
        digest = hashlib.sha256(f"{self.seed}:{prompt}".encode()).hexdigest()[:8]
        picked = []
        if sentences:
            idx = sorted({0, len(sentences) // 2, len(sentences) - 1})
            picked = [sentences[i] for i in idx]
        lines = [f"[mock-{digest}] Summary:"]
        lines += [f"- {s[:240]}" for s in picked]
        if stamps:
            # capped, so reduce inputs stay bounded
            uniq = list(dict.fromkeys(stamps))[:12]
            lines.append("Timestamps: " + " ".join(uniq))
        return "\n".join(lines)
