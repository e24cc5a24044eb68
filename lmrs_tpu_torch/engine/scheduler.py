"""Continuous-batching scheduler over the paged KV cache (the port of the
reference's ``engine/scheduler.py``): its default path — packed fresh
prefill, decode blocks, mixed steps, chunked continuation prefill, slot
growth with preemption and the prefix cache, through the ragged span
kernel — its speculative paths (tree and linear), int8 KV pages with
per-slot scales on all of them, cancellation, deadlines and admission
shedding, token streaming (``run(on_tokens=)``), the published radix
summary (``prefix_summary``), the host-RAM and disk spill tiers behind the
prefix cache, the disaggregated prefill→decode handoff and the ``/v1/kv``
page-set export and import, and the reference's observability: a typed
metric registry, the lifecycle tracer's events, live roofline attribution,
the cost ledger, the SLO engine, the step anatomy and flight-recorder
postmortems.

* Admission: a request takes a free slot when the pool holds its PROMPT
  pages minus those a prefix-cache match supplies (the cache evicts before
  back-pressure is declared); the slot starts prefill at the match
  boundary (``prefill_pos``).
* Prefill, when no slot decodes: every prefilling slot advances one chunk
  per iteration.  Whole prompts go in first-fit-decreasing packed bins of
  at most ``max_len`` tokens (``_dispatch_packed``; a lone prompt takes
  ``_dispatch_fresh``; ``LMRS_PACK_PREFILL=0``: every prompt alone);
  continuation chunks — a prefix hit's tail, a
  prompt longer than ``prefill_chunk`` — ride ONE ragged span dispatch
  (``_dispatch_rpa_chunks``).
* Mixed steps, once any slot decodes: every decoding row advances ONE
  token and the oldest prefilling slot's next slice (clipped to
  ``mixed_token_budget`` minus the decoding rows) rides the same span
  dispatch (``_mixed_iteration``), with one host fetch per step.
* Decode blocks otherwise: ``decode_block`` steps for every decoding slot,
  tokens kept on the device, ONE host fetch per block; the prefills' first
  tokens ride that fetch.
* Speculative blocks instead, with ``speculate_k = k > 0`` and mixed steps
  off: ``decode_block // (k + 1)`` steps, each drafting k tokens per row
  by n-gram lookup over a device-side token history, verifying them in one
  [B, k+1] ``forward_paged(multi_decode=True)`` and accepting by the
  exact-distribution rule (``_spec_decode_block``); ONE host fetch per
  block.  First tokens are fetched at decode admission, to seed the row's
  history.
* Tree speculation, with ``speculate_k = k > 0`` and mixed steps on (the
  reference's default for k > 0): every decode step, mixed or not, is ONE
  span dispatch (``_spec_span_iteration``) in which each decode row's span
  is [heal, cur, W root-branching chains of k drafts] (``spec_tree_width``
  gives W), drafted on the device from the history (``draft_tree_lookup``),
  attended through ancestor masks (the span kernel's ancestor-mask build)
  and accepted by ``verify_tree``; one fetch of (emit, count, chain,
  depth).  Tree nodes take depth-based rope positions but write K/V at
  their span-offset columns, so a non-first chain's accepted tokens sit at
  the wrong columns: the row's next span re-sends them first (``heal``,
  base = kv_len - heal) to rewrite them before any read.  A slot preempted
  or finished with a heal pending needs nothing: those columns lie past its
  prompt (the prefix cache takes prompt pages only), and a continuation
  re-prefills prompt + generated tokens.  Chain depth adapts per row
  (``_spec_ramp``, an acceptance EMA; ``LMRS_SPEC_ADAPTIVE=0`` pins it at
  k), collapses to 0 under page pressure, and a step where no row drafts
  or heals is a plain span step whose rows' history is re-seeded before the
  next drafting step.  ``LMRS_SPEC_TREE=0`` (or a k whose tree cannot fit
  32 offsets) keeps the reference's linear span flavour: mixed steps carry
  [cur, k drafts] spans verified by ``verify_tokens``, pure decode runs
  ``_spec_decode_block``.
* Slot growth: decoding slots grow their pages before each dispatch; under
  pool pressure the youngest decode slot is preempted back to the queue
  and later re-prefills prompt + generated tokens
  (``_ensure_decode_capacity``).
* Every completed prefill (and every preempted decode slot) donates its
  preamble pages to the prefix cache (``_cache_insert``).
* Spill tiers (``host_kv``, on by default; ``kv_disk``): an eviction
  captures the victim's pages into host RAM (``PagedKVCache.export_pages``)
  and the node stays spilled; at admission the spilled chain of
  ``match_hier`` is restored into the slot's fresh pages
  (``_prefetch_spilled``, asynchronous unless ``LMRS_HOST_KV_SYNC=1``) and
  counts as matched; a segment that cannot be restored (an entry dropped
  since the match, a ``DiskReadError``, a payload ``ValueError``) truncates
  the match there and its pages become prefill tail.  Off with int8 KV.
* Handoff, prefill side: a ``handoff_export`` request runs with a budget of
  one token; when its first token is not terminal the slot finishes as
  ``"handoff"`` with its prompt pages PINNED and the payload (pages,
  tokens, first token, int8 scales) captured host-side
  (``_pin_handoff``).  ``export_handoff`` reads the payload,
  ``release_handoff`` (the decode side's ack) frees the pages — deferred
  to the next block boundary while a run is live — and
  ``sweep_handoffs`` reclaims pins past their TTL.  Decode side: a request
  with ``handoff_state`` is admitted by import (``_admit_import``) and
  enters decode directly with the resume token; a bad payload finishes it
  as an error.
* ``kv_export``/``kv_import`` (between runs only): one preamble's warm
  page set, resident and spilled, out as a wire payload; in as pages the
  prefix cache adopts.
* Int8 KV (``kv_quantize="int8"``): int8 pools and [L, B, K, hd] f32 K/V
  scale buffers, one row per slot (``kv_scales``), passed to every
  dispatch.  A slot's scales are fixed by the dispatch that computes its
  prompt's first tokens (fresh, packed — segments map to slots through
  ``scale_rows`` — or a span starting at position 0) and reused by every
  later token; a preempted request re-prefills from position 0 and fixes
  new ones.  The prefix cache is off: a hit slot would read donor pages
  quantized with the donor's scales.
* Cancel and deadlines, at block boundaries only (the top of each loop
  iteration, after every prefill, decode block, mixed step or speculative
  block and before ``admit``): ``cancel(rid)`` ids are swept from the queue
  and the slots (``finish_reason="cancelled"``, tokens so far kept); with
  any deadline in the run, passed deadlines expire (``"deadline"``) and
  ``admit`` sheds head entries whose budget cannot cover the TTFT estimate
  (``"shed"``, no engine work).  A swept slot tears down like a finish.
  A run with neither pays one empty-set and one flag test an iteration.
* Observability (``obs/``), all host-side bookkeeping that adds no sync:
  each request's trace track runs enqueue → admit (queue_wait,
  prefix_match) → prefill → first_token → decode → finish (or preempt and
  a new admit, cancel, shed, deadline, handoff_*), and the scheduler track
  carries ``prefill_dispatch`` instants and ``decode_block`` spans with the
  block's model bytes (``hbm_gb``).  Every dispatch wall, taken at the one
  fetch its dispatch already makes, feeds the attribution (decode HBM
  utilisation, prefill MFU) and the ledger (apportioned to its rows); each
  loop pass is one anatomy iteration split into admit/plan/draft/dispatch/
  fetch/finish/io segments.  ``audit()`` carries the ledger's conservation
  and the anatomy's identity; postmortems fire on a dispatch fault, a
  deadline storm and an audit failure.
* Faults and hangs: the top of each loop iteration holds the
  ``scheduler.step`` and ``scheduler.heartbeat`` injection sites
  (``testing/faults.py``) and stamps the dispatch watchdog's heartbeat
  (``engine/watchdog.py``; ``LMRS_WATCHDOG=0``: none), which
  ``TorchEngine``'s runner watches from the caller's thread; a kernel
  build at first use inside a run opens its grace window.  The sites'
  degrade paths: an ``OutOfPages`` at admission requeues, a failed
  prefix-cache adoption costs a hit, a failed restore re-prefills, a
  failed handoff capture or import is a marked error.
* Streaming: ``run(on_tokens=)`` emits ``on_tokens(rid, delta)`` from
  ``_maybe_finish``, which every dispatch path reaches at each host fetch
  (decode blocks, first tokens, mixed steps, span and tree steps).  A delta
  is cut from the trimmed text, so a request's deltas join to exactly its
  result text; trailing U+FFFD (a multi-byte character still arriving) and
  ``max(len(stop)) - 1`` characters while stop strings are set are held
  back until the request finishes, and a delta goes out only while the
  text extends what was sent.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from lmrs_tpu_torch.config import EngineConfig, ModelConfig
from lmrs_tpu_torch.engine.api import (GenerationRequest, GenerationResult,
                                       apply_stop_sequences, preamble_key,
                                       preamble_text, remaining_budget)
from lmrs_tpu_torch.engine.host_kv import (DiskKVPool, DiskReadError,
                                          HostKVPool, as_dtype)
from lmrs_tpu_torch.engine.kv_cache import (OutOfPages, PagedKVCache,
                                            SequencePages, audit_allocator)
from lmrs_tpu_torch.engine.prefix_cache import PrefixCache
from lmrs_tpu_torch.fleet.qos import maybe_qos
from lmrs_tpu_torch.models.transformer import forward_paged
from lmrs_tpu_torch.obs import (POW2_TOKEN_BUCKETS, RATIO_BUCKETS,
                                CostLedger, DispatchAttribution,
                                MetricsRegistry, SLOEngine, dump_postmortem,
                                get_tracer, maybe_anatomy, req_tid)
from lmrs_tpu_torch.ops import kernels
from lmrs_tpu_torch.ops.paged_attention import pack_spans
from lmrs_tpu_torch.ops.sampling import filtered_probs, sample_logits
from lmrs_tpu_torch.ops.speculative import (draft_lookup, draft_tree_lookup,
                                            verify_tokens, verify_tree)
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.testing.faults import InjectedFault
from lmrs_tpu_torch.utils.env import env_bool, env_float, env_int
from lmrs_tpu_torch.utils.perf_model import pow2_bucket, prefill_flops

logger = logging.getLogger("lmrs_torch.scheduler")

# ancestor bitmasks are 32-bit words over a span's offsets
TREE_OFFSETS = 32


# the scheduler's counters: (key in ``counters``, help, unit); each is the
# registry counter ``lmrs_<key>_total``
_COUNTERS: tuple[tuple[str, str, str], ...] = (
    ("requests", "requests submitted to the scheduler", ""),
    ("prefill_tokens", "prompt tokens prefilled", "tokens"),
    ("prefill_dispatches", "prefill dispatches issued", ""),
    ("packed_dispatches", "packed multi-prompt prefill dispatches", ""),
    ("decode_tokens", "tokens generated by decode steps", "tokens"),
    ("decode_blocks", "decode and verify blocks issued", ""),
    ("decode_block_seconds", "host wall of decode blocks, fetch included",
     "seconds"),
    ("mixed_dispatches", "mixed prefill/decode steps issued", ""),
    ("mixed_step_seconds", "host wall of mixed steps, fetch included",
     "seconds"),
    ("prefill_tokens_piggybacked", "prompt tokens prefilled inside mixed "
     "steps", "tokens"),
    ("prefix_queries", "admissions that queried the prefix tree", ""),
    ("prefix_hits", "admissions that matched a cached prefix", ""),
    ("prefix_tokens_reused", "prompt tokens served from cached pages",
     "tokens"),
    ("preemptions", "slots evicted to the queue under page pressure", ""),
    ("stalls", "dispatches a slot sat out waiting for pages", ""),
    ("run_seconds", "scheduler wall-clock inside run()", "seconds"),
    ("spec_accepted_tokens", "draft tokens accepted (speculation)",
     "tokens"),
    ("cancelled", "requests aborted via cancel()", ""),
    ("deadline", "requests expired (finish_reason=deadline)", ""),
    ("shed", "requests shed at admission (finish_reason=shed)", ""),
    ("spec_tree_dispatches", "tree-speculative span dispatches", ""),
    ("spec_tree_nodes_sum", "drafted tree nodes over dispatched rows",
     "nodes"),
    ("spec_tree_rows", "decode rows of tree-speculative dispatches", ""),
    ("spec_accept_depth_sum", "accepted draft depth over dispatched rows",
     "tokens"),
    ("spec_heal_spans", "tree spans that re-sent a heal prefix", ""),
    ("prefix_spilled_hits", "admissions whose match extended into spilled "
     "segments", ""),
    ("prefix_tokens_prefetched", "prompt tokens restored from the spill "
     "tiers", "tokens"),
    ("prefix_spill_pages", "cache pages captured into the host tier",
     "pages"),
    ("prefix_prefetch_pages", "spilled pages restored into device pages",
     "pages"),
    ("spill_dropped_pages", "spilled pages dropped from the host pool",
     "pages"),
    ("prefetch_seconds", "host→device restore issue time", "seconds"),
    ("disk_demoted_pages", "spilled pages demoted host→disk", "pages"),
    ("disk_promoted_pages", "disk pages promoted back", "pages"),
    ("disk_dropped_pages", "disk pages dropped", "pages"),
    ("disk_read_failures", "disk spill reads that failed", ""),
    ("handoff_exports", "requests pinned for prefill→decode handoff", ""),
    ("handoff_imports", "sequences imported from a handoff payload", ""),
    ("handoff_orphaned_pages", "pinned pages reclaimed by the orphan sweep",
     "pages"),
    ("handoff_capture_seconds", "pin-time host capture of exported pages",
     "seconds"),
    ("handoff_import_seconds", "device scatter of imported pages",
     "seconds"),
    ("kv_migrate_exports", "warm page sets exported", ""),
    ("kv_migrate_imports", "migrated page sets imported", ""),
    ("kv_migrate_tokens", "prompt tokens installed by migration", "tokens"),
    ("watchdog_fires", "dispatch wedges declared by the watchdog (run "
     "abandoned, engine degraded fail-fast)", ""),
    ("wedged_requests", "requests terminated finish_reason=\"wedged\" by "
     "the watchdog sweep", ""),
)
# counters whose ``counters`` value stays a float (seconds)
_FLOAT_COUNTERS = frozenset(k for k, _, unit in _COUNTERS
                            if unit == "seconds")


def spec_tree_width(cfg: EngineConfig) -> int:
    """Chains per decode row of tree speculation under ``cfg``, 0 for
    linear speculation (or none).  As in the reference, ``speculate_k > 0``
    with mixed steps is tree speculation of ``LMRS_SPEC_TREE_WIDTH`` chains
    (default 2, 1-8), narrowed until a span of [heal (<= k), cur, width x
    k] fits the 32 offsets of an ancestor mask; ``LMRS_SPEC_TREE=0``, or a
    k too deep for even one chain, leaves linear speculation."""
    k = cfg.speculate_k
    if not (k and cfg.mixed_batch and env_bool("LMRS_SPEC_TREE", True)):
        return 0
    width = env_int("LMRS_SPEC_TREE_WIDTH", 2, lo=1, hi=8)
    while width > 1 and 1 + k * (width + 1) > TREE_OFFSETS:
        width -= 1
    return width if 1 + k * (width + 1) <= TREE_OFFSETS else 0


@dataclass
class _SlotState:
    req: GenerationRequest
    prompt_ids: list[int]  # ids to prefill (after a preemption: prompt + prior)
    max_new: int
    seq: SequencePages
    generated: list[int] = field(default_factory=list)
    kv_len: int = 0
    phase: str = "prefill"  # "prefill" until the prompt is in the pool
    prefill_pos: int = 0    # prompt tokens already in the pool
    t_start: float = 0.0    # first admission (kept across preemptions)
    t_admit: float = 0.0    # this slot life's admission
    # preemption: the continuation re-prefills prompt + prior tokens;
    # ``n_prompt`` is the ORIGINAL prompt length, ``prior`` the tokens
    # generated before the preemption (still output tokens)
    n_prompt: int = 0
    prior: list[int] = field(default_factory=list)
    # tree speculation: the accepted tokens of a NON-FIRST chain, re-sent
    # as the next span's leading tokens to rewrite their K/V at the true
    # columns; the acceptance EMA, chain depth and depth-0 probe timer of
    # the adaptive ramp (_spec_ramp); the token ids of a cross-refresh
    # draft hint and the history-buffer offset it was seeded at (the token
    # at kv position p sits in buffer column p + spec_hoff)
    spec_heal: list[int] = field(default_factory=list)
    spec_ema: float = 0.5
    spec_depth: int = 0
    spec_probe: int = 0
    spec_hint: list[int] = field(default_factory=list)
    spec_hoff: int = 0
    t_decode_start: float = 0.0  # this slot life's decode start (trace)


class ContinuousScheduler:
    """Host-side scheduling loop over device-side prefill/decode work."""

    def __init__(self, engine_cfg: EngineConfig, model_cfg: ModelConfig,
                 params, tokenizer, device: torch.device):
        self.cfg = engine_cfg
        self.model_cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = device
        self.B = engine_cfg.max_batch_slots
        self.max_len = model_cfg.max_seq_len
        self.decode_block = engine_cfg.decode_block
        # speculation: each step verifies spec_k drafts + 1 bonus token, so
        # fewer steps per block keep tokens per block ~ decode_block
        self.spec_k = engine_cfg.speculate_k
        self.decode_steps = (max(1, self.decode_block // (self.spec_k + 1))
                             if self.spec_k else self.decode_block)
        # [B, max_len] token history on the device (seeded per row at
        # decode admission, appended inside each speculative dispatch)
        self._spec_buf: torch.Tensor | None = None
        # tree speculation (spec_tree_width): chains per row, adaptive
        # depth, per-heal-length span templates, and the rows whose history
        # missed an append (plain span steps) and must be re-seeded
        self._spec_width = spec_tree_width(engine_cfg)
        self._spec_tree = self._spec_width > 0
        self._spec_adaptive = (self._spec_tree
                               and env_bool("LMRS_SPEC_ADAPTIVE", True))
        self._spec_tmpl: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._spec_stale: set[int] = set()
        self.prefill_chunk = engine_cfg.prefill_chunk
        # the reference's A/B switches: LMRS_PACK_PREFILL=0 prefills each
        # whole prompt in its own dispatch; LMRS_DEFER_TOK0=0 fetches the
        # first tokens of a prefill wave on their own instead of with the
        # next decode block
        self._pack_prefill = env_bool("LMRS_PACK_PREFILL", True)
        self.defer_tok0 = env_bool("LMRS_DEFER_TOK0", True)
        self._mixed = engine_cfg.mixed_batch
        self.mixed_token_budget = engine_cfg.mixed_token_budget
        ps = engine_cfg.page_size
        max_pages_per_slot = -(-self.max_len // ps)
        # an explicit pool size is a memory budget, floored at one
        # full-length sequence + the null page (a slot alone in the pool
        # always grows, so preemption guarantees progress)
        num_pages = max(engine_cfg.num_pages, max_pages_per_slot + 1)
        kv_quant = engine_cfg.kv_quantize == "int8"
        if kv_quant and ps % 32:
            # kept from the reference (its int8 tiles are 32 rows), so a
            # configuration behaves the same in both packages
            raise ValueError(f"kv_quantize=int8 needs page_size % 32 == 0 "
                             f"(got {ps})")
        self.cache = PagedKVCache(
            model_cfg, num_pages, ps, max_pages_per_slot, device=device,
            dtype=torch.int8 if kv_quant else params["embed"].dtype)
        # int8 KV: per-(slot, kv head, channel) K and V scales, updated in
        # place by the dispatches that fix them (models/transformer.py)
        self.kv_scales: tuple[torch.Tensor, torch.Tensor] | None = None
        if kv_quant:
            sshape = (model_cfg.n_layers, self.B, model_cfg.n_kv_heads,
                      model_cfg.hd)
            self.kv_scales = (torch.ones(sshape, device=device),
                              torch.ones(sshape, device=device))
        # The scheduler's typed metrics (obs/metrics.py): one registry per
        # engine, exposed in Prometheus text by the server's /metrics;
        # ``counters`` and ``metrics_report()`` are derived views over it
        self.registry = MetricsRegistry()
        c, g, h = (self.registry.counter, self.registry.gauge,
                   self.registry.histogram)
        self._m = {key: c(f"lmrs_{key}_total", help_, unit)
                   for key, help_, unit in _COUNTERS}
        self._m["peak_pages"] = g("lmrs_peak_pages_in_use",
                                  "max KV pages simultaneously allocated",
                                  "pages")
        self._h_occupancy = h("lmrs_decode_occupancy_ratio",
                              buckets=RATIO_BUCKETS,
                              help="fraction of batch slots live per decode "
                                   "dispatch")
        self._h_mixed_fill = h("lmrs_mixed_batch_fill_ratio",
                               buckets=RATIO_BUCKETS,
                               help="real tokens over mixed_token_budget "
                                    "per mixed step")
        self._h_rpa_span = h("lmrs_rpa_span_tokens",
                             buckets=POW2_TOKEN_BUCKETS,
                             help="real query-span tokens per ragged span "
                                  "dispatch", unit="tokens")
        self._h_spill_capture = h("lmrs_prefix_spill_capture_seconds",
                                  help="device→host capture of one spilled "
                                       "node's pages", unit="seconds")
        self._h_ttft = h("lmrs_ttft_seconds",
                         help="time to first token (engine-side)",
                         unit="seconds")
        self._h_block_gap = h("lmrs_decode_block_gap_seconds",
                              help="gap between consecutive decode "
                                   "dispatches", unit="seconds")
        self._h_queue_wait = h("lmrs_queue_wait_seconds",
                               help="enqueue -> slot admission wait",
                               unit="seconds")
        self._h_prefill_batch = h("lmrs_prefill_batch_tokens",
                                  buckets=POW2_TOKEN_BUCKETS,
                                  help="real prompt tokens per prefill "
                                       "dispatch", unit="tokens")
        self._tr = get_tracer()  # refreshed at each run()
        # Live roofline attribution (obs/perf.py): model FLOPs and bytes
        # of each dispatch over its wall (taken at the fetch the dispatch
        # already makes) against chip_spec()'s peaks.  Prefill dispatches
        # issued this iteration are sequenced on the device before the
        # dispatch that fetches their first tokens, so their FLOPs (and
        # the ledger's per-row view of them) wait here until that fetch.
        self._perf = DispatchAttribution(model_cfg, engine_cfg,
                                         self.registry, device=device)
        self._attr_pending_flops = 0.0
        self._attr_last_gb = 0.0  # last dispatch's model bytes (span arg)
        self._cost_pending_prefill: list[tuple] = []
        # (wall_s, decode_cost_s, prefill_cost_s, prefill_rows) of the last
        # decode or verify block, billed where its per-row tokens are known
        self._cost_step: tuple | None = None
        # The cost ledger (obs/ledger.py), the SLO engine (obs/slo.py) and
        # the step anatomy (obs/anatomy.py); LMRS_COST_LEDGER=0, LMRS_SLO=0
        # and LMRS_ANATOMY=0 turn each off (pure host bookkeeping: outputs
        # are the same either way)
        self._cost = CostLedger(self.registry)
        # Fair-share QoS (fleet/qos.py): admission picks by (class rank,
        # windowed device-seconds / weight, FIFO) and preemption victimizes
        # over-quota bulk work first; the ledger's apportionments feed the
        # policy's sliding window (the observer fires outside the ledger
        # lock).  LMRS_QOS=0 leaves _qos None: FIFO admission and the
        # youngest victim exactly
        self._qos = maybe_qos(self.registry)
        if self._qos is not None:
            self._cost.observer = self._qos.note_usage
        # the postmortems' counter snapshot, through a weak reference: a
        # strong one would make a cycle that keeps a dropped engine's
        # pools and weights on the card until a garbage collection
        me = weakref.ref(self)
        snapshot = lambda: me().counters if me() is not None else {}  # noqa: E731
        self._slo = SLOEngine(self.registry, metrics_cb=snapshot)
        self._an = maybe_anatomy(self.registry, metrics_cb=snapshot)
        # LMRS_PROFILE_ON_SLOW_STEP: the first warm decode block slower
        # than the threshold starts one torch.profiler capture per process
        self._slow_step_fired = False
        # the dispatch watchdog (engine/watchdog.py): the loop stamps a
        # heartbeat each iteration and TorchEngine's WatchdogRunner watches
        # it from the caller thread.  LMRS_WATCHDOG=0: no watchdog, run()
        # executes inline on the caller thread
        self.watchdog = None
        if env_bool("LMRS_WATCHDOG", True):
            from lmrs_tpu_torch.engine.watchdog import DispatchWatchdog

            self.watchdog = DispatchWatchdog()
        # the counters the watchdog's wedge sweep bumps, under the
        # reference's attribute names
        self._c_watchdog_fires = self._m["watchdog_fires"]
        self._c_wedged = self._m["wedged_requests"]
        self._c_deadline = self._m["deadline"]
        self._warm_kinds: set[str] = set()
        self._last_block_t: float | None = None  # run-scoped (run())
        # LMRS_HOST_KV_SYNC=1 blocks on each restore (the A/B fallback for
        # the default asynchronous copy)
        self._host_kv_sync = env_bool("LMRS_HOST_KV_SYNC", False)
        self._prefix_cache: PrefixCache | None = None
        # LMRS_PREFIX_CACHE=0 is the kill switch, as in the reference
        pc_on = engine_cfg.prefix_cache and env_bool("LMRS_PREFIX_CACHE", True)
        if pc_on and kv_quant:
            logger.info("prefix cache disabled: incompatible with int8 KV "
                        "(per-slot scales cannot cover donor pages)")
        elif pc_on:
            pool = None
            if engine_cfg.host_kv and engine_cfg.host_kv_gb > 0:
                disk = None
                if engine_cfg.kv_disk and engine_cfg.kv_disk_gb > 0:
                    disk = DiskKVPool(int(engine_cfg.kv_disk_gb * 2**30),
                                      engine_cfg.kv_disk_dir)
                pool = HostKVPool(int(engine_cfg.host_kv_gb * 2**30),
                                  disk=disk)
            capture = None
            if pool is not None:
                # a weak reference: the pool already reaches the prefix
                # cache through reclaim_cb, and a strong one back would
                # keep a dropped engine's pool alive until a collection
                export = weakref.WeakMethod(self.cache.export_pages)
                capture = lambda pages: export()(pages)  # noqa: E731
            sinks = {name: self._m[key] for name, key in (
                ("spill_pages", "prefix_spill_pages"),
                ("spill_dropped", "spill_dropped_pages"),
                ("disk_demoted", "disk_demoted_pages"),
                ("disk_promoted", "disk_promoted_pages"),
                ("disk_dropped", "disk_dropped_pages"),
                ("disk_read_fail", "disk_read_failures"))}
            sinks["spill_capture_s"] = self._h_spill_capture
            self._prefix_cache = PrefixCache(
                self.cache.allocator, ps,
                max_pages=engine_cfg.prefix_cache_max_pages,
                spill_pool=pool,
                capture_cb=capture,
                page_bytes=self.cache.page_payload_bytes(), metrics=sinks)
            self.cache.reclaim_cb = self._prefix_cache.evict
        # Handoff pins: rid -> {seq, payload, deadline_t, t_pinned} of the
        # prefill-role slots whose pages wait for the decode side's ack.
        # The lock covers the dict, the deferred releases and the run flag:
        # export/release run on HTTP handler threads while the scheduler
        # pins.  Off-thread releases never touch the allocator mid-run: the
        # record parks on _release_deferred and the scheduler thread frees
        # it at the next block boundary; between runs the free happens
        # inline under the lock (a starting run takes the lock to set
        # _run_live before its first allocation).
        self._pinned: dict[int, dict] = {}  # guarded-by: _pinned_lock
        self._release_deferred: list[tuple[int, dict]] = []  # guarded-by: _pinned_lock
        self._run_live = False  # guarded-by: _pinned_lock
        self._pinned_lock = threading.Lock()
        self.generator = torch.Generator(device=device).manual_seed(
            engine_cfg.seed + 1)
        # a model vocabulary wider than the tokenizer's (a byte tokenizer on
        # a 512- or 128k-row embedding) has rows no text maps to: they are
        # never sampled, so every generated id decodes
        self._vocab_limit = (tokenizer.vocab_size
                             if tokenizer.vocab_size < model_cfg.vocab_size
                             else None)
        self._double_finish = 0
        self._finished_ids: set[int] = set()
        # cancel(): ids land here from any thread (set.add is atomic under
        # the GIL) and are swept at the next block boundary; cleared at the
        # end of each run
        self._cancelled: set[int] = set()
        # deadline bookkeeping: _any_deadline gates the expiry sweep and
        # admission shedding so deadline-free runs pay nothing; _ttft_min is
        # the fastest TTFT this engine delivered (the optimistic estimate:
        # shed only what is provably unmeetable), _t_enq the run's enqueue
        # times, consumed at each request's first token
        self._any_deadline = False
        self._ttft_min = float("inf")
        self._t_enq: dict[int, float] = {}
        self._slots: list | None = None  # the live run's slots
        # streaming (run()-scoped): the callback, and rid -> text emitted
        self._on_tokens = None
        self._streamed: dict[int, str] = {}
        # published radix summary: preamble_key -> {"ids", "tick"} of the
        # preambles donated to the prefix cache (an LRU of 32), written by
        # the scheduler thread and read by HTTP handler threads through
        # the memoized prefix_summary() snapshot
        self._preambles: dict[str, dict] = {}
        self._preamble_tick = 0
        self._summary_memo: tuple[float, list] | None = None

    def live_tokens(self) -> dict[int, int]:
        """Request id -> output tokens so far, for each request holding a
        slot in the run in flight (empty between runs)."""
        return {st.req.request_id: len(st.prior) + len(st.generated)
                for st in self._slots or () if st is not None}

    def cancel(self, request_id: int) -> None:
        """Abort ``request_id`` of the current run at the next block
        boundary: a live slot finishes with ``finish_reason="cancelled"``
        (tokens so far kept) and frees its pages; a queued entry never
        prefills.  Callable from any thread; unknown ids are a no-op."""
        self._cancelled.add(request_id)

    # ------------------------------------------------------------- run loop

    def run(self, requests: list[GenerationRequest],
            on_result=None, on_tokens=None) -> list[GenerationResult]:
        """Run the stream to completion; results come back in submission
        order.  ``on_result(result, submit)`` fires inside the loop as each
        request completes, and ``submit(more)`` feeds new requests into the
        same run.  ``on_tokens(request_id, delta)`` fires at each host
        fetch with a request's new text (see the module docstring).
        request_ids must be unique within a run."""
        t_run = time.time()
        # per-run tracer capture: a None tracer keeps every site one branch
        tr = self._tr = get_tracer()
        # taken before the first allocator touch: an off-thread
        # release_handoff freeing inline holds this lock, so it either
        # completes before the flag flips or sees it set and defers
        with self._pinned_lock:
            self._run_live = True
        self._on_tokens = on_tokens
        self._streamed = {}
        # queue entries: (req, prefill_ids, max_new, n_prompt, prior,
        # t_start) — the last three carry a preempted request's state
        queue: deque[tuple] = deque()
        all_requests: list[GenerationRequest] = []
        results: dict[int, GenerationResult] = {}
        fresh: deque[int] = deque()

        def submit(new_requests: list[GenerationRequest]) -> None:
            for req in new_requests:
                all_requests.append(req)
                ids, max_new = self._encode(req)
                queue.append((req, ids, max_new, len(ids), [], None))
                self._t_enq[req.request_id] = time.time()
                if req.deadline_s is not None:
                    self._any_deadline = True
                self._m["requests"].inc(1)
                if tr:
                    tr.instant("enqueue", ts=self._t_enq[req.request_id],
                               tid=self._tid(req),
                               args={"prompt_tokens": len(ids)})

        self._finished_ids = set()
        self._t_enq = {}
        self._spec_stale.clear()  # slot rows do not survive runs
        self._any_deadline = False
        submit(requests)
        B = self.B
        slots: list[_SlotState | None] = [None] * B
        self._slots = slots
        last_tok = np.zeros((B,), np.int64)
        kv_lens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)

        def admit() -> None:
            for b in range(B):
                if slots[b] is not None:
                    continue
                # fair-share admission (fleet/qos.py): promote the policy's
                # pick from the queue's 64-entry head window to the front;
                # the others keep their order (a promotion, not a rotation,
                # so skipped entries do not starve)
                if self._qos is not None and len(queue) > 1:
                    win = min(len(queue), 64)
                    k = self._qos.pick_index(
                        [queue[i][0] for i in range(win)])
                    if k:
                        ent = queue[k]
                        del queue[k]
                        queue.appendleft(ent)
                        if tr:
                            tr.instant("qos_reorder",
                                       args={"picked": k, "window": win,
                                             "tenant": ent[0].tenant
                                             or "default"})
                # deadline admission control: shed head entries whose
                # remaining budget cannot cover the TTFT estimate, before
                # any prefill
                while queue and self._any_deadline:
                    rem = remaining_budget(queue[0][0])
                    if rem is None or rem >= self._ttft_estimate(
                            len(queue[0][1])):
                        break
                    self._expire_queue_entry(queue, 0, results, fresh)
                if not queue:
                    break
                req, ids, max_new, n_prompt, prior, t0 = queue[0]
                if req.handoff_state is not None:
                    # decode role: the pages arrive by import, the slot
                    # enters decode directly; False = page back-pressure
                    if not self._admit_import(b, queue, slots, results,
                                              fresh, kv_lens, last_tok,
                                              active, temps, top_k, top_p):
                        break
                    continue
                # prefix-cache probe: the matched pages come with a
                # reference of their own; the match leaves >= 1 token.  The
                # spilled chain extends it once restored into fresh pages
                cached_pages: list[int] = []
                cached_tokens = 0
                spill_chain: list = []
                if self._prefix_cache is not None:
                    cached_pages, cached_tokens, spill_chain = \
                        self._prefix_cache.match_hier(ids)
                # admission reserves PROMPT pages only; decode pages grow
                # per dispatch (_ensure_decode_capacity)
                need = min(self.cache.pages_needed(len(ids)),
                           self.cache.max_pages_per_slot) - len(cached_pages)
                free = self.cache.allocator.free_count
                if need > free and self._prefix_cache is not None:
                    # evict unshared cache before declaring back-pressure
                    self._prefix_cache.evict(need - free)
                if need > self.cache.allocator.free_count:
                    if cached_pages:  # release the match references
                        self.cache.allocator.free(cached_pages)
                    break  # back-pressure: wait for pages to free up
                queue.popleft()
                try:
                    fresh_pages = self.cache.alloc_pages(need)
                except OutOfPages:
                    # pressure raced (or was injected) past the free-count
                    # check: release the match references, requeue at the
                    # head and wait (back-pressure, never failure)
                    if cached_pages:
                        self.cache.allocator.free(cached_pages)
                    queue.appendleft((req, ids, max_new, n_prompt, prior, t0))
                    break
                prefetched_tokens = 0
                if spill_chain:
                    try:
                        before = cached_tokens
                        cached_pages, fresh_pages, cached_tokens = \
                            self._prefetch_spilled(spill_chain, cached_pages,
                                                   fresh_pages, cached_tokens)
                        prefetched_tokens = cached_tokens - before
                    except BaseException:
                        # a device error: the pages held here belong to no
                        # slot yet, so they go back before the run unwinds
                        self.cache.allocator.free(cached_pages + fresh_pages)
                        raise
                seq = SequencePages(pages=cached_pages + fresh_pages)
                if self._prefix_cache is not None:
                    self._m["prefix_queries"].inc(1)
                    if cached_tokens:
                        self._m["prefix_hits"].inc(1)
                        self._m["prefix_tokens_reused"].inc(cached_tokens)
                        self._cost.note_saved(
                            req,
                            prefix_tokens=cached_tokens - prefetched_tokens,
                            prefetched_tokens=prefetched_tokens,
                            prefetched_bytes=(
                                self.cache.pages_needed(prefetched_tokens)
                                * self.cache.page_payload_bytes()
                                if prefetched_tokens else 0.0))
                now = time.time()
                rid = req.request_id
                # queue wait = enqueue -> FIRST admission (a continuation
                # carries its original t_start in t0)
                t_q = self._t_enq.get(rid)
                if t_q is not None and t0 is None:
                    self._h_queue_wait.observe(max(0.0, now - t_q))
                    self._cost.note_queue_wait(req, now - t_q)
                    if tr:
                        tr.complete("queue_wait", t_q, now,
                                    tid=self._tid(req))
                if tr:
                    tr.instant("admit", ts=now, tid=self._tid(req),
                               args={"slot": b,
                                     "continuation": t0 is not None})
                    if cached_tokens:
                        tr.instant("prefix_match", ts=now,
                                   tid=self._tid(req),
                                   args={"tokens_reused": cached_tokens,
                                         "tokens_prefetched":
                                             prefetched_tokens})
                # a continuation keeps its ORIGINAL t_start, so the same
                # request never becomes the perpetual youngest victim
                slots[b] = _SlotState(
                    req=req, prompt_ids=ids, max_new=max_new, seq=seq,
                    prefill_pos=cached_tokens,
                    t_start=t0 if t0 is not None else now, t_admit=now,
                    n_prompt=n_prompt, prior=list(prior),
                    # tree speculation starts at full depth
                    spec_depth=self.spec_k if self._spec_tree else 0,
                    spec_hint=self._hint_ids(req, len(ids), max_new))
                # a row mid-prefill carries length 0 into any dispatch
                kv_lens[b] = 0
                last_tok[b] = 0
                active[b] = False
                temps[b] = req.temperature
                top_k[b] = req.top_k
                top_p[b] = min(max(req.top_p, 0.0), 1.0)
                self._note_peak_pages()

        def finish_first_tokens(deferred, tok0s, finish_all: bool) -> None:
            """Record the first tokens of this iteration's prefills."""
            for b, p, row in deferred:
                st = slots[b]
                if st is None:
                    continue  # preempted: its continuation resamples tok0
                st.generated.append(int(tok0s[p][row]))
                self._note_first_token(st)
                last_tok[b] = st.generated[-1]
                with an.seg("draft"):
                    self._seed_history(b, st)
                if finish_all or not active[b]:
                    # a stalled row emitted nothing this dispatch, but its
                    # first token is real output: check for an early finish
                    self._maybe_finish(b, slots, results, fresh, active,
                                       kv_lens, last_tok)

        def sync_first_tokens(pending, deferred, t_pf: float) -> None:
            """Fetch this iteration's first tokens on their own (no decode
            dispatch carries them): the wall from the wave's issue to this
            fetch is a clean prefill sample and one ledger note."""
            with an.seg("fetch"):
                tok0s = [t.numpy() for t in
                         _one_fetch([t for t, _ in pending])]
            t_fetch = time.time()
            with an.seg("finish"):
                self._perf.note_prefill_sync(
                    self._consume_prefill_attr(), t_pf, t_fetch,
                    warm=self._warm("prefill"))
                self._cost.note_step(max(0.0, t_fetch - t_pf),
                                     prefill_rows=self._consume_prefill_cost(),
                                     prefill_cost_s=1.0)
                finish_first_tokens(deferred, tok0s, finish_all=True)

        # step anatomy (obs/anatomy.py): one record per loop pass, closed by
        # iter_end (classed) at every continue and at the bottom; the exit
        # break discards it and the finally aborts what a fault left open
        an = self._an
        self._last_block_t = None
        wd = self.watchdog
        if wd is not None:
            wd.run_started()
        # a kernel built at first use inside this run opens the watchdog's
        # grace window (ops/kernels.load, on this thread)
        kernels.set_build_watchdog(wd)
        try:
            while True:
                an.iter_begin()
                with an.seg("admit"):
                    # injection site: a fired plan fails this iteration the
                    # way a bad dispatch would (the recovery path below)
                    faults.fire("scheduler.step")
                    # injection site + heartbeat: a "stall" plan here wedges
                    # the loop as a hung card would (no beat lands and the
                    # watchdog declares the wedge; with LMRS_WATCHDOG=0 the
                    # stall just holds the run)
                    faults.fire("scheduler.heartbeat")
                    if wd is not None:
                        wd.beat()
                    # block boundary: sweep cancels and expired deadlines;
                    # their results go out with this iteration's fresh batch
                    if self._cancelled:
                        self._sweep_cancelled(queue, slots, results, fresh,
                                              active, kv_lens, last_tok)
                    # acked or orphaned handoffs released off-thread free
                    # here
                    if self._release_deferred:
                        self._drain_released()
                    if self._any_deadline:
                        self._sweep_deadlines(queue, slots, results, fresh,
                                              active, kv_lens, last_tok)
                with an.seg("io"):
                    if on_result is not None:
                        while fresh:
                            on_result(results[fresh.popleft()], submit)
                if not (queue or any(s is not None for s in slots)):
                    an.iter_discard()
                    break
                with an.seg("admit"):
                    admit()
                if self._mixed:
                    with an.seg("plan"):
                        did = self._mixed_iteration(
                            slots, queue, results, fresh, kv_lens, last_tok,
                            active, temps, top_k, top_p)
                    if did:
                        an.iter_end("spec" if self.spec_k else "mixed")
                        continue
                t_pf = time.time()  # the prefill wave's issue anchor
                with an.seg("plan"):
                    pending = self._advance_prefills(slots)
                deferred = []  # (slot, pending index, row)
                with an.seg("finish"):
                    for p, (_, rows) in enumerate(pending):
                        for b, row in rows:
                            self._enter_decode(b, slots[b], kv_lens, active)
                            deferred.append((b, p, row))
                if deferred and (self.spec_k or not self.defer_tok0 or any(
                        slots[b].req.handoff_export for b, _, _ in deferred)):
                    # speculation seeds each new decode row's history with
                    # its first token, and a handoff slot (budget 1) pins
                    # on it: fetch the first tokens now (LMRS_DEFER_TOK0=0:
                    # always)
                    sync_first_tokens(pending, deferred, t_pf)
                    deferred = []
                if not active.any():
                    an.iter_end("prefill")
                    continue
                if self._spec_tree:
                    # pure-decode steps of tree speculation are span steps
                    # too: the verify kernel's block never sees a row with a
                    # heal pending.  Nothing dispatched means every row
                    # stalled: loop (preemption guarantees progress)
                    with an.seg("plan"):
                        self._spec_span_iteration(None, slots, queue, results,
                                                  fresh, kv_lens, last_tok,
                                                  active, temps, top_k, top_p)
                    an.iter_end("spec")
                    continue
                with an.seg("admit"):
                    stalled = self._ensure_decode_capacity(
                        slots, queue, kv_lens, last_tok, active)
                if not active.any():
                    # no dispatch carries these first tokens: fetch now
                    if deferred:
                        sync_first_tokens(pending, deferred, t_pf)
                    self._rearm(stalled, slots, active)
                    an.iter_end("prefill")
                    continue
                n_live = int(active.sum())
                now = time.time()
                self._note_dispatch_gap(now)
                with an.seg("plan"):
                    if self.spec_k:
                        emitted = self._spec_decode_block(
                            slots, last_tok, kv_lens, active, temps, top_k,
                            top_p)
                    else:
                        toks, n_valid, tok0s = self._decode_block(
                            slots, last_tok, kv_lens, active, temps, top_k,
                            top_p, pending)
                        emitted = [toks[b, : int(n_valid[b])].tolist()
                                   for b in range(B)]
                with an.seg("finish"):
                    # billed before any of this iteration's finishes: a row
                    # finishing on this block is billed while its ledger
                    # entry is still open
                    self._bill_block(slots, active, emitted)
                    if not self.spec_k:
                        finish_first_tokens(deferred, tok0s, finish_all=False)
                    block_tokens = 0
                    for b in range(B):
                        st = slots[b]
                        if st is None or not active[b]:
                            continue
                        new = emitted[b]
                        st.generated.extend(new)
                        st.kv_len += len(new)
                        kv_lens[b] = st.kv_len
                        last_tok[b] = st.generated[-1]
                        self._m["decode_tokens"].inc(len(new))
                        block_tokens += len(new)
                        if tr and new:
                            tr.instant("decode_block", ts=now,
                                       tid=self._tid(st.req),
                                       args={"tokens": len(new)})
                        self._maybe_finish(b, slots, results, fresh, active,
                                           kv_lens, last_tok)
                    if tr:
                        # the scheduler track's dispatch span: issue through
                        # host-side result processing; hbm_gb is the block's
                        # model byte cost (0 for verify blocks)
                        tr.complete("decode_block", now, time.time(),
                                    args={"active": n_live,
                                          "tokens": block_tokens,
                                          "hbm_gb": self._attr_last_gb})
                    self._rearm(stalled, slots, active)
                an.iter_end("spec" if self.spec_k else "plain")
        except Exception as run_exc:
            # the flight recorder first, so the postmortem holds the spans
            # and counters as the fault left them (a no-op unless
            # LMRS_POSTMORTEM_DIR is armed; never raises)
            dump_postmortem(
                "dispatch_fault", metrics=self.counters,
                extra={"error": f"{type(run_exc).__name__}: {run_exc}",
                       "live_slots": sum(s is not None for s in slots),
                       "queued": len(queue)})
            # the engine must survive for the next batch: free every live
            # slot's pages and drop the cache (the caller turns the
            # exception into error results)
            for b in range(B):
                if slots[b] is not None:
                    self.cache.close_sequence(slots[b].seq)
                    slots[b] = None
            # pinned handoffs drop too (the next ticket fetch answers 410
            # and the router re-prefills), freed before the cache clear so
            # no node is left shared with a dead pin
            with self._pinned_lock:
                dropped = ([r["seq"] for r in self._pinned.values()]
                           + [r["seq"] for _, r in self._release_deferred])
                self._pinned.clear()
                self._release_deferred.clear()
            for seq in dropped:
                self.cache.close_sequence(seq)
            if dropped:
                logger.warning("pool recovery dropped %d pinned handoffs",
                               len(dropped))
            if self._prefix_cache is not None:
                self._prefix_cache.clear()
            raise
        finally:
            if wd is not None:
                wd.run_ended()
            kernels.set_build_watchdog(None)
            with self._pinned_lock:
                self._run_live = False
            # releases parked during the run free here, on this thread
            self._drain_released()
            self._m["run_seconds"].inc(max(0.0, time.time() - t_run))
            # an iteration a fault left open contributes nothing to the
            # anatomy (a no-op after a clean close); un-consumed prefill
            # work must not bill the next run's first dispatch
            an.iter_abort()
            self._attr_pending_flops = 0.0
            self._cost_pending_prefill = []
            self._cost_step = None
            self._cancelled.clear()
            self._slots = None
            self._on_tokens = None
            self._streamed = {}
        return [results[r.request_id] for r in all_requests]

    # ------------------------------------------------------------ internals

    def _encode(self, req: GenerationRequest) -> tuple[list[int], int]:
        """bos + (system prompt + prompt) ids, middle-truncated so prompt +
        budget fit the window; budget capped at max_seq_len - 1."""
        text = (req.system_prompt + "\n\n" if req.system_prompt else "") + req.prompt
        ids = [self.tokenizer.bos_id] + self.tokenizer.encode(text)
        max_new = min(req.max_new_tokens, self.cfg.max_tokens, self.max_len - 1)
        limit = self.max_len - max_new
        if len(ids) > limit:
            head, tail = limit // 2, limit - limit // 2
            ids = ids[:head] + ids[-tail:]
        if req.handoff_export:
            # prefill role: stop after the first token (the ticket carries
            # the rest of the budget).  Clamped after the truncation, so
            # the prompt cut equals what the decode side encodes
            max_new = 1
        return ids, max_new

    def _orig_budget(self, req: GenerationRequest) -> int:
        """The request's real token budget (before the handoff clamp)."""
        return min(req.max_new_tokens, self.cfg.max_tokens, self.max_len - 1)

    def _trim_tokens(self, gen: list[int], max_new: int, stop):
        """(gen, text, stop_hit, hit_eos): budget-, EOS- and stop-trimmed."""
        gen = gen[:max_new]
        eos = self.tokenizer.eos_id
        hit_eos = eos in gen
        if hit_eos:
            gen = gen[: gen.index(eos)]
        text, stop_hit = apply_stop_sequences(self.tokenizer.decode(gen), stop)
        return gen, text, stop_hit, hit_eos

    def _trimmed_output(self, st: _SlotState):
        """(gen, text, stop_hit, hit_eos) of a slot's output so far."""
        return self._trim_tokens(st.prior + st.generated, st.max_new,
                                 st.req.stop)

    def _maybe_finish(self, b, slots, results, fresh, active, kv_lens,
                      last_tok) -> None:
        gen, text, stop_hit, hit_eos = self._trimmed_output(slots[b])
        finished = hit_eos or stop_hit or len(gen) >= slots[b].max_new
        if self._on_tokens is not None:
            self._stream(slots[b].req, text, finished)
        if not finished:
            return
        st = slots[b]
        if (st.req.handoff_export and not hit_eos and stop_hit is None
                and not st.prior and len(gen) < self._orig_budget(st.req)):
            # prefill role: not complete (its budget was clamped to 1) —
            # pin the pages for export instead of freeing them.  A terminal
            # first token finishes normally: nothing is left to hand off
            self._pin_handoff(b, slots, results, fresh, active, kv_lens,
                              last_tok, gen, text)
            return
        self._finish_slot(b, slots, results, fresh, active, kv_lens, last_tok,
                          gen, text, stop_hit,
                          "stop" if (hit_eos or stop_hit) else "length")

    def _stream(self, req: GenerationRequest, text: str,
                finished: bool) -> None:
        """Emit the new part of a request's trimmed text.  Until it
        finishes, trailing U+FFFD (a character whose bytes are still
        arriving) and, with stop strings, the last ``max(len(stop)) - 1``
        characters (a later match may start there) are held back; a delta
        goes out only while the text extends what was already sent."""
        rid = req.request_id
        sent = self._streamed.get(rid, "")
        frontier = len(text)
        if not finished:
            while frontier > len(sent) and text[frontier - 1] == "\ufffd":
                frontier -= 1
            if req.stop:
                hold = max((len(s) for s in req.stop if s), default=1) - 1
                frontier = min(frontier, len(text) - hold)
        if frontier > len(sent) and text.startswith(sent):
            self._on_tokens(rid, text[len(sent):frontier])
            self._streamed[rid] = text[:frontier]

    def _record_result(self, results: dict, res: GenerationResult,
                       fresh, req: GenerationRequest) -> None:
        """The one write into a run's results: an id terminating twice is
        counted for the audit.  Also the one place every outcome meets the
        cost ledger (the usage bill attaches here) and the SLO stream."""
        rid = res.request_id
        if rid in self._finished_ids:
            self._double_finish += 1
        self._finished_ids.add(rid)
        res.usage = self._cost.finish(req, res)
        self._slo.note_result(res.finish_reason, res.completion_tokens,
                              res.error)
        results[rid] = res
        fresh.append(rid)

    def cost_finish(self, req: GenerationRequest, res: GenerationResult
                    ) -> None:
        """Close a request's ledger entry for a result made OUTSIDE the
        loop (the watchdog's wedge sweep): the usage bill and the SLO
        outcome, as ``_record_result`` does for the loop's own results."""
        res.usage = self._cost.finish(req, res)
        self._slo.note_result(res.finish_reason, res.completion_tokens,
                              res.error)

    def _finish_slot(self, b, slots, results, fresh, active, kv_lens,
                     last_tok, gen, text, stop_hit, finish_reason) -> None:
        """Record slot b's result and tear the slot down: pages freed
        (prefix-cache matches drop their own reference), row state reset.
        Shared by a normal finish, a cancel and an in-flight expiry."""
        st = slots[b]
        now = time.time()
        self._record_result(results, GenerationResult(
            request_id=st.req.request_id, text=text,
            prompt_tokens=st.n_prompt, completion_tokens=len(gen),
            finish_reason=finish_reason, stop_sequence=stop_hit,
            device_seconds=now - st.t_start), fresh, st.req)
        if self._tr:
            tid = self._tid(st.req)
            if st.t_decode_start:  # close this slot life's decode span
                self._tr.complete("decode", st.t_decode_start, now, tid=tid,
                                  args={"completion_tokens": len(gen)})
            self._tr.instant(
                "cancel" if finish_reason == "cancelled" else "finish",
                ts=now, tid=tid,
                args={"reason": finish_reason,
                      "completion_tokens": len(gen)})
        self.cache.close_sequence(st.seq)
        slots[b] = None
        active[b] = False
        kv_lens[b] = 0  # a freed row carries length 0: the kernels skip it
        last_tok[b] = 0

    def _note_first_token(self, st: _SlotState) -> None:
        """A TTFT sample at a request's first host-visible token (a
        preemption continuation's re-prefill takes none)."""
        t = self._t_enq.pop(st.req.request_id, None)
        if t is not None:
            now = time.time()
            self._ttft_min = min(self._ttft_min, now - t)
            self._h_ttft.observe(max(0.0, now - t))
            self._slo.observe_ttft(now - t)
            if self._tr:
                self._tr.instant("first_token", ts=now,
                                 tid=self._tid(st.req))

    def _tid(self, req: GenerationRequest) -> int:
        """The request's trace track: its distributed trace id's when it
        carries one (one chain fleet-wide), else the per-run request id's.
        Call only under an ``if self._tr:`` guard."""
        if req.trace_id:
            return self._tr.track_for(req.trace_id)
        return req_tid(req.request_id)

    def _warm(self, kind: str) -> bool:
        """False the first time this engine dispatches ``kind``: that wall
        holds one-time work (a kernel build, library handles), so it
        counts work but never samples a ratio."""
        if kind in self._warm_kinds:
            return True
        self._warm_kinds.add(kind)
        return False

    def _note_dispatch_gap(self, now: float) -> None:
        """A decode-side dispatch starts at ``now``: the gap since the
        previous one (the cadence a streaming client sees) feeds the
        block-gap histogram and the SLO engine."""
        if self._last_block_t is not None:
            gap = max(0.0, now - self._last_block_t)
            self._h_block_gap.observe(gap)
            self._slo.observe_gap(gap)
        self._last_block_t = now

    def _note_prefill(self, req: GenerationRequest, tokens: int,
                      kv_start: int = 0) -> float:
        """One prefill row issued: its model FLOPs wait (with the ledger's
        per-row view) for the fetch that charges the wave's wall."""
        f = self._perf.prefill_flops(tokens, kv_start=kv_start)
        self._attr_pending_flops += f
        if self._cost.enabled:
            self._cost_pending_prefill.append((req, tokens, f))
        return f

    def _consume_prefill_attr(self) -> float:
        """Take (and reset) the model FLOPs of the prefill rows issued
        since the last consumption."""
        flops, self._attr_pending_flops = self._attr_pending_flops, 0.0
        return flops

    def _consume_prefill_cost(self) -> list[tuple]:
        """Take (and reset) the ledger's per-row view of the same work."""
        rows, self._cost_pending_prefill = self._cost_pending_prefill, []
        return rows

    def _roofline_phase_costs(self, nbytes: float,
                              flops: float) -> tuple[float, float]:
        """(decode_cost_s, prefill_cost_s): each phase's own roofline time,
        the denominators the ledger splits a dispatch wall by."""
        spec = self._perf._spec()
        return (max(nbytes, 0.0) / spec.peak_hbm_bw,
                max(flops, 0.0) / spec.peak_flops)

    def _bill_block(self, slots, active, emitted) -> None:
        """Bill the last decode or verify block (stashed by the block) to
        its live rows by their emitted tokens, with the prefill rows whose
        first tokens rode it."""
        if self._cost_step is None:
            return
        wall, dcost, pcost, prows = self._cost_step
        self._cost_step = None
        self._cost.note_step(
            wall, decode_rows=[(slots[b].req, len(emitted[b]),
                                len(slots[b].seq.pages))
                               for b in range(self.B)
                               if slots[b] is not None and active[b]],
            prefill_rows=prows, decode_cost_s=dcost, prefill_cost_s=pcost)

    def _maybe_profile_slow_step(self, wall_s: float, warm: bool) -> None:
        """``LMRS_PROFILE_ON_SLOW_STEP``: the first warm decode block slower
        than the threshold starts one bounded torch.profiler capture
        (``LMRS_PROFILE_DIR``), once per engine."""
        if self._slow_step_fired:
            return
        from lmrs_tpu_torch.obs.perf import (default_profile_dir,
                                             slow_step_threshold_s,
                                             start_profile_capture)

        thresh = slow_step_threshold_s()
        if not thresh or not warm or wall_s <= thresh:
            return
        self._slow_step_fired = True
        dur = env_float("LMRS_PROFILE_CAPTURE_S", 3.0, lo=0.1, hi=60.0)
        ok, msg = start_profile_capture(default_profile_dir(), dur)
        logger.warning("slow decode block (%.3fs > %.3fs threshold): "
                       "profiler capture %s (%s)", wall_s, thresh,
                       "started" if ok else "NOT started", msg)

    # ------------------------------------------------- cancel and deadlines

    def _sweep_cancelled(self, queue, slots, results, fresh, active, kv_lens,
                         last_tok) -> None:
        """Apply pending ``cancel`` ids: queued entries finish without
        prefilling (a preempted continuation keeps its prior tokens), live
        slots finish with their output so far.  The id set is snapshotted:
        ids added meanwhile are handled at the next boundary."""
        pending = set(self._cancelled)
        hit: set[int] = set()
        for i in range(len(queue) - 1, -1, -1):
            req, _, max_new, n_prompt, prior, _ = queue[i]
            if req.request_id not in pending:
                continue
            del queue[i]
            gen, text, stop_hit, _ = self._trim_tokens(list(prior), max_new,
                                                       req.stop)
            self._record_result(results, GenerationResult(
                request_id=req.request_id, text=text, prompt_tokens=n_prompt,
                completion_tokens=len(gen), finish_reason="cancelled",
                stop_sequence=stop_hit), fresh, req)
            hit.add(req.request_id)
            self._m["cancelled"].inc(1)
            if self._tr:  # cancelled while still queued: no spans open
                self._tr.instant("cancel", tid=self._tid(req),
                                 args={"state": "queued"})
        for b in range(self.B):
            st = slots[b]
            if st is None or st.req.request_id not in pending:
                continue
            gen, text, stop_hit, _ = self._trimmed_output(st)
            hit.add(st.req.request_id)
            self._finish_slot(b, slots, results, fresh, active, kv_lens,
                              last_tok, gen, text, stop_hit, "cancelled")
            self._m["cancelled"].inc(1)
        self._cancelled -= hit

    def _ttft_estimate(self, n_tokens: int) -> float:
        """Optimistic TTFT estimate for admission shedding: the fastest TTFT
        this engine has delivered, else the prefill's FLOPs at the card's
        dense bf16 peak (``chip_spec()``, through the attribution)."""
        if self._ttft_min != float("inf"):
            return self._ttft_min
        return prefill_flops(self.model_cfg, max(1, n_tokens),
                             head_tokens=1) / self._perf._spec().peak_flops

    def _expire_queue_entry(self, queue, i: int, results, fresh) -> None:
        """Terminate queue entry ``i``, which cannot (or can no longer) meet
        its deadline.  A fresh request is shed (``"shed"``, no text, no
        engine work); a preemption continuation already produced output and
        finishes as ``"deadline"`` with its trimmed prior tokens."""
        req, _ids, max_new, n_prompt, prior, t0 = queue[i]
        del queue[i]
        continuation = t0 is not None
        gen, text, stop_hit, _ = self._trim_tokens(list(prior), max_new,
                                                   req.stop)
        reason = "deadline" if continuation else "shed"
        self._record_result(results, GenerationResult(
            request_id=req.request_id,
            text=text if continuation else "",
            prompt_tokens=n_prompt,
            completion_tokens=len(gen) if continuation else 0,
            finish_reason=reason,
            stop_sequence=stop_hit if continuation else None), fresh, req)
        self._m[reason].inc()
        if self._tr:
            self._tr.instant(reason, tid=self._tid(req),
                             args={"queued": True})

    def _sweep_deadlines(self, queue, slots, results, fresh, active, kv_lens,
                         last_tok) -> None:
        """Expire passed deadlines: every queue entry (not just the head: an
        entry behind back-pressure must not wait to expire) and every live
        slot, which finishes as ``"deadline"`` with its output so far."""
        now = time.time()
        expired = 0
        for i in range(len(queue) - 1, -1, -1):
            dl = queue[i][0].deadline_s
            if dl is not None and dl <= now:
                self._expire_queue_entry(queue, i, results, fresh)
                expired += 1
        for b in range(self.B):
            st = slots[b]
            if (st is None or st.req.deadline_s is None
                    or st.req.deadline_s > now):
                continue
            gen, text, stop_hit, _ = self._trimmed_output(st)
            self._finish_slot(b, slots, results, fresh, active, kv_lens,
                              last_tok, gen, text, stop_hit, "deadline")
            self._m["deadline"].inc(1)
            expired += 1
        # a deadline storm (one sweep reaping >= LMRS_DEADLINE_STORM
        # requests, default 3): the engine is turning overload into
        # expired work, so freeze the evidence (a no-op unless armed)
        storm = env_int("LMRS_DEADLINE_STORM", 3, lo=0) if expired else 0
        if storm > 0 and expired >= storm:
            dump_postmortem("deadline_storm", metrics=self.counters,
                            extra={"expired_this_sweep": expired,
                                   "queued": len(queue)})

    def _enter_decode(self, b: int, st: _SlotState, kv_lens, active) -> None:
        """The slot's whole prompt is in the pool: it decodes from now on,
        and donates its preamble pages to the prefix cache at once (the
        dispatch writing them is already issued, so later admissions of the
        same run can hit)."""
        st.phase = "decode"
        st.t_decode_start = time.time()
        if self._tr:
            self._tr.complete("prefill", st.t_admit, st.t_decode_start,
                              tid=self._tid(st.req),
                              args={"prompt_tokens": len(st.prompt_ids)})
        st.kv_len = len(st.prompt_ids)
        kv_lens[b] = st.kv_len
        active[b] = True
        self._cache_insert(st)

    @staticmethod
    def _rearm(stalled, slots, active) -> None:
        for b in stalled:  # stalled rows rejoin the next dispatch
            if slots[b] is not None:
                active[b] = True

    def _note_peak_pages(self) -> None:
        in_use = self.cache.num_pages - 1 - self.cache.allocator.free_count
        self._m["peak_pages"].track_max(in_use)

    # ------------------------------------------------- growth and preemption

    def _ensure_decode_capacity(self, slots, queue, kv_lens, last_tok,
                                active, extra_tokens: int | None = None
                                ) -> list[int]:
        """Grow each active decode slot's pages to cover the coming
        dispatch (``extra_tokens`` overrides the decode-block growth: a
        mixed step advances decode rows by ONE token).  On pool exhaustion,
        preempt the youngest other decode slot (under QoS, the policy's
        worst: ``_qos_victim_slot``) and retry; with no other
        decode slot the row is STALLED for this dispatch (masked off, its
        progress kept).  Returns the stalled rows; the caller re-activates
        them after the dispatch."""
        block = (self.decode_block + self.spec_k if extra_tokens is None
                 else extra_tokens)
        stalled: list[int] = []
        for b in range(self.B):
            st = slots[b]
            if st is None or not active[b] or st.phase != "decode":
                continue
            target = min(st.kv_len + block, self.max_len)
            while True:
                try:
                    self.cache.grow(st.seq, target)
                    break
                except OutOfPages:
                    if self._qos is not None:
                        victim = self._qos_victim_slot(slots, active,
                                                       exclude=b)
                    else:
                        victim = self._youngest_decode_slot(slots, active,
                                                            exclude=b)
                    if victim is None:
                        stalled.append(b)
                        active[b] = False
                        self._m["stalls"].inc(1)
                        break
                    self._preempt(victim, slots, queue, kv_lens, last_tok,
                                  active)
        self._note_peak_pages()
        return stalled

    def _qos_victim_slot(self, slots, active, exclude: int) -> int | None:
        """QoS preemption policy (fleet/qos.py): the worst active decode
        slot by (batch class first, highest normalized windowed usage,
        youngest), so over-quota bulk work pays for the pool before a live
        session does.  Uniform traffic ties the first two keys and the
        rule is ``_youngest_decode_slot``'s."""
        best, best_key = None, None
        for b in range(self.B):
            st = slots[b]
            if (b == exclude or st is None or not active[b]
                    or st.phase != "decode"):
                continue
            key = self._qos.victim_key(st.req, st.t_start)
            if best_key is None or key >= best_key:
                best, best_key = b, key
        if best is not None:
            self._qos.note_preempt()
            if self._tr:
                self._tr.instant("qos_preempt",
                                 args={"slot": best,
                                       "tenant": slots[best].req.tenant
                                       or "default"})
        return best

    def _youngest_decode_slot(self, slots, active, exclude: int) -> int | None:
        """Latest-admitted active decode slot, or None if only ``exclude``
        (the slot being grown) qualifies."""
        best, best_t = None, -1.0
        for b in range(self.B):
            st = slots[b]
            if (b == exclude or st is None or not active[b]
                    or st.phase != "decode"):
                continue
            if st.t_start >= best_t:
                best, best_t = b, st.t_start
        return best

    def _preempt(self, b, slots, queue, kv_lens, last_tok, active) -> None:
        """Free a decode slot's pages and requeue it as a continuation:
        prompt + generated tokens re-prefill once pages free up.  Its
        prompt prefix stays cached (evictable), so the continuation
        re-matches instead of re-prefilling it."""
        st = slots[b]
        if st.phase == "decode":
            self._cache_insert(st)
        self.cache.close_sequence(st.seq)
        entry = (st.req, st.prompt_ids + st.generated, st.max_new,
                 st.n_prompt, st.prior + st.generated, st.t_start)
        # older continuations keep queue priority among those at the head
        pos = 0
        while (pos < len(queue) and queue[pos][5] is not None
               and queue[pos][5] <= st.t_start):
            pos += 1
        queue.insert(pos, entry)
        slots[b] = None
        active[b] = False
        kv_lens[b] = 0
        last_tok[b] = 0
        self._m["preemptions"].inc(1)
        if self._tr:
            now = time.time()
            tid = self._tid(st.req)
            if st.t_decode_start:  # close this slot life's decode span
                self._tr.complete("decode", st.t_decode_start, now, tid=tid,
                                  args={"preempted": True})
            self._tr.instant("preempt", ts=now, tid=tid,
                             args={"slot": b,
                                   "generated_so_far": len(st.prior)
                                   + len(st.generated)})
        logger.debug("preempted slot %d (request %d) under page pressure",
                     b, st.req.request_id)

    def _cache_insert(self, st: _SlotState) -> None:
        """Donate a fully-prefilled slot's prompt-page prefix to the prefix
        cache.  The ``cache_prefix`` hint (leading PROMPT chars expected to
        be shared) caps adoption so per-chunk bodies don't bloat the tree;
        a hint of 0 still donates a shared system prompt."""
        if self._prefix_cache is None:
            return
        self._note_preamble(st.req)
        cap = None
        hint = st.req.cache_prefix
        if hint is not None:
            if hint < 0:
                return
            text = preamble_text(st.req.system_prompt, st.req.prompt, hint)
            if not text:
                return  # hint 0 and no system prompt: nothing shared
            cap = 1 + len(self.tokenizer.encode(text))
        try:
            self._prefix_cache.insert(st.prompt_ids, st.seq.pages,
                                      max_tokens=cap)
        except InjectedFault:
            # the prefix_cache.insert site fires before any tree mutation:
            # caching is an optimization, so the fault costs a hit, never
            # the request
            logger.warning("prefix-cache insert failed; request continues "
                           "uncached", exc_info=True)

    def _note_preamble(self, req: GenerationRequest) -> None:
        """Record a donated preamble for the published radix summary: key =
        ``preamble_key`` over the region ``_cache_insert`` donates, with its
        token ids so ``prefix_summary`` can probe live coverage.  An LRU of
        32 preambles (a fleet shares a handful of map, reduce and system
        preambles)."""
        key = preamble_key(req.system_prompt, req.prompt, req.cache_prefix)
        if key is None:
            return
        self._preamble_tick += 1
        ent = self._preambles.get(key)
        if ent is None:
            text = preamble_text(req.system_prompt, req.prompt,
                                 req.cache_prefix)
            ids = tuple([self.tokenizer.bos_id] + self.tokenizer.encode(text))
            # ticked BEFORE the trim, so the new entry is never the victim
            ent = {"ids": ids, "tick": self._preamble_tick}
            self._preambles[key] = ent
            while len(self._preambles) > 32:
                oldest = min(self._preambles,
                             key=lambda k: self._preambles[k]["tick"])
                del self._preambles[oldest]
        ent["tick"] = self._preamble_tick

    def prefix_summary(self, top_k: int = 16) -> list[dict]:
        """The top-K recently donated preambles with their depth and live
        coverage (``PrefixCache.peek``; the port has no spill tier, so
        ``spilled_*`` is 0): the feed the router places requests on.
        Callable from other threads while a run goes on: memoized for 1 s,
        and a walk that races a mutation returns the previous summary."""
        if self._prefix_cache is None:
            return []
        now = time.time()
        memo = self._summary_memo
        if memo is not None and now - memo[0] < 1.0:
            return memo[1]
        out: list[dict] = []
        try:
            entries = sorted(self._preambles.items(),
                             key=lambda kv: -kv[1]["tick"])[:top_k]
            for key, ent in entries:
                out.append({"hash": key, "depth_tokens": len(ent["ids"]),
                            "tick": ent["tick"],
                            **self._prefix_cache.peek(list(ent["ids"]))})
        except RuntimeError:  # resized mid-walk: keep the last summary
            return memo[1] if memo is not None else []
        self._summary_memo = (now, out)
        return out

    # ------------------------------------------------------ span dispatches

    def _pick_mixed_prefill(self, slots) -> int | None:
        """The prefilling slot whose slice rides this mixed step: oldest
        admission first, ties on slot index; ONE slot per step."""
        best, best_t = None, float("inf")
        for b in range(self.B):
            st = slots[b]
            if st is None or st.phase != "prefill":
                continue
            if st.t_admit < best_t:
                best, best_t = b, st.t_admit
        return best

    def _mixed_iteration(self, slots, queue, results, fresh, kv_lens,
                         last_tok, active, temps, top_k, top_p) -> bool:
        """One mixed step: every live decode row advances ONE token (under
        speculation a verify span, ``_spec_span_iteration``) and one
        prefilling slot's next slice rides the SAME span dispatch.  Returns
        False (nothing dispatched) when there is nothing to mix or the
        budget leaves no room for a slice."""
        pf = self._pick_mixed_prefill(slots)
        has_decode = any(st is not None and active[b] and st.phase == "decode"
                         for b, st in enumerate(slots))
        if pf is None or not has_decode:
            return False
        if self.spec_k:  # decode rows carry verify spans
            return self._spec_span_iteration(pf, slots, queue, results, fresh,
                                             kv_lens, last_tok, active, temps,
                                             top_k, top_p)
        stalled = self._ensure_decode_capacity(slots, queue, kv_lens,
                                               last_tok, active,
                                               extra_tokens=1)
        rows = [b for b, st in enumerate(slots)
                if st is not None and active[b] and st.phase == "decode"]
        budget_left = self.mixed_token_budget - len(rows)
        if not rows or budget_left < 16:
            self._rearm(stalled, slots, active)
            return False
        st_pf = slots[pf]
        pos = st_pf.prefill_pos
        c = min(len(st_pf.prompt_ids) - pos, budget_left, self.prefill_chunk)
        is_final = pos + c >= len(st_pf.prompt_ids)
        q_lens = np.zeros((self.B,), np.int32)
        base = np.zeros((self.B,), np.int32)
        span_tokens: dict[int, list[int]] = {}
        for b in rows:
            q_lens[b], base[b] = 1, slots[b].kv_len
            span_tokens[b] = [int(last_tok[b])]
        q_lens[pf], base[pf] = c, pos
        span_tokens[pf] = st_pf.prompt_ids[pos: pos + c]
        live_tokens = int(sum(slots[b].kv_len for b in rows))
        t0 = time.time()
        self._note_dispatch_gap(t0)
        flops = self._perf.prefill_flops(c, kv_start=pos)
        tr = self._tr
        if tr:
            tr.instant("prefill_dispatch",
                       args={"rows": 1, "tokens": c, "mixed": True,
                             "rpa": True, "flops_g": round(flops / 1e9, 3)})
        nxt = self._dispatch_spans(slots, q_lens, base, span_tokens,
                                   temps, top_k, top_p)
        with self._an.seg("fetch"):
            nxt = _one_fetch([nxt])[0].numpy()
        t_done = time.time()
        with self._an.seg("finish"):
            self._m["mixed_step_seconds"].inc(max(0.0, t_done - t0))
            self._m["mixed_dispatches"].inc(1)
            self._h_mixed_fill.observe((len(rows) + c)
                                       / self.mixed_token_budget)
            self._m["prefill_tokens_piggybacked"].inc(c)
            self._m["prefill_tokens"].inc(c)
            self._h_occupancy.observe(len(rows) / self.B)
            st_pf.prefill_pos = pos + c
            # the fused step splits exactly: every decode row advanced one
            # token, and the slice's work is known
            extra = self._consume_prefill_attr()
            nb = self._perf.note_mixed_step(t0, t_done, len(rows),
                                            live_tokens, flops + extra,
                                            warm=self._warm("mixed"))
            self._attr_last_gb = round(nb / 1e9, 3)
            if self._cost.enabled:
                dcost, pcost = self._roofline_phase_costs(nb, flops + extra)
                self._cost.note_step(
                    max(0.0, t_done - t0),
                    decode_rows=[(slots[b].req, 1, len(slots[b].seq.pages))
                                 for b in rows],
                    prefill_rows=(self._consume_prefill_cost()
                                  + [(st_pf.req, c, flops)]),
                    decode_cost_s=dcost, prefill_cost_s=pcost)
            for b in rows:
                st = slots[b]
                st.generated.append(int(nxt[b]))
                st.kv_len += 1
                kv_lens[b] = st.kv_len
                last_tok[b] = st.generated[-1]
                self._m["decode_tokens"].inc(1)
                if tr:
                    tr.instant("decode_block", ts=t0, tid=self._tid(st.req),
                               args={"tokens": 1})
                self._maybe_finish(b, slots, results, fresh, active, kv_lens,
                                   last_tok)
            if is_final:
                # the slice completed the prompt: enter decode with the token
                # this very step sampled at the slice's last position
                self._enter_decode(pf, st_pf, kv_lens, active)
                st_pf.generated.append(int(nxt[pf]))
                self._note_first_token(st_pf)
                last_tok[pf] = st_pf.generated[-1]
                self._maybe_finish(pf, slots, results, fresh, active,
                                   kv_lens, last_tok)
            if tr:
                tr.complete("decode_block", t0, time.time(),
                            args={"active": len(rows), "tokens": len(rows),
                                  "hbm_gb": self._attr_last_gb,
                                  "mixed": True, "prefill_tokens": c})
            self._rearm(stalled, slots, active)
        return True

    def _span_layout(self, slots, q_lens, base):
        """The flat layout of a span dispatch over the rows with ``q_lens >
        0``: ``(q_starts, total, row_flat, table)``, the table cut to a
        power-of-two window over the widest span.  Raises if a span would
        write past its slot's pages (the write would land on the null
        page); positions at or past ``max_len`` are not written."""
        q_starts, total = pack_spans(q_lens)
        row_flat = np.full((total,), self.B, np.int32)
        max_pages = 1
        for b in np.flatnonzero(q_lens):
            s, n = int(q_starts[b]), int(q_lens[b])
            end = min(int(base[b]) + n, self.max_len)
            if end > slots[b].seq.capacity(self.cache.page_size):
                raise RuntimeError(f"span of slot {b} ({base[b]}+{n} tokens) "
                                   "exceeds its pages")
            row_flat[s: s + n] = b
            max_pages = max(max_pages, self.cache.pages_needed(end))
        w = min(pow2_bucket(max_pages, 4), self.cache.max_pages_per_slot)
        table = self.cache.page_table_array(
            [slots[b].seq if q_lens[b] > 0 else None
             for b in range(self.B)])[:, :w]
        return q_starts, total, row_flat, table

    def _dispatch_spans(self, slots, q_lens, base, span_tokens, temps,
                        top_k, top_p) -> torch.Tensor:
        """One ragged span forward: row b's ``span_tokens[b]`` at positions
        ``base[b]..``, packed into a flat buffer; samples one token per row
        at its span's last token (device tensor [B], not fetched)."""
        dev = self.device
        q_starts, total, row_flat, table = self._span_layout(slots, q_lens, base)
        self._an.note_bucket(total, table.shape[1], int(q_lens.sum()))
        tokens = np.zeros((1, total), np.int64)
        for b, toks in span_tokens.items():
            tokens[0, q_starts[b]: q_starts[b] + len(toks)] = toks
        # out-of-span tokens clamp to position 0: masked from every real
        # query, and the kernel writes nothing for them
        rf = np.clip(row_flat, 0, self.B - 1)
        positions = np.clip(base[rf] + np.arange(total) - q_starts[rf], 0,
                            self.max_len - 1)[None]
        # an inactive row samples some in-buffer token, never used
        gidx = np.minimum(q_starts + np.maximum(q_lens, 1) - 1, total - 1)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        with self._an.seg("dispatch"):
            logits = forward_paged(
                self.params, self.model_cfg, t(tokens), t(positions),
                self.cache.k, self.cache.v, t(table), t(base), self.max_len,
                packed_last_idx=t(gidx),
                spans=(t(q_starts), t(q_lens), t(row_flat)),
                kv_scales=self.kv_scales)
            out = self._sample(logits[0], temps, top_k, top_p)
        self._h_rpa_span.observe(int(q_lens.sum()))
        return out

    def _dispatch_rpa_chunks(self, items) -> tuple[torch.Tensor, list]:
        """Continuation chunks as ragged SPANS, all in one dispatch.
        Returns ``(tok0 device tensor [B] indexed by SLOT, [(slot, slot)])``
        for the chunks that complete their prompt."""
        q_lens = np.zeros((self.B,), np.int32)
        base = np.zeros((self.B,), np.int32)
        span_tokens: dict[int, list[int]] = {}
        slots_view: list[_SlotState | None] = [None] * self.B
        finals = []
        flops = 0.0
        for b, st, chunk, pos, is_final in items:
            q_lens[b], base[b] = len(chunk), pos
            span_tokens[b] = chunk
            slots_view[b] = st
            st.prefill_pos = pos + len(chunk)
            self._m["prefill_tokens"].inc(len(chunk))
            flops += self._note_prefill(st.req, len(chunk), kv_start=pos)
            if is_final:
                finals.append((b, b))
        n_tok = int(q_lens.sum())
        self._h_prefill_batch.observe(n_tok)
        if self._tr:
            self._tr.instant("prefill_dispatch",
                             args={"rows": len(items), "tokens": n_tok,
                                   "fresh": False, "rpa": True,
                                   "flops_g": round(flops / 1e9, 3)})
        temps, tks, tps = self._sampler_params(
            [st.req if st is not None else None for st in slots_view])
        tok0 = self._dispatch_spans(slots_view, q_lens, base, span_tokens,
                                    temps, tks, tps)
        self._m["prefill_dispatches"].inc(1)
        return tok0, finals

    # ------------------------------------------------------------ prefill

    @staticmethod
    def _pack_bins(items: list, capacity: int) -> list[list]:
        """First-fit-decreasing bin packing of (slot, state) items by prompt
        length, bins of at most ``capacity`` tokens."""
        bins: list[tuple[int, list]] = []
        for it in sorted(items, key=lambda t: -len(t[1].prompt_ids)):
            n = len(it[1].prompt_ids)
            for i, (used, lst) in enumerate(bins):
                if used + n <= capacity:
                    lst.append(it)
                    bins[i] = (used + n, lst)
                    break
            else:
                bins.append((n, [it]))
        return [lst for _, lst in bins]

    def _advance_prefills(self, slots) -> list[tuple[torch.Tensor, list]]:
        """Advance every prefilling slot by one prompt chunk; returns
        [(tok0 device tensor, [(slot, row)])] for the slots whose whole
        prompt is now in the pool — first tokens NOT fetched.  A prompt
        that fits one chunk from position 0 is prefilled fresh (packed
        bins of at most ``max_len`` tokens); every other chunk rides one
        ragged span dispatch."""
        whole, chunks = [], []
        for b, st in enumerate(slots):
            if st is None or st.phase != "prefill":
                continue
            pos = st.prefill_pos
            chunk = st.prompt_ids[pos: pos + self.prefill_chunk]
            is_final = pos + len(chunk) >= len(st.prompt_ids)
            if pos == 0 and is_final:
                whole.append((b, st))
            else:
                chunks.append((b, st, chunk, pos, is_final))
        pending = []
        bins = (self._pack_bins(whole, self.max_len) if self._pack_prefill
                else [[it] for it in whole])
        for bin_items in bins:
            if len(bin_items) == 1:
                pending.append(self._dispatch_fresh(*bin_items[0]))
            else:
                pending.append(self._dispatch_packed(bin_items))
            for _, st in bin_items:
                st.prefill_pos = len(st.prompt_ids)
        if chunks:
            tok0, rows = self._dispatch_rpa_chunks(chunks)
            if rows:
                pending.append((tok0, rows))
        return pending

    def _sample(self, logits, temps, top_k, top_p) -> torch.Tensor:
        if self._vocab_limit is not None:
            logits = logits.clone()
            logits[:, self._vocab_limit:] = float("-inf")
        return sample_logits(logits, temps, top_k, top_p,
                             generator=self.generator)

    @staticmethod
    def _sampler_params(reqs):
        """Per-row sampler arrays; a None row samples greedily (unused)."""
        return (np.array([r.temperature if r else 0.0 for r in reqs], np.float32),
                np.array([r.top_k if r else 0 for r in reqs], np.int64),
                np.array([min(max(r.top_p, 0.0), 1.0) if r else 1.0
                          for r in reqs], np.float32))

    def _dispatch_fresh(self, b: int, st: _SlotState):
        """One prompt, one [1, n] row: pages from the slot's table."""
        dev = self.device
        n = len(st.prompt_ids)
        tokens = torch.tensor([st.prompt_ids], dtype=torch.long, device=dev)
        positions = torch.arange(n, device=dev)[None]
        table = torch.tensor(self.cache.page_table_array([st.seq]), device=dev)
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        flops = self._note_prefill(st.req, n)
        self._h_prefill_batch.observe(n)
        if self._tr:
            self._tr.instant("prefill_dispatch",
                             args={"rows": 1, "tokens": n, "fresh": True,
                                   "flops_g": round(flops / 1e9, 3)})
        with self._an.seg("dispatch"):
            logits = forward_paged(
                self.params, self.model_cfg, tokens, positions, self.cache.k,
                self.cache.v, table, lens, self.max_len,
                last_pos=torch.tensor([n - 1], device=dev),
                kv_scales=self.kv_scales,
                scale_rows=torch.tensor([b], device=dev))
            tok0 = self._sample(logits[:, 0], *self._sampler_params([st.req]))
        self._m["prefill_tokens"].inc(n)
        self._m["prefill_dispatches"].inc(1)
        return tok0, [(b, 0)]

    def _dispatch_packed(self, items: list):
        """Several prompts concatenated into one [1, S] row: per-token
        segment ids, within-segment positions and host-built page ids; each
        segment's first token is sampled from its last row."""
        dev = self.device
        ps = self.cache.page_size
        s_real = sum(len(st.prompt_ids) for _, st in items)
        tokens = np.empty((1, s_real), np.int64)
        positions = np.empty((1, s_real), np.int64)
        seg_ids = np.empty((1, s_real), np.int32)
        token_pages = np.empty((1, s_real), np.int64)
        last_idx = np.empty((len(items),), np.int64)
        off = 0
        for si, (_, st) in enumerate(items):
            n = len(st.prompt_ids)
            within = np.arange(n)
            tokens[0, off:off + n] = st.prompt_ids
            positions[0, off:off + n] = within
            seg_ids[0, off:off + n] = si
            token_pages[0, off:off + n] = np.asarray(st.seq.pages)[within // ps]
            last_idx[si] = off + n - 1
            off += n
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        flops = sum(self._note_prefill(st.req, len(st.prompt_ids))
                    for _, st in items)
        self._h_prefill_batch.observe(s_real)
        if self._tr:
            self._tr.instant("prefill_dispatch",
                             args={"rows": len(items), "tokens": s_real,
                                   "packed": True,
                                   "flops_g": round(flops / 1e9, 3)})
        with self._an.seg("dispatch"):
            logits = forward_paged(
                self.params, self.model_cfg, t(tokens), t(positions),
                self.cache.k, self.cache.v,
                torch.zeros((1, 1), dtype=torch.long, device=dev),  # unused
                torch.tensor([s_real], dtype=torch.int32, device=dev),
                self.max_len, token_pages=t(token_pages),
                segment_ids=t(seg_ids), packed_last_idx=t(last_idx),
                kv_scales=self.kv_scales,
                scale_rows=torch.tensor([b for b, _ in items], device=dev))
            tok0 = self._sample(logits[0], *self._sampler_params(
                [st.req for _, st in items]))
        self._m["prefill_tokens"].inc(s_real)
        self._m["prefill_dispatches"].inc(1)
        self._m["packed_dispatches"].inc(1)
        return tok0, [(b, si) for si, (b, _) in enumerate(items)]

    # ------------------------------------------------------------- decode

    def _decode_table(self, slots) -> torch.Tensor:
        """The decoding slots' page tables on the device, cut to a
        power-of-two window over the widest one (slots grown for the coming
        dispatch); other rows carry the null page."""
        max_pages = max([1] + [len(st.seq.pages) for st in slots
                               if st is not None and st.phase == "decode"])
        w = min(pow2_bucket(max_pages, 4), self.cache.max_pages_per_slot)
        return torch.from_numpy(self.cache.page_table_array(
            [st.seq if (st is not None and st.phase == "decode") else None
             for st in slots])[:, :w]).to(self.device)

    def _decode_block(self, slots, last_tok, kv_lens, active, temps, top_k,
                      top_p, pending=()):
        """``decode_block`` decode steps for every active slot, tokens kept
        on the device; returns (tokens [B, n] host, n_valid [B] host, first
        tokens of ``pending`` as host arrays) from ONE fetch."""
        dev = self.device
        B, n_steps = self.B, self.decode_block
        table_d = self._decode_table(slots)
        tok = torch.from_numpy(last_tok.copy()).to(dev)
        for tok0, rows in pending:  # first tokens: on-device scatter, no sync
            idx = torch.tensor([b for b, _ in rows], device=dev)
            src = torch.tensor([r for _, r in rows], device=dev)
            tok[idx] = tok0[src]
        lens = torch.from_numpy(kv_lens.astype(np.int64)).to(dev)
        act = torch.from_numpy(active.copy()).to(dev)
        done = ~act
        eos = self.tokenizer.eos_id
        # inactive rows: zero sampler temperature (greedy, masked anyway)
        t_rows = np.where(active, temps, 0.0).astype(np.float32)
        n_live = int(active.sum())
        live_tokens = int(kv_lens[active].sum())
        toks, valid = [], []
        t0 = time.time()
        with self._an.seg("dispatch"):
            for _ in range(n_steps):
                pos = torch.clamp(lens, max=self.max_len - 1)
                kv_in = torch.where(act, torch.clamp(lens + 1,
                                                     max=self.max_len),
                                    torch.zeros_like(lens)).to(torch.int32)
                logits = forward_paged(
                    self.params, self.model_cfg, tok[:, None], pos[:, None],
                    self.cache.k, self.cache.v, table_d, kv_in, self.max_len,
                    kv_scales=self.kv_scales)
                nxt = self._sample(logits[:, 0], t_rows, top_k, top_p)
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                toks.append(nxt)
                valid.append(~done)
                lens = torch.where(done, lens, lens + 1)
                done = done | (nxt == eos)
                tok = nxt
            out_toks = torch.stack(toks, 1)
            out_valid = torch.stack(valid, 1).sum(dim=1)
        with self._an.seg("fetch"):
            fetched = [x.numpy() for x in _one_fetch(
                [out_toks, out_valid] + [t0_ for t0_, _ in pending])]
        t_done = time.time()
        with self._an.seg("finish"):
            self._m["decode_block_seconds"].inc(max(0.0, t_done - t0))
            self._m["decode_blocks"].inc(1)
            self._h_occupancy.observe(float(active.mean()))
            # the fetch waited out this block's device work and that of
            # the prefills sequenced before it (their FLOPs are pending)
            flops = self._consume_prefill_attr()
            warm = self._warm("decode")
            nb = self._perf.note_block(t0, t_done, n_steps, n_live,
                                       live_tokens, flops, warm=warm)
            self._attr_last_gb = round(nb / 1e9, 3)
            if self._cost.enabled:
                dcost, pcost = self._roofline_phase_costs(nb, flops)
                self._cost_step = (max(0.0, t_done - t0), dcost, pcost,
                                   self._consume_prefill_cost())
            self._maybe_profile_slow_step(t_done - t0, warm)
        return fetched[0], fetched[1], fetched[2:]

    # ------------------------------------------------ speculative decode

    def _hint_ids(self, req: GenerationRequest, n_ids: int,
                  max_new: int) -> list[int]:
        """A request's draft hint as token ids, under tree speculation only,
        clipped so hint + prompt + budget + one tree span still fit the
        history buffer (tokenized once, at admission)."""
        if not (self._spec_tree and req.draft_hint):
            return []
        room = (self.max_len - n_ids - max_new - 1
                - self._spec_width * self.spec_k)
        return self.tokenizer.encode(req.draft_hint)[:room] if room > 0 else []

    def _seed_history(self, b: int, st: _SlotState) -> None:
        """Load slot b's token history (prompt + generated) into the device
        buffer: one row upload at decode admission; the speculative steps
        append from then on.  A draft hint (tree speculation) goes ahead of
        the history, which then starts at column ``st.spec_hoff``."""
        if not self.spec_k:
            return
        if self._spec_buf is None:
            self._spec_buf = torch.zeros((self.B, self.max_len),
                                         dtype=torch.int32, device=self.device)
        row = np.zeros((self.max_len,), np.int32)
        hint = st.spec_hint if self._spec_tree else []
        hist = st.prompt_ids + st.generated
        hoff = min(len(hint), max(0, self.max_len - len(hist)))
        row[:hoff] = hint[:hoff]
        hist = hist[-(self.max_len - hoff):] if hoff < self.max_len else []
        row[hoff: hoff + len(hist)] = hist
        st.spec_hoff = hoff
        self._spec_buf[b] = torch.from_numpy(row).to(self.device)

    def _spec_decode_block(self, slots, last_tok, kv_lens, active, temps,
                           top_k, top_p) -> list[list[int]]:
        """One speculative block: ``decode_steps`` draft-verify steps for
        every active slot, on the device; returns the per-slot emitted
        token lists from ONE fetch.  Every row passes ``lens + 1 + k`` as
        its length, empty slots included (their table is the null page and
        their outputs are dropped), as the reference does."""
        dev = self.device
        B, k = self.B, self.spec_k
        T = k + 1
        table = self._decode_table(slots)
        eos, max_len = self.tokenizer.eos_id, self.max_len
        ngram = max(2, self.cfg.speculate_ngram)
        buf = self._spec_buf
        rows = torch.arange(B, device=dev)
        offs = torch.arange(T, device=dev)[None]
        tok = torch.from_numpy(last_tok.copy()).to(dev)
        lens = torch.from_numpy(kv_lens.astype(np.int64)).to(dev)
        done = ~torch.from_numpy(active.copy()).to(dev)
        # sampler params per (row, token); inactive rows greedy (dropped)
        t_bt = np.repeat(np.where(active, temps, 0.0).astype(np.float32), T)
        tk_bt, tp_bt = np.repeat(top_k, T), np.repeat(top_p, T)
        toks, counts = [], []
        t0 = time.time()
        with self._an.seg("dispatch"):
            for _ in range(self.decode_steps):
                # the current token enters the history at its KV position
                buf[rows, torch.clamp(lens, max=max_len - 1)] = tok.int()
                draft, n_valid = draft_lookup(buf, lens + 1, k, pad_id=eos,
                                              n=ngram)
                logits = forward_paged(
                    self.params, self.model_cfg,
                    torch.cat([tok[:, None], draft.long()], dim=1),
                    torch.clamp(lens[:, None] + offs, max=max_len - 1),
                    self.cache.k, self.cache.v, table,
                    # UNclamped: the write base is lens (see forward_paged)
                    (lens + 1 + k).to(torch.int32), max_len, multi_decode=True,
                    kv_scales=self.kv_scales)
                if self._vocab_limit is not None:  # as in _sample
                    logits[..., self._vocab_limit:] = float("-inf")
                probs = filtered_probs(logits.reshape(B * T, -1), t_bt, tk_bt,
                                       tp_bt).reshape(B, T, -1)
                emit, count = verify_tokens(probs, draft, n_valid,
                                            self.generator)
                emit = torch.where(done[:, None], torch.full_like(emit, eos),
                                   emit)
                count = torch.where(done, torch.zeros_like(count), count)
                hit_eos = ((offs < count[:, None]) & (emit == eos)).any(dim=1)
                # accepted tokens extend the history (the last one lands at the
                # next step's write index: idempotent)
                buf[rows[:, None], torch.clamp(lens[:, None] + 1 + offs,
                                               max=max_len - 1)] = emit
                lens = torch.clamp(lens + count, max=max_len)
                nxt = torch.gather(emit, 1,
                                   torch.clamp(count - 1, min=0)[:, None]
                                   .long())[:, 0]
                tok = torch.where(done, tok, nxt.long())
                done = done | hit_eos
                toks.append(emit)
                counts.append(count)
            toks_d, counts_d = torch.stack(toks, 1), torch.stack(counts, 1)
        with self._an.seg("fetch"):
            toks_h, counts_h = (x.numpy() for x in _one_fetch(
                [toks_d, counts_d]))
        t_done = time.time()
        with self._an.seg("finish"):
            self._m["decode_block_seconds"].inc(max(0.0, t_done - t0))
            self._m["decode_blocks"].inc(1)
            self._h_occupancy.observe(float(active.mean()))
            # verify blocks give step gaps only (their byte model differs);
            # pending prefill FLOPs are counted, never sampled, and the
            # ledger splits the wall by tokens (no phase costs)
            self._perf.note_gap(t0, t_done)
            flops = self._consume_prefill_attr()
            if flops > 0:
                self._perf.c_flops.inc(flops)
            self._attr_last_gb = 0.0
            if self._cost.enabled:
                self._cost_step = (max(0.0, t_done - t0), 0.0, 0.0,
                                   self._consume_prefill_cost())
            emitted: list[list[int]] = []
            for b in range(B):
                row: list[int] = []
                accepted = 0
                for s, c in enumerate(counts_h[b].tolist()):
                    row.extend(toks_h[b, s, :c].tolist())
                    accepted += max(0, c - 1)
                self._m["spec_accepted_tokens"].inc(accepted)
                if accepted and slots[b] is not None:
                    self._cost.note_saved(slots[b].req, spec_tokens=accepted)
                emitted.append(row)
        return emitted

    def _tree_span_template(self, hl: int) -> tuple[np.ndarray, np.ndarray]:
        """(rope offsets, ancestor masks) of a tree-speculation decode span
        with ``hl`` leading heal tokens, laid out [heal_0..heal_{hl-1}, cur,
        chain_0 (k), ..., chain_{W-1} (k)].  Heal tokens and cur keep mask
        0 (the causal rule); chain c's node j sees the heal + cur prefix and
        its own chain up to itself.  Rope offsets go by DEPTH (chain c's
        node j at hl + 1 + j whatever c), while K/V land at span-offset
        columns.  Bit 31 is reachable (hl = k at the capacity bound): the
        masks are built as uint32 and viewed as int32."""
        tmpl = self._spec_tmpl.get(hl)
        if tmpl is None:
            W, k = self._spec_width, self.spec_k
            n = hl + 1 + W * k
            pos = np.zeros((n,), np.int32)
            anc = np.zeros((n,), np.uint32)
            pos[: hl + 1] = np.arange(hl + 1)
            prefix = (1 << (hl + 1)) - 1
            for c in range(W):
                bits = prefix
                for j in range(k):
                    o = hl + 1 + c * k + j
                    pos[o] = hl + 1 + j
                    bits |= 1 << o
                    anc[o] = bits
            self._spec_tmpl[hl] = tmpl = (pos, anc.view(np.int32))
        return tmpl

    def _spec_ramp(self, st: _SlotState, depth_used: int) -> int:
        """Next-step chain depth for one row from its acceptance EMA
        (``LMRS_SPEC_ADAPTIVE``): accept streaks deepen the chains toward
        k, collapse ramps down to 0 (off), and a row at 0 re-probes at half
        depth every 8 steps so a change in the text can re-arm it."""
        k = self.spec_k
        if depth_used == 0:
            st.spec_probe += 1
            if st.spec_probe >= 8:
                st.spec_probe = 0
                st.spec_ema = 0.5
                return max(1, k // 2)
            return 0
        st.spec_probe = 0
        if st.spec_ema >= 0.6:
            return min(depth_used + 1, k)
        if st.spec_ema < 0.2:
            return 0
        if st.spec_ema < 0.35:
            return max(depth_used - 1, 1)
        return depth_used

    def _spec_span_iteration(self, pf, slots, queue, results, fresh, kv_lens,
                             last_tok, active, temps, top_k, top_p) -> bool:
        """One speculative span step (the reference's
        ``_rpa_mixed_iteration`` under speculation): every live decode row
        carries a verify span, and the prefilling slot ``pf``'s next slice,
        if any, rides the same dispatch (``_dispatch_spec_spans``; ONE host
        fetch).  Tree: [heal, cur, W chains of depth k] a row, depths set
        by ``_spec_ramp`` and collapsed to 0 under page pressure (fewer free
        pages than slots); when no row drafts or heals, the step is a plain
        span step (one token a row) and the rows' history is marked stale.
        Linear: [cur, k drafts].  Returns False (nothing dispatched) when no
        row decodes or the budget leaves the slice no room."""
        k, W = self.spec_k, self._spec_width
        tree = self._spec_tree
        adv = 1 + W * k if tree else 1 + k
        stalled = self._ensure_decode_capacity(slots, queue, kv_lens,
                                               last_tok, active,
                                               extra_tokens=adv)
        rows = [b for b, st in enumerate(slots)
                if st is not None and active[b] and st.phase == "decode"]
        hl = np.zeros((self.B,), np.int32)
        depth = np.zeros((self.B,), np.int32)
        pressure = False
        use_spec = True
        if tree:
            pressure = (self._spec_adaptive
                        and self.cache.allocator.free_count < self.B)
            for b in rows:
                hl[b] = len(slots[b].spec_heal)
                depth[b] = 0 if pressure else min(slots[b].spec_depth, k)
            use_spec = any(depth[b] > 0 or hl[b] > 0 for b in rows)
        if not use_spec:
            adv = 1
        dec_tokens = sum(int(hl[b]) + adv for b in rows)
        budget_left = self.mixed_token_budget - dec_tokens
        if not rows or (pf is not None and budget_left < 16):
            self._rearm(stalled, slots, active)
            return False
        if use_spec and self._spec_stale:
            # rows that took plain span steps missed their history appends
            with self._an.seg("draft"):
                for b in sorted(self._spec_stale):
                    if slots[b] is not None and slots[b].phase == "decode":
                        self._seed_history(b, slots[b])
            self._spec_stale.clear()
        st_pf, pos, c, is_final = None, 0, 0, False
        if pf is not None:
            st_pf = slots[pf]
            pos = st_pf.prefill_pos
            c = min(len(st_pf.prompt_ids) - pos, budget_left,
                    self.prefill_chunk)
            is_final = pos + c >= len(st_pf.prompt_ids)
        q_lens = np.zeros((self.B,), np.int32)
        base = np.zeros((self.B,), np.int32)
        for b in rows:
            # a heal span starts hl tokens back: the re-sent tokens rewrite
            # their K/V at the true columns before any read
            q_lens[b] = hl[b] + adv
            base[b] = slots[b].kv_len - hl[b]
        pf_tokens = []
        flops = 0.0
        tr = self._tr
        if pf is not None:
            q_lens[pf], base[pf] = c, pos
            pf_tokens = st_pf.prompt_ids[pos: pos + c]
            flops = self._perf.prefill_flops(c, kv_start=pos)
            if tr:
                tr.instant("prefill_dispatch",
                           args={"rows": 1, "tokens": c, "mixed": True,
                                 "rpa": True,
                                 "flops_g": round(flops / 1e9, 3)})
        live_tokens = int(sum(slots[b].kv_len for b in rows))
        t0 = time.time()
        self._note_dispatch_gap(t0)
        if use_spec:
            emit, count, chain, adepth = self._dispatch_spec_spans(
                slots, rows, pf, q_lens, base, hl, depth, pf_tokens,
                last_tok, temps, top_k, top_p)
        else:
            span_tokens = {b: [int(last_tok[b])] for b in rows}
            if pf is not None:
                span_tokens[pf] = pf_tokens
            nxt = self._dispatch_spans(slots, q_lens, base, span_tokens,
                                       temps, top_k, top_p)
            with self._an.seg("fetch"):
                nxt = _one_fetch([nxt])[0].numpy()
        t_done = time.time()
        with self._an.seg("finish"):
            # span-level exact split: a decode row's side of the step is its
            # whole span, not one token
            extra = self._consume_prefill_attr()
            nb = self._perf.note_mixed_step(
                t0, t_done, len(rows), live_tokens, flops + extra,
                warm=self._warm("spec-span" if use_spec else "span"),
                span_tokens=dec_tokens)
            self._attr_last_gb = round(nb / 1e9, 3)
            if self._cost.enabled:
                dcost, pcost = self._roofline_phase_costs(nb, flops + extra)
                self._cost.note_step(
                    max(0.0, t_done - t0),
                    decode_rows=[(slots[b].req,
                                  int(count[b]) if use_spec else 1,
                                  len(slots[b].seq.pages)) for b in rows],
                    prefill_rows=(self._consume_prefill_cost()
                                  + ([(st_pf.req, c, flops)]
                                     if pf is not None else [])),
                    decode_cost_s=dcost, prefill_cost_s=pcost)
            if pf is not None:
                self._m["mixed_step_seconds"].inc(max(0.0, t_done - t0))
                self._m["mixed_dispatches"].inc(1)
                self._h_mixed_fill.observe((dec_tokens + c) / self.mixed_token_budget)
                self._m["prefill_tokens_piggybacked"].inc(c)
                self._m["prefill_tokens"].inc(c)
                st_pf.prefill_pos = pos + c
            else:
                self._m["decode_block_seconds"].inc(max(0.0, t_done - t0))
                self._m["decode_blocks"].inc(1)
            self._h_occupancy.observe(len(rows) / self.B)
            if tree and use_spec:
                self._m["spec_tree_dispatches"].inc(1)
            for b in rows:
                st = slots[b]
                if use_spec:
                    cnt = int(count[b])
                    new = emit[b, :cnt].tolist()
                    self._m["spec_accepted_tokens"].inc(max(0, cnt - 1))
                    if cnt > 1:
                        self._cost.note_saved(st.req, spec_tokens=cnt - 1)
                    if tree:
                        self._m["spec_heal_spans"].inc(int(hl[b] > 0))
                        cs, ad, d_used = int(chain[b]), int(adepth[b]), int(depth[b])
                        # a non-first chain's drafts sit at THAT chain's
                        # span-offset columns: the next span re-sends them
                        st.spec_heal = new[:ad] if cs > 0 and ad > 0 else []
                        self._m["spec_tree_nodes_sum"].inc(1 + W * d_used)
                        self._m["spec_tree_rows"].inc(1)
                        self._m["spec_accept_depth_sum"].inc(ad)
                        if not pressure:
                            if d_used > 0:
                                st.spec_ema = 0.8 * st.spec_ema + 0.2 * ad / d_used
                            if self._spec_adaptive:
                                st.spec_depth = self._spec_ramp(st, d_used)
                else:
                    new = [int(nxt[b])]
                    self._spec_stale.add(b)
                    if self._spec_adaptive and not pressure:
                        st.spec_depth = self._spec_ramp(st, 0)
                st.generated.extend(new)
                st.kv_len += len(new)
                kv_lens[b] = st.kv_len
                last_tok[b] = st.generated[-1]
                self._m["decode_tokens"].inc(len(new))
                if tr:
                    tr.instant("decode_block", ts=t0, tid=self._tid(st.req),
                               args={"tokens": len(new)})
                self._maybe_finish(b, slots, results, fresh, active, kv_lens,
                                   last_tok)
            if is_final:
                # the slice completed the prompt: enter decode with the token
                # this step drew at its last position, and seed the history
                self._enter_decode(pf, st_pf, kv_lens, active)
                st_pf.generated.append(int(emit[pf, 0]) if use_spec
                                       else int(nxt[pf]))
                self._note_first_token(st_pf)
                last_tok[pf] = st_pf.generated[-1]
                with self._an.seg("draft"):
                    self._seed_history(pf, st_pf)
                self._maybe_finish(pf, slots, results, fresh, active, kv_lens,
                                   last_tok)
            if tr:
                tr.complete("decode_block", t0, time.time(),
                            args={"active": len(rows), "tokens": dec_tokens,
                                  "hbm_gb": self._attr_last_gb,
                                  "mixed": pf is not None, "rpa": True,
                                  "spec_tree": bool(tree and use_spec),
                                  "prefill_tokens": c})
            self._rearm(stalled, slots, active)
        return True

    def _dispatch_spec_spans(self, slots, rows, pf, q_lens, base, hl, depth,
                             pf_tokens, last_tok, temps, top_k, top_p):
        """The device half of a speculative span step.  Decode row b's span
        is [heal (``hl[b]`` host tokens), cur, drafts]: tree — W chains of
        k by ``draft_tree_lookup`` at depth ``depth[b]``, rope offsets and
        ancestor masks from ``_tree_span_template``; linear — k drafts by
        ``draft_lookup`` at consecutive positions.  ``pf``'s slice (host
        tokens, the causal rule) rides the same dispatch; its first token
        is emit[pf, 0], drawn from its last position (no drafts).  Drafting,
        the forward, acceptance and the history append run on the device;
        returns host arrays (emit [B, k+1], count [B], chain [B], depth
        [B]) from ONE fetch (chain and depth None when linear)."""
        dev = self.device
        B, k, max_len = self.B, self.spec_k, self.max_len
        tree = self._spec_tree
        W = self._spec_width if tree else 1
        n_nodes = 1 + W * k
        q_starts, total, row_flat, table = self._span_layout(slots, q_lens, base)
        self._an.note_bucket(total, table.shape[1], int(q_lens.sum()))
        tokens = np.zeros((total,), np.int64)
        pos_off = np.zeros((total,), np.int64)
        anc = np.zeros((total,), np.int32)
        for b in rows + ([pf] if pf is not None else []):
            s, n = int(q_starts[b]), int(q_lens[b])
            if b == pf:
                tokens[s: s + n] = pf_tokens
                pos_off[s: s + n] = np.arange(n)
            elif tree:
                tokens[s: s + hl[b]] = slots[b].spec_heal
                t_pos, t_anc = self._tree_span_template(int(hl[b]))
                pos_off[s: s + n], anc[s: s + n] = t_pos, t_anc
            else:
                pos_off[s: s + n] = np.arange(n)
        rf = np.clip(row_flat, 0, B - 1)
        positions = np.clip(base[rf] + pos_off, 0, max_len - 1)
        is_dec = np.zeros((B,), bool)
        is_dec[rows] = True
        # each decode row's nodes (cur, then the drafts); other rows their
        # last token, repeated
        lead = q_starts + hl
        last = np.minimum(q_starts + np.maximum(q_lens, 1) - 1, total - 1)
        gidx = np.where(is_dec[:, None],
                        lead[:, None] + np.arange(n_nodes)[None],
                        last[:, None]).reshape(-1)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        with self._an.seg("dispatch"):
            buf = self._spec_buf
            dr = t(np.asarray(rows, np.int64))
            # the rows' true kv_len, shifted by each row's draft-hint offset
            # (0 without a hint): the buffer column of the current token
            hoff = np.zeros((B,), np.int64)
            for b in rows:
                hoff[b] = slots[b].spec_hoff
            col = t((base + hl).astype(np.int64) + hoff)
            cur = t(last_tok.astype(np.int64))
            buf[dr, torch.clamp(col[dr], max=max_len - 1)] = cur[dr].int()
            eos, ngram = self.tokenizer.eos_id, max(2, self.cfg.speculate_ngram)
            if tree:
                chains, n_valid = draft_tree_lookup(buf, col + 1, k, W, pad_id=eos,
                                                    n=ngram, depth=t(depth))
            else:
                draft, n_lin = draft_lookup(buf, col + 1, k, pad_id=eos, n=ngram)
                chains, n_valid = draft[:, None], n_lin[:, None]
            n_valid = torch.where(t(is_dec)[:, None], n_valid,
                                  torch.zeros_like(n_valid))
            flat = t(tokens)
            nodes = torch.cat([cur[:, None], chains.reshape(B, W * k).long()], 1)
            at = t(lead)[dr][:, None] + torch.arange(n_nodes, device=dev)[None]
            flat[at.reshape(-1)] = nodes[dr].reshape(-1)
            logits = forward_paged(
                self.params, self.model_cfg, flat[None], t(positions)[None],
                self.cache.k, self.cache.v, t(table), t(base), max_len,
                packed_last_idx=t(gidx),
                spans=(t(q_starts), t(q_lens), t(row_flat)),
                kv_scales=self.kv_scales, span_anc=t(anc) if tree else None)
            if self._vocab_limit is not None:  # as in _sample
                logits[..., self._vocab_limit:] = float("-inf")
            probs = filtered_probs(logits[0], np.repeat(temps, n_nodes),
                                   np.repeat(top_k, n_nodes),
                                   np.repeat(top_p, n_nodes)).reshape(B, n_nodes, -1)
            if tree:
                out = list(verify_tree(probs, chains, n_valid, self.generator))
            else:
                out = list(verify_tokens(probs, chains[:, 0], n_valid[:, 0],
                                         self.generator))
            # accepted tokens extend the decode rows' history (the last one at
            # the next step's write index: idempotent)
            offs = torch.arange(k + 1, device=dev)[None]
            buf[dr[:, None], torch.clamp(col[dr][:, None] + 1 + offs,
                                         max=max_len - 1)] = out[0][dr]
        self._h_rpa_span.observe(int(q_lens.sum()))
        with self._an.seg("fetch"):
            fetched = [x.numpy() for x in _one_fetch(out)]
        return tuple(fetched) if tree else (*fetched, None, None)

    def _spec_tree_report(self) -> dict:
        """The tree-speculation block of ``metrics_report``: whether it is
        armed, its dispatches, mean drafted nodes and accepted depth per
        dispatched row, accepted tokens per row, and heal spans."""
        c = self.counters
        rows = c["spec_tree_rows"]
        per_row = lambda n: round(n / rows, 3) if rows else 0.0  # noqa: E731
        return {
            "enabled": self._spec_tree,
            "width": self._spec_width,
            "adaptive": self._spec_adaptive,
            "dispatches": c["spec_tree_dispatches"],
            "mean_nodes": per_row(c["spec_tree_nodes_sum"]),
            "mean_accept_depth": per_row(c["spec_accept_depth_sum"]),
            "accept_per_step": per_row(c["spec_accepted_tokens"]),
            "heal_spans": c["spec_heal_spans"],
        }

    # --------------------------------------------------------- spill tiers

    def _prefetch_spilled(self, chain, cached_pages: list[int],
                          fresh: list[int], cached_tokens: int):
        """Restore the matched spilled segments (host or disk tier →
        device) into their share of the freshly allocated pages, in
        positional order; each promotes its node to resident on those pages
        and extends the match.  The first segment that cannot be restored
        (an entry dropped since the match, a ``DiskReadError``, a payload
        ``ValueError``, the ``prefix.prefetch`` fault) truncates the match
        there: its pages and every later segment's become prefill tail.  A
        device error raises.
        Returns ``(cached_pages, fresh_tail, cached_tokens)``."""
        ps = self.cfg.page_size
        used = got = 0
        t0 = time.time()
        for node, n_tok in chain:
            npg = n_tok // ps
            try:
                # injection site: fires before any mutation for this
                # segment, so a fault costs the segment's reuse only
                faults.fire("prefix.prefetch")
                self._prefix_cache.prefetch_into(
                    node, fresh[used: used + npg], self.cache,
                    sync=self._host_kv_sync)
            except (LookupError, DiskReadError, ValueError, InjectedFault):
                logger.warning("KV prefetch failed; re-prefilling the "
                               "spilled segment", exc_info=True)
                break
            used += npg
            got += n_tok
        if used:
            m = self._m
            m["prefetch_seconds"].inc(max(0.0, time.time() - t0))
            m["prefix_prefetch_pages"].inc(used)
            m["prefix_tokens_prefetched"].inc(got)
            m["prefix_spilled_hits"].inc()
            # the restore's scatter rides into the next dispatch's wall
            self._perf.note_prefetch(used * self.cache.page_payload_bytes())
        return cached_pages + fresh[:used], fresh[used:], cached_tokens + got

    def _host_kv_report(self) -> dict:
        """The spill-tier block of ``metrics_report`` (the reference's
        keys): armed or not, budget and occupancy, spill/prefetch work."""
        pc = self._prefix_cache
        armed = pc is not None and pc.pool is not None
        c = self.counters
        out = {
            "enabled": armed,
            "budget_gb": round(self.cfg.host_kv_gb, 3) if armed else 0.0,
            "spilled_hits": c["prefix_spilled_hits"],
            "tokens_prefetched": c["prefix_tokens_prefetched"],
            "spill_pages": c["prefix_spill_pages"],
            "prefetch_pages": c["prefix_prefetch_pages"],
        }
        if armed:
            out["spilled_pages_resident"] = pc.spilled_pages()
            out["pool_bytes"] = pc.pool.used_bytes
            out["pool_entries"] = len(pc.pool)
            out["dropped_pages_total"] = pc.pool.dropped_pages_total
            if pc.disk is not None:
                # disk keys only with the disk tier armed
                out["disk_pages_resident"] = pc.disk_pages()
                out.update(pc.disk.stats())
        return out

    # ------------------------------------------------ disaggregated handoff

    def _pin_handoff(self, b, slots, results, fresh, active, kv_lens,
                     last_tok, gen, text) -> None:
        """Finish a prefill-role slot as ``"handoff"``: capture the payload
        (pages covering the prompt, resume state, int8 scales) host-side
        NOW, on the scheduler thread, so a handler thread's export never
        touches the device; keep the prompt pages allocated (pinned) until
        ``release_handoff`` or the orphan sweep.  The ``handoff.export``
        fault degrades to a marked per-request error; a failed capture of a
        device tensor raises."""
        st = slots[b]
        rid = st.req.request_id
        now = time.time()
        keep = self.cache.pages_needed(len(st.prompt_ids))
        t0 = time.time()
        try:
            payload = self.cache.export_sequence(st.seq, len(st.prompt_ids))
        except InjectedFault as e:
            # the handoff.export site fires before any capture: the request
            # errors marked (the router re-prefills elsewhere) and its
            # pages free, so the pool stays clean
            logger.warning("handoff export capture failed for request %d",
                           rid, exc_info=True)
            self._record_result(results, GenerationResult(
                request_id=rid, prompt_tokens=st.n_prompt,
                finish_reason="error",
                error=f"handoff export failed: {type(e).__name__}: {e}"),
                fresh, st.req)
            self.cache.close_sequence(st.seq)
            slots[b] = None
            active[b] = False
            kv_lens[b] = 0
            last_tok[b] = 0
            return
        if self.kv_scales is not None:
            # per-slot scales, fixed at prefill: the decode side writes them
            # into its slot's scale rows at admission
            payload["kscale"] = self.kv_scales[0][:, b].cpu().numpy()
            payload["vscale"] = self.kv_scales[1][:, b].cpu().numpy()
        self._m["handoff_capture_seconds"].inc(max(0.0, time.time() - t0))
        # resume state: the tokens whose K/V is exported, plus the sampled
        # first token the decode side feeds next
        payload["tokens"] = [int(t) for t in st.prompt_ids]
        payload["generated"] = [int(t) for t in gen]
        payload["n_prompt"] = st.n_prompt
        if st.req.trace_id:
            payload["trace_id"] = st.req.trace_id
        if st.req.tenant:
            payload["tenant"] = st.req.tenant
        # ... and the QoS class: the decode leg competes in the class the
        # prefill leg was admitted under
        if st.req.qos_class:
            payload["qos_class"] = st.req.qos_class
        # pages grown past the prompt for decode are not part of the
        # handoff: release them before pinning
        if len(st.seq.pages) > keep:
            self.cache.allocator.free(st.seq.pages[keep:])
            st.seq.pages = st.seq.pages[:keep]
        st.seq.length = len(st.prompt_ids)
        ttl = self.cfg.handoff_ttl_s
        rem = remaining_budget(st.req)
        if rem is not None:
            # pages pinned past the request's own deadline are worthless
            ttl = max(0.5, min(ttl, rem))
        with self._pinned_lock:
            self._pinned[rid] = {"seq": st.seq, "payload": payload,
                                 "deadline_t": now + ttl, "t_pinned": now}
        self._m["handoff_exports"].inc(1)
        self._record_result(results, GenerationResult(
            request_id=rid, text=text, prompt_tokens=st.n_prompt,
            completion_tokens=len(gen), finish_reason="handoff",
            device_seconds=now - st.t_start), fresh, st.req)
        if self._tr:
            tid = self._tid(st.req)
            if st.t_decode_start:
                self._tr.complete("decode", st.t_decode_start, now, tid=tid,
                                  args={"completion_tokens": len(gen)})
            self._tr.instant("handoff_export", ts=now, tid=tid,
                             args={"pages": len(st.seq.pages),
                                   "kv_len": len(st.prompt_ids)})
        slots[b] = None
        active[b] = False
        kv_lens[b] = 0
        last_tok[b] = 0

    def export_handoff(self, request_id: int) -> dict:
        """The wire payload of a pinned export, captured at pin time (no
        device access; repeatable).  ``KeyError`` for unknown or released
        ids (the ticket's 410)."""
        with self._pinned_lock:
            return self._pinned[request_id]["payload"]

    def release_handoff(self, request_id: int, orphaned: bool = False) -> int:
        """Release a pinned export's pages (the decode side acked, or with
        ``orphaned`` the sweep reclaims an expired one).  Idempotent;
        returns the pages released.  Callable from any thread: while a run
        is live the free is deferred to the scheduler thread's next block
        boundary, between runs it happens inline under the lock."""
        with self._pinned_lock:
            rec = self._pinned.pop(request_id, None)
            if rec is None:
                return 0
            n = len(rec["seq"].pages)
            if self._run_live:
                self._release_deferred.append((request_id, rec))
            else:
                self.cache.close_sequence(rec["seq"])
        if orphaned:
            self._m["handoff_orphaned_pages"].inc(n)
            logger.warning("handoff %d orphaned: %d pinned pages reclaimed",
                           request_id, n)
        tr = get_tracer()
        if tr:
            trace = rec["payload"].get("trace_id")
            tr.instant("handoff_release",
                       tid=tr.track_for(trace) if trace else req_tid(request_id),
                       args={"pages": n, "orphaned": orphaned})
        return n

    def _drain_released(self) -> None:
        """Free the releases parked while the run was live (scheduler
        thread only), under the lock: an inline free from a handler thread
        may run concurrently once the run flag is down."""
        with self._pinned_lock:
            items, self._release_deferred = self._release_deferred, []
            for _rid, rec in items:
                self.cache.close_sequence(rec["seq"])

    def sweep_handoffs(self, now: float | None = None) -> int:
        """Reclaim pinned exports past their deadline (the orphan sweep's
        engine half).  Returns pages released."""
        now = time.time() if now is None else now
        with self._pinned_lock:
            expired = [rid for rid, r in self._pinned.items()
                       if r["deadline_t"] <= now]
        return sum(self.release_handoff(rid, orphaned=True)
                   for rid in expired)

    def pinned_handoffs(self) -> dict[int, int]:
        """rid -> pinned page count."""
        with self._pinned_lock:
            return {rid: len(r["seq"].pages)
                    for rid, r in self._pinned.items()}

    def _admit_import(self, b, queue, slots, results, fresh, kv_lens,
                      last_tok, active, temps, top_k, top_p) -> bool:
        """Admit the queue head's IMPORTED sequence (decode role): scatter
        the transferred pages into the pool and enter the slot in decode
        with the resume token, no prefill.  False on page back-pressure
        (the entry stays queued).  A bad payload (page claim, token
        mismatch, geometry, missing scales) finishes the entry as an error
        the router falls back from; a device error raises."""
        req, ids, max_new, n_prompt, _prior, _t0 = queue[0]
        state = req.handoff_state
        # the decode leg continues the exporter's trace and bills its tenant
        if not req.trace_id and isinstance(state.get("trace_id"), str):
            req.trace_id = state["trace_id"]
        if not req.tenant and isinstance(state.get("tenant"), str):
            req.tenant = state["tenant"]

        def fail(why: str) -> bool:
            queue.popleft()
            logger.warning("handoff import failed for request %d: %s",
                           req.request_id, why)
            self._record_result(results, GenerationResult(
                request_id=req.request_id, prompt_tokens=n_prompt,
                finish_reason="error",
                error=f"handoff import failed: {why}"), fresh, req)
            return True

        try:
            need = int(state.get("n_pages", 0) or 0)
        except (TypeError, ValueError):
            need = -1
        if not 0 < need <= min(self.cache.max_pages_per_slot,
                               self.cache.num_pages - 1):
            # an unsatisfiable claim must fail, never wait at the head
            return fail(f"page claim {need} exceeds this pool's capacity")
        if need > self.cache.allocator.free_count:
            if self._prefix_cache is not None:
                self._prefix_cache.evict(need - self.cache.allocator.free_count)
            if need > self.cache.allocator.free_count:
                return False
        t_imp = time.time()
        try:
            gen = [int(t) for t in state.get("generated", ())]
            toks = [int(t) for t in state.get("tokens", ())]
            kv_len = int(state.get("kv_len", -1))
            if toks != list(ids):
                # tokenizer or config drift between the two sides
                raise ValueError(
                    f"token mismatch: payload covers {len(toks)} prompt "
                    f"tokens, this engine encodes {len(ids)}")
            if kv_len != len(ids):
                raise ValueError(f"kv_len {kv_len} != {len(ids)} prompt "
                                 "tokens")
            if not gen:
                raise ValueError("handoff state carries no resume token")
            scales = None
            if self.kv_scales is not None:
                want = ((self.kv_scales[0].shape[0],)
                        + tuple(self.kv_scales[0].shape[2:]))
                ks = np.asarray(state["kscale"], dtype=np.float32)
                vs = np.asarray(state["vscale"], dtype=np.float32)
                if ks.shape != want or vs.shape != want:
                    raise ValueError(f"scale shape {ks.shape}/{vs.shape} != "
                                     f"pool's {want}")
                scales = (ks, vs)
            seq = self.cache.import_sequence(state)
        except OutOfPages:
            return False
        except (ValueError, KeyError, TypeError, InjectedFault) as e:
            # InjectedFault: the handoff.import site, before any allocation
            return fail(f"{type(e).__name__}: {e}")
        queue.popleft()
        # consumed: a preempted continuation re-admits through prefill
        req.handoff_state = None
        now = time.time()
        st = _SlotState(req=req, prompt_ids=ids, max_new=max_new, seq=seq,
                        phase="decode", prefill_pos=len(ids), kv_len=kv_len,
                        t_start=now, t_admit=now, n_prompt=n_prompt,
                        generated=gen,
                        spec_depth=self.spec_k if self._spec_tree else 0,
                        t_decode_start=now)
        slots[b] = st
        kv_lens[b] = kv_len
        last_tok[b] = gen[-1]
        active[b] = True
        temps[b] = req.temperature
        top_k[b] = req.top_k
        top_p[b] = min(max(req.top_p, 0.0), 1.0)
        if scales is not None:
            # the exporter's scales, into THIS slot's rows
            for buf, sc in zip(self.kv_scales, scales):
                buf[:, b] = torch.from_numpy(sc).to(self.device)
        self._seed_history(b, st)
        self._m["handoff_imports"].inc(1)
        self._m["handoff_import_seconds"].inc(max(0.0, time.time() - t_imp))
        if self._tr:
            self._tr.instant("handoff_import", ts=now, tid=self._tid(req),
                             args={"slot": b, "kv_len": kv_len,
                                   "pages": len(seq.pages)})
        self._note_first_token(st)
        self._note_peak_pages()
        # stream the first token at once (it is never terminal: the pin
        # guard kept terminal first tokens from becoming handoffs)
        self._maybe_finish(b, slots, results, fresh, active, kv_lens,
                           last_tok)
        return True

    # ------------------------------------------------- page-set migration

    def kv_export(self, preamble: str) -> dict | None:
        """The warm page set of one published preamble hash (resident
        pages gathered from the pool, spilled segments read from their
        tier) as a wire payload a sibling's ``kv_import`` installs; this
        cache is left as it was.  Between runs only: None mid-run, for an
        unknown or cold preamble, and with the prefix cache off.  Holds the
        pin lock throughout, so no run starts under it."""
        with self._pinned_lock:
            if self._run_live or self._prefix_cache is None:
                return None
            ent = self._preambles.get(preamble)
            if ent is None:
                return None
            faults.fire("migrate.export")
            ids = list(ent["ids"])
            ps = self.cfg.page_size
            pages, matched, chain = self._prefix_cache.match_hier(ids)
            k_parts, v_parts = [], []
            try:
                if matched:
                    pay = self.cache.export_pages(pages)
                    k_parts.append(pay["k"])
                    v_parts.append(pay["v"])
            finally:
                if matched:
                    self.cache.allocator.free(pages)
            tokens = matched
            for node, n_tok in chain:
                pay = self._prefix_cache.spill_payload(node)
                if pay is None:
                    break
                k_parts.append(pay["k"])
                v_parts.append(pay["v"])
                tokens += n_tok
            if tokens == 0:
                return None
            wire = self.cache.wire_dtype
            k = as_dtype(np.concatenate(k_parts, axis=1), wire)
            v = as_dtype(np.concatenate(v_parts, axis=1), wire)
            kh, _ps, hd = (int(x) for x in self.cache.k.shape[1:])
            self._m["kv_migrate_exports"].inc(1)
            return {"kind": "kv_pageset", "version": 1, "preamble": preamble,
                    "tokens": tokens, "ids": [int(t) for t in ids[:tokens]],
                    "n_pages": tokens // ps, "page_size": ps,
                    "n_layers": self.cache.n_layers, "n_kv_heads": kh,
                    "head_dim": hd, "dtype": wire, "k": k, "v": v}

    def kv_import(self, payload: dict) -> int:
        """Install a migrated page set into the prefix cache: allocate
        pages, scatter (synchronously: control plane), insert under the
        payload's ids and publish the preamble in the radix summary.
        Returns the tokens now warm.  A geometry, dtype or framing
        mismatch raises ``ValueError``; pool pressure ``OutOfPages`` after
        a reclaim; a live run ``RuntimeError`` (retry between runs)."""
        with self._pinned_lock:
            if self._run_live:
                raise RuntimeError("engine busy; kv import retries between "
                                   "runs")
            if self._prefix_cache is None:
                raise ValueError("prefix cache off; nothing to import into")
            faults.fire("migrate.import")
            kh, ps, hd = (int(x) for x in self.cache.k.shape[1:])
            want = {"page_size": self.cache.page_size,
                    "n_layers": self.cache.n_layers, "n_kv_heads": kh,
                    "head_dim": hd, "dtype": self.cache.wire_dtype}
            for key, val in want.items():
                got = payload.get(key)
                if got != val:
                    raise ValueError(f"incompatible kv payload: {key}={got!r}"
                                     f", this pool has {val!r}")
            ids = [int(t) for t in payload.get("ids", ())]
            n = int(payload.get("n_pages", 0) or 0)
            tokens = int(payload.get("tokens", 0) or 0)
            if n <= 0 or tokens != n * ps or len(ids) != tokens:
                raise ValueError(
                    f"inconsistent kv payload framing: {n} pages / {tokens} "
                    f"tokens / {len(ids)} ids (page_size {ps})")
            if n > self.cache.allocator.free_count:
                self._prefix_cache.evict(n - self.cache.allocator.free_count)
            pages = self.cache.alloc_pages(n)
            try:
                self.cache.import_pages(
                    pages, {"k": payload["k"], "v": payload["v"],
                            "dtype": payload["dtype"]}, sync=True)
                self._prefix_cache.insert(ids, pages, max_tokens=tokens)
            finally:
                # the cache holds its own references on adopted pages
                self.cache.allocator.free(pages)
            key = payload.get("preamble")
            if isinstance(key, str) and key:
                self._preamble_tick += 1
                self._preambles[key] = {"ids": tuple(ids),
                                        "tick": self._preamble_tick}
                self._summary_memo = None
            self._m["kv_migrate_imports"].inc(1)
            self._m["kv_migrate_tokens"].inc(tokens)
            return tokens

    # ------------------------------------------------------------ reporting

    def audit(self, live_seqs=None) -> list[str]:
        """Invariant audit (empty list = clean): the prefix cache's tree
        structure and spill tiers, page conservation and refcount balance
        against the live sequences (none between runs), the handoff-pinned
        sequences and the cache's retained pages, and no request finished
        twice."""
        holders: dict[int, int] = {}
        with self._pinned_lock:
            pinned = ([r["seq"] for r in self._pinned.values()]
                      + [r["seq"] for _, r in self._release_deferred])
        for seq in list(live_seqs or ()) + pinned:
            for p in seq.pages:
                holders[p] = holders.get(p, 0) + 1
        violations: list[str] = []
        if self._prefix_cache is not None:
            violations += self._prefix_cache.audit()
            for p in self._prefix_cache.retained_pages():
                holders[p] = holders.get(p, 0) + 1
        violations += audit_allocator(self.cache.allocator,
                                      self.cache.num_pages, holders)
        if self._double_finish:
            violations.append(f"{self._double_finish} request(s) finished "
                              "more than once")
        # the ledger's conservation and the anatomy's identity (totals
        # only advance at iteration ends: safe mid-run)
        violations += self._cost.audit()
        violations += self._an.audit()
        if violations:
            dump_postmortem("audit_failure", metrics=self.counters,
                            extra={"violations": violations})
        return violations

    def metrics_report(self) -> dict:
        """Cumulative engine metrics.  ``decode_tokens_per_sec`` is decode
        tokens over the host time of the dispatches that produced them
        (decode blocks and mixed steps, each ending in its host fetch)."""
        c = self.counters
        dec_s = c["decode_block_seconds"] + c["mixed_step_seconds"]
        dec_disp = c["decode_blocks"] + c["mixed_dispatches"]
        mixed = c["mixed_dispatches"]
        out = {
            "requests": c["requests"],
            "prefill_tokens": c["prefill_tokens"],
            "prefill_dispatches": c["prefill_dispatches"],
            "packed_prefill_dispatches": c["packed_dispatches"],
            "decode_tokens": c["decode_tokens"],
            "decode_blocks": c["decode_blocks"],
            "decode_block_seconds": round(c["decode_block_seconds"], 4),
            "mixed_step_seconds": round(c["mixed_step_seconds"], 4),
            "decode_tokens_per_sec": round(c["decode_tokens"] / dec_s, 2) if dec_s else 0.0,
            "mean_decode_occupancy": round(
                c["occupancy_sum"] / dec_disp, 4) if dec_disp else 0.0,
            "peak_kv_pages": c["peak_pages"],
            "peak_kv_page_utilization": round(
                c["peak_pages"] / (self.cache.num_pages - 1), 4),
            "preemptions": c["preemptions"],
            "stalls": c["stalls"],
            "cancelled": c["cancelled"],
            "deadline": c["deadline"],
            "shed": c["shed"],
            "mixed_batch": {
                "enabled": self._mixed,
                "token_budget": self.mixed_token_budget,
                "dispatches": mixed,
                "fill_ratio": round(c["mixed_fill_sum"] / mixed, 3) if mixed else 0.0,
                "prefill_tokens_piggybacked": c["prefill_tokens_piggybacked"],
            },
            "rpa": {"dispatches": c["rpa_dispatches"],
                    "span_tokens": c["rpa_span_tokens"]},
            "run_seconds": round(c["run_seconds"], 4),
        }
        if self.spec_k:
            out["spec_accepted_tokens"] = c["spec_accepted_tokens"]
            for key in ("spec_tree_dispatches", "spec_tree_nodes_sum",
                        "spec_tree_rows", "spec_accept_depth_sum"):
                out[key] = c[key]
            out["spec_tree"] = self._spec_tree_report()
        if self._prefix_cache is not None:
            q, hits = c["prefix_queries"], c["prefix_hits"]
            out["prefix_cache"] = {
                "hit_rate": round(hits / q, 3) if q else 0.0,
                "hits": hits, "queries": q,
                "tokens_reused": c["prefix_tokens_reused"],
                "prefill_tokens_saved": c["prefix_tokens_reused"],
                "spilled_hits": c["prefix_spilled_hits"],
                "tokens_prefetched": c["prefix_tokens_prefetched"],
                **self._prefix_cache.stats(),
            }
        out["host_kv"] = self._host_kv_report()
        if c["kv_migrate_exports"] or c["kv_migrate_imports"]:
            # only once a page set moved (the mock's contract)
            out["kv_migrate"] = {"exports": c["kv_migrate_exports"],
                                 "imports": c["kv_migrate_imports"],
                                 "tokens_imported": c["kv_migrate_tokens"]}
        out["ttft_ms"] = self._h_ttft.percentile_report()
        out["decode_block_gap_ms"] = self._h_block_gap.percentile_report()
        out["queue_wait_ms"] = self._h_queue_wait.percentile_report()
        out["perf_attribution"] = self._perf.report()
        out["cost"] = self._cost.report()
        out["slo"] = self._slo.report()
        if self._an.enabled:  # LMRS_ANATOMY=0: no anatomy key at all
            out["anatomy"] = self.anatomy_report()
        return out

    @property
    def counters(self) -> dict:
        """The scheduler's cumulative counts as a plain dict (a snapshot
        read off the registry; seconds and ratio sums stay floats)."""
        out = {k: (m.value if k in _FLOAT_COUNTERS else int(m.value))
               for k, m in self._m.items()}
        out["occupancy_sum"] = self._h_occupancy.sum
        out["mixed_fill_sum"] = self._h_mixed_fill.sum
        out["rpa_dispatches"] = self._h_rpa_span.count
        out["rpa_span_tokens"] = int(self._h_rpa_span.sum)
        out["spill_capture_seconds"] = self._h_spill_capture.sum
        return out

    def metrics_registry(self) -> MetricsRegistry:
        """The registry behind ``metrics_report()``, for Prometheus
        exposition (the server's ``GET /metrics`` merges it in)."""
        return self.registry

    def perf_attribution_report(self) -> dict:
        """Live per-phase roofline attribution (obs/perf.py)."""
        return self._perf.report()

    def usage_report(self) -> dict:
        """Per-tenant cost rollups (the ``GET /v1/usage`` document)."""
        return self._cost.usage_report()

    def qos_report(self) -> dict:
        """Fair-share window state (the ``GET /v1/usage`` ``qos`` block)."""
        if self._qos is None:
            return {"object": "qos", "enabled": False}
        return self._qos.report()

    def slo_report(self) -> dict:
        """Burn-rate SLO evaluation (the ``/healthz`` ``slo`` block)."""
        return self._slo.report()

    def anatomy_report(self, before: dict | None = None) -> dict:
        """Step anatomy and span-bucket economics (the ``GET /v1/anatomy``
        document); ``before`` is an ``anatomy_snapshot()`` window anchor.
        The round trip rides along so a stale sample is flagged, not
        subtracted."""
        return self._an.report(before, rtt=self._perf.rtt_sample())

    def anatomy_snapshot(self) -> dict:
        """Window anchor for ``anatomy_report(before=...)``."""
        return self._an.snapshot()

    @property
    def metrics(self) -> dict:
        """Raw cumulative values under the reference scheduler's key names
        (its ``metrics`` snapshot; the spill-tier and handoff keys)."""
        c = self.counters
        with self._pinned_lock:
            pinned = sum(len(r["seq"].pages) for r in self._pinned.values())
        return {
            "prefill_tokens": c["prefill_tokens"],
            "decode_tokens": c["decode_tokens"],
            "preemptions": c["preemptions"],
            "prefix_queries": c["prefix_queries"],
            "prefix_hits": c["prefix_hits"],
            "prefix_tokens_reused": c["prefix_tokens_reused"],
            "prefix_spilled_hits": c["prefix_spilled_hits"],
            "prefix_tokens_prefetched": c["prefix_tokens_prefetched"],
            "prefix_spill_pages": c["prefix_spill_pages"],
            "prefix_prefetch_pages": c["prefix_prefetch_pages"],
            "handoff_exports": c["handoff_exports"],
            "handoff_imports": c["handoff_imports"],
            "handoff_orphaned_pages": c["handoff_orphaned_pages"],
            "handoff_pinned_pages": pinned,
            "deadline_exceeded": c["deadline"],
            "watchdog_fires": c["watchdog_fires"],
            "wedged_requests": c["wedged_requests"],
        }


def _one_fetch(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Bring several device tensors to the host in one transfer: flatten,
    concatenate as int64, copy once, split."""
    flat = torch.cat([t.reshape(-1).long() for t in tensors]).cpu()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape))
        off += n
    return out
