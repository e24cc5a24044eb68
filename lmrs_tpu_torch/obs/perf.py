"""Live per-dispatch performance attribution and on-demand profiler
capture (a copy of the reference's ``obs/perf.py``; ``torch.profiler`` in
place of ``jax.profiler``, and the round-trip probe times a tiny op and a
``.cpu()`` fetch in place of ``jax.device_get``).

* ``DispatchAttribution``, owned by the continuous scheduler and fed from
  the real dispatch loop.  Each decode block knows its model byte cost
  (weights once per step plus the live-KV walk) and each prefill dispatch
  its model FLOP cost; the measured dispatch walls, minus the host round
  trip, turn those into ``lmrs_decode_hbm_util_ratio`` and
  ``lmrs_prefill_mfu_ratio`` samples against ``chip_spec()``'s peaks, plus
  ``lmrs_step_gap_ms``, the host-side gap between consecutive decode
  dispatches.  A wall is taken at the one host fetch its block already
  makes, so the attribution adds no synchronisation.

  - decode blocks with no prefill work sequenced into them are clean
    samples: util = model_bytes / (wall - rtt) / peak_bw;
  - blocks that carry same-iteration prefill dispatches (their first
    tokens ride the block's fetch) count the prefill FLOPs but give no
    sample.  The reference splits such a wall by the decode share its
    clean samples estimate, which holds where a wall is device time; on
    an eager host it is mostly kernel issue, under which the prefills'
    device time hides, and the remainder read as MFU is noise (phase 5
    on an H100 80GB HBM3 at 700 W: 0.11-1.38);
  - fused mixed steps are split exactly by each phase's roofline time
    (``note_mixed_step``);
  - prefill waves fetched on their own give clean MFU samples
    (``note_prefill_sync``);
  - speculative blocks contribute step gaps only.

  On an eager host a block's wall is mostly kernel issue, so the live
  utilisation reads low; that is the true reading of the wall.

* ``start_profile_capture``, the ``POST /v1/debug/profile`` and
  ``LMRS_PROFILE_ON_SLOW_STEP`` hook: a bounded, one-at-a-time
  ``torch.profiler`` capture (CPU and CUDA activities) exported as a
  Chrome trace into a directory, stopped by its own thread's timer so an
  abandoned capture can never run forever.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from lmrs_tpu_torch.utils.env import env_float, env_str

logger = logging.getLogger("lmrs_torch.obs.perf")


class DispatchAttribution:
    """Roofline attribution fed from the live dispatch loop (see module
    doc).  Registers its metrics on the scheduler's registry so they ride
    the existing ``metrics_report()`` / Prometheus surfaces."""

    def __init__(self, model_cfg, engine_cfg, registry, device=None):
        from lmrs_tpu_torch.obs.metrics import MS_LATENCY_BUCKETS, RATIO_BUCKETS

        self.model_cfg = model_cfg
        self.device = device  # where the round-trip probe runs
        self._chip = None  # chip_spec() of that device, resolved once
        self._quantized = bool(getattr(engine_cfg, "quantize", None))
        self._kv_quantized = bool(getattr(engine_cfg, "kv_quantize", None))
        self._rtt: float | None = None
        self._rtt_t: float | None = None  # clock time of the last probe
        self._clock = time.time  # injectable (stale-RTT regression test)
        self._last_block_end: float | None = None
        h, g, c = registry.histogram, registry.gauge, registry.counter
        self.h_mfu = h("lmrs_prefill_mfu_ratio", buckets=RATIO_BUCKETS,
                       help="live prefill model-FLOPs utilization per "
                            "attributed dispatch")
        self.h_hbm = h("lmrs_decode_hbm_util_ratio", buckets=RATIO_BUCKETS,
                       help="live decode HBM-bandwidth utilization per "
                            "clean decode block")
        self.h_gap = h("lmrs_step_gap_ms", buckets=MS_LATENCY_BUCKETS,
                       help="host-side gap between consecutive decode "
                            "dispatches (end of fetch to next issue)",
                       unit="ms")
        self.g_mfu = g("lmrs_prefill_mfu_ratio_last",
                       "most recent live prefill MFU sample")
        self.g_hbm = g("lmrs_decode_hbm_util_ratio_last",
                       "most recent live decode HBM-utilization sample")
        self.g_gap = g("lmrs_step_gap_ms_last",
                       "most recent decode step gap", "ms")
        self.c_flops = c("lmrs_prefill_model_flops_total",
                         "model-accounted prefill FLOPs dispatched",
                         "flops")
        self.c_bytes = c("lmrs_decode_model_bytes_total",
                         "model-accounted decode HBM bytes dispatched",
                         "bytes")
        # host-RAM KV prefetch (engine/host_kv.py): scatter bytes issued
        # asynchronously ride into the NEXT decode block's wall, so that
        # block must not feed the clean-sample EMA — the pending flag
        # marks it dirty and the bytes are counted here
        self.c_prefetch_bytes = c("lmrs_prefix_prefetch_bytes_total",
                                  "host→HBM bytes restored by KV spill "
                                  "prefetch", "bytes")
        self._prefetch_pending = False

    # ------------------------------------------------------------ plumbing

    def _spec(self):
        """The peaks of the card the engine runs on (a CPU device prices
        as unknown), resolved once."""
        if self._chip is None:
            import torch

            from lmrs_tpu_torch.utils.perf_model import chip_spec

            dev = self.device
            if dev is None or torch.device(dev).type != "cuda":
                self._chip = chip_spec("cpu" if dev is not None else None)
            else:
                self._chip = chip_spec(torch.cuda.get_device_name(
                    torch.device(dev)))
        return self._chip

    def ensure_rtt(self) -> float:
        """Median of three trivial dependent round trips (a tiny op on the
        engine's device, then ``.cpu()``), measured lazily and re-sampled
        on a slow cadence (``LMRS_RTT_RESAMPLE_S``, default 300 s).  A
        re-probe failure keeps the previous sample (and refreshes its
        timestamp).  Subtracted from every dispatch wall, and nothing more
        is."""
        from lmrs_tpu_torch.obs.anatomy import rtt_resample_s

        now = self._clock()
        if (self._rtt is not None and self._rtt_t is not None
                and now - self._rtt_t < rtt_resample_s()):
            return self._rtt
        try:
            import torch

            x = torch.zeros((8,), dtype=torch.float32, device=self.device)
            (x + 1).cpu()  # warm the tiny op
            rtts = []
            for _ in range(3):
                t0 = time.time()
                (x + 1).cpu()
                rtts.append(time.time() - t0)
            self._rtt = sorted(rtts)[1]
        except Exception:  # noqa: BLE001 - attribution must never kill
            if self._rtt is None:
                logger.warning("RTT probe failed; attribution walls will "
                               "include the host link RTT", exc_info=True)
                self._rtt = 0.0
            else:
                logger.warning("RTT re-probe failed; keeping the previous "
                               "sample", exc_info=True)
        self._rtt_t = now
        return self._rtt

    def rtt_sample(self) -> tuple[float | None, float | None]:
        """``(rtt_s, age_s)`` of the current sample WITHOUT probing —
        the anatomy report's stale-RTT guard reads this so a report can
        never trigger a device round trip, and a sample older than its
        staleness horizon is flagged instead of silently skewing the
        dispatch/fetch split."""
        if self._rtt is None or self._rtt_t is None:
            return None, None
        return self._rtt, max(self._clock() - self._rtt_t, 0.0)

    def prefill_flops(self, chunk_tokens: int, kv_start: int = 0) -> float:
        """Model FLOPs of one prefill row: a fresh causal chunk
        (``kv_start=0``) or a windowed continuation chunk attending
        ``kv_start`` earlier KV tokens.  LM head on the sampled row only
        (the packed-prefill gather — forward_paged last_pos)."""
        from lmrs_tpu_torch.utils.perf_model import prefill_flops

        return prefill_flops(self.model_cfg, max(1, chunk_tokens),
                             head_tokens=1, kv_start=kv_start)

    def decode_bytes(self, steps: int, n_live: int, live_tokens: int) -> float:
        """Model HBM bytes of one decode block: every matmul weight once
        per step (batch-amortized) plus the live-KV walk, whose per-step
        total grows by one token per live row per step."""
        from lmrs_tpu_torch.utils.perf_model import (kv_bytes_per_token,
                                               weight_bytes)

        kv_token_steps = (steps * live_tokens
                          + n_live * steps * (steps - 1) / 2.0)
        kv = kv_bytes_per_token(self.model_cfg) * kv_token_steps
        if self._kv_quantized:
            kv /= 2
        return steps * weight_bytes(self.model_cfg, self._quantized) + kv

    def note_prefetch(self, nbytes: float) -> None:
        """A KV spill prefetch was issued (async scatter): count its HBM
        bytes and mark the next decode block dirty — its wall includes
        the transfer, so it must count work but never sample utilization
        (same discipline as compiling shapes)."""
        if nbytes > 0:
            self.c_prefetch_bytes.inc(nbytes)
        self._prefetch_pending = True

    # ------------------------------------------------------------- samples

    def note_gap(self, t_start: float, t_end: float) -> None:
        """Record the host-side gap since the previous block's fetch
        completed (the device-idle window between dispatches), and mark
        this block's end.  Called by every block path — including
        speculative blocks, which contribute no byte/FLOP samples."""
        if self._last_block_end is not None:
            gap_ms = max(0.0, (t_start - self._last_block_end) * 1e3)
            self.h_gap.observe(gap_ms)
            self.g_gap.set(gap_ms)
        self._last_block_end = t_end

    def note_block(self, t_start: float, t_end: float, steps: int,
                   n_live: int, live_tokens: int, prefill_flops: float,
                   warm: bool) -> float:
        """One decode-block dispatch: wall [t_start, t_end], ``n_live``
        rows at ``live_tokens`` total context, with ``prefill_flops`` of
        same-iteration prefill work sequenced before it on device (0 for
        a clean decode block).  Only a clean, warm block samples; any
        other counts its work (module doc).  Returns the block's model
        byte cost (the ``hbm_gb`` trace-span arg)."""
        self.note_gap(t_start, t_end)
        nbytes = self.decode_bytes(steps, n_live, live_tokens)
        self.c_bytes.inc(nbytes)
        if prefill_flops > 0:
            self.c_flops.inc(prefill_flops)
            warm = False
        if self._prefetch_pending:
            # the wall includes an async spill-prefetch scatter sequenced
            # before this block: count the work, skip the samples
            self._prefetch_pending = False
            warm = False
        if not warm:
            return nbytes
        t = (t_end - t_start) - self.ensure_rtt()
        if t <= 1e-6:
            return nbytes
        util = nbytes / t / self._spec().peak_hbm_bw
        if 0.0 < util < 4.0:  # garbage guard (clock steps, CPU fallback)
            self.h_hbm.observe(util)
            self.g_hbm.set(util)
        return nbytes

    def note_mixed_step(self, t_start: float, t_end: float, n_live: int,
                        live_tokens: int, prefill_flops: float,
                        warm: bool, span_tokens: int | None = None) -> float:
        """One FUSED mixed dispatch (SARATHI mixed batches): ``n_live``
        decode rows advance one token and a prefill slice of known size
        rides the SAME program.  Its per-row token counts are exact, so
        the wall is apportioned proportionally to each phase's own
        roofline time (``bytes/peak_bw`` vs ``flops/peak_flops``), under
        which both phase samples equal the step's combined roofline
        utilization — the assumption-free number for a step whose two
        phases share one kernel launch (they cannot be timed apart
        host-side).  Returns the step's model byte cost (the ``hbm_gb``
        trace-span arg).

        ``span_tokens`` is the SPAN-LEVEL decode token count from a
        ragged span dispatch (LMRS_RPA): total decode-side query tokens
        in the step — ``(1 + spec_k) * n_live`` when decode rows carry
        verify spans.  Defaults to ``n_live`` (one token per live row,
        the legacy fused step), under which the byte model is unchanged."""
        self.note_gap(t_start, t_end)
        if span_tokens is None or span_tokens <= n_live or n_live <= 0:
            nbytes = self.decode_bytes(1, n_live, live_tokens)
        else:
            # ragged span step: every query token in a row's span walks
            # that row's KV, so the walk term scales by the mean span
            # length instead of the legacy one-token-per-row shape
            from lmrs_tpu_torch.utils.perf_model import (kv_bytes_per_token,
                                                   weight_bytes)
            kv = (kv_bytes_per_token(self.model_cfg)
                  * live_tokens * span_tokens / n_live)
            if self._kv_quantized:
                kv /= 2
            nbytes = weight_bytes(self.model_cfg, self._quantized) + kv
        self.c_bytes.inc(nbytes)
        if prefill_flops > 0:
            self.c_flops.inc(prefill_flops)
        if self._prefetch_pending:  # same contract as note_block
            self._prefetch_pending = False
            warm = False
        if not warm:
            return nbytes
        spec = self._spec()
        t = (t_end - t_start) - self.ensure_rtt()
        if t <= 1e-6:
            return nbytes
        t_model = (nbytes / spec.peak_hbm_bw
                   + max(prefill_flops, 0.0) / spec.peak_flops)
        util = t_model / t
        if 0.0 < util < 4.0:  # same garbage guard as note_block
            self.h_hbm.observe(util)
            self.g_hbm.set(util)
            if prefill_flops > 0:
                self.h_mfu.observe(util)
                self.g_mfu.set(util)
        return nbytes

    def note_prefill_sync(self, flops: float, t_start: float,
                          t_end: float, warm: bool) -> None:
        """A prefill wave whose first tokens were fetched SYNCHRONOUSLY
        (handoff-export slots, speculation, LMRS_DEFER_TOK0=0): the wall
        covers exactly the prefill compute + one RTT — a clean MFU sample
        (this is the prefill pod's whole serving life under
        disaggregation)."""
        if flops <= 0:
            return
        self.c_flops.inc(flops)
        if self._prefetch_pending:  # the wave's wall includes the scatter
            self._prefetch_pending = False
            warm = False
        if not warm:
            return
        t = (t_end - t_start) - self.ensure_rtt()
        if t <= 1e-6:
            return
        mfu = flops / t / self._spec().peak_flops
        if 0.0 < mfu < 4.0:
            self.h_mfu.observe(mfu)
            self.g_mfu.set(mfu)

    # -------------------------------------------------------------- report

    def report(self) -> dict:
        """The ``perf_attribution`` block of ``metrics_report()`` / bench
        detail: per-phase live roofline ratios + the model-accounted work
        totals they were computed over."""
        return {
            "prefill_mfu": self.h_mfu.percentile_report(scale=1.0,
                                                        ndigits=4),
            "prefill_mfu_last": round(self.g_mfu.value, 4),
            "decode_hbm_util": self.h_hbm.percentile_report(scale=1.0,
                                                            ndigits=4),
            "decode_hbm_util_last": round(self.g_hbm.value, 4),
            "step_gap_ms": self.h_gap.percentile_report(scale=1.0),
            # 6 decimals: tiny test models dispatch MEGA-scale work, and
            # a report that rounds real nonzero totals to 0.0 reads as
            # "attribution dead" exactly where tests check liveness
            "model_prefill_gflops": round(self.c_flops.value / 1e9, 6),
            "model_decode_gb": round(self.c_bytes.value / 1e9, 6),
            "rtt_ms": (round(self._rtt * 1e3, 2)
                       if self._rtt is not None else None),
        }


# ------------------------------------------------ on-demand profiler capture

_capture_lock = threading.Lock()
_capture_active = False


def profile_capture_active() -> bool:
    with _capture_lock:
        return _capture_active


def default_profile_dir() -> str:
    """Where captures land unless the caller says otherwise: the one
    ``LMRS_PROFILE_DIR`` fallback shared by ``/v1/debug/profile`` and the
    slow-step trigger."""
    import tempfile

    return (env_str("LMRS_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "lmrs_profile"))


def start_profile_capture(out_dir: str, duration_s: float = 2.0
                          ) -> tuple[bool, str]:
    """Start a bounded ``torch.profiler`` capture (CPU activity, and CUDA
    activity when a card is present) that exports a Chrome trace
    ``lmrs-profile-<ms>-<pid>.json`` into ``out_dir`` after
    ``duration_s``.  The capture starts, waits and stops on one daemon
    thread of its own (the profiler is process-wide: kernels launched by
    the scheduler thread are recorded).  One capture at a time per
    process; returns ``(ok, dir_or_reason)`` and never raises."""
    import math

    global _capture_active
    # NaN survives min/max clamps and would kill the timer's wait
    duration_s = float(duration_s)
    if not math.isfinite(duration_s):
        duration_s = 2.0
    duration_s = min(max(duration_s, 0.1), 60.0)
    with _capture_lock:
        if _capture_active:
            return False, "a profile capture is already running"
        _capture_active = True
    started = threading.Event()
    failure: list[str] = []

    def _capture() -> None:
        global _capture_active
        prof = None
        try:
            import pathlib

            import torch
            from torch.profiler import ProfilerActivity, profile

            pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 - report, never raise
            failure.append(f"profiler start failed: {type(e).__name__}: {e}")
            with _capture_lock:
                _capture_active = False
            started.set()
            return
        started.set()
        try:
            threading.Event().wait(duration_s)
            prof.stop()
            path = os.path.join(out_dir, f"lmrs-profile-"
                                f"{int(time.time() * 1e3)}-{os.getpid()}.json")
            prof.export_chrome_trace(path)
            logger.info("profile capture written to %s", path)
        except Exception:  # noqa: BLE001 - best-effort stop
            logger.warning("profiler stop failed", exc_info=True)
        finally:
            with _capture_lock:
                _capture_active = False

    threading.Thread(target=_capture, name="lmrs-profile", daemon=True).start()
    started.wait()
    if failure:
        return False, failure[0]
    logger.info("profile capture started: %s (%.1fs)", out_dir, duration_s)
    return True, out_dir


def slow_step_threshold_s() -> float:
    """The ``LMRS_PROFILE_ON_SLOW_STEP`` trigger threshold (seconds);
    0 = disabled.  Read per call so tests can arm it without rebuilding
    the engine."""
    return env_float("LMRS_PROFILE_ON_SLOW_STEP", 0.0, lo=0.0)
