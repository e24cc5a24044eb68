"""The dispatch watchdog (a copy of the reference's ``engine/watchdog.py``).

A dispatch that wedges (a hung card, a kernel that never ends, an injected
``scheduler.heartbeat`` stall) would freeze the engine forever: the
scheduler loop blocks in its host fetch with no timeout.  This module turns
a wedge into a bounded, observable failure:

* :class:`DispatchWatchdog`: monotonic heartbeat state the scheduler loop
  stamps once per iteration (``beat``).  ``LMRS_WATCHDOG_S`` sets the wedge
  threshold; the default (0 = auto) is ~30x an EMA of the inter-beat step
  time, floored at 60 s, and 300 s before the first sample.  A kernel
  build at first use (``ops/kernels.load``, one ``nvcc`` per source) opens
  a one-shot grace window (``grace_cold`` / ``grace_end``), so a cold build
  never reads as a hang.

* :class:`WatchdogRunner`: owned by ``TorchEngine`` when the watchdog is
  armed (``LMRS_WATCHDOG``, default on).  The scheduler's ``run()`` moves
  onto a daemon dispatch thread and the CALLER thread becomes the
  watchdog: it polls the heartbeat while it waits on the run.  When no
  progress lands within the threshold it declares a wedge: the flight
  recorder's ``watchdog`` postmortem, then terminal results for every
  request the run never delivered (expired deadlines ``"deadline"``, the
  rest ``finish_reason="wedged"`` with ``error`` set, so the executor
  retries them).  The engine then runs FAIL-FAST degraded (new batches
  return wedged results at once) until the abandoned run's thread returns,
  or the supervisor (``serving/supervisor.py``) bounces the process.

* :class:`DaemonExecutor`: a single-worker executor over a DAEMON thread,
  so a wedged dispatch never pins interpreter exit.

What the card changes against the TPU (each handled where named):

* Thread-local state: the dispatch thread does not inherit the caller's
  CUDA current device, current stream or grad mode; ``_dispatch`` enters
  the engine's device and ``torch.no_grad()`` there.
* The GIL: the watching caller can fire only while the blocked dispatch
  thread has released the GIL.  The host fetch (``.cpu()``) releases it
  inside ATen, and a kernel launch blocked on a full launch queue releases
  it because ``ops/kernels.load`` opens the libraries with
  ``ctypes.CDLL`` (never ``PyDLL``, which would hold it).
* An abandoned run still on the card: fail-fast mode keeps a new run from
  launching while the abandoned thread can still launch (the split
  kernels' counter buffers assume one stream at a time).
* Exceptions: a CUDA or kernel error raised on the dispatch thread
  reaches the caller unchanged, through the run's future.

``LMRS_WATCHDOG=0`` restores inline dispatch: the scheduler runs on the
caller thread, no runner thread exists, and the heartbeat sites cost one
``None`` test each.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field

from lmrs_tpu_torch.engine.api import GenerationRequest, GenerationResult
from lmrs_tpu_torch.obs import dump_postmortem
from lmrs_tpu_torch.utils.env import env_float

logger = logging.getLogger("lmrs_torch.watchdog")

# a kernel build at first use may take minutes (one nvcc per source, ~30 s
# for all of them on the card's host; longer on a loaded one) — a one-shot
# grace window this wide keeps every legitimate build out of the wedge
# detector without a knob nobody should tune
COLD_COMPILE_GRACE_S = 3600.0


class DaemonExecutor:
    """Single-worker executor over one DAEMON thread.

    ``concurrent.futures.ThreadPoolExecutor`` workers are non-daemon:
    one wedged future pins interpreter exit forever.  This executor keeps
    the same ``submit() -> Future`` surface on a thread that can never
    hold the process hostage.  Tasks run strictly in submission order."""

    def __init__(self, thread_name: str = "lmrs-worker"):
        import queue

        self._q: queue.Queue = queue.Queue()
        # orders the shutdown flag against enqueues: without it a submit
        # racing shutdown could land its item BEHIND the stop sentinel —
        # a future that never runs and is never cancelled, which a
        # watcher would poll forever
        self._mu = threading.Lock()
        self._shutdown = False  # guarded-by: _mu
        self._thread = threading.Thread(target=self._loop,
                                        name=thread_name, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            self._run_one(*item)
            # no reference to the finished task outlives it: the loop's
            # frame would otherwise keep its callable (and through it an
            # engine's pools on the card) alive while it waits
            del item

    @staticmethod
    def _run_one(fut: Future, fn, args, kwargs) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - future carries it
            fut.set_exception(e)

    @property
    def is_shutdown(self) -> bool:
        with self._mu:
            return self._shutdown

    def submit(self, fn, *args, **kwargs) -> Future:
        fut: Future = Future()
        with self._mu:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._q.put((fut, fn, args, kwargs))
        return fut

    def shutdown(self, wait: bool = False, cancel_futures: bool = False) -> None:
        """Stop accepting work; the daemon thread drains (or dies with
        the process).  ``cancel_futures`` cancels everything still
        queued — a wedged RUNNING task is simply abandoned (daemon)."""
        with self._mu:
            self._shutdown = True
            if cancel_futures:
                import queue

                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        item[0].cancel()
            self._q.put(None)
        if wait:
            self._thread.join(timeout=5.0)


class DispatchWatchdog:
    """Monotonic heartbeat + wedge-threshold state (see module doc).

    Thread contract: ``beat``/``grace_cold``/``run_started``/
    ``run_ended`` are called by the dispatch thread; ``stalled_for`` /
    ``timeout_s`` by the watching caller thread.  All state writes are
    single plain-float/bool stores (GIL-atomic), read racily on purpose
    — a heartbeat landing mid-check just reads as progress."""

    def __init__(self):
        self.ema_step_s: float | None = None  # inter-beat EMA (warm steps)
        self._last_beat: float | None = None  # monotonic; None = no run live
        self._grace_until = 0.0  # monotonic deadline of a cold-shape grace
        # True while the CURRENT inter-beat window contained a build
        # grace — the next beat must skip the EMA fold even though
        # grace_end() already re-armed stall detection (folding a 30 s
        # build wall would inflate the auto threshold ~30x for the
        # rest of the run)
        self._window_graced = False

    # ------------------------------------------------- dispatch-thread side

    def run_started(self) -> None:
        self._grace_until = 0.0
        self._window_graced = False
        self._last_beat = time.monotonic()

    def run_ended(self) -> None:
        self._last_beat = None

    def beat(self) -> None:
        """One scheduler-loop iteration landed: progress.  Folds the
        inter-beat gap into the step-time EMA unless a build grace
        opened anywhere in the window (a build wall must not inflate the
        wedge threshold for the rest of the run — the flag, not
        ``_grace_until``, carries this: ``grace_end`` re-arms stall
        detection the moment the build lands, but the wall still
        pollutes THIS window's gap)."""
        now = time.monotonic()
        prev = self._last_beat
        if prev is not None and not self._window_graced:
            gap = now - prev
            self.ema_step_s = (gap if self.ema_step_s is None
                               else 0.8 * self.ema_step_s + 0.2 * gap)
        self._window_graced = False
        self._grace_until = 0.0
        self._last_beat = now

    def grace_cold(self) -> None:
        """A kernel build starts (``ops/kernels.load``): suspend wedge
        detection for one generous window (closed by ``grace_end`` when
        the build lands, or by the next beat)."""
        self._grace_until = time.monotonic() + COLD_COMPILE_GRACE_S
        self._window_graced = True

    def grace_end(self) -> None:
        """The build completed: re-arm the detector NOW.  Without this, a
        grace opened for a build in the same loop iteration would also
        mask a genuine stall at the next loop-top heartbeat site — the
        build is done, so the wedge clock must run again.  The silence
        is counted from here, not from the last beat: a build longer
        than the threshold would otherwise read as a wedge at the first
        poll between its end and the next beat."""
        self._grace_until = 0.0
        if self._last_beat is not None:
            self._last_beat = time.monotonic()

    # --------------------------------------------------- watcher-thread side

    def timeout_s(self) -> float:
        """The wedge threshold: ``LMRS_WATCHDOG_S`` when set (> 0), else
        scaled off the step-time EMA — generous (30x a normal step,
        floored well above any warm dispatch) because a false positive
        abandons a healthy run.  Read per call so tests can retune
        without rebuilding the engine."""
        explicit = env_float("LMRS_WATCHDOG_S", 0.0, lo=0.0)
        if explicit > 0:
            return explicit
        if self.ema_step_s is None:
            return 300.0  # no sample yet: only a gross hang trips
        return min(max(30.0 * self.ema_step_s, 60.0), 900.0)

    def stalled_for(self) -> float:
        """Seconds since the last heartbeat, 0.0 when no run is live or
        a build grace window is open."""
        last = self._last_beat
        if last is None or time.monotonic() < self._grace_until:
            return 0.0
        return time.monotonic() - last


def _shutdown_boxed(box: list) -> None:
    box[0].shutdown(wait=False, cancel_futures=True)


@dataclass
class _RunCtx:
    """Per-run bookkeeping the wedge sweep synthesizes results from.
    Mutated only by the dispatch thread (callback wrappers) until
    ``abandoned`` flips — after which the wrappers are no-ops and the
    watcher thread owns the snapshot."""

    known: list[GenerationRequest]
    results: dict[int, GenerationResult] = field(default_factory=dict)
    streamed: dict[int, str] = field(default_factory=dict)
    abandoned: bool = False


class WatchdogRunner:
    """Run ``scheduler.run()`` on a daemon dispatch thread, watched from
    the caller thread (see module doc).  One runner per scheduler; runs
    are serialized on its one dispatch thread."""

    def __init__(self, scheduler):
        self.sched = scheduler
        self._pool = DaemonExecutor(thread_name="lmrs-dispatch")
        # a dropped engine stops its dispatch thread (the box follows a
        # pool re-created after shutdown)
        self._pool_box = [self._pool]
        weakref.finalize(self, _shutdown_boxed, self._pool_box)
        self._lock = threading.Lock()
        self._stuck: Future | None = None  # guarded-by: _lock
        self._stuck_since = 0.0            # guarded-by: _lock

    # ---------------------------------------------------------------- state

    @property
    def wedged(self) -> bool:
        """True while a wedged run still holds the dispatch thread (the
        engine's fail-fast degraded state)."""
        with self._lock:
            return self._stuck is not None and not self._stuck.done()

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until any abandoned run finishes and clear the degraded
        state (tests; the serving layer recovers lazily at the next
        batch).  Returns True when the dispatch thread is idle."""
        with self._lock:
            fut = self._stuck
        if fut is None:
            return True
        try:
            fut.result(timeout=timeout_s)
        except Exception:  # noqa: BLE001 - the run's own failure is logged
            pass
        with self._lock:
            if self._stuck is fut and fut.done():
                self._clear_stuck_locked(fut)
        return fut.done()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _clear_stuck_locked(self, fut: Future) -> None:  # holds-lock: _lock
        """Caller holds self._lock."""
        exc = fut.exception() if fut.done() else None
        if exc is not None:
            # the abandoned run died; the scheduler's except path already
            # ran pool recovery, so the engine is usable again
            logger.warning("abandoned wedged run finished with %s: %s",
                           type(exc).__name__, exc)
        else:
            logger.info("wedged dispatch recovered after %.1fs; engine "
                        "re-armed", time.monotonic() - self._stuck_since)
        self._stuck = None

    # ------------------------------------------------------------------ run

    def run(self, requests: list[GenerationRequest],
            on_result=None, on_tokens=None) -> list[GenerationResult]:
        stuck_for: float | None = None
        with self._lock:
            fut = self._stuck
            if fut is not None:
                if fut.done():
                    self._clear_stuck_locked(fut)
                else:
                    stuck_for = time.monotonic() - self._stuck_since
        if stuck_for is not None:
            # fail-fast degraded: nothing queues behind a dead dispatch —
            # the caller's retry/routing layers place the work elsewhere
            # (or the supervisor bounces us).  Delivery runs OUTSIDE the
            # lock: on_result callbacks are arbitrary caller code and may
            # themselves read wedged()/wait_idle() (the non-reentrant
            # lock would deadlock), same discipline as the wedge sweep.
            return self._deliver_synthesized(
                _RunCtx(list(requests)), on_result,
                err=f"engine wedged: dispatch thread stuck for "
                    f"{stuck_for:.1f}s")
        ctx = _RunCtx(list(requests))
        with self._lock:
            if self._pool.is_shutdown:
                # an engine shut down and then reused (a pipeline's
                # shutdown reaches an engine its caller still holds)
                # starts a fresh dispatch thread
                self._pool = DaemonExecutor(thread_name="lmrs-dispatch")
                self._pool_box[0] = self._pool
            pool = self._pool
        run_fut = pool.submit(
            self._dispatch, requests,
            on_result=self._wrap_on_result(ctx, on_result),
            on_tokens=self._wrap_on_tokens(ctx, on_tokens))
        wd = self.sched.watchdog
        while True:
            try:
                # the caller thread IS the watchdog while it waits: poll
                # granularity adapts to the threshold (cache-cheap; the
                # run future wakes it immediately on completion)
                return run_fut.result(
                    timeout=max(0.05, min(wd.timeout_s() / 4.0, 2.0)))
            except FutureTimeout:
                stalled = wd.stalled_for()
                timeout = wd.timeout_s()
                if stalled <= timeout:
                    continue
                return self._declare_wedge(ctx, run_fut, on_result,
                                           stalled, timeout)

    def _dispatch(self, requests, on_result, on_tokens):
        """``scheduler.run`` on the dispatch thread, under the caller's
        thread-local state the card needs: a new thread starts on CUDA
        device 0, on that device's default stream and with grad mode on,
        so an engine on ``cuda:N`` would issue into the wrong device's
        context and trained leaf tensors would record autograd graphs.
        The engine's device is entered (its default stream is the one the
        scheduler's kernels and fetches use) and grad mode is off."""
        import contextlib

        import torch

        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            # the pool's device names the card by index ("cuda" alone
            # would mean this thread's current device, card 0)
            device = self.sched.cache.k.device
            if device.type == "cuda":
                stack.enter_context(torch.cuda.device(device))
            return self.sched.run(requests, on_result=on_result,
                                  on_tokens=on_tokens)

    # ------------------------------------------------------------ callbacks

    def _wrap_on_result(self, ctx: _RunCtx, user_cb):
        """Track delivery + submissions; mute everything once abandoned
        (a resumed wedged run must not double-deliver into the caller's
        queues).  Returning None keeps the scheduler's no-callback fast
        path when the caller passed none — except that delivery tracking
        still matters for the wedge sweep, so a tracker is always
        installed."""
        def wrapped(res: GenerationResult, submit) -> None:
            if ctx.abandoned:
                return
            ctx.results[res.request_id] = res
            if user_cb is not None:
                def tracked_submit(more: list[GenerationRequest]) -> None:
                    ctx.known.extend(more)
                    submit(more)

                user_cb(res, tracked_submit)

        return wrapped

    def _wrap_on_tokens(self, ctx: _RunCtx, user_cb):
        """Delta tracker (the wedge sweep's partial-text source) — but
        ONLY when the caller actually streams: installing a callback on
        non-streaming runs would force the scheduler's per-block
        frontier-trimming path and hold a second copy of every
        completion for pure overhead.  Non-streaming wedged results
        carry text="" — their callers retry on the marked error anyway."""
        if user_cb is None:
            return None

        def wrapped(rid: int, delta: str) -> None:
            if ctx.abandoned:
                return
            ctx.streamed[rid] = ctx.streamed.get(rid, "") + delta
            user_cb(rid, delta)

        return wrapped

    # ---------------------------------------------------------- wedge sweep

    def _declare_wedge(self, ctx: _RunCtx, run_fut: Future, on_result,
                       stalled: float, timeout: float
                       ) -> list[GenerationResult]:
        """No heartbeat within the threshold: abandon the run, freeze the
        evidence, and terminate every undelivered request (see module
        doc).  The abandoned thread keeps the stuck device call; if it
        ever returns, the run's own finally/except restores the pool and
        the degraded state clears at the next batch."""
        ctx.abandoned = True  # flipped BEFORE any delivery: the stuck
        # thread may resume mid-sweep and must find its callbacks muted
        with self._lock:
            self._stuck = run_fut
            self._stuck_since = time.monotonic()
        # cancel everything the abandoned run still holds: if the stall
        # is transient, its first post-stall loop iteration sweeps the
        # cancels and the run drains in ~one block instead of recomputing
        # the whole abandoned workload to muted callbacks — the engine
        # re-arms while the caller's retry budget is still alive (the
        # end-to-end wedge drive caught a degraded engine outliving
        # 3 x retry_delay without this)
        for r in ctx.known:
            self.sched.cancel(r.request_id)
        self.sched._c_watchdog_fires.inc()
        undelivered = [r for r in ctx.known
                       if r.request_id not in ctx.results]
        logger.error("dispatch wedge: no scheduler heartbeat for %.1fs "
                     "(threshold %.1fs); abandoning the run, %d request(s) "
                     "terminate wedged/deadline", stalled, timeout,
                     len(undelivered))
        # postmortem FIRST, before synthesis mutates counters: the dump
        # must show the metrics as the wedge left them (the same ordering
        # rule as the dispatch-fault recovery path).  No-op unless
        # LMRS_POSTMORTEM_DIR is armed; never raises.
        dump_postmortem(
            "watchdog", metrics=self.sched.counters,
            extra={"stalled_s": round(stalled, 3),
                   "timeout_s": round(timeout, 3),
                   "undelivered": len(undelivered),
                   "step_ema_s": self.sched.watchdog.ema_step_s})
        return self._deliver_synthesized(
            ctx, on_result,
            err=f"engine dispatch wedged: no progress for {stalled:.1f}s")

    def _deliver_synthesized(self, ctx: _RunCtx, on_result,
                             err: str) -> list[GenerationResult]:
        """Terminal results for every request the run never delivered:
        ``"deadline"`` for expired budgets (no error — the contractual
        outcome the caller asked for; the executor must not retry it),
        ``"wedged"`` + error for the rest (the executor retries those
        once a healthy engine can take them).  Partial streamed text is
        kept — it is real output a streaming client may already hold
        (the cancel/expiry contract, scheduler.cancel docstring)."""
        now = time.time()
        out: list[GenerationResult] = []
        for req in ctx.known:
            rid = req.request_id
            res = ctx.results.get(rid)
            if res is None:
                text = ctx.streamed.get(rid, "")
                expired = req.deadline_s is not None and req.deadline_s <= now
                if expired:
                    res = GenerationResult(
                        request_id=rid, text=text,
                        finish_reason="deadline")
                    self.sched._c_deadline.inc()
                else:
                    res = GenerationResult(
                        request_id=rid, text=text,
                        finish_reason="wedged", error=err)
                    self.sched._c_wedged.inc()
                # the wedge bill still lands in the cost ledger (and the
                # SLO outcome stream): a wedged request is exactly the
                # kind of waste per-tenant accounting must show
                self.sched.cost_finish(req, res)
                if on_result is not None:
                    on_result(res, self._dead_submit)
            out.append(res)
        return out

    @staticmethod
    def _dead_submit(more: list[GenerationRequest]) -> None:
        logger.warning("submit() ignored on a wedged run: %d request(s) "
                       "dropped (the caller's retry owns them)", len(more))
