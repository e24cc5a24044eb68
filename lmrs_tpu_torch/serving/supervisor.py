"""Supervised restart (``lmrs-serve-torch --supervise``; a copy of the
reference's ``serving/supervisor.py``).

The watchdog (``engine/watchdog.py``) turns a wedged dispatch into bounded
results and a degraded fail-fast engine, but a process whose dispatch
thread is stuck on a hung card is fixed only by a restart.  This module
makes the restart a code path:

* the engine runs in a CHILD process (the same ``lmrs-serve-torch`` argv,
  minus ``--supervise``); the parent owns only the child's lifecycle;
* the parent polls ``GET /healthz``: the server answers 503 with
  ``"wedged": true`` while its engine is watchdog-degraded, so a wedge is
  visible from outside the process;
* a wedged child is SIGKILLed at once; an unreachable one after
  ``LMRS_SUPERVISE_FAILS`` consecutive failed polls (polls before its
  first healthy answer count only past the start-up grace); a child that
  dies on its own is respawned, with a backoff that doubles while children
  never become healthy;
* each respawn re-runs the server's start-up recovery: the jobs journal
  and the live-session journals resume interrupted work, and the
  supervisor keeps no state of its own.

Knobs: ``LMRS_SUPERVISE_POLL_S`` (poll cadence), ``LMRS_SUPERVISE_FAILS``
(failed polls before the kill), ``LMRS_SUPERVISE_BACKOFF_S`` (respawn
backoff), ``LMRS_SUPERVISE_PIDFILE`` (the live child's pid, rewritten at
each spawn).  SIGTERM and SIGINT are forwarded to the child and end the
loop.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

from lmrs_tpu_torch.utils.env import env_float, env_int, env_str

logger = logging.getLogger("lmrs_torch.supervisor")

# a cold start legitimately takes a while (weights drawn or loaded onto
# the card, kernel builds, journal recovery): unreachable polls before the
# FIRST healthy answer never count against the kill threshold inside this
# window
STARTUP_GRACE_S = 300.0


class Supervisor:
    """Spawn-and-watch loop around one ``lmrs-serve-torch`` child process."""

    def __init__(self, child_argv: list[str], host: str = "127.0.0.1",
                 port: int = 8000):
        self.child_argv = list(child_argv)
        self.host = host if host not in ("0.0.0.0", "::") else "127.0.0.1"
        self.port = port
        self.poll_s = env_float("LMRS_SUPERVISE_POLL_S", 2.0, lo=0.1)
        self.fail_threshold = env_int("LMRS_SUPERVISE_FAILS", 3, lo=1)
        self.backoff_s = env_float("LMRS_SUPERVISE_BACKOFF_S", 0.5, lo=0.0)
        self.pidfile = env_str("LMRS_SUPERVISE_PIDFILE")
        self.restarts = 0
        self.child: subprocess.Popen | None = None
        self._stop = False

    # ------------------------------------------------------------- lifecycle

    def _spawn(self) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "lmrs_tpu_torch.serving.cli",
               *self.child_argv]
        child = subprocess.Popen(cmd)
        logger.info("supervisor: child pid %d spawned (restart #%d)",
                    child.pid, self.restarts)
        if self.pidfile:
            try:
                with open(self.pidfile, "w", encoding="utf-8") as fh:
                    fh.write(str(child.pid))
            except OSError:
                logger.warning("supervisor: pidfile %s not writable",
                               self.pidfile, exc_info=True)
        return child

    def _kill(self, child: subprocess.Popen, why: str) -> None:
        logger.error("supervisor: SIGKILL child pid %d (%s)",
                     child.pid, why)
        try:
            child.kill()
        except OSError:
            pass
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            logger.error("supervisor: child pid %d did not reap", child.pid)

    def _poll_health(self) -> tuple[bool, bool]:
        """(healthy, wedged) from one /healthz poll.  A 503 whose body
        carries ``"wedged": true`` is the watchdog-degraded signature;
        anything else non-200 (or unreachable) is a plain failed poll."""
        url = f"http://{self.host}:{self.port}/healthz"
        try:
            with urllib.request.urlopen(
                    url, timeout=max(1.0, min(self.poll_s, 5.0))) as resp:
                return resp.status == 200, False
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read() or b"{}")
            except ValueError:
                doc = {}
            return False, bool(doc.get("wedged"))
        except OSError:
            return False, False

    def _watch(self, child: subprocess.Popen) -> tuple[str, bool]:
        """Block until the child needs replacing; returns (why, the
        child ever answered a healthy poll) — the health bit drives the
        crash-loop backoff in run()."""
        fails = 0
        seen_healthy = False
        started = time.monotonic()
        while not self._stop:
            time.sleep(self.poll_s)
            rc = child.poll()
            if rc is not None:
                return f"child exited rc={rc}", seen_healthy
            healthy, wedged = self._poll_health()
            if healthy:
                fails, seen_healthy = 0, True
                continue
            if wedged:
                # the engine itself declared the wedge (watchdog): no
                # point waiting out the threshold — the dispatch thread
                # is stuck and only a bounce frees the device
                self._kill(child, "engine wedged (watchdog-degraded)")
                return "wedged", seen_healthy
            if not seen_healthy and time.monotonic() - started \
                    < STARTUP_GRACE_S:
                continue  # still starting up: don't count the poll
            fails += 1
            if fails >= self.fail_threshold:
                self._kill(child, f"{fails} consecutive failed health "
                                  "polls")
                return "unreachable", seen_healthy
        return "stopped", seen_healthy

    def run(self) -> int:
        """Supervise until terminated.  SIGTERM/SIGINT forward to the
        child (graceful stop) and end the loop; returns the last child's
        exit code."""
        def _forward(signum, _frame):
            self._stop = True
            child = self.child
            if child is not None and child.poll() is None:
                try:
                    child.terminate()
                except OSError:
                    pass

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _forward)
            except ValueError:
                pass  # not the main thread (tests drive run() directly)
        rc = 0
        # crash-loop containment: a child that dies without EVER becoming
        # healthy (bad flags, broken checkpoint) doubles the backoff up
        # to a cap instead of respawning ~2x/second forever; one healthy
        # child resets it.  Respawns themselves stay unbounded — a
        # supervisor that gives up is just a slower crash.
        backoff = max(self.backoff_s, 0.1)
        while not self._stop:
            self.child = self._spawn()
            why, was_healthy = self._watch(self.child)
            rc = self.child.poll()
            if self._stop:
                break
            self.restarts += 1
            if was_healthy:
                backoff = max(self.backoff_s, 0.1)
            else:
                backoff = min(backoff * 2, 30.0)
                logger.error("supervisor: child never became healthy; "
                             "backoff now %.1fs", backoff)
            logger.warning("supervisor: respawning after %s (restart #%d)",
                           why, self.restarts)
            time.sleep(backoff)
        child = self.child
        if child is not None and child.poll() is None:
            try:
                child.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self._kill(child, "graceful stop timed out")
        if self.pidfile:
            try:
                os.unlink(self.pidfile)
            except OSError:
                pass
        # a graceful stop (SIGTERM/SIGINT forwarded to the child) is a
        # clean exit for the SUPERVISOR even though the child reports the
        # signal; a supervisor ending any other way surfaces the child rc
        if self._stop or not isinstance(rc, int) or rc < 0:
            return 0
        return rc
