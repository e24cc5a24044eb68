"""``lmrs-lint-torch`` (``lmrs_tpu_torch/analysis/``) against the JAX
package's ``lmrs-lint``: every race, env and drift fixture of
``tests/test_analysis.py``, rewritten with the port's paths and catalogs,
gives the same findings through both packages' ``run_passes`` (rule, line
and message, apart from the path prefix).  Then the port's own cases: the
literal ``site=`` keyword, the eager-step ``tracing`` rules, the golden
output, the baseline file, and the checked-in tree linting clean."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from lmrs_tpu.analysis import Module as JModule
from lmrs_tpu.analysis import RepoContext as JContext
from lmrs_tpu.analysis import run_passes as j_run_passes

from lmrs_tpu_torch.analysis import (Baseline, Module, RepoContext,
                                     run_passes, run_repo)
from lmrs_tpu_torch.analysis import drift, locks, tracing

REPO = Path(__file__).resolve().parents[1]
DOCS = ("ROBUSTNESS.md", "OBSERVABILITY.md", "KNOBS.md")


def port_ctx(sources: dict[str, str], docs: dict[str, str] | None = None
             ) -> RepoContext:
    """Port paths; the three catalogs empty unless given."""
    mods = [Module.from_source(p, s) for p, s in sources.items()]
    full = {f"docs/torch/{d}": "" for d in DOCS}
    full.update({f"docs/torch/{k}": v for k, v in (docs or {}).items()})
    return RepoContext(root=REPO, modules=mods, docs=full)


def both(sources: dict[str, str], docs: dict[str, str], family: str):
    """The same fixture through both packages: ``sources`` and ``docs``
    keyed by paths under the package and under docs/.  Findings as (rule,
    path, line, message), the port's path prefix folded to the
    reference's."""
    jctx = JContext(
        root=REPO,
        modules=[JModule.from_source(f"lmrs_tpu/{p}", s)
                 for p, s in sources.items()],
        docs={**{f"docs/{d}": "" for d in DOCS},
              **{f"docs/{k}": v for k, v in docs.items()}})
    tctx = port_ctx({f"lmrs_tpu_torch/{p}":
                     s.replace("lmrs_tpu.", "lmrs_tpu_torch.")
                     for p, s in sources.items()}, docs)

    def fold(text: str) -> str:
        return text.replace("lmrs_tpu_torch/", "lmrs_tpu/").replace(
            "docs/torch/", "docs/")

    want = [(f.rule, f.path, f.line, f.message)
            for f in j_run_passes(jctx, (family,))]
    got = [(f.rule, fold(f.path), f.line, fold(f.message))
           for f in run_passes(tctx, (family,))]
    return want, got


# ----------------------------------------------------------- race fixtures

RACE_POSITIVE = '''
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._pinned = {}  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock

    def bad_write(self, k, v):
        self._pinned[k] = v          # write without the lock

    def bad_increment(self):
        self.count += 1              # lost-update RMW

    def bad_mutator(self, k):
        self._pinned.pop(k, None)    # mutator call without the lock
'''

RACE = {
    "positive": (RACE_POSITIVE, ["race.unguarded-write"] * 3),
    "negative": ('''
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._pinned = {}  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock

    def good_write(self, k, v):
        with self._lock:
            self._pinned[k] = v
            self.count += 1

    def reads_are_fine(self):
        return dict(self._pinned)

    def _helper(self, k):  # holds-lock: _lock
        self._pinned.pop(k, None)
''', []),
    "comment-above": ('''
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._deferred = []

    def bad(self, item):
        self._deferred.append(item)
''', ["race.unguarded-write"]),
    "module-global": ('''
import threading

_lock = threading.Lock()
_last = {}  # guarded-by: _lock

def bad(reason, t):
    _last[reason] = t

def good(reason, t):
    with _lock:
        _last[reason] = t
''', ["race.unguarded-write"]),
    "order-cycle": ('''
import threading

class C:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._b:
            with self._a:
                pass
''', ["race.lock-order-cycle"]),
    "order-consistent": ('''
import threading

class C:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._a:
            with self._b:
                pass
''', []),
    "cycle-via-call": ('''
import threading

class C:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def outer(self):
        with self._a:
            self.inner()

    def inner(self):
        with self._b:
            pass

    def other(self):
        with self._b:
            with self._a:
                pass
''', ["race.lock-order-cycle"]),
    "blocking": ('''
import os
import time
import threading

class J:
    def __init__(self):
        self._lock = threading.Lock()

    def bad(self, fh):
        with self._lock:
            time.sleep(0.1)
            os.fsync(fh.fileno())

    def good(self, fh):
        with self._lock:
            data = fh.name
        time.sleep(0.1)
        return data
''', ["race.blocking-under-lock"] * 2),
    "suppressed": ('''
import os
import threading

class J:
    def __init__(self):
        self._lock = threading.Lock()

    def append(self, fh):
        with self._lock:
            os.fsync(fh.fileno())  # lint: ignore[race.blocking-under-lock]
''', []),
}


@pytest.mark.parametrize("name", sorted(RACE))
def test_race_fixture_matches_the_reference(name):
    src, rules = RACE[name]
    want, got = both({"x.py": src}, {}, "race")
    assert got == want
    assert sorted(f[0] for f in got) == sorted(rules)


# ---------------------------------------------------------- drift fixtures

DRIFT = {
    "fault-sites": ({"x.py": '''
from lmrs_tpu.testing import faults

def step():
    faults.fire("kv.allocate")
    faults.fire("scheduler.newsite")
'''}, {"ROBUSTNESS.md": """
| site | fires as | exercises |
|---|---|---|
| `kv.allocate` | OutOfPages | back-pressure |
| `ghost.site` | nothing | stale row |
"""}, {"drift.fault-site-undocumented", "drift.fault-site-stale"}),
    "metrics": ({"x.py": '''
class S:
    def __init__(self, registry):
        c, g, h = (registry.counter, registry.gauge, registry.histogram)
        self._c = c("lmrs_widgets_total", "widgets")
        self._g = registry.gauge("lmrs_live_widgets", "live")
'''}, {"OBSERVABILITY.md": """
### Catalog

| metric | type |
|---|---|
| `lmrs_widgets_total` | counter |
| `lmrs_gone_metric` | counter |
"""}, {"drift.metric-undocumented", "drift.metric-stale"}),
    "suffix-shorthand": ({}, {"OBSERVABILITY.md":
                              "| `lmrs_widgets_total` / `_live` | counter |\n"},
                         {"drift.metric-suffix-shorthand",
                          "drift.metric-stale"}),
    "trace-instant-args": ({"x.py": '''
def emit(tr, pages, kv_len):
    tr.instant("handoff_export", args={"pages": pages})
    tr.instant("handoff_import", args={"pages": pages, "kv_len": kv_len})
    tr.instant("job_done")
'''}, {}, {"drift.trace-instant-args"}),
}


@pytest.mark.parametrize("name", sorted(DRIFT))
def test_drift_fixture_matches_the_reference(name):
    sources, docs, rules = DRIFT[name]
    want, got = both(sources, docs, "drift")
    assert got == want
    assert {f[0] for f in got} == rules


# ------------------------------------------------------------ env fixtures

ENV_SRC = '''
import os
from lmrs_tpu.utils.env import env_int

BAD = os.environ.get("LMRS_BAD_KNOB", "1")
GOOD = env_int("LMRS_GOOD_KNOB", 4)
'''
ENV_DOC = "| `LMRS_GOOD_KNOB` | 4 | a knob |\n| `LMRS_GONE` | - | stale |\n"


def test_env_fixture_matches_the_reference():
    want, got = both({"x.py": ENV_SRC}, {"KNOBS.md": ENV_DOC}, "env")
    assert got == want
    assert [f[0] for f in got] == ["env.knob-stale", "env.direct-read",
                                   "env.knob-undocumented"]


def test_env_module_itself_is_exempt_in_both():
    for pkg, ctx_cls, mod_cls, run in (
            ("lmrs_tpu", JContext, JModule, j_run_passes),
            ("lmrs_tpu_torch", RepoContext, Module, run_passes)):
        path = f"{pkg}/utils/env.py"
        real = (REPO / path).read_text(encoding="utf-8")
        ctx = ctx_cls(root=REPO, modules=[mod_cls.from_source(path, real)],
                      docs={"docs/KNOBS.md": "", "docs/torch/KNOBS.md": ""})
        assert [f for f in run(ctx, ("env",))
                if f.rule == "env.direct-read"] == [], pkg


# --------------------------------------------------------- the port's own

def test_site_keyword_is_a_fault_site():
    """The port names a site once and hands it to the helper that fires
    it (``serving/server.py``'s ``_fetch_blob(..., site="handoff.
    transfer")``): the literal keyword counts as the site."""
    src = '''
from lmrs_tpu_torch.testing import faults

def fetch(site=None):
    if site:
        faults.fire(site, OSError)

def caller():
    fetch(site="handoff.transfer")
    fetch(site="handoff.ack")
    fetch(site=None)
'''
    doc = "| `handoff.transfer` | OSError | x |\n| `ghost.site` | - | y |\n"
    findings = drift.run(port_ctx({"lmrs_tpu_torch/x.py": src},
                                  {"ROBUSTNESS.md": doc}))
    got = sorted((f.rule, f.message.split("'")[1]) for f in findings)
    assert got == [("drift.fault-site-stale", "ghost.site"),
                   ("drift.fault-site-undocumented", "handoff.ack")]


TRACING_POSITIVE = '''
import numpy as np
import torch

def step(x: torch.Tensor, lens, n: int):
    y = torch.softmax(x, -1)
    if y.sum() > 0:              # branch on a device value
        y = y * 2
    while lens.max() > n:        # a parameter without a host type
        lens = lens - 1
    host = y.tolist()            # host sync
    v = float(y[0])              # host sync
    torch.cuda.synchronize()     # host sync
    return host, v, y.cpu().numpy()
'''

TRACING_NEGATIVE = '''
import torch

def step(x: torch.Tensor, mask=None, causal: bool = True, block=64,
         dev: torch.device = None):
    b, s = x.shape
    if mask is None:               # is-None test: static
        mask = torch.ones(b, s, device=x.device)
    if x.shape[0] > 8 and x.dtype == torch.bfloat16:   # metadata: static
        x = x[:8]
    if causal and block > 32 and x.device == dev:      # host parameters
        x = x * 2
    if any(t.shape != (b, s) for t in (x, mask)):      # shape check
        raise ValueError("shape")
    if x.stride(-1) != 1 or x.data_ptr() % 16 or len(x) > 4:
        raise ValueError("layout")
    for name, t in {"x": x}.items():
        if name == "x" and isinstance(t, torch.Tensor):
            pass
    return x * mask
'''


def test_tracing_rules_on_eager_step_code():
    findings = tracing.run(port_ctx({
        "lmrs_tpu_torch/ops/x.py": TRACING_POSITIVE}))
    got = sorted((f.rule, f.line) for f in findings)
    assert got == [("tracing.host-sync-in-step", 11),
                   ("tracing.host-sync-in-step", 12),
                   ("tracing.host-sync-in-step", 13),
                   ("tracing.host-sync-in-step", 14),
                   ("tracing.python-branch-on-tensor", 7),
                   ("tracing.python-branch-on-tensor", 9)]
    assert all("`step`" in f.message for f in findings)


def test_tracing_static_uses_are_not_flagged():
    assert tracing.run(port_ctx({
        "lmrs_tpu_torch/models/x.py": TRACING_NEGATIVE})) == []


def test_tracing_scope_and_inline_suppression():
    """Step rules run on models/ and ops/ only; a plain version's host
    loop carries its reason inline."""
    outside = tracing.run(port_ctx({
        "lmrs_tpu_torch/serving/x.py": TRACING_POSITIVE}))
    assert outside == []
    src = '''
import torch

def ref(lens: torch.Tensor):
    # the plain version walks its rows on the host
    return lens.tolist()  # lint: ignore[tracing.host-sync-in-step]
'''
    ctx = port_ctx({"lmrs_tpu_torch/ops/x.py": src})
    assert len(tracing.run(ctx)) == 1
    assert run_passes(ctx, ("tracing",)) == []


def test_tracing_nested_function_closes_over_device_values():
    src = '''
import torch

def outer(x: torch.Tensor):
    def inner(k: int):
        if x[k] > 0:
            return x.item()
        return k
    return inner
'''
    got = sorted(f.rule for f in tracing.run(port_ctx({
        "lmrs_tpu_torch/ops/x.py": src})))
    assert got == ["tracing.host-sync-in-step",
                   "tracing.python-branch-on-tensor"]


def test_deprecated_api_table_and_forbidden_imports():
    src = '''
import jax
import jax.numpy as jnp
from lmrs_tpu.engine import kv_cache
from lmrs_tpu_torch.engine import kv_cache as ok
import torch
from torch.cuda.amp import GradScaler

def f(x):
    with torch.cuda.amp.autocast():
        torch.testing.assert_allclose(x, x)
    return torch.backends.cuda.sdp_kernel()
'''
    findings = tracing.run(port_ctx({"chip_smoke.py": src}))
    assert all(f.rule == "tracing.deprecated-api" for f in findings)
    got = sorted((f.line, f.message) for f in findings)
    assert got == [
        (2, "the port imports `jax`"),
        (3, "the port imports `jax.numpy`"),
        (4, "the port imports `lmrs_tpu.engine`"),
        (7, "deprecated torch API `torch.cuda.amp`"),
        (10, "deprecated torch API `torch.cuda.amp`"),
        (11, "deprecated torch API `torch.testing.assert_allclose`"),
        (12, "deprecated torch API `torch.backends.cuda.sdp_kernel`")]


def test_golden_finding_output():
    findings = locks.run(port_ctx({"lmrs_tpu_torch/x.py": RACE_POSITIVE}))
    got = "\n".join(f.render() for f in findings)
    want = """\
lmrs_tpu_torch/x.py:11: [race.unguarded-write] assignment to Pool._pinned outside `with _lock:`
    hint: guarded-by declared at line 7; hold _lock for the write, or mark the enclosing function `# holds-lock: _lock` if every caller already holds it
lmrs_tpu_torch/x.py:14: [race.unguarded-write] read-modify-write (+=) to Pool.count outside `with _lock:`
    hint: guarded-by declared at line 8; hold _lock for the write, or mark the enclosing function `# holds-lock: _lock` if every caller already holds it
lmrs_tpu_torch/x.py:17: [race.unguarded-write] .pop() mutation to Pool._pinned outside `with _lock:`
    hint: guarded-by declared at line 7; hold _lock for the write, or mark the enclosing function `# holds-lock: _lock` if every caller already holds it"""
    assert got == want


def test_baseline_accepts_counts_and_expires(tmp_path):
    findings = locks.run(port_ctx({"lmrs_tpu_torch/x.py": RACE_POSITIVE}))
    path = tmp_path / "baseline.json"
    Baseline.from_findings(findings).save(path)
    new, accepted, expired = Baseline.load(path).apply(findings)
    assert (len(new), len(accepted), expired) == (0, 3, [])
    new, accepted, expired = Baseline.load(path).apply(findings[:2])
    assert (len(new), len(accepted), len(expired)) == (0, 2, 1)
    new, accepted, _ = Baseline.load(path).apply(findings + [findings[0]])
    assert len(new) == 1 and len(accepted) == 3
    assert json.loads(path.read_text())["schema"] == "lmrs-lint-baseline-v1"
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "nope", "findings": {}}')
    with pytest.raises(ValueError):
        Baseline.load(bad)


def test_baseline_keys_survive_line_shifts():
    f1 = locks.run(port_ctx({"lmrs_tpu_torch/x.py": RACE_POSITIVE}))
    f2 = locks.run(port_ctx({"lmrs_tpu_torch/x.py": "\n\n\n" + RACE_POSITIVE}))
    assert [f.key for f in f1] and [f.key for f in f1] == [f.key for f in f2]
    assert [f.line for f in f1] != [f.line for f in f2]


def test_cli_refuses_subset_baseline_and_root_without_the_port(tmp_path,
                                                               capsys):
    from lmrs_tpu_torch.analysis.cli import main

    assert main(["--family", "race", "--write-baseline", str(REPO)]) == 2
    assert main([str(tmp_path)]) == 2
    assert "no lmrs_tpu_torch/" in capsys.readouterr().err
    Baseline.load(REPO / "lint-baseline-torch.json")


def test_port_is_lint_clean_against_checked_in_baseline():
    """The tree as committed has no finding, and the checked-in
    ``lint-baseline-torch.json`` accepts none."""
    doc = json.loads((REPO / "lint-baseline-torch.json").read_text())
    assert doc == {"schema": "lmrs-lint-baseline-v1", "findings": {}}
    new, accepted, expired = run_repo(REPO)
    assert new == [], "\n" + "\n".join(f.render() for f in new)
    assert (accepted, expired) == ([], [])
