"""Code-vs-docs contract drift checkers (family ``drift``), the reference's
``analysis/drift.py`` over the port's tree and the port's own catalogs.

Serving contracts live half in code, half in documentation consumers
read: the fault-site table in docs/torch/ROBUSTNESS.md, the metric
catalog in docs/torch/OBSERVABILITY.md, and the trace-instant arg
contract in ``obs.trace.validate_trace_events``.  These checks make the
drift a CI failure:

* ``drift.fault-site-undocumented`` / ``drift.fault-site-stale`` —
  sites named by a literal first argument of ``faults.fire`` /
  ``faults.check``, or by a literal ``site=`` keyword (the port names a
  site once and hands it to a helper that fires it), vs the
  ROBUSTNESS.md site table;
* ``drift.metric-undocumented`` / ``drift.metric-stale`` — registered
  ``lmrs_*`` counter/gauge/histogram names vs the OBSERVABILITY.md
  catalog table (rows must spell FULL metric names — suffix shorthand
  like ``_hits_total`` is itself flagged);
* ``drift.trace-instant-args`` — every ``tracer.instant("name", ...)``
  emit site whose name carries a contract in
  ``_INSTANT_REQUIRED_ARGS`` must pass the required keys in a literal
  ``args={...}`` dict (the stitcher's skew anchors and the postmortem
  reader parse them).
"""

from __future__ import annotations

import ast
import re

from lmrs_tpu_torch.analysis.core import Finding, RepoContext

ROBUSTNESS_DOC = "docs/torch/ROBUSTNESS.md"
OBSERVABILITY_DOC = "docs/torch/OBSERVABILITY.md"

_SITE_RE = re.compile(r"^[a-z_]+\.[a-z_.]+$")
_METRIC_RE = re.compile(r"^lmrs_[a-z0-9_]+$")
_TABLE_CELL_TOKENS = re.compile(r"`([^`]+)`")


def _table_tokens(doc_text: str, pattern: re.Pattern) -> dict[str, int]:
    """Backticked tokens matching ``pattern`` inside markdown TABLE rows,
    token -> first line number (1-based)."""
    out: dict[str, int] = {}
    for i, line in enumerate(doc_text.splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        for tok in _TABLE_CELL_TOKENS.findall(line):
            tok = tok.strip()
            if pattern.match(tok):
                out.setdefault(tok, i)
    return out


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


# ------------------------------------------------------------- fault sites

def _code_fault_sites(ctx: RepoContext) -> dict[str, tuple[str, int]]:
    sites: dict[str, tuple[str, int]] = {}
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name.endswith(("faults.fire", "faults.check")) and \
                    node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                sites.setdefault(node.args[0].value,
                                 (mod.path, node.lineno))
            for kw in node.keywords:
                if kw.arg == "site" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str) \
                        and _SITE_RE.match(kw.value.value):
                    sites.setdefault(kw.value.value, (mod.path, node.lineno))
    return sites


def _check_fault_sites(ctx: RepoContext, findings: list[Finding]) -> None:
    code = _code_fault_sites(ctx)
    doc_text = ctx.doc(ROBUSTNESS_DOC)
    doc = _table_tokens(doc_text, _SITE_RE)
    for site, (path, line) in sorted(code.items()):
        if site not in doc:
            findings.append(Finding(
                rule="drift.fault-site-undocumented", path=path, line=line,
                message=f"fault site {site!r} has no row in the "
                        f"{ROBUSTNESS_DOC} site table",
                hint="add a `| `site` | fires as | exercises |` row — "
                     "chaos plans are written against that table"))
    for site, line in sorted(doc.items()):
        if site not in code:
            findings.append(Finding(
                rule="drift.fault-site-stale", path=ROBUSTNESS_DOC,
                line=line,
                message=f"documented fault site {site!r} no longer exists "
                        "in code",
                hint="delete the stale row (or restore the site)"))


# ----------------------------------------------------------------- metrics

_REGISTER_METHODS = frozenset(("counter", "gauge", "histogram"))


def _register_aliases(mod_tree: ast.Module) -> set[str]:
    """Local names bound to registry register methods — the repo's
    ``c, g, h = (reg.counter, reg.gauge, reg.histogram)`` idiom."""
    aliases: set[str] = set()
    for node in ast.walk(mod_tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs: list[tuple[ast.expr, ast.expr]] = []
        if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) and \
                len(tgt.elts) == len(val.elts):
            pairs = list(zip(tgt.elts, val.elts))
        else:
            pairs = [(tgt, val)]
        for t, v in pairs:
            if isinstance(t, ast.Name) and isinstance(v, ast.Attribute) \
                    and v.attr in _REGISTER_METHODS:
                aliases.add(t.id)
    return aliases


def _code_metrics(ctx: RepoContext) -> dict[str, tuple[str, int]]:
    metrics: dict[str, tuple[str, int]] = {}
    for mod in ctx.modules:
        aliases = _register_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_reg = (isinstance(fn, ast.Attribute)
                      and fn.attr in _REGISTER_METHODS) or \
                     (isinstance(fn, ast.Name) and fn.id in aliases)
            if is_reg and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    node.args[0].value.startswith("lmrs_"):
                metrics.setdefault(node.args[0].value,
                                   (mod.path, node.lineno))
    return metrics


def _check_metrics(ctx: RepoContext, findings: list[Finding]) -> None:
    code = _code_metrics(ctx)
    doc_text = ctx.doc(OBSERVABILITY_DOC)
    doc = _table_tokens(doc_text, _METRIC_RE)
    # suffix shorthand (a backticked `_hits_total` cell) defeats exact
    # matching — flag it so the catalog stays machine-checkable.
    # Histogram CHILD suffixes (`_sum`/`_count`/`_bucket`) are Prometheus
    # series the exposition derives, not registered names: legit prose.
    for i, line in enumerate(doc_text.splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        for tok in _TABLE_CELL_TOKENS.findall(line):
            if tok.strip() in ("_sum", "_count", "_bucket"):
                continue
            if re.match(r"^_[a-z0-9_]+$", tok.strip()):
                findings.append(Finding(
                    rule="drift.metric-suffix-shorthand",
                    path=OBSERVABILITY_DOC, line=i,
                    message=f"catalog row abbreviates a metric name as "
                            f"`{tok.strip()}`",
                    hint="spell the full lmrs_* name — the drift checker "
                         "(and grep) match exact names"))
    for name, (path, line) in sorted(code.items()):
        if name not in doc:
            findings.append(Finding(
                rule="drift.metric-undocumented", path=path, line=line,
                message=f"metric {name!r} is registered but missing from "
                        f"the {OBSERVABILITY_DOC} catalog",
                hint="add a catalog row (type/unit/lifetime/meaning) — "
                     "dashboards are built from that table"))
    for name, line in sorted(doc.items()):
        if name not in code:
            findings.append(Finding(
                rule="drift.metric-stale", path=OBSERVABILITY_DOC,
                line=line,
                message=f"catalogued metric {name!r} is not registered "
                        "anywhere in code",
                hint="delete the stale row (or restore the metric)"))


# ----------------------------------------------------------- trace instants

def _required_instant_args() -> dict[str, tuple[str, ...]]:
    from lmrs_tpu_torch.obs.trace import _INSTANT_REQUIRED_ARGS

    return dict(_INSTANT_REQUIRED_ARGS)


def _check_trace_instants(ctx: RepoContext, findings: list[Finding]) -> None:
    contract = _required_instant_args()
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "instant" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            want = contract.get(name)
            if want is None:
                continue
            args_kw = next((kw for kw in node.keywords
                            if kw.arg == "args"), None)
            if args_kw is None:
                findings.append(Finding(
                    rule="drift.trace-instant-args", path=mod.path,
                    line=node.lineno,
                    message=f"`{name}` instant emitted without args "
                            f"(contract requires {', '.join(want)})",
                    hint="validate_trace_events rejects the trace; "
                         "downstream readers parse these keys"))
                continue
            if not isinstance(args_kw.value, ast.Dict):
                continue  # built dynamically: can't verify statically
            keys = {k.value for k in args_kw.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
            missing = [k for k in want if k not in keys]
            if missing:
                findings.append(Finding(
                    rule="drift.trace-instant-args", path=mod.path,
                    line=node.lineno,
                    message=f"`{name}` instant missing contract arg(s) "
                            f"{', '.join(missing)} "
                            f"(validate_trace_events requires "
                            f"{', '.join(want)})",
                    hint="add the key(s) to the args dict — the CI trace "
                         "gate fails the emitted trace otherwise"))


def run(ctx: RepoContext) -> list[Finding]:
    findings: list[Finding] = []
    _check_fault_sites(ctx, findings)
    _check_metrics(ctx, findings)
    _check_trace_instants(ctx, findings)
    return findings
