"""``LMRS_*`` environment-knob discipline (family ``env``), the reference's
``analysis/envpass.py`` over the port's tree and its own knob table.

The repo's env surface is part of its serving contract, and ad-hoc
parsing produced real outages (NaN profiler duration, ``""`` disabling
the postmortem throttle, ``LMRS_FLASH_BLOCK=""`` crashing module import).
Two rules keep the class extinct:

* ``env.direct-read`` — ``os.environ``/``os.getenv`` access to an
  ``LMRS_*`` name anywhere outside ``lmrs_tpu_torch/utils/env.py``: the knob
  bypasses the validated parser (empty-string-means-default, finite
  guard, bounds clamp, warn-once);
* ``env.knob-undocumented`` / ``env.knob-stale`` — every knob read
  through the parser (``env_str``/``env_bool``/``env_int``/``env_float``/
  ``env_list``, or a config ``_env`` field default) must have a row in
  the docs/torch/KNOBS.md master table, and every documented knob must
  still be read somewhere.
"""

from __future__ import annotations

import ast
import re

from lmrs_tpu_torch.analysis.core import Finding, RepoContext

KNOBS_DOC = "docs/torch/KNOBS.md"
ENV_MODULE = "lmrs_tpu_torch/utils/env.py"

_HELPERS = frozenset(("env_str", "env_bool", "env_int", "env_float",
                      "env_list", "_env"))
_KNOB_RE = re.compile(r"^LMRS_[A-Z0-9_]+$")
_TABLE_CELL_TOKENS = re.compile(r"`([^`]+)`")


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _const_knob(node: ast.expr) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and _KNOB_RE.match(node.value):
        return node.value
    return None


def _check_direct_reads(ctx: RepoContext, findings: list[Finding],
                        reads: dict[str, tuple[str, int]]) -> None:
    for mod in ctx.modules:
        if mod.path == ENV_MODULE:
            continue
        for node in ast.walk(mod.tree):
            knob = None
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in ("os.environ.get", "os.getenv") and node.args:
                    knob = _const_knob(node.args[0])
                elif name.rsplit(".", 1)[-1] in _HELPERS and node.args:
                    k = _const_knob(node.args[0])
                    if k:
                        reads.setdefault(k, (mod.path, node.lineno))
                    continue
            elif isinstance(node, ast.Subscript) and \
                    _dotted(node.value) == "os.environ":
                knob = _const_knob(node.slice)
            if knob:
                reads.setdefault(knob, (mod.path, node.lineno))
                findings.append(Finding(
                    rule="env.direct-read", path=mod.path,
                    line=node.lineno,
                    message=f"direct os.environ read of {knob} bypasses "
                            "the validated parser",
                    hint="route through lmrs_tpu_torch.utils.env (env_str/"
                         "env_bool/env_int/env_float/env_list): empty-"
                         "means-default, finite guard, bounds, warn-once"))


def _doc_knobs(ctx: RepoContext) -> dict[str, int]:
    out: dict[str, int] = {}
    for i, line in enumerate(ctx.doc(KNOBS_DOC).splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        for tok in _TABLE_CELL_TOKENS.findall(line):
            tok = tok.strip().split("=", 1)[0]
            if _KNOB_RE.match(tok):
                out.setdefault(tok, i)
    return out


def run(ctx: RepoContext) -> list[Finding]:
    findings: list[Finding] = []
    reads: dict[str, tuple[str, int]] = {}
    _check_direct_reads(ctx, findings, reads)
    doc = _doc_knobs(ctx)
    for knob, (path, line) in sorted(reads.items()):
        if knob not in doc:
            findings.append(Finding(
                rule="env.knob-undocumented", path=path, line=line,
                message=f"env knob {knob} is read but has no row in "
                        f"{KNOBS_DOC}",
                hint="add it to the master knob table (default, range, "
                     "meaning) — operators discover knobs there"))
    for knob, line in sorted(doc.items()):
        if knob not in reads:
            findings.append(Finding(
                rule="env.knob-stale", path=KNOBS_DOC, line=line,
                message=f"documented knob {knob} is never read in code",
                hint="delete the stale row (or restore the read)"))
    return findings
