"""Shared machinery for the lmrs-lint-torch passes (a copy of the
reference's ``analysis/core.py`` over the port's tree): findings, module
loading, inline suppressions, and the checked-in baseline.

Finding identity (the baseline key) deliberately excludes line numbers —
an accepted pre-existing finding must stay suppressed when unrelated
edits shift the file — and keys are COUNTED: two identical-looking
findings in one file occupy two baseline slots, so a third new instance
of an accepted pattern still surfaces.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BASELINE_SCHEMA = "lmrs-lint-baseline-v1"

# trailing same-line suppression: ``code  # lint: ignore[rule]`` — rule may
# be a prefix ("race" silences the family, "race.unguarded-write" one rule)
_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore\[([\w.,\s-]+)\]")


@dataclass(frozen=True)
class Finding:
    rule: str      # "family.check-name", e.g. "race.unguarded-write"
    path: str      # repo-relative posix path
    line: int      # 1-based
    message: str
    hint: str = ""

    @property
    def family(self) -> str:
        return self.rule.split(".", 1)[0]

    @property
    def key(self) -> str:
        """Baseline identity: rule + file + message, no line number."""
        return f"{self.rule}|{self.path}|{self.message}"

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class Module:
    """One parsed source file (path is repo-relative posix)."""

    path: str
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)

    @classmethod
    def from_source(cls, path: str, source: str) -> "Module":
        return cls(path=path, source=source, tree=ast.parse(source),
                   lines=source.splitlines())

    def line_text(self, lineno: int) -> str:
        """1-based line text ('' out of range)."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed_rules(self, lineno: int) -> set[str]:
        """Rules (or rule prefixes) suppressed on this line via
        ``# lint: ignore[...]``."""
        m = _IGNORE_RE.search(self.line_text(lineno))
        if not m:
            return set()
        return {tok.strip() for tok in m.group(1).split(",") if tok.strip()}

    def is_suppressed(self, finding: Finding) -> bool:
        for tok in self.suppressed_rules(finding.line):
            if finding.rule == tok or finding.rule.startswith(tok + "."):
                return True
        return False


# default scan surface: the port's package, its card driver and its
# scripts (tests are exercised BY the analyzer, not scanned by it)
_DEFAULT_GLOBS = ("lmrs_tpu_torch/**/*.py", "chip_smoke.py",
                  "scripts/torch_*.py")
BASELINE_FILE = "lint-baseline-torch.json"
_EXCLUDE_PARTS = ("__pycache__",)


def find_repo_root(start: Path | None = None) -> Path:
    """The repo checkout root: the nearest ancestor of ``start`` (default
    cwd) containing ``lmrs_tpu_torch/``; falls back to the package's
    parent."""
    cur = (start or Path.cwd()).resolve()
    for cand in (cur, *cur.parents):
        if (cand / "lmrs_tpu_torch" / "__init__.py").exists():
            return cand
    return Path(__file__).resolve().parents[2]


def load_modules(root: Path, globs: tuple[str, ...] = _DEFAULT_GLOBS
                 ) -> list[Module]:
    mods: list[Module] = []
    seen: set[str] = set()
    for pattern in globs:
        for p in sorted(root.glob(pattern)):
            rel = p.relative_to(root).as_posix()
            if rel in seen or any(part in p.parts
                                  for part in _EXCLUDE_PARTS):
                continue
            seen.add(rel)
            try:
                mods.append(Module.from_source(rel, p.read_text(
                    encoding="utf-8")))
            except (SyntaxError, UnicodeDecodeError) as e:
                # a file the analyzer cannot parse is itself a finding
                # (surfaced by run_passes via ctx.parse_failures)
                mods.append(Module(path=rel, source="",
                                   tree=ast.parse(""), lines=[]))
                mods[-1].parse_error = str(e)  # type: ignore[attr-defined]
    return mods


@dataclass
class RepoContext:
    """What a pass sees: the parsed modules plus doc text (overridable by
    tests, so fixtures can plant doc drift without touching disk)."""

    root: Path
    modules: list[Module]
    docs: dict[str, str] = field(default_factory=dict)

    @classmethod
    def load(cls, root: Path | None = None) -> "RepoContext":
        root = root or find_repo_root()
        return cls(root=root, modules=load_modules(root))

    def doc(self, rel_path: str) -> str:
        """Text of a docs file ('' when absent — the drift passes then
        report everything code-side as undocumented)."""
        if rel_path not in self.docs:
            p = self.root / rel_path
            self.docs[rel_path] = (p.read_text(encoding="utf-8")
                                   if p.exists() else "")
        return self.docs[rel_path]

    def module(self, rel_path: str) -> Module | None:
        for m in self.modules:
            if m.path == rel_path:
                return m
        return None


class Baseline:
    """Checked-in acceptance of pre-existing findings.

    The file maps finding keys to accepted counts.  ``apply`` splits a
    run's findings into (new, accepted) and reports baseline keys that no
    longer match anything ("expired" — the underlying issue was fixed, so
    the entry should be pruned; ``--write-baseline`` does it)."""

    def __init__(self, counts: dict[str, int] | None = None):
        self.counts: dict[str, int] = dict(counts or {})

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        p = Path(path)
        if not p.exists():
            return cls()
        doc = json.loads(p.read_text(encoding="utf-8"))
        if doc.get("schema") != BASELINE_SCHEMA:
            raise ValueError(
                f"{path}: unknown baseline schema {doc.get('schema')!r}")
        counts = doc.get("findings", {})
        if not all(isinstance(v, int) and v > 0 for v in counts.values()):
            raise ValueError(f"{path}: baseline counts must be positive "
                             "integers")
        return cls(counts)

    @classmethod
    def from_findings(cls, findings: list[Finding]) -> "Baseline":
        b = cls()
        for f in findings:
            b.counts[f.key] = b.counts.get(f.key, 0) + 1
        return b

    def save(self, path: str | Path) -> None:
        doc = {"schema": BASELINE_SCHEMA,
               "findings": dict(sorted(self.counts.items()))}
        Path(path).write_text(json.dumps(doc, indent=1) + "\n",
                              encoding="utf-8")

    def apply(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[str]]:
        """-> (new, accepted, expired_keys)."""
        budget = dict(self.counts)
        new: list[Finding] = []
        accepted: list[Finding] = []
        for f in findings:
            if budget.get(f.key, 0) > 0:
                budget[f.key] -= 1
                accepted.append(f)
            else:
                new.append(f)
        expired = sorted(k for k, n in budget.items() if n > 0)
        return new, accepted, expired


def run_passes(ctx: RepoContext,
               families: tuple[str, ...] = ("race", "tracing", "drift",
                                            "env")) -> list[Finding]:
    """Run the selected pass families; findings sorted by (path, line),
    inline suppressions already applied."""
    from lmrs_tpu_torch.analysis import drift, envpass, locks, tracing

    passes = {"race": locks.run, "tracing": tracing.run,
              "drift": drift.run, "env": envpass.run}
    findings: list[Finding] = []
    for mod in ctx.modules:
        err = getattr(mod, "parse_error", None)
        if err:
            findings.append(Finding(rule="core.parse-error", path=mod.path,
                                    line=1, message=f"unparseable: {err}"))
    for fam in families:
        findings.extend(passes[fam](ctx))
    by_path = {m.path: m for m in ctx.modules}
    findings = [f for f in findings
                if f.path not in by_path or not by_path[f.path].
                is_suppressed(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_repo(root: Path | None = None,
             baseline_path: str | Path | None = None
             ) -> tuple[list[Finding], list[Finding], list[str]]:
    """One-call repo scan -> (new, accepted, expired_baseline_keys).  The
    CI gate and the tests' repo-clean check both ride this."""
    ctx = RepoContext.load(root)
    findings = run_passes(ctx)
    if baseline_path is None:
        baseline_path = ctx.root / BASELINE_FILE
    baseline = Baseline.load(baseline_path)
    return baseline.apply(findings)
