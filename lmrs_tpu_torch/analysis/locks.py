"""Lock-discipline / race detector (pass family ``race``), the reference's
``analysis/locks.py`` over the port's tree.

The repo declares its guarded-state conventions inline:

* ``self._pinned: dict = {}  # guarded-by: _pinned_lock`` on an attribute's
  defining line (usually ``__init__``) marks every later WRITE to that
  attribute as requiring ``with self._pinned_lock:``;
* ``GLOBAL = {}  # guarded-by: _some_lock`` does the same for module-level
  state and module-level locks;
* ``# holds-lock: _pinned_lock`` on (or directly above) a ``def`` line
  declares that the method is only ever called with the lock already held
  (the "Caller holds self._lock" docstring convention, machine-readable).

Checks:

* ``race.unguarded-write`` — assignment/augmented-assignment/``del``/known
  mutator-method call on a guarded attribute outside the owning ``with``;
* ``race.lock-order-cycle`` — the acquisition-order graph (lock A held
  while B is taken, lexically or via a same-class method call one level
  deep) contains a cycle: two threads taking the locks in opposite orders
  can deadlock;
* ``race.blocking-under-lock`` — a known-blocking call (sleep, fsync,
  socket/HTTP I/O, device syncs: ``torch.cuda.synchronize`` and a
  stream's or event's ``synchronize()``) while any declared lock is held:
  every other thread needing that lock now waits on the disk/wire/device.

Reads are deliberately NOT flagged: the repo's idiom allows GIL-atomic
snapshot reads of guarded dicts/counters, and flagging them would bury
the write races this pass exists for.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from lmrs_tpu_torch.analysis.core import Finding, Module, RepoContext

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z_]\w*(?:\s*,\s*"
                       r"[A-Za-z_]\w*)*)")

# method names that mutate their receiver in place — a call on a guarded
# attribute counts as a write
_MUTATORS = frozenset((
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "add",
    "setdefault", "sort", "reverse",
))

# call names (dotted suffixes) that block the calling thread
_BLOCKING = frozenset((
    "time.sleep", "os.fsync", "os.fdatasync", "torch.cuda.synchronize",
    "socket.create_connection", "select.select", "subprocess.run",
))
_BLOCKING_METHODS = frozenset((
    "getresponse", "fsync", "synchronize", "urlopen", "recv", "accept",
    "sleep",
))


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('' when dynamic)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@dataclass
class _Scope:
    """Guarded-state declarations of one class (or the module, name='')."""

    name: str
    guarded: dict[str, tuple[str, int]] = field(default_factory=dict)
    # attr -> (lock name, decl line)
    locks: set[str] = field(default_factory=set)


def _collect_scopes(mod: Module) -> dict[str, _Scope]:
    """Parse guarded-by annotations: scope name ('' = module level) ->
    declarations.  The annotated line must define ``self.<attr>`` (class
    scope) or ``NAME = ...`` (module scope)."""
    scopes: dict[str, _Scope] = {"": _Scope("")}

    class_ranges: list[tuple[str, int, int]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            end = max((getattr(n, "end_lineno", node.lineno)
                       for n in ast.walk(node)), default=node.lineno)
            class_ranges.append((node.name, node.lineno, end))
            scopes.setdefault(node.name, _Scope(node.name))

    def scope_at(lineno: int) -> _Scope:
        best = None
        for name, lo, hi in class_ranges:
            if lo <= lineno <= hi and (best is None or lo > best[1]):
                best = (name, lo)
        return scopes[best[0]] if best else scopes[""]

    for i, text in enumerate(mod.lines, start=1):
        m = _GUARDED_RE.search(text)
        if not m:
            continue
        lock = m.group(1)
        sc = scope_at(i)

        def attr_on(line_text: str, scope: _Scope):
            return (re.search(r"\bself\.(\w+)", line_text) if scope.name
                    else re.match(r"\s*(\w+)\s*[:=]", line_text))

        attr_m = attr_on(text, sc)
        decl_line = i
        if attr_m is None and text.strip().startswith("#"):
            # standalone-comment form: the annotation sits on its own
            # line directly ABOVE the attribute's defining line (used
            # when the defining line is too long to carry a trailer)
            nxt = mod.line_text(i + 1)
            sc = scope_at(i + 1)
            attr_m = attr_on(nxt, sc)
            decl_line = i + 1
        if attr_m:
            sc.guarded[attr_m.group(1)] = (lock, decl_line)
            sc.locks.add(lock)

    # every lock-object construction is a known lock too (the order/
    # blocking checks must see locks that guard nothing declared)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = node.value.func
            name = ctor.attr if isinstance(ctor, ast.Attribute) else (
                ctor.id if isinstance(ctor, ast.Name) else "")
            if name not in ("Lock", "RLock", "Condition", "Semaphore",
                            "BoundedSemaphore"):
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    scope_at(node.lineno).locks.add(t.attr)
                elif isinstance(t, ast.Name):
                    scopes[""].locks.add(t.id)
    return scopes


def _holds_locks(mod: Module, fn: ast.FunctionDef | ast.AsyncFunctionDef
                 ) -> set[str]:
    """Locks declared held on entry via ``# holds-lock:`` anywhere on the
    (possibly multi-line) def signature or the line directly above it."""
    out: set[str] = set()
    sig_end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for lineno in range(fn.lineno - 1, sig_end):
        m = _HOLDS_RE.search(mod.line_text(lineno))
        if m:
            out |= {tok.strip() for tok in m.group(1).split(",")}
    return out


def _lock_name(item: ast.expr) -> str | None:
    """The lock behind a ``with`` item: ``self.<name>`` or a bare module
    global ``<name>`` that LOOKS like a lock (``*lock*`` in the name) or
    is declared one via guarded-by."""
    if isinstance(item, ast.Attribute) and isinstance(item.value, ast.Name) \
            and item.value.id in ("self", "cls"):
        return item.attr
    if isinstance(item, ast.Name):
        return item.id
    return None


class _FunctionWalker(ast.NodeVisitor):
    """Walks one function body tracking the held-lock set."""

    def __init__(self, mod: Module, scope: _Scope, module_scope: _Scope,
                 known_locks: set[str], findings: list[Finding],
                 edges: list[tuple[str, str, str, int]],
                 acquires: dict[str, set[str]], fn_name: str,
                 held: set[str]):
        self.mod = mod
        self.scope = scope
        self.module_scope = module_scope
        self.known_locks = known_locks
        self.findings = findings
        self.edges = edges          # (lock_a, lock_b, path, line)
        self.acquires = acquires    # method name -> locks it takes directly
        self.fn_name = fn_name
        self.held: list[str] = list(held)

    # -------------------------------------------------------- with / locks

    def visit_With(self, node: ast.With) -> None:
        taken: list[str] = []
        for item in node.items:
            name = _lock_name(item.context_expr)
            if name and name in self.known_locks:
                for h in self.held:
                    if h != name:
                        self.edges.append((self._qual(h), self._qual(name),
                                           self.mod.path, item.context_expr
                                           .lineno))
                self.acquires.setdefault(self.fn_name, set()).add(name)
                taken.append(name)
        self.held.extend(taken)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()
        # with-item expressions themselves (rare) are not revisited

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def _qual(self, lock: str) -> str:
        owner = self.scope.name if lock in self.scope.locks else ""
        prefix = f"{self.mod.path}:{owner}" if owner else self.mod.path
        return f"{prefix}.{lock}"

    # ------------------------------------------------------------- writes

    def _check_write(self, attr: str, lineno: int, what: str) -> None:
        decl = self.scope.guarded.get(attr)
        scope = self.scope
        if decl is None:
            decl = self.module_scope.guarded.get(attr)
            scope = self.module_scope
        if decl is None:
            return
        lock, decl_line = decl
        if lock in self.held:
            return
        # the declaration LINE goes in the hint, not the message: the
        # message is the baseline identity and must survive line shifts
        self.findings.append(Finding(
            rule="race.unguarded-write",
            path=self.mod.path, line=lineno,
            message=f"{what} to {scope.name + '.' if scope.name else ''}"
                    f"{attr} outside `with {lock}:`",
            hint=f"guarded-by declared at line {decl_line}; hold {lock} "
                 f"for the write, or mark the enclosing function "
                 f"`# holds-lock: {lock}` if every caller already holds "
                 "it"))

    def _write_target(self, node: ast.expr, lineno: int, what: str) -> None:
        # unwrap subscripts: self.d[k] = v mutates self.d
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in ("self", "cls"):
            self._check_write(node.attr, lineno, what)
        elif isinstance(node, ast.Name):
            if node.id in self.module_scope.guarded:
                self._check_write(node.id, lineno, what)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                self._write_target(el, node.lineno, "assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._write_target(node.target, node.lineno,
                           "read-modify-write (+=)")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._write_target(node.target, node.lineno, "assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._write_target(t, node.lineno, "del")
        self.generic_visit(node)

    # -------------------------------------------------------------- calls

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # mutator-method write: self.attr.append(...)
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            base = func.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id in ("self", "cls"):
                self._check_write(base.attr, node.lineno,
                                  f".{func.attr}() mutation")
            elif isinstance(base, ast.Name) and \
                    base.id in self.module_scope.guarded:
                self._check_write(base.id, node.lineno,
                                  f".{func.attr}() mutation")
        # blocking call while a lock is held
        if self.held:
            dotted = _dotted(func)
            leaf = dotted.rsplit(".", 1)[-1]
            if dotted in _BLOCKING or leaf in _BLOCKING_METHODS:
                self.findings.append(Finding(
                    rule="race.blocking-under-lock",
                    path=self.mod.path, line=node.lineno,
                    message=f"blocking call {dotted or leaf}() while "
                            f"holding {', '.join(self.held)}",
                    hint="move the I/O outside the critical section (copy "
                         "under the lock, act after), or suppress with "
                         "`# lint: ignore[race.blocking-under-lock]` if "
                         "serializing on the I/O is the point"))
        # same-class call edges: self.m() while holding A -> A precedes
        # every lock m() takes directly (one level, resolved by run())
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and func.value.id == "self" \
                and self.held:
            self.edges.append(("__call__:" + func.attr,
                               ",".join(self._qual(h) for h in self.held),
                               self.mod.path, node.lineno))
        self.generic_visit(node)

    # nested defs run with an EMPTY held set (they execute later, not here)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved, self.held = self.held, []
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = lambda self, node: None  # noqa: E731 - no statements


def _find_cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """Simple cycles in the acquisition-order digraph (bounded DFS)."""
    cycles: list[list[str]] = []
    seen_keys: set[tuple[str, ...]] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) > 1:
                    rot = min(range(len(path)),
                              key=lambda i: path[i])
                    key = tuple(path[rot:] + path[:rot])
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(path + [start])
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))
    return cycles


def run(ctx: RepoContext) -> list[Finding]:
    findings: list[Finding] = []
    edges: list[tuple[str, str, str, int]] = []
    call_edges: list[tuple[str, str, str, int]] = []

    for mod in ctx.modules:
        scopes = _collect_scopes(mod)
        module_scope = scopes[""]
        known_locks = set().union(*(s.locks for s in scopes.values()))
        if not known_locks:
            continue
        acquires: dict[str, set[str]] = {}
        raw_edges: list[tuple[str, str, str, int]] = []

        def walk_class(cls_name: str, body: list[ast.stmt]) -> None:
            scope = scopes.get(cls_name, module_scope)
            for node in body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    if node.name in ("__init__", "__new__"):
                        continue  # construction precedes sharing
                    held = _holds_locks(mod, node)
                    w = _FunctionWalker(mod, scope, module_scope,
                                        known_locks, findings, raw_edges,
                                        acquires, node.name, held)
                    for stmt in node.body:
                        w.visit(stmt)

        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                walk_class(node.name, node.body)
        walk_class("", [n for n in mod.tree.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))])

        # resolve one level of same-class call edges: holding A and
        # calling self.m() orders A before every lock m() takes directly
        for a, b, path, line in raw_edges:
            if a.startswith("__call__:"):
                method = a.split(":", 1)[1]
                helds = b.split(",")
                for lock in acquires.get(method, ()):  # direct only
                    q = (f"{path}:" + next(
                        (s.name for s in scopes.values()
                         if lock in s.locks and s.name), "")).rstrip(":") \
                        + f".{lock}"
                    for h in helds:
                        if h != q:
                            edges.append((h, q, path, line))
            else:
                edges.append((a, b, path, line))

    graph: dict[str, set[str]] = {}
    locs: dict[tuple[str, str], tuple[str, int]] = {}
    for a, b, path, line in edges:
        graph.setdefault(a, set()).add(b)
        locs.setdefault((a, b), (path, line))
    for cycle in _find_cycles(graph):
        first = locs.get((cycle[0], cycle[1]), ("?", 1))
        findings.append(Finding(
            rule="race.lock-order-cycle",
            path=first[0], line=first[1],
            message="lock acquisition order cycle: "
                    + " -> ".join(c.rsplit(".", 1)[-1] for c in cycle)
                    + " (full: " + " -> ".join(cycle) + ")",
            hint="pick one global order for these locks and release "
                 "before acquiring against it"))
    _ = call_edges
    return findings
