"""Eager-step hazard pass (family ``tracing``): the port's counterpart of
the reference's JAX tracing pass.

The port runs its step code eagerly, so a host sync inside it does not
fail a trace: it stalls the host until the card drains, once per call,
and the next launch waits behind it.  The pass checks every function in
``lmrs_tpu_torch/models/`` and ``lmrs_tpu_torch/ops/`` with the
reference's taint rules:

* ``tracing.host-sync-in-step`` — ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` on a device value, ``float()`` / ``int()`` /
  ``bool()`` of one, or ``torch.cuda.synchronize()`` (the counterpart of
  ``host-sync-in-jit``);
* ``tracing.python-branch-on-tensor`` — ``if`` / ``while`` on a device
  value: an implicit ``.item()`` (the counterpart of
  ``python-branch-on-traced``);
* ``tracing.deprecated-api`` — the deprecated-API table, run on EVERY
  module: ``torch.cuda.amp`` (autocast, GradScaler, custom_fwd),
  ``torch.testing.assert_allclose``, ``torch.backends.cuda.sdp_kernel``,
  and any import of ``jax`` or of the reference package ``lmrs_tpu``.

Device values: a function's parameters, except those annotated with a
type that does not name ``Tensor`` and unannotated ones whose default is
a literal other than ``None`` (the eager counterpart of
``static_argnames``), and names assigned from a ``torch.*`` call (other
than device, dtype and runtime queries) or from an expression that uses a
device value.  Heuristics lean PRECISE over complete: ``x is None``,
``isinstance``, and ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` /
``.size()`` / ``len()`` uses are static and never flagged.  A plain
version's deliberate host loop carries an inline suppression with its
reason.

The reference's ``dynamic-shape-in-jit`` and
``jit-closes-over-mutable-global`` have no meaning under eager execution;
their counterparts are graph-capture hazards, which come with CUDA graphs.
"""

from __future__ import annotations

import ast

from lmrs_tpu_torch.analysis.core import Finding, Module, RepoContext

_SCOPE_PREFIXES = ("lmrs_tpu_torch/models/", "lmrs_tpu_torch/ops/")

# dotted-name -> replacement hint
_DEPRECATED = {
    "torch.cuda.amp": "use torch.autocast('cuda', ...) / "
                      "torch.amp.GradScaler('cuda') / torch.amp.custom_fwd("
                      "device_type='cuda'): the torch.cuda.amp namespace is "
                      "deprecated",
    "torch.testing.assert_allclose": "use torch.testing.assert_close",
    "torch.backends.cuda.sdp_kernel": "use torch.nn.attention.sdpa_kernel",
}
# modules the port never imports (it runs where JAX is not installed)
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "lmrs_tpu")

# torch calls that return host values (devices, dtypes, runtime queries,
# context managers), not tensors
_HOST_TORCH_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.utils.", "torch.distributed.",
    "torch.profiler.", "torch.autograd.", "torch.library.", "torch.device",
    "torch.finfo", "torch.iinfo", "torch.is_", "torch.get_", "torch.set_",
    "torch.Size", "torch.Generator", "torch.no_grad", "torch.inference_mode",
    "torch.manual_seed", "torch.dtype", "torch.compiler.",
)
# tensor metadata: host values, no sync
_STATIC_ATTRS = frozenset(("shape", "ndim", "dtype", "size", "device",
                           "is_cuda", "numel", "dim", "element_size",
                           "stride", "data_ptr", "is_contiguous",
                           "storage_offset"))
_SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy"))
_HOST_SYNC_FNS = frozenset(("float", "int", "bool"))


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _own_nodes(fn: ast.AST):
    """Every node of ``fn``'s body, not descending into nested functions,
    lambdas or classes (they are checked on their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _static_param(arg: ast.arg, default: ast.expr | None) -> bool:
    if arg.annotation is not None:
        return "Tensor" not in ast.unparse(arg.annotation)
    return isinstance(default, ast.Constant) and default.value is not None


def _params(fn: ast.FunctionDef) -> set[str]:
    """Parameters that carry device values (see the module doc)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    return {arg.arg for arg, d in pairs
            if arg.arg not in ("self", "cls") and not _static_param(arg, d)}


def _device_call(node: ast.AST) -> bool:
    """A ``torch.*`` call that returns a tensor."""
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    return name.startswith("torch.") and \
        not name.startswith(_HOST_TORCH_PREFIXES)


_COMPS = (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)


def _comp_targets(node: ast.AST) -> set[str]:
    return {n.id for g in node.generators for n in ast.walk(g.target)
            if isinstance(n, ast.Name)}


def _sync_operands(call: ast.Call) -> list[ast.expr]:
    """The operands a host-sync call brings to the host ([] for any other
    call)."""
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in _SYNC_METHODS:
        return [call.func.value]
    if isinstance(call.func, ast.Name) and call.func.id in _HOST_SYNC_FNS:
        return list(call.args)
    return []


def _dynamic_names(expr: ast.AST, tainted: set[str]) -> set[str]:
    """Device-valued names used DYNAMICALLY in ``expr`` — shape/dtype/
    device/size reads, ``len``, ``is None`` tests, and isinstance checks
    are host values and excluded."""
    static_spots: set[int] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    static_spots.add(id(sub))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("len", "isinstance", "getattr",
                                 "hasattr", "type", "callable"):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    static_spots.add(id(sub))
        elif isinstance(node, ast.Compare) and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    static_spots.add(id(sub))
        elif isinstance(node, ast.Call) and _sync_operands(node):
            # the sync's result is a host value (the sync is its own
            # finding)
            for arg in _sync_operands(node):
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name):
                        static_spots.add(id(sub))
        elif isinstance(node, _COMPS):
            # a comprehension whose element uses its targets only
            # statically (a shape check over a list of tensors) reads its
            # iterable statically too
            targets = _comp_targets(node)
            for g in node.generators:
                for sub in ast.walk(g.target):
                    static_spots.add(id(sub))
            body = ([node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            body += [c for g in node.generators for c in g.ifs]
            if not any(_dynamic_names(e, tainted | targets) & targets
                       for e in body):
                for g in node.generators:
                    for sub in ast.walk(g.iter):
                        if isinstance(sub, ast.Name):
                            static_spots.add(id(sub))
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and n.id in tainted
            and id(n) not in static_spots}


def _taint(fn: ast.FunctionDef, outer: set[str]) -> set[str]:
    """Device-valued names of ``fn``: its device parameters, the enclosing
    function's device names it closes over, and names assigned from a
    torch call or a dynamic use of a device value (two passes ~= fixpoint
    for linear code)."""
    tainted = (set(outer) - {a.arg for a in fn.args.args}) | _params(fn)
    for _ in range(2):
        for node in _own_nodes(fn):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign) and (
                    _dynamic_names(node.value, tainted)
                    or any(_device_call(n) for n in ast.walk(node.value))):
                targets = node.targets
            elif isinstance(node, (ast.For, ast.comprehension)) and \
                    _dynamic_names(node.iter, tainted) and \
                    not any(isinstance(n, ast.Call)
                            for n in ast.walk(node.iter)):
                # iterating over device values (a list or tuple of
                # tensors; ``.items()`` of a dict yields its keys too)
                targets = [node.target]
            for t in targets:
                tainted |= _target_names(t)
    return tainted


def _target_names(t: ast.expr) -> set[str]:
    """Names an assignment target binds or fills: ``out[k] = v`` fills
    ``out`` (not ``k``); ``a.b = v`` binds no local name."""
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, (ast.Tuple, ast.List)):
        return set().union(*(_target_names(e) for e in t.elts))
    if isinstance(t, (ast.Starred, ast.Subscript)):
        return _target_names(t.value)
    return set()


def _check_fn(mod: Module, fn: ast.FunctionDef, outer: set[str],
              findings: list[Finding]) -> None:
    tainted = _taint(fn, outer)
    where = f"step code `{fn.name}`"
    for node in _own_nodes(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _check_fn(mod, node, tainted, findings)
        elif isinstance(node, (ast.If, ast.While)):
            dyn = _dynamic_names(node.test, tainted)
            if dyn:
                kw = "while" if isinstance(node, ast.While) else "if"
                findings.append(Finding(
                    rule="tracing.python-branch-on-tensor",
                    path=mod.path, line=node.lineno,
                    message=f"Python `{kw}` on device value(s) "
                            f"{', '.join(sorted(dyn))} in {where}",
                    hint="branch on a host value (a shape, a config "
                         "field), or select on the device (torch.where); "
                         "the test is an implicit .item()"))
        elif isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name == "torch.cuda.synchronize":
                findings.append(Finding(
                    rule="tracing.host-sync-in-step",
                    path=mod.path, line=node.lineno,
                    message=f"torch.cuda.synchronize() in {where}",
                    hint="sync once where the host needs the result, "
                         "outside the step"))
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and \
                    _dynamic_names(node.func.value, tainted):
                findings.append(Finding(
                    rule="tracing.host-sync-in-step",
                    path=mod.path, line=node.lineno,
                    message=f".{node.func.attr}() on a device value in "
                            f"{where}",
                    hint="keep the value on the device, or return it and "
                         "fetch it once where the host needs it"))
            elif name in _HOST_SYNC_FNS:
                dyn: set[str] = set()
                for arg in node.args:
                    dyn |= _dynamic_names(arg, tainted)
                if dyn:
                    findings.append(Finding(
                        rule="tracing.host-sync-in-step",
                        path=mod.path, line=node.lineno,
                        message=f"{name}() forces a host sync on device "
                                f"value(s) {', '.join(sorted(dyn))} in "
                                f"{where}",
                        hint="torch ops keep it on the device; host "
                             "conversion belongs outside the step"))


def _deprecated_key(name: str, imported: bool) -> str | None:
    """The table entry ``name`` falls under: the name itself, or for an
    import, a module inside a deprecated namespace."""
    for key in _DEPRECATED:
        if name == key or (imported and name.startswith(key + ".")):
            return key
    return None


def _check_deprecated(mod: Module, findings: list[Finding]) -> None:
    for node in ast.walk(mod.tree):
        imported = isinstance(node, (ast.Import, ast.ImportFrom))
        if isinstance(node, ast.Attribute):
            names = [_dotted(node)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names = [node.module]
        elif isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        else:
            continue
        for name in names:
            key = _deprecated_key(name, imported)
            if key is not None:
                findings.append(Finding(
                    rule="tracing.deprecated-api", path=mod.path,
                    line=node.lineno,
                    message=f"deprecated torch API `{key}`",
                    hint=_DEPRECATED[key]))
            elif imported and name.split(".", 1)[0] in _FORBIDDEN_ROOTS:
                findings.append(Finding(
                    rule="tracing.deprecated-api", path=mod.path,
                    line=node.lineno,
                    message=f"the port imports `{name}`",
                    hint="the port imports torch and numpy, never jax or "
                         "the reference package: keep its own copy of "
                         "what it needs"))


def run(ctx: RepoContext) -> list[Finding]:
    findings: list[Finding] = []
    for mod in ctx.modules:
        _check_deprecated(mod, findings)
        if not (mod.path.startswith(_SCOPE_PREFIXES)
                or mod.path.startswith("fixtures/")):
            continue
        for node in _own_nodes(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_fn(mod, node, set(), findings)
            elif isinstance(node, ast.ClassDef):
                for sub in _own_nodes(node):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        _check_fn(mod, sub, set(), findings)
    return findings
