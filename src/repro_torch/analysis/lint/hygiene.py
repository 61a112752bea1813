"""Trace-hygiene pass: AST rules for the retrace/warn bug classes.

The port's own copy of ``repro/analysis/lint/hygiene.py``, with one
addition: ``jit-in-fn`` also names ``torch.compile(...)`` inside a
function body, the port's counterpart of ``jax.jit`` (each call builds a
fresh compiled callable with an empty cache).  Everything else, pragma
included, behaves as the reference does.

The failure modes this pass guards (a per-call re-jit, silently shed
options) are all *source shapes*, so an AST walk proves their absence
without running anything.

Rules (suppress a deliberate site with ``# lint: ok(<rule>)`` on the
flagged line):

* ``jit-in-fn`` — a ``jit(...)`` or ``torch.compile(...)`` call (or a
  ``@jit``/``@torch.compile``-decorated nested def) inside a function
  body.  Each call builds a fresh jitted callable with an empty
  compilation cache, so a hot path pays a full retrace per invocation.
  Allowed: module/class scope,
  and one-time construction assigned to a ``self`` attribute (an
  ``__init__`` building the instance's stable step function).
* ``warn-stacklevel`` — ``warnings.warn`` without ``stacklevel``: the
  warning points at the library line instead of the caller, and
  ``filterwarnings`` dedup by location collapses distinct callers.
* ``mutable-default`` — a mutable literal (``[]``/``{}``/``set()``
  /``list()``/``dict()``) as a parameter default: one shared instance
  across calls.
* ``nonhashable-static`` — a parameter named in a jit wrapper's
  ``static_argnames`` (or positioned by ``static_argnums``) whose
  default is a mutable literal: the first defaulted call raises
  ``unhashable type`` — at runtime, on the path that happens to
  default.
* ``unused-import`` — an import binding never referenced in the
  module.  Deliberate re-exports are NOT findings: names listed in the
  module's ``__all__`` (the ``repro/api.py`` facade idiom), redundant
  aliases (``from m import x as x``), lines carrying a ``# noqa``
  marker, and ``from __future__`` imports are all recognised as
  intentional.  Side-effect imports without any of those markers are
  what this rule exists to make explicit.
"""

from __future__ import annotations

import ast
import pathlib

from .common import Finding, PassResult

__all__ = ["RULES", "check_source", "run_hygiene_pass"]

RULES = ("jit-in-fn", "warn-stacklevel", "mutable-default",
         "nonhashable-static", "unused-import")

_PRAGMA = "# lint: ok("


def _suppressed(lines, lineno: int, rule: str) -> bool:
    """Pragma on the flagged line or the line directly above it."""
    token = f"{_PRAGMA}{rule})"
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and token in lines[ln - 1]:
            return True
    return False


def _is_jit(node: ast.expr) -> bool:
    """``jax.jit`` / ``api.jit`` / bare ``jit`` / ``torch.compile``
    reference."""
    return ((isinstance(node, ast.Attribute) and node.attr == "jit")
            or (isinstance(node, ast.Name) and node.id == "jit")
            or (isinstance(node, ast.Attribute) and node.attr == "compile"
                and isinstance(node.value, ast.Name)
                and node.value.id == "torch"))


def _is_jit_call(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) and _is_jit(node.func)


def _is_mutable_literal(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set") and not node.args
            and not node.keywords)


def _jit_wrapper_call(node: ast.expr):
    """Return the jit-configuring Call for ``jit(...)`` or
    ``partial(jit, ...)`` expressions, else None."""
    if not isinstance(node, ast.Call):
        return None
    if _is_jit(node.func):
        return node
    fn = node.func
    partial_like = ((isinstance(fn, ast.Name) and fn.id == "partial")
                    or (isinstance(fn, ast.Attribute)
                        and fn.attr == "partial"))
    if partial_like and node.args and _is_jit(node.args[0]):
        return node
    return None


def _static_spec(call: ast.Call):
    """Extract literal ``static_argnames`` / ``static_argnums`` from a
    jit-configuring call; non-literal specs are skipped (not provable
    statically)."""
    names, nums = [], []
    for kw in call.keywords:
        if kw.arg not in ("static_argnames", "static_argnums"):
            continue
        vals = (kw.value.elts
                if isinstance(kw.value, (ast.Tuple, ast.List))
                else [kw.value])
        for v in vals:
            if isinstance(v, ast.Constant):
                if kw.arg == "static_argnames" and isinstance(v.value, str):
                    names.append(v.value)
                elif kw.arg == "static_argnums" and isinstance(v.value,
                                                               int):
                    nums.append(v.value)
    return names, nums


def _defaults_by_arg(fn: ast.FunctionDef):
    """Map parameter name -> (position, default node or None)."""
    args = fn.args
    out = {}
    pos = args.posonlyargs + args.args
    pad = [None] * (len(pos) - len(args.defaults))
    for i, (a, d) in enumerate(zip(pos, pad + list(args.defaults))):
        out[a.arg] = (i, d)
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        out[a.arg] = (None, d)
    return out


class _Walker(ast.NodeVisitor):
    def __init__(self, where: str, lines):
        self.where = where
        self.lines = lines
        self.fn_depth = 0
        self.self_allowed = set()   # id() of jit Calls built onto self
        self.findings = []

    def _flag(self, rule: str, lineno: int, detail: str):
        if not _suppressed(self.lines, lineno, rule):
            self.findings.append(Finding(
                "hygiene", rule, f"{self.where}:{lineno}", detail))

    # -- allowance prescan: self.<attr> = [wrap(] jit(...) [)] --------
    def visit_Assign(self, node: ast.Assign):
        if all(isinstance(t, ast.Attribute)
               and isinstance(t.value, ast.Name) and t.value.id == "self"
               for t in node.targets):
            for sub in ast.walk(node.value):
                if _is_jit_call(sub):
                    self.self_allowed.add(id(sub))
        self.generic_visit(node)

    # -- function defs: defaults, nested-jit decorators, static spec --
    def _visit_fn(self, node):
        for name, (_, default) in _defaults_by_arg(node).items():
            if default is not None and _is_mutable_literal(default):
                self._flag("mutable-default", node.lineno,
                           f"parameter {name!r} of {node.name}() defaults "
                           f"to a shared mutable instance")
        by_arg = _defaults_by_arg(node)
        for deco in node.decorator_list:
            wrapper = _jit_wrapper_call(deco) if isinstance(deco,
                                                            ast.Call) \
                else (deco if _is_jit(deco) else None)
            if wrapper is None:
                continue
            if self.fn_depth > 0:
                self._flag("jit-in-fn", deco.lineno,
                           f"@jit on nested def {node.name}() builds a "
                           f"fresh compilation cache per enclosing call")
            if isinstance(wrapper, ast.Call):
                self._check_static(wrapper, node, by_arg)
        self.fn_depth += 1
        self.generic_visit(node)
        self.fn_depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _check_static(self, call: ast.Call, fn: ast.FunctionDef, by_arg):
        names, nums = _static_spec(call)
        for name in names:
            entry = by_arg.get(name)
            if entry and entry[1] is not None \
                    and _is_mutable_literal(entry[1]):
                self._flag("nonhashable-static", call.lineno,
                           f"static arg {name!r} of {fn.name}() defaults "
                           f"to an unhashable mutable literal")
        for num in nums:
            for name, (pos, default) in by_arg.items():
                if pos == num and default is not None \
                        and _is_mutable_literal(default):
                    self._flag("nonhashable-static", call.lineno,
                               f"static arg #{num} ({name!r}) of "
                               f"{fn.name}() defaults to an unhashable "
                               f"mutable literal")

    # -- calls: jit-in-fn, warn-stacklevel ----------------------------
    def visit_Call(self, node: ast.Call):
        if _is_jit(node.func) and self.fn_depth > 0 \
                and id(node) not in self.self_allowed:
            self._flag("jit-in-fn", node.lineno,
                       "jit(...) constructed inside a function body — "
                       "fresh compilation cache per call")
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "warn" \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "warnings":
            if not any(kw.arg == "stacklevel" for kw in node.keywords):
                self._flag("warn-stacklevel", node.lineno,
                           "warnings.warn without stacklevel points at "
                           "the library, not the caller")
        self.generic_visit(node)


def _dunder_all(tree) -> set[str]:
    """String literals assigned (or ``+=``-extended) into ``__all__``."""
    exported = set()
    for node in ast.walk(tree):
        value = None
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets):
            value = node.value
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == "__all__":
            value = node.value
        if isinstance(value, (ast.List, ast.Tuple, ast.Set)):
            for elt in value.elts:
                if isinstance(elt, ast.Constant) \
                        and isinstance(elt.value, str):
                    exported.add(elt.value)
    return exported


def _check_unused_imports(where: str, tree, lines) -> list:
    """The ``unused-import`` rule: import bindings nothing references.

    A binding counts as *deliberately* kept when the module exports it
    through ``__all__`` (the facade re-export idiom), when it uses the
    redundant-alias form (``from m import x as x`` / ``import m as m``),
    or when the import line carries a ``# noqa`` marker (the
    pre-existing convention for side-effect imports).
    """
    exported = _dunder_all(tree)
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    findings = []

    def flag(bound: str, lineno: int, what: str):
        if bound in used or bound in exported:
            return
        line = lines[lineno - 1] if 1 <= lineno <= len(lines) else ""
        if "# noqa" in line:
            return
        if _suppressed(lines, lineno, "unused-import"):
            return
        findings.append(Finding(
            "hygiene", "unused-import", f"{where}:{lineno}",
            f"{what} is never used; re-export it via __all__, mark the "
            f"line # noqa, or drop it"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname is not None and alias.asname == alias.name:
                    continue            # import m as m — explicit re-export
                bound = alias.asname or alias.name.split(".")[0]
                flag(bound, node.lineno, f"import {alias.name!r}")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                if alias.asname is not None and alias.asname == alias.name:
                    continue            # from m import x as x — re-export
                bound = alias.asname or alias.name
                flag(bound, node.lineno,
                     f"imported name {bound!r}")
    return findings


def check_source(where: str, text: str) -> list:
    """Run all hygiene rules over one source blob."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("hygiene", "syntax-error", f"{where}:{e.lineno}",
                        str(e))]
    walker = _Walker(where, text.splitlines())
    walker.visit(tree)
    walker.findings += _check_unused_imports(where, tree,
                                             text.splitlines())
    # Module-level statics: x = jit(f, static_argnames=...) naming a
    # module function whose static default is mutable.
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for node in ast.walk(tree):
        wrapper = _jit_wrapper_call(node)
        if wrapper is None:
            continue
        target = None
        args = [a for a in wrapper.args if not _is_jit(a)]
        if args and isinstance(args[0], ast.Name):
            target = fns.get(args[0].id)
        if target is not None:
            walker._check_static(wrapper, target,
                                 _defaults_by_arg(target))
    return walker.findings


def run_hygiene_pass(root="src") -> PassResult:
    """Walk every ``.py`` under ``root`` and apply the rules."""
    rootp = pathlib.Path(root)
    findings, checked = [], 0
    for path in sorted(rootp.rglob("*.py")):
        text = path.read_text()
        findings += check_source(str(path), text)
        checked += 1
    return PassResult("hygiene", findings, checked)
