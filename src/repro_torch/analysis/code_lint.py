"""Stdlib-AST code lint: the local stand-in for the ruff gate (the port of
:mod:`repro.analysis.code_lint`, the same rules).

CI runs ruff (``[tool.ruff]`` in pyproject.toml) — but ruff is an
optional install, and the analysis gate must work on a bare interpreter.
This module re-implements the violation classes the repo actually gates
on, using only ``ast``:

* **unused imports** (F401): an imported name never read anywhere in the
  module (``__init__.py`` re-exports and ``__all__`` entries excepted);
* **undefined exports**: an ``__all__`` string naming nothing defined or
  imported at module level;
* **mutable default arguments**: a ``list``/``dict``/``set`` literal or
  constructor call as a parameter default;
* **shadowed builtins**: a function/class/assignment binding over a
  curated set of builtins where shadowing is overwhelmingly a bug
  (``list``/``dict``/``set``/… — deliberately NOT ``l``/``id``-style
  single letters the numeric code uses idiomatically);
* **bare except**: ``except:`` with no exception class (E722).

Findings come back as :class:`repro_torch.analysis.Finding` values with the
file and line.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Set

from repro_torch.analysis import Finding

# Builtins whose shadowing is gated. Deliberately excludes single-letter
# math/softmax names (l, id-style) the numeric code uses idiomatically.
SHADOW_BUILTINS = {"list", "dict", "set", "tuple", "str", "bytes", "type",
                   "object", "print", "open", "isinstance", "getattr",
                   "setattr", "super", "property", "staticmethod",
                   "classmethod", "enumerate", "zip", "map"}


def _imported_names(tree: ast.Module):
    """(alias node, bound name, lineno) for every module-level import."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out.append((a, (a.asname or a.name).split(".")[0],
                            node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                out.append((a, a.asname or a.name, node.lineno))
    return out


def _used_names(tree: ast.Module) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    for node in ast.walk(tree):          # strings in __all__ count as usage
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for el in ast.walk(node.value):
                        if isinstance(el, ast.Constant) \
                                and isinstance(el.value, str):
                            used.add(el.value)
    return used


def _module_bindings(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _is_mutable_default(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set"))


def lint_source(src: str, path: str) -> List[Finding]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("code-lint", path,
                        f"syntax error at line {e.lineno}: {e.msg}")]
    findings: List[Finding] = []
    is_init = Path(path).name == "__init__.py"

    used = _used_names(tree)
    if not is_init:                      # __init__ re-exports are the point
        for a, name, lineno in _imported_names(tree):
            if a.asname is not None and a.asname == a.name:
                continue                 # `import X as X`: explicit re-export
            if name not in used and not name.startswith("_"):
                findings.append(Finding(
                    "code-lint", path,
                    f"line {lineno}: unused import '{name}'"))

    bound = _module_bindings(tree) | {n for _, n, _l in
                                      _imported_names(tree)}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__" \
                        and isinstance(node.value, (ast.List, ast.Tuple)):
                    for el in node.value.elts:
                        if isinstance(el, ast.Constant) \
                                and isinstance(el.value, str) \
                                and el.value not in bound:
                            findings.append(Finding(
                                "code-lint", path,
                                f"line {node.lineno}: __all__ exports "
                                f"undefined name '{el.value}'"))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in list(node.args.defaults) \
                    + [d for d in node.args.kw_defaults if d is not None]:
                if _is_mutable_default(d):
                    findings.append(Finding(
                        "code-lint", path,
                        f"line {node.lineno}: function '{node.name}' has a "
                        f"mutable default argument"))
        elif isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append(Finding(
                "code-lint", path,
                f"line {node.lineno}: bare 'except:' (catch a class)"))

    # Shadowing is gated at MODULE level only (a method named ``set`` is
    # normal API; a module-level ``list = ...`` is a landmine).
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) \
                and node.name in SHADOW_BUILTINS:
            findings.append(Finding(
                "code-lint", path,
                f"line {node.lineno}: module-level '{node.name}' shadows "
                f"a builtin"))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in SHADOW_BUILTINS:
                    findings.append(Finding(
                        "code-lint", path,
                        f"line {node.lineno}: module-level assignment "
                        f"shadows builtin '{t.id}'"))
    return findings


def lint_paths(roots: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for root in roots:
        p = Path(root)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings += lint_source(f.read_text(), str(f))
    return findings
