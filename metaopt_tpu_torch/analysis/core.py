"""Shared plumbing for the ``lint`` checkers (port of
``metaopt_tpu/analysis/core.py``).

One :class:`LintModule` per source file: the parsed AST, a parent map
(for enclosing-function/class lookup), the raw source lines, and every
``# mtpu:`` pragma found in the file, indexed by line. Checkers never
re-read files — they get the loaded modules and a
:class:`~metaopt_tpu_torch.analysis.registry.LintConfig`.

Pragma grammar (one per comment; the comment may trail code)::

    # mtpu: hotpath
    # mtpu: holds(<lock>[, <lock>...])
    # mtpu: lint-ok <RULE> [free-text reason]

``hotpath`` and ``holds`` attach to the ``def`` they annotate (same line
as the ``def``, or the line directly above it). ``lint-ok`` suppresses
one rule on exactly the line it sits on.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

_PRAGMA_RE = re.compile(r"#\s*mtpu:\s*(.+?)\s*$")
_HOLDS_RE = re.compile(r"holds\(([^)]*)\)")
_LINT_OK_RE = re.compile(r"lint-ok\s+([A-Z]{3}\d{3})")


@dataclass(frozen=True)
class Finding:
    """One lint finding: rule + location + a stable identity.

    ``symbol`` is the enclosing ``Class.function`` qualname and ``detail``
    a short rule-specific key (attr/op/lock names) — together with the
    rule and file they form the baseline fingerprint, which survives
    line-number drift from unrelated edits.
    """

    rule: str
    file: str
    line: int
    message: str
    symbol: str = ""
    detail: str = ""

    def fingerprint(self) -> str:
        return "::".join((self.rule, self.file, self.symbol, self.detail))

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


class LintModule:
    """A parsed source file plus the lookup tables checkers need."""

    def __init__(self, path: str, relpath: str, source: str) -> None:
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self._functions: Optional[List[Tuple[ast.AST,
                                             Optional[ast.ClassDef]]]] = None
        # line -> raw pragma payloads ("hotpath", "holds(_lock)", ...)
        self.pragmas: Dict[int, List[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m:
                self.pragmas.setdefault(i, []).append(m.group(1))

    # -- pragma queries ----------------------------------------------------
    def _def_pragmas(self, fn: ast.AST) -> List[str]:
        """Pragmas attached to a def: on its line or the line above
        (above any decorators)."""
        first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
        out: List[str] = []
        for ln in (first - 1, fn.lineno):
            out.extend(self.pragmas.get(ln, ()))
        return out

    def is_hotpath(self, fn: ast.AST) -> bool:
        return any(p.startswith("hotpath") for p in self._def_pragmas(fn))

    def holds_locks(self, fn: ast.AST) -> Set[str]:
        """Lock names a ``holds(...)`` pragma asserts the caller owns."""
        out: Set[str] = set()
        for p in self._def_pragmas(fn):
            m = _HOLDS_RE.search(p)
            if m:
                out.update(s.strip() for s in m.group(1).split(",")
                           if s.strip())
        return out

    def suppressed(self, line: int, rule: str) -> bool:
        for p in self.pragmas.get(line, ()):
            m = _LINT_OK_RE.search(p)
            if m and m.group(1) == rule:
                return True
        return False

    # -- structure queries -------------------------------------------------
    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None

    def qualname(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def functions(self) -> Iterable[Tuple[ast.FunctionDef,
                                          Optional[ast.ClassDef]]]:
        """Every def with its enclosing class, in ``ast.walk`` order
        (computed once per module: every checker family asks)."""
        if self._functions is None:
            self._functions = [
                (node, self.enclosing_class(node))
                for node in ast.walk(self.tree)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return iter(self._functions)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``self._wal.append`` -> "self._wal.append"; None when the callee is
    not a plain name/attribute chain (subscripts, calls, lambdas)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_hashable_literal(node: ast.AST) -> bool:
    """Conservative: literals that are certainly hashable."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Tuple):
        return all(is_hashable_literal(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                    ast.Constant):
        return True
    return False


def load_paths(paths: Iterable[str], root: Optional[str] = None
               ) -> List[LintModule]:
    """Load every ``.py`` under the given files/directories (sorted,
    deterministic). ``relpath`` is relative to ``root`` (default: cwd)."""
    root = os.path.abspath(root or os.getcwd())
    files: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    modules: List[LintModule] = []
    for f in sorted(set(files)):
        rel = os.path.relpath(f, root)
        with open(f, "r", encoding="utf-8") as fh:
            src = fh.read()
        try:
            modules.append(LintModule(f, rel, src))
        except SyntaxError as e:  # pragma: no cover - repo parses clean
            raise SyntaxError(f"lint: cannot parse {rel}: {e}") from e
    return modules
