"""Lock-discipline checkers (MTL001-MTL004) — lockdep in miniature (port
of ``metaopt_tpu/analysis/locks.py``; the same rules and resolution).

The pass walks every function with a stack of held lock nodes (``with
self._foo:`` pushes "Class._foo"; ``with self._exp_lock(n):`` pushes the
EXP pseudo-node), records three event kinds in context — lock
acquisitions, calls, attribute writes — then:

* builds the global lock-acquisition graph (including one level of
  cross-function propagation through a name-based call graph iterated to
  a fixpoint) and reports every edge on a cycle as **MTL001**;
* reports blocking calls (fsync / socket / sleep / subprocess), direct
  or via a callee, made while holding a lock from the configured
  no-block set as **MTL002**;
* reports writes to registered guarded attributes outside their guard
  as **MTL003** (``__init__`` and ``holds(<guard>)``-annotated functions
  excepted);
* reports calls into ``holds(X)``-annotated functions from a context not
  holding X as **MTL004**.

Call resolution is deliberately conservative: ``self.m()`` resolves only
within the class, ``super().m()`` walks the scanned base-class chain
(and resolves nowhere else — bare-name fan-out across sibling classes
manufactured phantom cycles), known receiver *roles* (``self.ledger`` ->
the sharded proxy, ``self._wal`` -> the WAL) resolve through the config,
common container method names (``append``, ``get``, ...) never resolve,
and anything else resolves by bare method name across the scanned set.

Inherited locks share one graph node: ``self._kernel_lock`` acquired in a
subclass canonicalizes to the class whose ``__init__`` creates the lock
(``MOTPE._kernel_lock`` -> ``TPE._kernel_lock``), so a subclass method
holding an inherited lock while ``super()`` re-acquires sibling locks
participates in the same cycle check as the base class's own methods.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from metaopt_tpu_torch.analysis.core import Finding, LintModule, dotted_name
from metaopt_tpu_torch.analysis.registry import EXP_LOCK, LintConfig

_MUTATING_METHODS = {
    "append", "add", "pop", "popitem", "update", "setdefault", "clear",
    "extend", "remove", "discard", "insert",
}


@dataclass
class _Event:
    kind: str                  # "acquire" | "call" | "write"
    name: str                  # lock node / dotted callee / attr name
    line: int
    held: FrozenSet[str]


@dataclass
class _FuncInfo:
    mod: LintModule
    node: ast.FunctionDef
    cls: Optional[str]
    qualname: str
    holds: FrozenSet[str]
    events: List[_Event] = field(default_factory=list)
    # transitive summaries (fixpoint)
    locks: Set[str] = field(default_factory=set)
    blocking: Set[Tuple[str, str]] = field(default_factory=set)


def _norm_lock(name: str, cls: Optional[str]) -> str:
    """Bare pragma/config lock names -> graph nodes ("_lock" in class
    MemoryLedger -> "MemoryLedger._lock"; "EXP" stays)."""
    if name == EXP_LOCK or "." in name:
        return name
    return f"{cls}.{name}" if cls else name


def _looks_like_lock(attr: str) -> bool:
    return (attr.endswith("lock") or attr.endswith("guard")
            or attr in ("_cv", "_mutex") or "mutex" in attr)


class _FuncWalker(ast.NodeVisitor):
    """Collects acquire/call/write events with the held-lock stack."""

    def __init__(self, info: _FuncInfo, cfg: LintConfig,
                 owner) -> None:
        self.info = info
        self.cfg = cfg
        self.owner = owner  # (cls, attr) -> defining class for lock nodes
        self.held: Tuple[str, ...] = tuple(sorted(info.holds))

    def _emit(self, kind: str, name: str, line: int) -> None:
        self.info.events.append(
            _Event(kind, name, line, frozenset(self.held)))

    def _lock_of(self, expr: ast.AST) -> Optional[Tuple[str, List[str]]]:
        """(lock_node, locks_taken_inside) for a with-item, else None."""
        cls = self.info.cls
        if isinstance(expr, ast.Call):
            dn = dotted_name(expr.func)
            if dn:
                fac = self.cfg.lock_factories.get(dn.split(".")[-1])
                if fac:
                    return fac[0], list(fac[1])
            return None
        dn = dotted_name(expr)
        if not dn:
            return None
        parts = dn.split(".")
        attr = parts[-1]
        if parts[0] == "self" and len(parts) == 2 and cls:
            declared = self.cfg.lock_attrs.get(cls)
            if declared is not None:
                if attr in declared:
                    return f"{self.owner(cls, attr)}.{attr}", []
                return None
            if _looks_like_lock(attr):
                return f"{self.owner(cls, attr)}.{attr}", []
            return None
        if len(parts) == 1 and _looks_like_lock(attr):
            return attr, []
        return None

    # -- with / locks ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            got = self._lock_of(item.context_expr)
            if got is None:
                continue
            lock, inner = got
            self._emit("acquire", lock, node.lineno)
            for sub in inner:
                self._emit("acquire", sub, node.lineno)
            self.held = self.held + (lock,)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        if pushed:
            self.held = self.held[:-pushed]

    # -- calls -------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        dn = dotted_name(node.func)
        if dn is None and isinstance(node.func, ast.Attribute):
            attrs: List[str] = []
            cur: ast.AST = node.func
            while isinstance(cur, ast.Attribute):
                attrs.append(cur.attr)
                cur = cur.value
            if (isinstance(cur, ast.Call) and isinstance(cur.func, ast.Name)
                    and cur.func.id == "super" and len(attrs) == 1):
                # super().m(): same-object dispatch up the base chain —
                # resolved against scanned bases only, never by bare name
                # (sibling classes sharing method names otherwise create
                # phantom cross-class edges)
                dn = "super." + attrs[0]
            else:
                # call-rooted chain (``Experiment(...).configure()``): keep
                # the attribute tail so bare-name resolution still sees the
                # method — this is how the _producers_guard -> EXP edge
                # behind the delete_experiment AB-BA doctrine enters the
                # graph
                dn = "?." + ".".join(reversed(attrs))
        if dn:
            self._emit("call", dn, node.lineno)
            parts = dn.split(".")
            if len(parts) >= 2 and parts[-1] in _MUTATING_METHODS:
                # self.X.append(...) mutates self.X
                owner = dotted_name(node.func.value) if isinstance(
                    node.func, ast.Attribute) else None
                if owner:
                    op = owner.split(".")
                    if op[0] == "self" and len(op) == 2:
                        self._emit("write", op[1], node.lineno)
        self.generic_visit(node)

    # -- writes ------------------------------------------------------------
    def _write_targets(self, tgt: ast.AST, line: int) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._write_targets(e, line)
            return
        if isinstance(tgt, ast.Starred):
            self._write_targets(tgt.value, line)
            return
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        dn = dotted_name(tgt)
        if dn:
            parts = dn.split(".")
            if parts[0] == "self" and len(parts) >= 2:
                self._emit("write", parts[1], line)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._write_targets(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._write_targets(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._write_targets(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._write_targets(t, node.lineno)
        self.generic_visit(node)

    # nested defs get their own _FuncInfo; don't double-walk their bodies
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.visit(node.body)


class LockChecker:
    def __init__(self, modules: List[LintModule], cfg: LintConfig) -> None:
        self.modules = modules
        self.cfg = cfg
        self.funcs: List[_FuncInfo] = []
        self.by_class: Dict[Tuple[str, str], _FuncInfo] = {}
        self.by_name: Dict[str, List[_FuncInfo]] = {}
        self.class_bases: Dict[str, List[str]] = {}
        self.class_lock_defs: Dict[str, Set[str]] = {}
        self._hierarchy()
        self._collect()
        self._summarize()

    # -- pass 0: class hierarchy + lock-defining classes -------------------
    def _hierarchy(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                self.class_bases.setdefault(node.name, [
                    b.id for b in node.bases if isinstance(b, ast.Name)])
                defs: Set[str] = set()
                declared = self.cfg.lock_attrs.get(node.name, frozenset())
                for item in node.body:
                    if not (isinstance(item, ast.FunctionDef)
                            and item.name in self.cfg.init_methods):
                        continue
                    for sub in ast.walk(item):
                        if not isinstance(sub, ast.Assign):
                            continue
                        for tgt in sub.targets:
                            dn = dotted_name(tgt)
                            if not dn:
                                continue
                            p = dn.split(".")
                            if p[0] == "self" and len(p) == 2 and (
                                    _looks_like_lock(p[1])
                                    or p[1] in declared):
                                defs.add(p[1])
                self.class_lock_defs.setdefault(node.name, set()).update(defs)

    def _lock_owner(self, cls: str, attr: str) -> str:
        """Nearest ancestor (self included) whose __init__ creates the
        lock — inherited acquisitions share the base class's node."""
        cur, seen = cls, set()
        while cur and cur not in seen:
            seen.add(cur)
            if attr in self.class_lock_defs.get(cur, ()):
                return cur
            cur = next((b for b in self.class_bases.get(cur, ())
                        if b in self.class_bases), None)
        return cls

    def _norm(self, name: str, cls: Optional[str]) -> str:
        node = _norm_lock(name, cls)
        if cls and node == f"{cls}.{name}":
            return f"{self._lock_owner(cls, name)}.{name}"
        return node

    # -- pass 1: per-function events --------------------------------------
    def _collect(self) -> None:
        for mod in self.modules:
            for fn, cls in mod.functions():
                clsname = cls.name if cls is not None else None
                holds = frozenset(
                    self._norm(h, clsname) for h in mod.holds_locks(fn))
                info = _FuncInfo(mod, fn, clsname, mod.qualname(fn), holds)
                walker = _FuncWalker(info, self.cfg, self._lock_owner)
                for stmt in fn.body:
                    walker.visit(stmt)
                self.funcs.append(info)
                if clsname:
                    self.by_class.setdefault((clsname, fn.name), info)
                self.by_name.setdefault(fn.name, []).append(info)

    # -- call resolution ---------------------------------------------------
    def _resolve(self, dn: str, caller: _FuncInfo
                 ) -> Tuple[List[_FuncInfo], Set[str]]:
        """(callee infos, extra lock nodes acquired by the call itself).

        The extra set models the sharded-ledger proxy: a mutator call
        acquires EXP and journals into the WAL buffer even though no
        scanned function by that name does so directly.
        """
        cfg = self.cfg
        parts = dn.split(".")
        last = parts[-1]
        if parts[0] == "self" and len(parts) == 2 and caller.cls:
            hit = self.by_class.get((caller.cls, last))
            return ([hit] if hit else []), set()
        if parts[0] == "super" and len(parts) == 2 and caller.cls:
            cur, seen = caller.cls, {caller.cls}
            while True:
                cur = next((b for b in self.class_bases.get(cur, ())
                            if b in self.class_bases and b not in seen),
                           None)
                if cur is None:
                    return [], set()
                seen.add(cur)
                hit = self.by_class.get((cur, last))
                if hit:
                    return [hit], set()
        recv = parts[-2] if len(parts) >= 2 else None
        role = cfg.receiver_roles.get(recv) if recv else None
        if role == "wal":
            hit = self.by_class.get((cfg.wal_class, last))
            return ([hit] if hit else []), set()
        if role == "backend":
            hit = self.by_class.get((cfg.backend_class, last))
            return ([hit] if hit else []), set()
        if role == "proxy":
            if last in cfg.proxy_lock_free:
                return [], set()
            extra: Set[str] = set()
            if last in cfg.proxy_mutators:
                extra = {EXP_LOCK, f"{cfg.wal_class}._buf_lock"}
            hit = self.by_class.get((cfg.backend_class, last))
            return ([hit] if hit else []), extra
        if last in cfg.never_resolve:
            return [], set()
        if len(parts) == 1:
            return list(self.by_name.get(last, ())), set()
        # foreign receiver: resolve by bare method name across the set
        return [f for f in self.by_name.get(last, ())
                if f.cls and f.cls not in cfg.no_fallback_classes], set()

    # -- pass 2: transitive summaries to a fixpoint ------------------------
    def _summarize(self) -> None:
        for info in self.funcs:
            for ev in info.events:
                if ev.kind == "acquire":
                    info.locks.add(ev.name)
                elif ev.kind == "call" and self._blocking(ev.name):
                    info.blocking.add(
                        (ev.name, f"{info.mod.relpath}:{ev.line}"))
        changed = True
        while changed:
            changed = False
            for info in self.funcs:
                for ev in info.events:
                    if ev.kind != "call":
                        continue
                    callees, extra = self._resolve(ev.name, info)
                    add_locks = set(extra)
                    add_block: Set[Tuple[str, str]] = set()
                    for c in callees:
                        if c is info:
                            continue
                        add_locks |= c.locks
                        add_block |= c.blocking
                    if not add_locks <= info.locks:
                        info.locks |= add_locks
                        changed = True
                    if not add_block <= info.blocking:
                        info.blocking |= add_block
                        changed = True

    def _blocking(self, dn: str) -> bool:
        last = dn.split(".")[-1]
        for pat in self.cfg.blocking_calls:
            if "." in pat:
                if dn == pat or dn.endswith("." + pat):
                    return True
            elif last == pat:
                return True
        return False

    # -- findings ----------------------------------------------------------
    def run(self) -> List[Finding]:
        out: List[Finding] = []
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

        def edge(a: str, b: str, mod: LintModule, line: int,
                 sym: str) -> None:
            if a != b and (a, b) not in edges:
                edges[(a, b)] = (mod.relpath, line, sym)

        for info in self.funcs:
            for ev in info.events:
                if ev.kind == "acquire":
                    for h in ev.held:
                        edge(h, ev.name, info.mod, ev.line, info.qualname)
                elif ev.kind == "call":
                    callees, extra = self._resolve(ev.name, info)
                    acq = set(extra)
                    blk: Set[Tuple[str, str]] = set()
                    for c in callees:
                        if c is not info:
                            acq |= c.locks
                            blk |= c.blocking
                    for h in ev.held:
                        for l in acq:
                            if l in ev.held:
                                # re-entrant: the callee re-acquires a lock
                                # the caller already holds — no new ordering
                                continue
                            edge(h, l, info.mod, ev.line, info.qualname)
                    hot = ev.held & self.cfg.no_block_locks
                    if hot:
                        held = ",".join(sorted(hot))
                        if self._blocking(ev.name):
                            out.append(self._f(
                                "MTL002", info, ev.line,
                                f"blocking call {ev.name}() while holding "
                                f"{held}", detail=f"{ev.name}|{held}"))
                        else:
                            for bname, bloc in sorted(blk):
                                out.append(self._f(
                                    "MTL002", info, ev.line,
                                    f"call {ev.name}() reaches blocking "
                                    f"{bname}() (at {bloc}) while holding "
                                    f"{held}",
                                    detail=f"{ev.name}>{bname}|{held}"))
                    # MTL004: holds-contract at the call site
                    for c in callees:
                        need = c.holds - ev.held
                        if need and c is not info:
                            out.append(self._f(
                                "MTL004", info, ev.line,
                                f"call {ev.name}() requires "
                                f"{','.join(sorted(need))} held "
                                f"(holds pragma on {c.qualname})",
                                detail=f"{ev.name}|"
                                       f"{','.join(sorted(need))}"))
                elif ev.kind == "write":
                    out.extend(self._check_write(info, ev))

        out.extend(self._cycles(edges))
        return [f for f in out if not self._suppressed(f)]

    def _check_write(self, info: _FuncInfo, ev: _Event) -> List[Finding]:
        if not info.cls or info.node.name in self.cfg.init_methods:
            return []
        guard = self.cfg.guarded_attrs.get(info.cls, {}).get(ev.name)
        if guard is None or guard in ev.held or guard in info.holds:
            return []
        return [self._f(
            "MTL003", info, ev.line,
            f"write to {info.cls}.{ev.name} outside its guard {guard}",
            detail=f"{ev.name}|{guard}")]

    def _cycles(self, edges: Dict[Tuple[str, str],
                                  Tuple[str, int, str]]) -> List[Finding]:
        adj: Dict[str, Set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        # nodes reachable from b back to a => edge a->b is on a cycle
        out: List[Finding] = []
        for (a, b), (relpath, line, sym) in sorted(edges.items()):
            stack, seen = [b], {b}
            on_cycle = False
            while stack:
                n = stack.pop()
                if n == a:
                    on_cycle = True
                    break
                for m in adj.get(n, ()):
                    if m not in seen:
                        seen.add(m)
                        stack.append(m)
            if on_cycle:
                out.append(Finding(
                    "MTL001", relpath, line,
                    f"lock-order inversion: {a} -> {b} completes a cycle "
                    f"(potential deadlock)", symbol=sym,
                    detail=f"{a}->{b}"))
        return out

    def _f(self, rule: str, info: _FuncInfo, line: int, msg: str,
           detail: str = "") -> Finding:
        return Finding(rule, info.mod.relpath, line, msg,
                       symbol=info.qualname, detail=detail)

    def _suppressed(self, f: Finding) -> bool:
        for mod in self.modules:
            if mod.relpath == f.file:
                return mod.suppressed(f.line, f.rule)
        return False


def check_locks(modules: List[LintModule], cfg: LintConfig
                ) -> List[Finding]:
    return LockChecker(modules, cfg).run()
