"""Durability-contract checkers (MTD001-MTD004); port of
``metaopt_tpu/analysis/durability.py``, reading the port's protocol.

The contract (coord/protocol.py, "Durability semantics"): once the reply
to a mutating op is on the wire, the mutation and its reply-cache entry
are fsynced. Statically that decomposes into:

* the protocol module *declares* which ops journal
  (``JOURNALED_OPS`` / ``REPLY_JOURNALED_OPS`` / ``NESTED_JOURNALED_OPS``);
* every declared-journaled op's ``_dispatch`` branch must reach a
  journal point — a sharded-ledger mutator call (which journals inside
  the experiment lock) or a direct ``self._wal.append`` — else
  **MTD001**;
* the registries must not drift from the server's op sets: every op in
  ``_MUTATING_OPS`` is declared journaled, and every declared-journaled
  op is in ``_DURABLE_OPS`` so its reply actually waits on the fsync
  barrier — else **MTD002**;
* reply-journaled ops (``worker_cycle``) must call ``_journal_reply`` in
  their ``_handle_<op>`` handler — else **MTD003**;
* the binary wire's opcode table (``WIRE_OPCODES``) must cover every
  mutating/journaled op (a v2 request for one would otherwise carry the
  opcode-0 "unknown" hint, losing routing observability for exactly the
  ops whose retries depend on the reply cache), and opcode values must
  be unique and nonzero (they are on the wire; 0 is reserved for
  not-in-table) — else **MTD004**. Modules with no ``WIRE_OPCODES``
  declaration skip the check: a repo (or fixture) without the binary
  wire has nothing to drift.

The checker reads both the registry and the server sets from the AST
(never imports), so fixture modules in tests exercise it hermetically.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from metaopt_tpu_torch.analysis.core import Finding, LintModule, dotted_name
from metaopt_tpu_torch.analysis.registry import LintConfig, registry_frozensets

_REGISTRY_NAMES = {"JOURNALED_OPS", "REPLY_JOURNALED_OPS",
                   "NESTED_JOURNALED_OPS"}
_SERVER_SETS = {"_MUTATING_OPS", "_DURABLE_OPS", "_MUTATORS"}
_WIRE_TABLE_NAME = "WIRE_OPCODES"


def _wire_opcodes(modules: List[LintModule]
                  ) -> Tuple[Optional[Dict[str, int]],
                             Optional[LintModule], int]:
    """The binary wire's op→opcode table, parsed from whichever scanned
    module declares it (``WIRE_OPCODES = {...}``, plain or annotated
    assignment). None when no module declares one — MTD004 then has
    nothing to check."""
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                tgt, val = node.target, node.value
            else:
                continue
            if not (isinstance(tgt, ast.Name)
                    and tgt.id == _WIRE_TABLE_NAME):
                continue
            try:
                d = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                continue
            if isinstance(d, dict) and all(
                    isinstance(k, str) and isinstance(v, int)
                    for k, v in d.items()):
                return d, mod, node.lineno
    return None, None, 0


def _find_registry(modules: List[LintModule], cfg: LintConfig
                   ) -> Tuple[Dict[str, FrozenSet[str]],
                              Optional[LintModule]]:
    """The declared op registries: from the config when set explicitly
    (tests), else parsed out of the protocol module."""
    reg: Dict[str, FrozenSet[str]] = {}
    if cfg.journaled_ops is not None:
        reg["JOURNALED_OPS"] = cfg.journaled_ops
        reg["REPLY_JOURNALED_OPS"] = cfg.reply_journaled_ops or frozenset()
        reg["NESTED_JOURNALED_OPS"] = (cfg.nested_journaled_ops
                                       or frozenset())
        return reg, None
    for mod in modules:
        if mod.relpath.endswith(cfg.protocol_module):
            got = registry_frozensets(mod, _REGISTRY_NAMES)
            if "JOURNALED_OPS" in got:
                for k in _REGISTRY_NAMES:
                    reg[k] = got.get(k, frozenset())
                return reg, mod
    return reg, None


def _server_class(mod: LintModule) -> Optional[ast.ClassDef]:
    """The class that declares op sets and a dispatch method."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            names = {t.id for s in node.body
                     if isinstance(s, ast.Assign)
                     for t in s.targets if isinstance(t, ast.Name)}
            if "_MUTATING_OPS" in names or "_DURABLE_OPS" in names:
                return node
    return None


def _branch_ops(test: ast.AST, op_var: str) -> Set[str]:
    """Op literals a dispatch ``if`` guards: ``op == "register"`` or
    ``op in ("a", "b")``."""
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return set()
    left = test.left
    if not (isinstance(left, ast.Name) and left.id == op_var):
        return set()
    cmp = test.comparators[0]
    if isinstance(test.ops[0], ast.Eq) and isinstance(cmp, ast.Constant) \
            and isinstance(cmp.value, str):
        return {cmp.value}
    if isinstance(test.ops[0], ast.In) and isinstance(
            cmp, (ast.Tuple, ast.List, ast.Set)):
        return {e.value for e in cmp.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)}
    return set()


def _journals(body: List[ast.stmt], cfg: LintConfig) -> bool:
    """Does this dispatch branch reach a journal point?"""
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func)
            if dn is None:
                continue
            parts = dn.split(".")
            last = parts[-1]
            if last in ("_journal_mutation", "_journal_reply"):
                return True
            recv = parts[-2] if len(parts) >= 2 else None
            if last == "append" and recv in cfg.journal_receivers:
                return True
            if recv is not None and cfg.receiver_roles.get(
                    recv) == "proxy" and last in cfg.proxy_mutators:
                return True
    return False


def check_durability(modules: List[LintModule], cfg: LintConfig
                     ) -> List[Finding]:
    out: List[Finding] = []
    reg, reg_mod = _find_registry(modules, cfg)
    server_mod: Optional[LintModule] = None
    server_cls: Optional[ast.ClassDef] = None
    for mod in modules:
        cls = _server_class(mod)
        if cls is not None:
            server_mod, server_cls = mod, cls
            break
    if server_cls is None or server_mod is None:
        return out
    sets = registry_frozensets(server_mod, _SERVER_SETS)
    mutating = sets.get("_MUTATING_OPS", frozenset())
    durable = sets.get("_DURABLE_OPS", frozenset())
    journaled = reg.get("JOURNALED_OPS", frozenset())
    reply_j = reg.get("REPLY_JOURNALED_OPS", frozenset())
    nested_j = reg.get("NESTED_JOURNALED_OPS", frozenset())
    cls_line = server_cls.lineno
    reg_file = reg_mod.relpath if reg_mod else server_mod.relpath

    if not reg:
        out.append(Finding(
            "MTD002", server_mod.relpath, cls_line,
            "no JOURNALED_OPS registry found for a server class with "
            "declared op sets", symbol=server_cls.name, detail="missing"))
        return out

    # registry drift (MTD002)
    for op in sorted(mutating - (journaled | reply_j | nested_j)):
        out.append(Finding(
            "MTD002", reg_file, 1,
            f"op {op!r} is in _MUTATING_OPS but not declared in the "
            f"journaled-ops registry", symbol=server_cls.name,
            detail=f"undeclared|{op}"))
    for op in sorted((journaled | reply_j | nested_j) - durable):
        out.append(Finding(
            "MTD002", server_mod.relpath, cls_line,
            f"op {op!r} is declared journaled but missing from "
            f"_DURABLE_OPS — its reply never waits on the fsync barrier",
            symbol=server_cls.name, detail=f"nobarrier|{op}"))

    # dispatch branches (MTD001)
    dispatch: Optional[ast.FunctionDef] = None
    handlers: Dict[str, ast.FunctionDef] = {}
    for node in server_cls.body:
        if isinstance(node, ast.FunctionDef):
            if node.name == cfg.dispatch_function:
                dispatch = node
            handlers[node.name] = node
    seen_ops: Set[str] = set()
    if dispatch is not None:
        for node in ast.walk(dispatch):
            if not isinstance(node, ast.If):
                continue
            ops = _branch_ops(node.test, cfg.dispatch_op_var)
            seen_ops |= ops
            need = ops & journaled
            if need and not _journals(node.body, cfg):
                out.append(Finding(
                    "MTD001", server_mod.relpath, node.lineno,
                    f"dispatch branch for {'/'.join(sorted(need))} "
                    f"mutates without reaching a wal.append/journal "
                    f"call", symbol=f"{server_cls.name}."
                    f"{cfg.dispatch_function}",
                    detail="|".join(sorted(need))))
    for op in sorted(journaled - seen_ops):
        out.append(Finding(
            "MTD001", server_mod.relpath,
            dispatch.lineno if dispatch else cls_line,
            f"declared-journaled op {op!r} has no dispatch branch",
            symbol=server_cls.name, detail=f"nobranch|{op}"))

    # reply-journaled handlers (MTD003)
    for op in sorted(reply_j):
        h = handlers.get(f"_handle_{op}")
        if h is None:
            out.append(Finding(
                "MTD003", server_mod.relpath, cls_line,
                f"reply-journaled op {op!r} has no _handle_{op} handler",
                symbol=server_cls.name, detail=f"nohandler|{op}"))
            continue
        called = any(
            isinstance(n, ast.Call)
            and (dotted_name(n.func) or "").endswith("_journal_reply")
            for n in ast.walk(h))
        if not called:
            out.append(Finding(
                "MTD003", server_mod.relpath, h.lineno,
                f"_handle_{op} never journals its reply "
                f"(_journal_reply) — retries across a restart "
                f"double-execute", symbol=f"{server_cls.name}."
                f"_handle_{op}", detail=f"nojournal|{op}"))

    # binary-wire opcode table vs the durability contract (MTD004)
    table = cfg.wire_opcodes
    wire_mod: Optional[LintModule] = None
    wire_line = cls_line
    if table is None:
        table, wire_mod, wire_line = _wire_opcodes(modules)
    if table is not None:
        wire_file = wire_mod.relpath if wire_mod else reg_file
        need = journaled | reply_j | nested_j | mutating
        for op in sorted(need - set(table)):
            out.append(Finding(
                "MTD004", wire_file, wire_line,
                f"mutating/journaled op {op!r} has no WIRE_OPCODES "
                f"entry — its binary-wire requests degrade to the "
                f"opcode-0 'unknown' hint", symbol=_WIRE_TABLE_NAME,
                detail=f"missing|{op}"))
        codes: Dict[int, str] = {}
        for op, code in table.items():
            if code == 0:
                out.append(Finding(
                    "MTD004", wire_file, wire_line,
                    f"op {op!r} is assigned opcode 0, the reserved "
                    f"not-in-table value", symbol=_WIRE_TABLE_NAME,
                    detail=f"reserved|{op}"))
            elif code in codes:
                out.append(Finding(
                    "MTD004", wire_file, wire_line,
                    f"opcode {code} is assigned to both {codes[code]!r} "
                    f"and {op!r} — opcodes are on the wire and must be "
                    f"unique", symbol=_WIRE_TABLE_NAME,
                    detail=f"dup|{code}"))
            else:
                codes[code] = op
    return [f for f in out if not _suppressed(modules, f)]


def _suppressed(modules: List[LintModule], f: Finding) -> bool:
    for mod in modules:
        if mod.relpath == f.file:
            return mod.suppressed(f.line, f.rule)
    return False
