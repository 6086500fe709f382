"""Crash-consistency analysis: static persistence-order checkers (the
``MTP`` rule family) plus exhaustive crash-point enumeration of the real
durable paths (the dynamic suites behind ``crashcheck``).

Static side — four checkers over the same parsed-module set the lint
framework uses, with the lock checker's kind of call summaries so publish helpers are
seen through one level of indirection:

``MTP001`` crash-atomic publish order.  Every rename-publish of a
    ``*.tmp`` staging file (``os.replace`` / ``os.rename`` / the
    ``fsjournal`` seam equivalents) must be preceded by an fsync-carrying
    write and followed by a directory fsync, in source order within the
    publishing function (or via a callee whose effect summary carries
    the missing half).  Without the fsync the rename can be reordered
    before the data blocks by the filesystem; without the dir fsync the
    rename itself may not survive a crash.

``MTP002`` WAL-before-ack.  In functions under an ack-publisher scope
    (``CrashConfig.ack_publishers``, default ``CoordServer._serve_conn``)
    every reply-send call must be preceded by a ``wal.sync(...)`` call —
    the zero-acked-write-loss invariant reduced to source order.

``MTP003`` ordered durable sequences.  ``protocol.DURABLE_SEQUENCES``
    (read via ``ast.literal_eval``, never imported — same doctrine as
    ``JOURNALED_OPS``) declares multi-step protocols such as evict's
    ``publish file -> journal record -> drop state``.  The checker
    enumerates acyclic control-flow paths through the declared function
    (if: both arms; loops: zero or one iteration; return/raise ends the
    path; except handlers ignored; capped at ``_PATH_CAP`` paths) and
    flags any path where a later step executes before an earlier
    non-``optional`` step has.  Aborting after a prefix is LEGAL — each
    step is a crash barrier the recovery protocol tolerates; running a
    step without its prerequisites is the bug class (reorder or skip).

``MTP004`` dead crash barriers.  Every ``faults.fire("<kind>")`` site
    must be armed by at least one test: the kind string appears in the
    tests tree, either literally or via a module-level ``*FAULTS*``
    string constant that a test imports (``sim/engine.py:DEFAULT_FAULTS``
    arms ``sim_delay`` that way).  An unarmed barrier is dead chaos code
    — it can rot without any signal.

Dynamic side — each suite drives a REAL durable path (bare WAL, v1
snapshot, v2 incremental archive, evict/hydrate, hand-off apply) under
``fsjournal.recording``, then for every legal crash state of the trace
(every event prefix, plus torn tails of the interrupted write — see
``fsjournal.enumerate_crash_states`` for the bound) materializes the
state into the same directory tree and runs the real offline recovery
(``read_records`` / ``recover_shard_state``).  Certified invariants:

* zero acked-write loss: every effect acked (``fsj.mark("acked")``)
  before the crash point is present after recovery;
* exactly-once replies: the journaled reply cache is bit-identical for
  every ack not compacted away before the crash point;
* recovery idempotence: recovering the recovered state is a no-op.

Violations surface as ``MTP1xx`` findings (``MTP101`` lost acked write,
``MTP102`` reply-cache divergence, ``MTP103`` recovery crash) so the
baseline/grandfathering machinery treats both sides uniformly — though
dynamic findings are never baselined: a reproducible lost write is a bug
to fix, not to grandfather.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import shutil
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from metaopt_tpu_torch.analysis.core import Finding, LintModule, dotted_name
from metaopt_tpu_torch.analysis.registry import CrashConfig, default_crash_config

__all__ = [
    "check_crash",
    "run_suite",
    "SUITES",
    "load_durable_sequences",
]

# ---------------------------------------------------------------------------
# effect extraction
# ---------------------------------------------------------------------------

_SEAM_MODULE = "metaopt_tpu_torch.utils.fsjournal"
_SEAM_FUNCS = frozenset(
    {"write_file", "append", "replace", "unlink", "truncate",
     "fsync_dir", "mark"})

#: event kinds an effect stream may contain (the static twin of the
#: journal's trace vocabulary)
_K_FSYNCED_WRITE = "fsynced_write"   # write guaranteed durable in order
_K_REPLACE = "replace"               # rename-publish; info = src expr text
_K_DIR_FSYNC = "dir_fsync"
_K_UNLINK = "unlink"
_K_WAL_APPEND = "wal_append"         # info = op literal (or None)
_K_WAL_SYNC = "wal_sync"
_K_ACK_SEND = "ack_send"             # info = callee tail
_K_CALL = "call"                     # info = dotted name

_PATH_CAP = 512          # MTP003: max enumerated paths per function
_SUMMARY_DEPTH = 3       # call-summary recursion bound


def _seam_names(tree: ast.AST, seam: str = _SEAM_MODULE
                ) -> Tuple[Set[str], Dict[str, str]]:
    """Names bound to the fsjournal seam ``seam`` (a dotted module name) in
    this module: a set of module aliases (``fsj`` in ``import ... as fsj``,
    and the dotted name itself) and a map of directly imported function
    names (``{"replace": "replace"}``)."""
    parent, _, leaf = seam.rpartition(".")
    aliases: Set[str] = {seam}
    funcs: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == seam and a.asname:
                    aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == seam:
                for a in node.names:
                    if a.name in _SEAM_FUNCS:
                        funcs[a.asname or a.name] = a.name
            elif node.module == parent:
                for a in node.names:
                    if a.name == leaf:
                        aliases.add(a.asname or leaf)
    return aliases, funcs


def _mod_seam(mod: LintModule, cfg: CrashConfig
              ) -> Tuple[Set[str], Dict[str, str]]:
    """:func:`_seam_names` of one module, computed once per module."""
    cache = mod.__dict__.setdefault("_seam_cache", {})
    if cfg.seam_module not in cache:
        cache[cfg.seam_module] = _seam_names(mod.tree, cfg.seam_module)
    return cache[cfg.seam_module]


def _seam_func(d: str, aliases: Set[str], funcs: Dict[str, str]
               ) -> Optional[str]:
    """Canonical seam function name for dotted callee ``d``, or None."""
    if d in funcs:
        return funcs[d]
    head, _, tail = d.rpartition(".")
    if tail in _SEAM_FUNCS and head in aliases:
        return tail
    return None


def _own_statements(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a def's body WITHOUT descending into nested defs/lambdas —
    a nested def's effects belong to the nested function, which the
    framework yields separately."""
    stack = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _assignments(fn: ast.AST) -> Dict[str, str]:
    """Simple ``name = <expr>`` bindings in a def (own statements only),
    used to resolve a rename's src argument back to its staging
    expression (``tmp`` -> ``path + ".tmp"``)."""
    out: Dict[str, str] = {}
    for node in _own_statements(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                out[node.targets[0].id] = ast.unparse(node.value)
            except Exception:  # pragma: no cover - unparse is total on 3.9+
                pass
    return out


def _arg_text(node: Optional[ast.AST], assigns: Dict[str, str]) -> str:
    if node is None:
        return ""
    if isinstance(node, ast.Name) and node.id in assigns:
        return assigns[node.id]
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover
        return ""


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _wal_append_op(call: ast.Call) -> Optional[str]:
    """The ``op`` literal of a journaled record, when the record is a
    dict literal at the append site."""
    if not call.args:
        return None
    rec = call.args[0]
    if isinstance(rec, ast.Dict):
        for k, v in zip(rec.keys, rec.values):
            if (isinstance(k, ast.Constant) and k.value == "op"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                return v.value
    return None


def _classify_call(call: ast.Call, assigns: Dict[str, str],
                   aliases: Set[str], funcs: Dict[str, str],
                   cfg: CrashConfig) -> Optional[Tuple[str, Any]]:
    """Map one Call node to an effect-stream event, or None."""
    d = dotted_name(call.func)
    if d is None:
        return None
    head, _, tail = d.rpartition(".")
    seam = _seam_func(d, aliases, funcs)
    if seam is not None:
        if seam in ("write_file", "append", "truncate"):
            fsync = _kw(call, "fsync")
            if isinstance(fsync, ast.Constant) and fsync.value is False:
                return None  # explicitly unfsynced: carries no ordering
            return (_K_FSYNCED_WRITE, seam)
        if seam == "replace":
            src = call.args[0] if call.args else _kw(call, "src")
            return (_K_REPLACE, _arg_text(src, assigns))
        if seam == "unlink":
            return (_K_UNLINK, None)
        if seam == "fsync_dir":
            return (_K_DIR_FSYNC, None)
        return None  # mark: a logical label, not a persistence effect
    if d == "os.fsync" or tail == "fsync" and head not in cfg.wal_receivers:
        return (_K_FSYNCED_WRITE, "fsync")
    if tail == "fsync_dir":
        return (_K_DIR_FSYNC, None)
    if head == "os" and tail in ("replace", "rename"):
        src = call.args[0] if call.args else None
        return (_K_REPLACE, _arg_text(src, assigns))
    if head == "os" and tail in ("unlink", "remove"):
        return (_K_UNLINK, None)
    if head in cfg.wal_receivers:
        if tail == "append":
            return (_K_WAL_APPEND, _wal_append_op(call))
        if tail == "sync":
            return (_K_WAL_SYNC, None)
    if tail in cfg.ack_calls:
        return (_K_ACK_SEND, tail)
    return (_K_CALL, d)


def _effects(fn: ast.AST, mod: LintModule, aliases: Set[str],
             funcs: Dict[str, str], cfg: CrashConfig
             ) -> List[Tuple[int, str, Any]]:
    """The def's persistence-effect stream in source order (own
    statements only; nested defs excluded)."""
    assigns = _assignments(fn)
    out: List[Tuple[int, str, Any]] = []
    for node in _own_statements(fn):
        if isinstance(node, ast.Call):
            ev = _classify_call(node, assigns, aliases, funcs, cfg)
            if ev is not None:
                out.append((node.lineno, ev[0], ev[1]))
    out.sort(key=lambda e: e[0])
    return out


class _Summaries:
    """Interprocedural effect-kind summaries: which effect kinds a
    function (transitively, to a small depth) performs.  Used so MTP001
    sees an fsync or dir-fsync done by a local helper the publisher
    calls, without re-attributing the helper's findings to the caller."""

    def __init__(self, cfg: CrashConfig) -> None:
        self.cfg = cfg
        #: qualname -> (fn node, module, aliases, funcs)
        self.defs: Dict[str, Tuple[ast.AST, LintModule, Set[str],
                                   Dict[str, str]]] = {}
        self._memo: Dict[str, Set[str]] = {}

    def add_module(self, mod: LintModule) -> None:
        aliases, funcs = _mod_seam(mod, self.cfg)
        for fn, _cls in mod.functions():
            self.defs.setdefault(mod.qualname(fn), (fn, mod, aliases, funcs))

    def resolve(self, caller_qual: str, callee: str) -> Optional[str]:
        """Resolve a dotted callee to a known qualname: ``self.x`` /
        ``cls.x`` within the caller's class, bare names at module level
        (best effort; analysis summaries only need local helpers)."""
        head, _, tail = callee.rpartition(".")
        if head in ("self", "cls"):
            cls = caller_qual.rsplit(".", 2)[0] if "." in caller_qual else ""
            cand = f"{cls}.{tail}" if cls else tail
            if cand in self.defs:
                return cand
        if not head and tail in self.defs:
            return tail
        return None

    def kinds(self, qual: str, _depth: int = 0) -> Set[str]:
        if qual in self._memo:
            return self._memo[qual]
        if _depth >= _SUMMARY_DEPTH or qual not in self.defs:
            return set()
        self._memo[qual] = set()  # cycle guard
        fn, mod, aliases, funcs = self.defs[qual]
        kinds: Set[str] = set()
        for _ln, kind, info in _effects(fn, mod, aliases, funcs, self.cfg):
            if kind == _K_CALL:
                target = self.resolve(qual, info)
                if target:
                    kinds |= self.kinds(target, _depth + 1)
            else:
                kinds.add(kind)
        self._memo[qual] = kinds
        return kinds


# ---------------------------------------------------------------------------
# MTP001 — crash-atomic publish order
# ---------------------------------------------------------------------------

def _short(text: str, limit: int = 48) -> str:
    text = " ".join(text.split())
    return text if len(text) <= limit else text[:limit - 3] + "..."


def _check_publish_order(mod: LintModule, summaries: _Summaries,
                         cfg: CrashConfig) -> List[Finding]:
    findings: List[Finding] = []
    aliases, funcs = _mod_seam(mod, cfg)
    for fn, _cls in mod.functions():
        qual = mod.qualname(fn)
        evs = _effects(fn, mod, aliases, funcs, cfg)
        for i, (ln, kind, src) in enumerate(evs):
            if kind != _K_REPLACE or ".tmp" not in (src or ""):
                continue

            def _has(kinds_wanted: Set[str], window) -> bool:
                for _l, k, info in window:
                    if k in kinds_wanted:
                        return True
                    if k == _K_CALL:
                        target = summaries.resolve(qual, info)
                        if target and (kinds_wanted
                                       & summaries.kinds(target)):
                            return True
                return False

            if not _has({_K_FSYNCED_WRITE}, evs[:i]):
                findings.append(Finding(
                    rule="MTP001", file=mod.relpath, line=ln,
                    message=(f"rename-publish of {_short(src)} without a "
                             "preceding fsync'd write: the rename can hit "
                             "disk before the data it publishes"),
                    symbol=qual, detail=f"nofsync|{_short(src)}"))
            if not _has({_K_DIR_FSYNC}, evs[i + 1:]):
                findings.append(Finding(
                    rule="MTP001", file=mod.relpath, line=ln,
                    message=(f"rename-publish of {_short(src)} without a "
                             "following directory fsync: the rename itself "
                             "may not survive a crash"),
                    symbol=qual, detail=f"nodirfsync|{_short(src)}"))
    return findings


# ---------------------------------------------------------------------------
# MTP002 — WAL durable before ack leaves
# ---------------------------------------------------------------------------

def _check_wal_before_ack(mod: LintModule, cfg: CrashConfig
                          ) -> List[Finding]:
    findings: List[Finding] = []
    aliases, funcs = _mod_seam(mod, cfg)
    for fn, _cls in mod.functions():
        qual = mod.qualname(fn)
        if not any(qual == p or qual.startswith(p + ".")
                   for p in cfg.ack_publishers):
            continue
        synced = False
        for ln, kind, info in _effects(fn, mod, aliases, funcs, cfg):
            if kind == _K_WAL_SYNC:
                synced = True
            elif kind == _K_ACK_SEND and not synced:
                findings.append(Finding(
                    rule="MTP002", file=mod.relpath, line=ln,
                    message=(f"reply leaves via {info}() before any "
                             "wal.sync() in this sender: an acked write "
                             "may not be durable"),
                    symbol=qual, detail=f"unsynced|{info}"))
    return findings


# ---------------------------------------------------------------------------
# MTP003 — DURABLE_SEQUENCES path analysis
# ---------------------------------------------------------------------------

def load_durable_sequences(modules: Sequence[LintModule], cfg: CrashConfig
                           ) -> Dict[str, Dict[str, Any]]:
    """Read ``DURABLE_SEQUENCES`` out of the protocol module as a literal
    (never imported — the registry must stay readable by tooling that
    cannot import the package)."""
    if cfg.durable_sequences is not None:
        return dict(cfg.durable_sequences)
    for mod in modules:
        if not mod.relpath.endswith(cfg.protocol_module):
            continue
        for node in mod.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "DURABLE_SEQUENCES"):
                try:
                    val = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return {}
                return val if isinstance(val, dict) else {}
    return {}


class _TooManyPaths(Exception):
    pass


def _is_wal_guard(test: ast.AST, cfg: CrashConfig) -> bool:
    """``if wal is not None:`` (and friends) — the no-WAL configuration
    legitimately skips journaling steps; treating the guard as always
    true keeps MTP003 about ORDER, not about optional journaling."""
    try:
        text = ast.unparse(test)
    except Exception:  # pragma: no cover
        return False
    receivers = set(cfg.wal_receivers) | {
        r[5:] for r in cfg.wal_receivers if r.startswith("self.")}
    for r in receivers:
        if text in (r, f"self.{r}", f"{r} is not None",
                    f"self.{r} is not None"):
            return True
    return False


def _stmt_tokens(stmt: ast.AST, match) -> List[int]:
    """Step indices matched by calls inside one non-control statement,
    in source order."""
    hits: List[Tuple[int, int, int]] = []
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            for idx in match(node):
                hits.append((node.lineno, node.col_offset, idx))
        stack.extend(ast.iter_child_nodes(node))
    hits.sort()
    return [idx for _l, _c, idx in hits]


# path termination levels: how far up the control stack a path unwinds
_FALL = 0    # falls through to the next statement
_LOOP = 1    # break/continue: ends the enclosing loop body only
_FUNC = 2    # return/raise: terminates the whole function


def _paths_through(body: Sequence[ast.AST], match, cfg: CrashConfig
                   ) -> List[Tuple[List[int], int]]:
    """Acyclic ``(tokens, termination)`` paths through a statement list.
    If: both arms (wal-None guards: body only); loops: zero or one
    iteration, break/continue unwind to the loop only; try: body +
    orelse + finally, handlers ignored; return/raise end the path."""
    paths: List[Tuple[List[int], int]] = [([], _FALL)]

    def _extend(stmt_paths: List[Tuple[List[int], int]]) -> None:
        nonlocal paths
        new: List[Tuple[List[int], int]] = []
        for toks, done in paths:
            if done != _FALL:
                new.append((toks, done))
                continue
            for st, sdone in stmt_paths:
                new.append((toks + st, sdone))
        if len(new) > _PATH_CAP:
            raise _TooManyPaths()
        paths = new

    for stmt in body:
        if isinstance(stmt, ast.If):
            pre = _stmt_tokens(stmt.test, match)
            arm_paths = [(pre + p, d)
                         for p, d in _paths_through(stmt.body, match, cfg)]
            if not _is_wal_guard(stmt.test, cfg):
                if stmt.orelse:
                    arm_paths += [(pre + p, d)
                                  for p, d in _paths_through(
                                      stmt.orelse, match, cfg)]
                else:
                    arm_paths.append((pre, _FALL))
            _extend(arm_paths)
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            pre = _stmt_tokens(
                stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor))
                else stmt.test, match)
            once = _paths_through(stmt.body, match, cfg)
            # break/continue end the iteration; execution resumes after
            # the loop, so _LOOP demotes to _FALL at this level
            arm_paths = [(pre, _FALL)] + [
                (pre + p, _FALL if d == _LOOP else d) for p, d in once]
            _extend(arm_paths)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            pre = []
            for item in stmt.items:
                pre += _stmt_tokens(item.context_expr, match)
            _extend([(pre + p, d)
                     for p, d in _paths_through(stmt.body, match, cfg)])
        elif isinstance(stmt, ast.Try):
            inner = _paths_through(
                list(stmt.body) + list(stmt.orelse) + list(stmt.finalbody),
                match, cfg)
            _extend(inner)
        elif isinstance(stmt, (ast.Return, ast.Raise)):
            toks: List[int] = []
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                toks = _stmt_tokens(stmt.value, match)
            elif isinstance(stmt, ast.Raise) and stmt.exc is not None:
                toks = _stmt_tokens(stmt.exc, match)
            _extend([(toks, _FUNC)])
        elif isinstance(stmt, (ast.Break, ast.Continue)):
            _extend([([], _LOOP)])
        else:
            toks = _stmt_tokens(stmt, match)
            if toks:
                _extend([(toks, _FALL)])
    return paths


def _enumerate_paths(body: Sequence[ast.AST], match, cfg: CrashConfig
                     ) -> List[List[int]]:
    return [toks for toks, _done in _paths_through(body, match, cfg)]


def _step_matcher(steps: Sequence[str], assigns: Dict[str, str],
                  aliases: Set[str], funcs: Dict[str, str],
                  cfg: CrashConfig):
    """Compile a registry entry's step list into a Call -> [step index]
    matcher.  Vocabulary: ``publish:<suffix>`` / ``wal.append:<op>`` /
    ``wal.sync`` / ``call:<name>``."""

    def match(call: ast.Call) -> List[int]:
        ev = _classify_call(call, assigns, aliases, funcs, cfg)
        out: List[int] = []
        for idx, step in enumerate(steps):
            verb, _, arg = step.partition(":")
            if verb == "publish":
                if (ev is not None and ev[0] == _K_REPLACE
                        and arg in (ev[1] or "")):
                    out.append(idx)
            elif verb == "wal.append":
                if (ev is not None and ev[0] == _K_WAL_APPEND
                        and (not arg or ev[1] == arg)):
                    out.append(idx)
            elif verb == "wal.sync":
                if ev is not None and ev[0] == _K_WAL_SYNC:
                    out.append(idx)
            elif verb == "call":
                d = dotted_name(call.func)
                if d is not None and d.rpartition(".")[2] == arg:
                    out.append(idx)
        return out

    return match


def _check_durable_sequences(modules: Sequence[LintModule],
                             cfg: CrashConfig) -> List[Finding]:
    registry = load_durable_sequences(modules, cfg)
    findings: List[Finding] = []
    for name, entry in sorted(registry.items()):
        target = str(entry.get("function", ""))
        steps = [str(s) for s in entry.get("steps", [])]
        optional = {int(i) for i in entry.get("optional", [])}
        if not target or not steps:
            continue
        found = False
        for mod in modules:
            for fn, _cls in mod.functions():
                if mod.qualname(fn) != target:
                    continue
                found = True
                aliases, funcs = _mod_seam(mod, cfg)
                match = _step_matcher(steps, _assignments(fn), aliases,
                                      funcs, cfg)
                try:
                    paths = _enumerate_paths(fn.body, match, cfg)
                except _TooManyPaths:
                    findings.append(Finding(
                        rule="MTP003", file=mod.relpath, line=fn.lineno,
                        message=(f"durable sequence '{name}': control "
                                 f"flow exceeds {_PATH_CAP} paths — "
                                 "refactor or split the protocol body"),
                        symbol=target, detail=f"{name}|toowide"))
                    continue
                seen: Set[str] = set()
                for toks in paths:
                    state = 0
                    for idx in toks:
                        if idx < state:
                            continue  # an already-done step repeated: fine
                        missing = [j for j in range(state, idx)
                                   if j not in optional]
                        if missing:
                            key = f"{name}|{steps[idx]}"
                            if key not in seen:
                                seen.add(key)
                                findings.append(Finding(
                                    rule="MTP003", file=mod.relpath,
                                    line=fn.lineno,
                                    message=(
                                        f"durable sequence '{name}': a "
                                        f"path runs step '{steps[idx]}' "
                                        f"before required step "
                                        f"'{steps[missing[0]]}' — crash "
                                        "between them loses the ordering "
                                        "the recovery protocol assumes"),
                                    symbol=target, detail=key))
                            state = idx + 1
                        else:
                            state = idx + 1
        if not found:
            findings.append(Finding(
                rule="MTP003", file=modules[0].relpath if modules else "?",
                line=1,
                message=(f"durable sequence '{name}' names unknown "
                         f"function '{target}' — registry and code have "
                         "drifted"),
                symbol=target, detail=f"{name}|missing"))
    return findings


# ---------------------------------------------------------------------------
# MTP004 — dead crash barriers
# ---------------------------------------------------------------------------

def _fire_sites(mod: LintModule) -> List[Tuple[int, str, str]]:
    """(line, qualname, kind) for every ``faults.fire("<kind>")`` with a
    string-literal kind."""
    out: List[Tuple[int, str, str]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        if d is None:
            continue
        head, _, tail = d.rpartition(".")
        if tail != "fire" or "faults" not in head:
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.append((node.lineno, mod.qualname(node), node.args[0].value))
    return out


def _fault_constants(modules: Sequence[LintModule], cfg: CrashConfig
                     ) -> Dict[str, str]:
    """Module-level ``*FAULTS*`` string constants (name -> spec text):
    a test importing the NAME arms every kind the spec mentions."""
    out: Dict[str, str] = {}
    for mod in modules:
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if not any(m in name for m in cfg.fault_const_markers):
                continue
            try:
                val = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                continue
            if isinstance(val, str):
                out[name] = val
            elif isinstance(val, (list, tuple)) and all(
                    isinstance(v, str) for v in val):
                out[name] = ",".join(val)
    return out


def _tests_text(tests_dir: str,
                patterns: Optional[Sequence[str]] = None) -> str:
    """The text of every ``.py`` file under ``tests_dir`` (only those whose
    ``/``-separated relative path matches one of ``patterns``, if given)."""
    chunks: List[str] = []
    for dirpath, _dirs, files in sorted(os.walk(tests_dir)):
        for fname in sorted(files):
            rel = os.path.relpath(os.path.join(dirpath, fname),
                                  tests_dir).replace(os.sep, "/")
            if fname.endswith(".py") and (
                    patterns is None
                    or any(fnmatch.fnmatchcase(rel, p) for p in patterns)):
                try:
                    with open(os.path.join(dirpath, fname),
                              encoding="utf-8") as f:
                        chunks.append(f.read())
                except OSError:
                    pass
    return "\n".join(chunks)


def _check_dead_barriers(modules: Sequence[LintModule], cfg: CrashConfig,
                         tests_dir: Optional[str]) -> List[Finding]:
    if not tests_dir or not os.path.isdir(tests_dir):
        return []
    text = _tests_text(tests_dir, cfg.tests_patterns)
    consts = _fault_constants(modules, cfg)
    armed_via_const: Set[str] = set()
    for cname, spec in consts.items():
        if cname in text:
            for part in spec.split(","):
                kind = part.split(":", 1)[0].strip()
                if kind:
                    armed_via_const.add(kind)
    findings: List[Finding] = []
    for mod in modules:
        for ln, qual, kind in _fire_sites(mod):
            if kind in text or kind in armed_via_const:
                continue
            findings.append(Finding(
                rule="MTP004", file=mod.relpath, line=ln,
                message=(f"crash barrier '{kind}' is armed by no test "
                         "(not named in tests/ and not reachable through "
                         "an imported *FAULTS* constant) — dead chaos "
                         "code rots silently"),
                symbol=qual, detail=kind))
    return findings


# ---------------------------------------------------------------------------
# static entry point
# ---------------------------------------------------------------------------

def check_crash(modules: Sequence[LintModule],
                cfg: Optional[CrashConfig] = None,
                tests_dir: Optional[str] = None) -> List[Finding]:
    """Run MTP001-MTP004 over parsed modules; pragma-suppressed findings
    (``# mtpu: lint-ok MTP00x reason``) are dropped here, like every
    other checker family."""
    cfg = cfg or default_crash_config()
    summaries = _Summaries(cfg)
    for mod in modules:
        summaries.add_module(mod)
    findings: List[Finding] = []
    per_mod: Dict[str, LintModule] = {m.relpath: m for m in modules}
    for mod in modules:
        findings.extend(_check_publish_order(mod, summaries, cfg))
        findings.extend(_check_wal_before_ack(mod, cfg))
    findings.extend(_check_durable_sequences(list(modules), cfg))
    findings.extend(_check_dead_barriers(list(modules), cfg, tests_dir))
    out: List[Finding] = []
    for f in findings:
        mod = per_mod.get(f.file)
        if mod is not None and mod.suppressed(f.line, f.rule):
            continue
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# dynamic suites: drive a real durable path, enumerate its crash states,
# recover each one with the real offline recovery, certify the invariants
# ---------------------------------------------------------------------------

def _reset_tree(root: str) -> None:
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)


class _Expect:
    """What the acked prefix of a trace promises recovery will rebuild."""

    def __init__(self) -> None:
        self.trials: Set[Tuple[str, str]] = set()            # (exp, tid)
        self.signals: Set[Tuple[str, str, str]] = set()      # exp, tid, sig
        self.deleted: Set[str] = set()
        self.replies: Dict[str, Tuple[int, str]] = {}        # req -> (seq, js)
        self.compacted_upto = 0

    def apply_mark(self, meta: Dict[str, Any]) -> None:
        label = meta.get("label")
        if label == "acked":
            op = meta.get("x_op")
            exp = meta.get("x_exp")
            if op == "register":
                self.trials.add((exp, meta["x_tid"]))
                self.deleted.discard(exp)
            elif op == "set_signal":
                self.signals.add((exp, meta["x_tid"], meta["x_sig"]))
            elif op == "delete_experiment":
                self.deleted.add(exp)
                self.trials = {t for t in self.trials if t[0] != exp}
                self.signals = {s for s in self.signals if s[0] != exp}
            if meta.get("x_req"):
                self.replies[meta["x_req"]] = (
                    int(meta.get("x_seq") or 0), meta.get("x_reply") or "")
        elif label == "wal_compacted":
            self.compacted_upto = max(self.compacted_upto,
                                      int(meta.get("upto") or 0))


def _expect_at(events: Sequence[Dict[str, Any]], upto: int) -> _Expect:
    exp = _Expect()
    for e in events[:upto]:
        if e.get("kind") == "mark":
            exp.apply_mark(e)
    return exp


def _certify_state(label: str, expect: _Expect,
                   state: Dict[str, Dict[str, Any]],
                   findings: List[Finding], suite: str) -> None:
    """Compare one recovered state against the acked-prefix promises."""

    def _fail(rule: str, msg: str, detail: str) -> None:
        findings.append(Finding(
            rule=rule, file=f"<suite:{suite}>", line=0,
            message=f"crash state {label}: {msg}",
            symbol=label, detail=detail))

    recovered_replies: Dict[str, Dict[str, Any]] = {}
    trial_ids: Dict[str, Set[str]] = {}
    sig_map: Dict[Tuple[str, str], str] = {}
    for exp, st in state.items():
        trial_ids[exp] = {d["id"] for d in (st.get("trials") or [])}
        for s in st.get("signals") or []:
            sig_map[(exp, s["trial_id"])] = s["signal"]
        for r in st.get("replies") or []:
            recovered_replies[r["req"]] = r["reply"]
    for (exp, tid) in sorted(expect.trials):
        if tid not in trial_ids.get(exp, set()):
            _fail("MTP101",
                  f"acked trial {exp}/{tid} lost after recovery",
                  f"trial|{exp}|{tid}")
    for (exp, tid, sig) in sorted(expect.signals):
        got = sig_map.get((exp, tid))
        if got != sig:
            _fail("MTP101",
                  f"acked signal {exp}/{tid}={sig!r} lost after recovery "
                  f"(got {got!r})", f"signal|{exp}|{tid}")
    for exp in sorted(expect.deleted):
        if trial_ids.get(exp):
            _fail("MTP101",
                  f"acked delete of {exp} resurrected "
                  f"{len(trial_ids[exp])} trial(s)", f"delete|{exp}")
    for req, (seq, reply_js) in sorted(expect.replies.items()):
        if seq and seq <= expect.compacted_upto:
            continue  # compaction legitimately retires journaled replies
        got = recovered_replies.get(req)
        if got is None:
            _fail("MTP102", f"acked reply {req} missing from the "
                  "recovered reply cache (retry would re-execute)",
                  f"reply|{req}")
        elif json.dumps(got, sort_keys=True, default=str) != reply_js:
            _fail("MTP102", f"acked reply {req} not bit-identical after "
                  "recovery (exactly-once broken)", f"replydiff|{req}")


def _recover_files(root: str) -> Dict[str, Dict[str, Any]]:
    from metaopt_tpu_torch.coord.handoff import recover_shard_state
    snap = os.path.join(root, "snap.json")
    return recover_shard_state(snap, snap + ".wal")


def _enumerate_and_certify(root: str, events: List[Dict[str, Any]],
                           suite: str, torn_cuts: Optional[int],
                           findings: List[Finding]) -> int:
    """Materialize every crash state into ``root`` (original absolute
    paths, so evict-file references recorded in the WAL resolve) and run
    the real recovery + certifier.  Returns the state count."""
    from metaopt_tpu_torch.utils import fsjournal as fsj
    states = 0
    for label, upto, files in fsj.enumerate_crash_states(
            events, torn_cuts=torn_cuts):
        states += 1
        _reset_tree(root)
        fsj.write_tree(files, root)
        expect = _expect_at(events, upto)
        try:
            state = _recover_files(root)
            again = _recover_files(root)
        except Exception as exc:  # noqa: BLE001 - any crash is the finding
            findings.append(Finding(
                rule="MTP103", file=f"<suite:{suite}>", line=0,
                message=f"crash state {label}: recovery raised "
                        f"{type(exc).__name__}: {exc}",
                symbol=label, detail=f"raise|{type(exc).__name__}"))
            continue
        _certify_state(label, expect, state, findings, suite)
        if json.dumps(state, sort_keys=True, default=str) != \
                json.dumps(again, sort_keys=True, default=str):
            findings.append(Finding(
                rule="MTP103", file=f"<suite:{suite}>", line=0,
                message=f"crash state {label}: recovery is not "
                        "idempotent (second pass differs)",
                symbol=label, detail="nonidempotent"))
    return states


def _offline_server(root: str, **kw: Any):
    """A CoordServer used as a library: no sockets, no threads, requests
    driven straight through ``_handle`` with the sender's durability
    barrier emulated inline — deterministic by construction."""
    from metaopt_tpu_torch.coord.server import CoordServer
    server = CoordServer(
        snapshot_path=os.path.join(root, "snap.json"),
        snapshot_interval_s=3600.0,
        host_algorithms=False,
        wal_group_ms=0.0,
        **kw)
    server._recover()
    return server


def _call(server: Any, op: str, args: Dict[str, Any],
          req: Optional[str] = None, **mark_extra: Any) -> Dict[str, Any]:
    from metaopt_tpu_torch.utils import fsjournal as fsj
    msg: Dict[str, Any] = {"op": op, "args": args}
    if req is not None:
        msg["req"] = req
    reply = server._handle(msg)
    if not (isinstance(reply, dict) and reply.get("ok")):
        raise RuntimeError(f"{op} failed: {reply!r}")
    barrier = server._barrier_seq(op)
    if barrier and server._wal is not None:
        server._wal.sync(barrier)  # what the live _sender does pre-send
    fsj.mark("acked", x_op=op, x_req=req, x_seq=barrier,
             x_reply=json.dumps(reply, sort_keys=True, default=str),
             **mark_extra)
    return reply


def _trial_doc(exp: str, tid: str, x: float) -> Dict[str, Any]:
    from metaopt_tpu_torch.ledger.trial import Trial
    return Trial(params={"x": x}, experiment=exp, id=tid).to_dict()


def _drive_server_suite(root: str, incremental: bool,
                        evict: bool = False) -> List[Dict[str, Any]]:
    """The shared snapshot/archive/evict scenario: mutate, snapshot,
    mutate past the snapshot, optionally evict + touch, close."""
    from metaopt_tpu_torch.utils import fsjournal as fsj
    kw: Dict[str, Any] = {"snapshot_incremental": incremental}
    if incremental:
        kw["archive_segment_rows"] = 2
    if evict:
        kw["evict_dir"] = os.path.join(root, "evicted")
    server = _offline_server(root, **kw)
    try:
        for name in ("exp_a", "exp_b"):
            _call(server, "create_experiment",
                  {"config": {"name": name}}, req=f"c-{name}",
                  x_exp=name)
        for i in range(3):
            _call(server, "register",
                  {"trial": _trial_doc("exp_a", f"a{i}", float(i))},
                  req=f"r-a{i}", x_exp="exp_a", x_tid=f"a{i}")
        _call(server, "register",
              {"trial": _trial_doc("exp_b", "b0", 7.0)},
              req="r-b0", x_exp="exp_b", x_tid="b0")
        done = _trial_doc("exp_a", "a0", 0.0)
        done["status"] = "reserved"
        _call(server, "update_trial", {"trial": done}, req="u-a0-r",
              x_exp="exp_a", x_tid="a0")
        _call(server, "set_signal",
              {"experiment": "exp_a", "trial_id": "a1", "signal": "pause"},
              req="s-a1", x_exp="exp_a", x_tid="a1", x_sig="pause")
        server.snapshot(server.snapshot_path)
        fsj.mark("snapshot")
        # past-snapshot tail: must come back from the WAL alone
        _call(server, "register",
              {"trial": _trial_doc("exp_a", "a3", 3.0)},
              req="r-a3", x_exp="exp_a", x_tid="a3")
        if evict:
            assert server.evict_experiment("exp_b"), "evict refused"
            fsj.mark("evicted", x_exp="exp_b")
            # touching an evicted experiment hydrates it back
            _call(server, "set_signal",
                  {"experiment": "exp_b", "trial_id": "b0",
                   "signal": "pause"},
                  req="s-b0", x_exp="exp_b", x_tid="b0", x_sig="pause")
        if incremental:
            # a second snapshot: seals new segments, GCs dead ones
            _call(server, "register",
                  {"trial": _trial_doc("exp_b", "b1", 8.0)},
                  req="r-b1", x_exp="exp_b", x_tid="b1")
            server.snapshot(server.snapshot_path)
            fsj.mark("snapshot")
        _call(server, "register",
              {"trial": _trial_doc("exp_a", "a4", 4.0)},
              req="r-a4", x_exp="exp_a", x_tid="a4")
    finally:
        if server._wal is not None:
            server._wal.close()
    journal = fsj.installed()
    assert journal is not None
    return journal.snapshot()


def _suite_wal(root: str, findings: List[Finding]) -> Tuple[int, int]:
    """Bare WriteAheadLog: group commit, a v1-fallback record inside a
    v2 log (a >64-bit int defeats msgpack), compaction mid-stream.
    Every byte cut of every append is enumerated (torn_cuts=None)."""
    from metaopt_tpu_torch.coord.wal import WriteAheadLog, read_records
    from metaopt_tpu_torch.utils import fsjournal as fsj

    path = os.path.join(root, "snap.json.wal")
    with fsj.recording(root) as journal:
        wal = WriteAheadLog(path, group_window_s=0.0).open()
        acked: List[int] = []
        for i in range(4):
            seq = wal.append({"op": "set_signal", "experiment": "e",
                              "trial_id": f"t{i}", "signal": "pause"})
            wal.sync(seq)
            fsj.mark("acked_seq", seq=seq)
            acked.append(seq)
        # v1 fallback inside a v2 log: msgpack cannot carry 1 << 70
        seq = wal.append({"op": "x_mixed", "n": 1 << 70})
        wal.sync(seq)
        fsj.mark("acked_seq", seq=seq)
        wal.compact(acked[1])  # rewrite: drops seqs 1..2, keeps the tail
        for i in range(2):
            seq = wal.append({"op": "set_signal", "experiment": "e",
                              "trial_id": f"u{i}", "signal": "resume"})
            wal.sync(seq)
            fsj.mark("acked_seq", seq=seq)
        wal.close()
        events = journal.snapshot()

    states = 0
    for label, upto, files in fsj.enumerate_crash_states(events,
                                                         torn_cuts=None):
        states += 1
        _reset_tree(root)
        fsj.write_tree(files, root)
        acked_seqs: List[int] = []
        compacted = 0
        for e in events[:upto]:
            if e.get("kind") != "mark":
                continue
            if e.get("label") == "acked_seq":
                acked_seqs.append(int(e["seq"]))
            elif e.get("label") == "wal_compacted":
                compacted = max(compacted, int(e.get("upto") or 0))
        try:
            recs, torn = read_records(path, truncate_torn=True)
            recs2, torn2 = read_records(path, truncate_torn=True)
        except Exception as exc:  # noqa: BLE001
            findings.append(Finding(
                rule="MTP103", file="<suite:wal>", line=0,
                message=f"crash state {label}: read_records raised "
                        f"{type(exc).__name__}: {exc}",
                symbol=label, detail=f"raise|{type(exc).__name__}"))
            continue
        got = {r.get("seq") for r in recs}
        for seq in acked_seqs:
            if seq not in got and seq > compacted:
                findings.append(Finding(
                    rule="MTP101", file="<suite:wal>", line=0,
                    message=f"crash state {label}: acked record seq={seq} "
                            "lost after torn-tail recovery",
                    symbol=label, detail=f"seq|{seq}"))
        if torn2 != 0 or [r.get("seq") for r in recs2] != \
                [r.get("seq") for r in recs]:
            findings.append(Finding(
                rule="MTP103", file="<suite:wal>", line=0,
                message=f"crash state {label}: torn-tail truncation is "
                        "not idempotent",
                symbol=label, detail="nonidempotent"))
    return states, len(events)


def _suite_server(root: str, findings: List[Finding], suite: str,
                  incremental: bool, evict: bool) -> Tuple[int, int]:
    from metaopt_tpu_torch.utils import fsjournal as fsj
    with fsj.recording(root):
        events = _drive_server_suite(root, incremental=incremental,
                                     evict=evict)
    states = _enumerate_and_certify(root, events, suite, torn_cuts=3,
                                    findings=findings)
    return states, len(events)


def _suite_handoff(root: str, findings: List[Finding]) -> Tuple[int, int]:
    """Destination side of a shard hand-off: apply a shipped state twice
    (the retry path), certify every crash state of the dest's disk and
    end-to-end idempotence."""
    from metaopt_tpu_torch.utils import fsjournal as fsj

    tids = [f"h{i}" for i in range(3)]
    shipped = {
        "experiment": {"name": "exp_h"},
        "trials": [_trial_doc("exp_h", t, float(i))
                   for i, t in enumerate(tids)],
        "signals": [{"trial_id": "h1", "signal": "pause"}],
        "replies": [{"req": "ship-1",
                     "reply": {"ok": True, "result": {"id": "h2"}}}],
        "wal_tail": [],
    }
    with fsj.recording(root) as journal:
        server = _offline_server(root)
        try:
            for attempt in (1, 2):  # the retry after a lost ack
                out = server._handoff_apply({
                    "experiment": "exp_h",
                    "state": json.loads(json.dumps(shipped)),
                })
                if not out.get("ok"):
                    raise RuntimeError(f"handoff_apply failed: {out!r}")
                barrier = server._barrier_seq("handoff_apply")
                if barrier and server._wal is not None:
                    server._wal.sync(barrier)
                fsj.mark("acked", x_op="handoff_apply", x_seq=barrier,
                         x_exp="exp_h")
                for tid in tids:
                    fsj.mark("acked", x_op="register", x_exp="exp_h",
                             x_tid=tid)
                fsj.mark("acked", x_op="set_signal", x_exp="exp_h",
                         x_tid="h1", x_sig="pause")
        finally:
            if server._wal is not None:
                server._wal.close()
        events = journal.snapshot()

    states = _enumerate_and_certify(root, events, "handoff", torn_cuts=3,
                                    findings=findings)
    # end-to-end: the double apply must not duplicate or drop anything,
    # and the SHIPPED reply must be re-journaled on the dest
    _reset_tree(root)
    fsj.write_tree(fsj.materialize(events, len(events)), root)
    final = _recover_files(root)
    got = {d["id"] for d in (final.get("exp_h") or {}).get("trials") or []}
    if got != set(tids):
        findings.append(Finding(
            rule="MTP101", file="<suite:handoff>", line=0,
            message=f"double handoff_apply diverged: recovered trials "
                    f"{sorted(got)} != shipped {tids}",
            symbol="final", detail="applydiff"))
    if "ship-1" not in {r["req"] for st in final.values()
                        for r in (st.get("replies") or [])}:
        findings.append(Finding(
            rule="MTP102", file="<suite:handoff>", line=0,
            message="shipped reply 'ship-1' not re-journaled by "
                    "handoff_apply (retry on the survivor re-executes)",
            symbol="final", detail="reply|ship-1"))
    return states, len(events)


def _run_one(name: str) -> Tuple[List[Finding], Dict[str, Any]]:
    import tempfile
    findings: List[Finding] = []
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix=f"crashcheck-{name}-") as root:
        if name == "wal":
            states, events = _suite_wal(root, findings)
        elif name == "snapshot":
            states, events = _suite_server(root, findings, "snapshot",
                                           incremental=False, evict=False)
        elif name == "archive":
            states, events = _suite_server(root, findings, "archive",
                                           incremental=True, evict=False)
        elif name == "evict":
            states, events = _suite_server(root, findings, "evict",
                                           incremental=False, evict=True)
        elif name == "handoff":
            states, events = _suite_handoff(root, findings)
        else:
            raise ValueError(f"unknown crashcheck suite: {name!r}")
    stats = {"suite": name, "crash_states": states, "events": events,
             "runtime_s": round(time.monotonic() - t0, 3)}
    return findings, stats


SUITES = ("wal", "snapshot", "archive", "evict", "handoff")


def run_suite(name: str) -> Tuple[List[Finding], Dict[str, Any]]:
    """Run one dynamic suite; returns (findings, stats).  ``name`` must
    be one of ``SUITES``."""
    return _run_one(name)
