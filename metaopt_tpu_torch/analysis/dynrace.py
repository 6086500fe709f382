"""``race`` — hybrid lockset + vector-clock race detection (port of
``metaopt_tpu/analysis/dynrace.py``, scoped to ``metaopt_tpu_torch``).

The static linter proves lock-ORDER discipline from AST facts; it
cannot see interleaving-sensitive bugs (a write published outside its
guard is only a race if some unordered thread reads it). This module adds
the dynamic half and the static glue between them:

**Static (MTR001)** — extends the lint registry: the *shared-attribute
set* is every attribute with a ``holds()``/``guarded_attrs`` declaration
plus every attribute written from ≥ 2 thread entry points in the
lock-order call graph (thread entry points = ``Thread(target=...)`` /
``self._spawn(...)`` targets found in the AST, plus declared extras).
A shared-written attribute with NO guard declaration is a finding: the
declaration is what wires the attribute into both MTL003 and the dynamic
instrumentation below, so "undeclared shared write" means "invisible to
every checker".

**Dynamic (MTR101/MTR102)** — Eraser-style lockset refined with
FastTrack-style vector-clock epochs (Savage et al. 1997; Flanagan &
Freund 2009). Inside :func:`instrument`, ``threading.Lock/RLock/
Condition``, ``threading.Thread.start/join``, ``threading.Event`` and
``queue.Queue`` are wrapped so acquire/release/fork/join/wait/notify/
put/get maintain per-thread vector clocks, and every guard-declared
class gets ``__setattr__``/``__getattribute__`` hooks. Each access to a
monitored attribute records an epoch ``(tid, clock)``, the thread's held
lockset and a cheap stack; two accesses to the same attribute race
(**MTR101**) when they come from different threads, at least one is a
write, their locksets are disjoint AND neither epoch happens-before the
other's clock. Nested acquisitions also feed a runtime lock-order graph
whose cycles are **MTR102** (the dynamic mirror of MTL001 — it sees
locks the AST cannot name, e.g. per-experiment RLock families, which
collapse to one node by creation site exactly like the EXP pseudo-node).
Both report with the stacks of BOTH sides.

Wrapped primitives keep working after :func:`instrument` exits (event
emission is gated on the runtime's ``active`` flag), so objects built
under instrumentation survive it.

Locks that PyTorch (or Triton) itself creates inside the instrumented
region are wrapped like any other, so their release→acquire edges still
order accesses, but they never enter the lock-order graph: a cycle through
a framework's private lock is not one the port can reorder, and MTR102
stays about the locks the port and its callers make.

Rule table:

========  ============================================================
MTR001    shared-written attribute lacks a guard declaration (static)
MTR101    data race: unordered accesses with disjoint locksets (dynamic)
MTR102    lock-order inversion observed at runtime (dynamic)
========  ============================================================
"""

from __future__ import annotations

import ast
import itertools
import os
import queue as _queue_mod
import sys
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from metaopt_tpu_torch.analysis.core import Finding, LintModule, dotted_name
from metaopt_tpu_torch.analysis.locks import LockChecker, _looks_like_lock
from metaopt_tpu_torch.analysis.registry import LintConfig, RaceConfig

# The runtime's own synchronization must bypass the wrappers (a wrapped
# lock inside the event handler would recurse), so the real primitives
# are captured at import time, before any instrument() patches land.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_THREAD_START = threading.Thread.start
_REAL_THREAD_JOIN = threading.Thread.join
_REAL_EVENT_SET = threading.Event.set
_REAL_EVENT_WAIT = threading.Event.wait
_REAL_QUEUE_PUT = _queue_mod.Queue.put
_REAL_QUEUE_GET = _queue_mod.Queue.get

_STACK_DEPTH = 14
_PKG_FILE_MARK = os.sep + "metaopt_tpu_torch" + os.sep
#: creation sites inside these packages mark a lock as the framework's own
_FOREIGN_FILE_MARKS = tuple(os.sep + p + os.sep for p in ("torch", "triton"))
_SELF_FILE = os.path.abspath(__file__)


def _fast_stack(skip: int = 2) -> Tuple[Tuple[str, int, str], ...]:
    """A cheap stack: (abspath, lineno, funcname) per frame, innermost
    first, without touching source files (formatted lazily at report
    time). ~1-2us vs ~50us for traceback.extract_stack."""
    out: List[Tuple[str, int, str]] = []
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow stack
        return ()
    while f is not None and len(out) < _STACK_DEPTH:
        code = f.f_code
        if code.co_filename != _SELF_FILE:
            out.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    return tuple(out)


def _render_stack(stack: Tuple[Tuple[str, int, str], ...],
                  indent: str = "      ") -> str:
    import linecache

    lines = []
    for fname, lineno, func in stack:
        short = fname
        mark = short.rfind(_PKG_FILE_MARK)
        if mark != -1:
            short = short[mark + 1:]
        else:
            short = os.path.basename(short)
        src = linecache.getline(fname, lineno).strip()
        lines.append(f"{indent}{short}:{lineno} in {func}"
                     + (f"  `{src}`" if src else ""))
    return "\n".join(lines)


def _primary_frame(stack: Tuple[Tuple[str, int, str], ...]
                   ) -> Tuple[str, int, str]:
    """Innermost frame inside the scanned package (falls back to the
    innermost frame) — the finding's file:line anchor."""
    for fname, lineno, func in stack:
        if _PKG_FILE_MARK in fname:
            return fname, lineno, func
    return stack[0] if stack else ("<unknown>", 0, "<unknown>")


# ---------------------------------------------------------------------------
# vector clocks
# ---------------------------------------------------------------------------


def _merge(dst: Dict[int, int], src: Dict[int, int]) -> None:
    for tid, c in src.items():
        if dst.get(tid, 0) < c:
            dst[tid] = c


class _SyncMeta:
    """Per-primitive state: identity, a human label, and the vector clock
    last published into it (release / put / set)."""

    __slots__ = ("uid", "label", "vc", "site", "foreign")

    def __init__(self, uid: int, label: str, site: str,
                 foreign: bool = False) -> None:
        self.uid = uid
        self.label = label
        self.vc: Dict[int, int] = {}
        self.site = site
        #: created by the framework (see the module docstring)
        self.foreign = foreign


class _ThreadState:
    __slots__ = ("tid", "ident", "name", "vc", "held")

    def __init__(self, tid: int, ident: int) -> None:
        self.tid = tid
        self.ident = ident
        self.name: Optional[str] = None  # resolved lazily (see _state)
        self.vc: Dict[int, int] = {tid: 1}
        #: _SyncMeta -> recursion count (lockset = keys with count > 0)
        self.held: Dict[_SyncMeta, int] = {}

    @property
    def label(self) -> str:
        return self.name or f"thread-{self.ident}"


class _Access:
    __slots__ = ("tid", "clock", "lockset", "stack", "thread", "write")

    def __init__(self, st: _ThreadState, lockset: FrozenSet[int],
                 stack, write: bool) -> None:
        self.tid = st.tid
        self.clock = st.vc[st.tid]
        self.lockset = lockset
        self.stack = stack
        self.thread = st.label
        self.write = write


class _AttrState:
    """FastTrack-shaped per-(object, attr) history: the last write plus
    the most recent read per thread since that write."""

    __slots__ = ("write", "reads")

    def __init__(self) -> None:
        self.write: Optional[_Access] = None
        self.reads: Dict[int, _Access] = {}


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


class RaceRuntime:
    """Event sink for the wrapped primitives and attribute hooks.

    One instance per :func:`instrument` context. All shared structures
    are guarded by one real (unwrapped) lock; the event volume of the
    designated suites is small enough that a single lock beats the
    complexity of sharding the detector itself.
    """

    def __init__(self, monitor: Dict[type, FrozenSet[str]],
                 root: Optional[str] = None) -> None:
        #: class -> attrs to check (already MRO-merged by the caller)
        self.monitor = monitor
        self.root = os.path.abspath(root or os.getcwd())
        self.active = False
        self._big = _REAL_LOCK()
        self._local = threading.local()
        self._uids = itertools.count(1)
        self._tids = itertools.count(1)
        #: thread ident -> state (ident reuse after a join is tolerated:
        #: the dead thread's clock was already merged by on_join)
        self._states: Dict[int, _ThreadState] = {}
        #: (id(obj), clsname, attr) -> history; obj kept alive in _pins so
        #: a recycled id can never alias two objects' histories
        self._attrs: Dict[Tuple[int, str, str], _AttrState] = {}
        self._pins: Dict[int, Any] = {}
        #: (label_a, label_b) -> (stack, thread_name) of first observation
        self._edges: Dict[Tuple[str, str], Tuple[Any, str]] = {}
        #: report key -> Finding (dedup across the run)
        self._reports: Dict[Tuple, Finding] = {}
        self.events = 0

    # -- thread state ------------------------------------------------------
    def _state(self) -> _ThreadState:
        # NEVER threading.current_thread() here: a just-born thread emits
        # its first event (``_started.set()`` in _bootstrap_inner) BEFORE
        # registering in threading._active, and current_thread() would
        # mint a _DummyThread whose __init__ itself sets a wrapped Event
        # — unbounded recursion. get_ident() allocates nothing.
        st = getattr(self._local, "st", None)
        if st is None:
            ident = threading.get_ident()
            with self._big:
                st = _ThreadState(next(self._tids), ident)
                self._states[ident] = st
            self._local.st = st
        if st.name is None:
            t = threading._active.get(st.ident)  # plain dict read
            if t is not None:
                st.name = t.name
                fork_vc = getattr(t, "_mtpu_race_fork_vc", None)
                if fork_vc:
                    _merge(st.vc, fork_vc)
                    st.vc[st.tid] = st.vc.get(st.tid, 0) + 1
        return st

    def _lockset(self, st: _ThreadState) -> FrozenSet[int]:
        return frozenset(m.uid for m, n in st.held.items() if n > 0)

    # -- sync events -------------------------------------------------------
    def new_meta(self, kind: str, skip: int = 2) -> _SyncMeta:
        """Label by creation site (file:line) — every lock minted at the
        same line is one graph node, which is exactly the EXP pseudo-node
        doctrine for per-experiment RLock families. The label is refined
        to ``Class.attr`` when the object is later assigned onto a
        monitored class (see the setattr hook)."""
        foreign = False
        try:
            f = sys._getframe(skip)
            while f is not None and f.f_code.co_filename == _SELF_FILE:
                f = f.f_back
            site = (f"{os.path.basename(f.f_code.co_filename)}:"
                    f"{f.f_lineno}" if f is not None else "?")
            foreign = f is not None and any(
                m in f.f_code.co_filename for m in _FOREIGN_FILE_MARKS)
        except ValueError:  # pragma: no cover
            site = "?"
        uid = next(self._uids)
        return _SyncMeta(uid, f"{kind}@{site}", site, foreign)

    def on_acquire(self, meta: _SyncMeta, stack_skip: int = 3) -> None:
        if not self.active:
            return
        st = self._state()
        with self._big:
            self.events += 1
            prev = st.held.get(meta, 0)
            if prev:  # re-entrant: no ordering, no new HB information
                st.held[meta] = prev + 1
                return
            _merge(st.vc, meta.vc)
            for held, n in st.held.items():
                if meta.foreign or held.foreign:
                    continue
                if n > 0 and held.label != meta.label:
                    key = (held.label, meta.label)
                    if key not in self._edges:
                        self._edges[key] = (_fast_stack(stack_skip),
                                            st.label)
            st.held[meta] = 1

    def on_release(self, meta: _SyncMeta) -> None:
        if not self.active:
            return
        st = self._state()
        with self._big:
            self.events += 1
            n = st.held.get(meta, 0)
            if n > 1:
                st.held[meta] = n - 1
                return
            st.held.pop(meta, None)
            _merge(meta.vc, st.vc)
            st.vc[st.tid] += 1

    def on_publish(self, meta: _SyncMeta) -> None:
        """Event.set / queue.put: one-way clock transfer to the object."""
        if not self.active:
            return
        st = self._state()
        with self._big:
            self.events += 1
            _merge(meta.vc, st.vc)
            st.vc[st.tid] += 1

    def on_receive(self, meta: _SyncMeta) -> None:
        """Successful Event.wait / queue.get: merge the published clock."""
        if not self.active:
            return
        st = self._state()
        with self._big:
            self.events += 1
            _merge(st.vc, meta.vc)

    def on_wait_release(self, meta: _SyncMeta) -> int:
        """Condition.wait entry: the wait fully releases the cv lock
        (RLocks release every recursion level); returns the count to
        restore on wake."""
        if not self.active:
            return 0
        st = self._state()
        with self._big:
            self.events += 1
            n = st.held.pop(meta, 0)
            if n:
                _merge(meta.vc, st.vc)
                st.vc[st.tid] += 1
            return n

    def on_wait_wake(self, meta: _SyncMeta, count: int) -> None:
        if not self.active:
            return
        st = self._state()
        with self._big:
            self.events += 1
            _merge(st.vc, meta.vc)
            if count:
                st.held[meta] = st.held.get(meta, 0) + count

    def on_fork(self, child: threading.Thread) -> None:
        if not self.active:
            return
        st = self._state()
        with self._big:
            self.events += 1
            child._mtpu_race_fork_vc = dict(st.vc)  # type: ignore[attr-defined]
            st.vc[st.tid] += 1

    def on_join(self, child: threading.Thread) -> None:
        if not self.active or child.is_alive():
            return
        ident = child.ident
        st = self._state()
        with self._big:
            self.events += 1
            cst = self._states.get(ident) if ident is not None else None
            if cst is not None:
                _merge(st.vc, cst.vc)

    # -- attribute accesses ------------------------------------------------
    def on_access(self, obj: Any, clsname: str, attr: str,
                  write: bool) -> None:
        if not self.active:
            return
        if getattr(self._local, "in_hook", False):
            return  # the handler itself must never re-enter
        self._local.in_hook = True
        try:
            st = self._state()
            acc = _Access(st, self._lockset(st), _fast_stack(3), write)
            with self._big:
                self.events += 1
                key = (id(obj), clsname, attr)
                hist = self._attrs.get(key)
                if hist is None:
                    hist = self._attrs[key] = _AttrState()
                    self._pins.setdefault(id(obj), obj)
                if write:
                    if hist.write is not None:
                        self._check_pair(clsname, attr, hist.write, acc,
                                         st.vc)
                    for r in hist.reads.values():
                        self._check_pair(clsname, attr, r, acc, st.vc)
                    hist.write = acc
                    hist.reads.clear()
                else:
                    if hist.write is not None:
                        self._check_pair(clsname, attr, hist.write, acc,
                                         st.vc)
                    hist.reads[acc.tid] = acc
        finally:
            self._local.in_hook = False

    def _check_pair(self, clsname: str, attr: str, prev: _Access,
                    cur: _Access, cur_vc: Dict[int, int]) -> None:
        """Report when prev/cur conflict: different threads, at least one
        write, disjoint locksets, and prev NOT happens-before cur (the
        FastTrack epoch test: cur's clock component for prev's thread is
        older than prev's epoch)."""
        if prev.tid == cur.tid:
            return
        if not (prev.write or cur.write):
            return
        if prev.lockset & cur.lockset:
            return
        if cur_vc.get(prev.tid, 0) >= prev.clock:
            return  # ordered by a tracked sync edge
        sym_prev = _primary_frame(prev.stack)[2]
        sym_cur = _primary_frame(cur.stack)[2]
        key = ("MTR101", clsname, attr, frozenset((sym_prev, sym_cur)))
        if key in self._reports:
            return
        fname, lineno, _ = _primary_frame(cur.stack)
        kind = "write/write" if (prev.write and cur.write) else "read/write"
        msg = (
            f"data race on {clsname}.{attr} ({kind}): unordered accesses "
            f"with disjoint locksets\n"
            f"    {'write' if prev.write else 'read'} by thread "
            f"{prev.thread} [{self._fmt_lockset(prev.lockset)}]:\n"
            f"{_render_stack(prev.stack)}\n"
            f"    {'write' if cur.write else 'read'} by thread "
            f"{cur.thread} [{self._fmt_lockset(cur.lockset)}]:\n"
            f"{_render_stack(cur.stack)}"
        )
        self._reports[key] = Finding(
            "MTR101", self._rel(fname), lineno, msg,
            symbol=f"{clsname}.{attr}",
            detail="|".join(sorted((sym_prev, sym_cur))))

    def _fmt_lockset(self, lockset: FrozenSet[int]) -> str:
        if not lockset:
            return "no locks held"
        labels = sorted(self._label_of.get(uid, f"#{uid}")
                        for uid in lockset)
        return "holding " + ",".join(labels)

    #: uid -> current label; maintained by the labeling hook
    @property
    def _label_of(self) -> Dict[int, str]:
        d = getattr(self, "_label_cache", None)
        if d is None:
            d = self._label_cache = {}
        return d

    def note_label(self, meta: _SyncMeta, label: str) -> None:
        """Refine a creation-site label to ``Class.attr`` (first naming
        wins: a lock shared across attrs keeps its original name)."""
        with self._big:
            if "@" in meta.label:
                meta.label = label
            self._label_of[meta.uid] = meta.label

    def seen_label(self, meta: _SyncMeta) -> None:
        with self._big:
            self._label_of.setdefault(meta.uid, meta.label)

    # -- findings ----------------------------------------------------------
    def _rel(self, fname: str) -> str:
        try:
            rel = os.path.relpath(os.path.abspath(fname), self.root)
        except ValueError:  # pragma: no cover - windows drive mismatch
            return fname
        return rel if not rel.startswith("..") else fname

    def findings(self) -> List[Finding]:
        """Race reports plus lock-order cycles from the dynamic graph."""
        out = list(self._reports.values())
        adj: Dict[str, Set[str]] = {}
        for a, b in self._edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        for (a, b), (stack, tname) in sorted(self._edges.items()):
            # edge a->b is on a cycle iff a is reachable from b
            stack_, seen = [b], {b}
            on_cycle = False
            while stack_:
                n = stack_.pop()
                if n == a:
                    on_cycle = True
                    break
                for m in adj.get(n, ()):
                    if m not in seen:
                        seen.add(m)
                        stack_.append(m)
            if not on_cycle:
                continue
            fname, lineno, sym = _primary_frame(stack)
            msg = (f"lock-order inversion observed at runtime: {a} -> {b} "
                   f"completes a cycle\n    {a} -> {b} by thread {tname}:\n"
                   f"{_render_stack(stack)}")
            rev = self._edges.get((b, a))
            if rev is not None:
                msg += (f"\n    {b} -> {a} by thread {rev[1]}:\n"
                        f"{_render_stack(rev[0])}")
            key = ("MTR102", a, b)
            if key not in self._reports:
                self._reports[key] = Finding(
                    "MTR102", self._rel(fname), lineno, msg, symbol=sym,
                    detail=f"{a}->{b}")
                out.append(self._reports[key])
        out.sort(key=lambda f: (f.file, f.line, f.rule, f.detail))
        return out


# ---------------------------------------------------------------------------
# wrapped primitives
# ---------------------------------------------------------------------------


class _WrappedLock:
    """Instrumented Lock/RLock. Delegates to the real primitive; event
    emission is gated on the runtime's ``active`` flag so instances
    outlive their instrument() context safely."""

    def __init__(self, rt: RaceRuntime, real: Any, meta: _SyncMeta) -> None:
        self._rt = rt
        self._real = real
        self._meta = meta
        rt.seen_label(meta)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._real.acquire(blocking, timeout)
        if got:
            self._rt.on_acquire(self._meta)
        return got

    def release(self) -> None:
        self._rt.on_release(self._meta)
        self._real.release()

    def __enter__(self) -> "_WrappedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __getattr__(self, name: str) -> Any:  # _at_fork_reinit etc.
        return getattr(self._real, name)


class _WrappedCondition:
    """Instrumented Condition. Built either standalone (fresh inner
    RLock) or over a :class:`_WrappedLock`, in which case the condition
    IS that lock's node (same meta) — mirroring how ``queue.Queue``
    shares one mutex across its three conditions."""

    def __init__(self, rt: RaceRuntime, lock: Any = None,
                 meta: Optional[_SyncMeta] = None) -> None:
        self._rt = rt
        if isinstance(lock, _WrappedLock):
            self._meta = lock._meta
            self._real = _REAL_CONDITION(lock._real)
        elif lock is not None:  # a real, uninstrumented lock
            self._meta = meta or rt.new_meta("Condition", skip=3)
            self._real = _REAL_CONDITION(lock)
        else:
            self._meta = meta or rt.new_meta("Condition", skip=3)
            self._real = _REAL_CONDITION(_REAL_RLOCK())
        rt.seen_label(self._meta)

    def acquire(self, *args: Any) -> bool:
        got = self._real.acquire(*args)
        if got:
            self._rt.on_acquire(self._meta)
        return got

    def release(self) -> None:
        self._rt.on_release(self._meta)
        self._real.release()

    def __enter__(self) -> "_WrappedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        n = self._rt.on_wait_release(self._meta)
        try:
            return self._real.wait(timeout)
        finally:
            self._rt.on_wait_wake(self._meta, n)

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        # re-implemented over our wait() so every wake re-merges clocks
        import time as _time

        end = None if timeout is None else _time.monotonic() + timeout
        result = predicate()
        while not result:
            rem = None if end is None else end - _time.monotonic()
            if rem is not None and rem <= 0:
                break
            self.wait(rem)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._real, name)


# ---------------------------------------------------------------------------
# instrumentation: patches + class hooks
# ---------------------------------------------------------------------------

_LOCKISH = (_WrappedLock, _WrappedCondition)


def _install_class_hooks(rt: RaceRuntime) -> List[Tuple[type, str, Any, bool]]:
    """Hook ``__setattr__``/``__getattribute__`` on every monitored class.

    The setattr hook does double duty: it reports writes to monitored
    attrs AND names any lock/condition assigned onto the class
    (``self._buf_lock = Lock()`` -> node "WriteAheadLog._buf_lock").
    Returns an undo list of (cls, name, original, was_inherited).
    """
    undo: List[Tuple[type, str, Any, bool]] = []
    for cls, attrs in rt.monitor.items():
        clsname = cls.__name__
        orig_set = cls.__setattr__
        orig_get = cls.__getattribute__
        attrset = frozenset(attrs)

        def make_set(orig_set: Any, clsname: str, attrset: FrozenSet[str]):
            def hooked_setattr(self: Any, name: str, value: Any) -> None:
                if isinstance(value, _LOCKISH):
                    rt.note_label(value._meta, f"{clsname}.{name}")
                if name in attrset:
                    rt.on_access(self, clsname, name, write=True)
                orig_set(self, name, value)
            return hooked_setattr

        def make_get(orig_get: Any, clsname: str, attrset: FrozenSet[str]):
            def hooked_getattribute(self: Any, name: str) -> Any:
                if name in attrset:
                    rt.on_access(self, clsname, name, write=False)
                return orig_get(self, name)
            return hooked_getattribute

        undo.append((cls, "__setattr__", cls.__dict__.get("__setattr__"),
                     "__setattr__" not in cls.__dict__))
        undo.append((cls, "__getattribute__",
                     cls.__dict__.get("__getattribute__"),
                     "__getattribute__" not in cls.__dict__))
        cls.__setattr__ = make_set(orig_set, clsname, attrset)  # type: ignore[assignment]
        cls.__getattribute__ = make_get(orig_get, clsname, attrset)  # type: ignore[assignment]
    return undo


def _uninstall_class_hooks(undo: List[Tuple[type, str, Any, bool]]) -> None:
    for cls, name, orig, was_inherited in undo:
        if was_inherited:
            try:
                delattr(cls, name)
            except AttributeError:  # pragma: no cover
                pass
        else:
            setattr(cls, name, orig)


@contextmanager
def instrument(rt: RaceRuntime):
    """Patch the synchronization primitives and install attribute hooks
    for the duration of the block. Not re-entrant; one active runtime
    per process."""

    def lock_factory() -> _WrappedLock:
        return _WrappedLock(rt, _REAL_LOCK(), rt.new_meta("Lock"))

    def rlock_factory() -> _WrappedLock:
        return _WrappedLock(rt, _REAL_RLOCK(), rt.new_meta("RLock"))

    def condition_factory(lock: Any = None) -> _WrappedCondition:
        return _WrappedCondition(rt, lock)

    def thread_start(self: threading.Thread) -> None:
        rt.on_fork(self)
        return _REAL_THREAD_START(self)

    def thread_join(self: threading.Thread,
                    timeout: Optional[float] = None) -> None:
        _REAL_THREAD_JOIN(self, timeout)
        rt.on_join(self)

    def _obj_meta(obj: Any, kind: str) -> _SyncMeta:
        meta = obj.__dict__.get("_mtpu_race_meta")
        if meta is None:
            meta = rt.new_meta(kind, skip=3)
            obj.__dict__["_mtpu_race_meta"] = meta
        return meta

    def event_set(self: threading.Event) -> None:
        rt.on_publish(_obj_meta(self, "Event"))
        return _REAL_EVENT_SET(self)

    def event_wait(self: threading.Event,
                   timeout: Optional[float] = None) -> bool:
        got = _REAL_EVENT_WAIT(self, timeout)
        if got:
            rt.on_receive(_obj_meta(self, "Event"))
        return got

    def queue_put(self: Any, item: Any, block: bool = True,
                  timeout: Optional[float] = None) -> None:
        # publish BEFORE the item becomes visible to a getter
        rt.on_publish(_obj_meta(self, "Queue"))
        return _REAL_QUEUE_PUT(self, item, block, timeout)

    def queue_get(self: Any, block: bool = True,
                  timeout: Optional[float] = None) -> Any:
        item = _REAL_QUEUE_GET(self, block, timeout)
        rt.on_receive(_obj_meta(self, "Queue"))
        return item

    undo_hooks = _install_class_hooks(rt)
    threading.Lock = lock_factory  # type: ignore[misc]
    threading.RLock = rlock_factory  # type: ignore[misc]
    threading.Condition = condition_factory  # type: ignore[misc]
    threading.Thread.start = thread_start  # type: ignore[method-assign]
    threading.Thread.join = thread_join  # type: ignore[method-assign]
    threading.Event.set = event_set  # type: ignore[method-assign]
    threading.Event.wait = event_wait  # type: ignore[method-assign]
    _queue_mod.Queue.put = queue_put  # type: ignore[method-assign]
    _queue_mod.Queue.get = queue_get  # type: ignore[method-assign]
    rt.active = True
    try:
        yield rt
    finally:
        rt.active = False
        threading.Lock = _REAL_LOCK  # type: ignore[misc]
        threading.RLock = _REAL_RLOCK  # type: ignore[misc]
        threading.Condition = _REAL_CONDITION  # type: ignore[misc]
        threading.Thread.start = _REAL_THREAD_START  # type: ignore[method-assign]
        threading.Thread.join = _REAL_THREAD_JOIN  # type: ignore[method-assign]
        threading.Event.set = _REAL_EVENT_SET  # type: ignore[method-assign]
        threading.Event.wait = _REAL_EVENT_WAIT  # type: ignore[method-assign]
        _queue_mod.Queue.put = _REAL_QUEUE_PUT  # type: ignore[method-assign]
        _queue_mod.Queue.get = _REAL_QUEUE_GET  # type: ignore[method-assign]
        _uninstall_class_hooks(undo_hooks)


def monitored_classes(cfg: LintConfig, race_cfg: RaceConfig
                      ) -> Dict[type, FrozenSet[str]]:
    """Resolve the monitor map: import each declared class and merge the
    guarded-attr declarations down its MRO (a mixin's declarations apply
    to every concrete adopter), minus the unlocked-read/exempt lists."""
    out: Dict[type, FrozenSet[str]] = {}
    for clsname, modpath in sorted(race_cfg.monitor_modules.items()):
        import importlib

        cls = getattr(importlib.import_module(modpath), clsname)
        attrs: Set[str] = set()
        for k in cls.__mro__:
            attrs |= set(cfg.guarded_attrs.get(k.__name__, ()))
            attrs |= race_cfg.extra_monitored.get(k.__name__, set())
        attrs -= {a for c, a in race_cfg.race_exempt
                  if c in {k.__name__ for k in cls.__mro__}}
        if attrs:
            out[cls] = frozenset(attrs)
    return out


# ---------------------------------------------------------------------------
# static half: the shared-attribute set + MTR001
# ---------------------------------------------------------------------------


def _thread_targets(checker: LockChecker) -> Dict[str, Any]:
    """Thread entry points found in the AST: ``Thread(target=X)`` (any
    receiver spelling) and ``self._spawn(X, ...)``. Returns
    {root_qualname: _FuncInfo}."""
    roots: Dict[str, Any] = {}

    def add(info: Any) -> None:
        if info is not None:
            roots.setdefault(info.qualname, info)

    for mod in checker.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func)
            target_expr = None
            if dn and dn.split(".")[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target_expr = kw.value
            elif dn and dn.split(".")[-1] == "_spawn" and node.args:
                target_expr = node.args[0]
            if target_expr is None:
                continue
            tdn = dotted_name(target_expr)
            if not tdn:
                continue
            parts = tdn.split(".")
            cls = mod.enclosing_class(node)
            clsname = cls.name if cls is not None else None
            if parts[0] == "self" and len(parts) == 2 and clsname:
                add(checker.by_class.get((clsname, parts[1])))
            elif len(parts) == 1:
                # nested worker fn (``target=work``): same module, and the
                # spawning function's qualname is a prefix of the worker's
                outer = mod.qualname(node)
                for info in checker.by_name.get(parts[0], ()):
                    if info.mod is mod and info.qualname.startswith(outer):
                        add(info)
    return roots


def _threadlocal_attrs(checker: LockChecker, cfg: LintConfig
                       ) -> Set[Tuple[str, str]]:
    """(class, attr) pairs assigned ``threading.local()`` in an init
    method — per-thread by construction, never shared."""
    out: Set[Tuple[str, str]] = set()
    for info in checker.funcs:
        if not info.cls or info.node.name not in cfg.init_methods:
            continue
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Assign):
                continue
            dn = dotted_name(node.value.func) if isinstance(
                node.value, ast.Call) else None
            if not dn or dn.split(".")[-1] != "local":
                continue
            for tgt in node.targets:
                tdn = dotted_name(tgt)
                if tdn and tdn.startswith("self.") and tdn.count(".") == 1:
                    out.add((info.cls, tdn.split(".")[1]))
    return out


def compute_shared_attrs(checker: LockChecker, cfg: LintConfig,
                         race_cfg: RaceConfig
                         ) -> Dict[Tuple[str, str],
                                   Tuple[Set[str], FrozenSet[str]]]:
    """(class, attr) -> (entry-point qualnames that can write it, the
    intersection of locksets over every such write path).

    The BFS from each thread entry point carries the locks held along
    the path (a call made under ``with self._exp_lock(n):`` protects the
    whole subtree, including the sharded-ledger proxy's implicit EXP),
    so a write counts as *unprotected sharing* only when two entry
    points reach it and no single lock covers all the paths — a static
    Eraser lockset, not mere reachability.
    """
    roots = dict(_thread_targets(checker))
    for qn in race_cfg.entry_points:
        for info in checker.funcs:
            if info.qualname == qn:
                roots.setdefault(qn, info)
    #: (cls, attr) -> {root: intersection of per-write locksets}
    shared: Dict[Tuple[str, str], Dict[str, FrozenSet[str]]] = {}
    for root_qn, root in sorted(roots.items()):
        # visited[id(info)] = held-sets already walked; a superset of a
        # walked set can only see MORE protection, so it is skipped
        visited: Dict[int, List[FrozenSet[str]]] = {}
        stack: List[Tuple[Any, FrozenSet[str]]] = [
            (root, frozenset(root.holds))]
        while stack:
            info, held = stack.pop()
            done = visited.setdefault(id(info), [])
            if any(h <= held for h in done):
                continue
            done.append(held)
            for ev in info.events:
                here = held | ev.held
                if ev.kind == "write" and info.cls:
                    if info.node.name in cfg.init_methods:
                        continue
                    per_root = shared.setdefault((info.cls, ev.name), {})
                    prev = per_root.get(root_qn)
                    per_root[root_qn] = (here if prev is None
                                         else prev & here)
                elif ev.kind == "call":
                    callees, extra = checker._resolve(ev.name, info)
                    for c in callees:
                        if c is not info:
                            stack.append(
                                (c, here | extra | frozenset(c.holds)))
    out: Dict[Tuple[str, str], Tuple[Set[str], FrozenSet[str]]] = {}
    for key, per_root in shared.items():
        if len(per_root) < 2:
            continue
        common = frozenset.intersection(*per_root.values())
        if not common:
            out[key] = (set(per_root), common)
    return out


def check_shared(modules: List[LintModule], cfg: LintConfig,
                 race_cfg: RaceConfig,
                 checker: Optional[LockChecker] = None) -> List[Finding]:
    """MTR001: shared-written attribute without a guard declaration.

    Scope is the *declared concurrency surface* — classes that own locks
    (``lock_attrs``), already guard attrs (``guarded_attrs``), or are
    dynamically monitored (``monitor_modules``). A class in that set has
    announced itself thread-shared; its shared-written but undeclared
    attrs are the blind spots of both MTL003 and the instrumentation.
    Classes outside it are left to the dynamic detector (the bare-name
    static call graph is too coarse to accuse them soundly).
    """
    checker = checker or LockChecker(modules, cfg)
    surface = (set(cfg.lock_attrs) | set(cfg.guarded_attrs)
               | set(race_cfg.monitor_modules))
    tlocal = _threadlocal_attrs(checker, cfg)
    shared = compute_shared_attrs(checker, cfg, race_cfg)
    out: List[Finding] = []
    for (clsname, attr), (roots, _) in sorted(shared.items()):
        if clsname not in surface:
            continue
        if attr in cfg.guarded_attrs.get(clsname, ()):
            continue  # declared: MTL003 + the dynamic hooks cover it
        if (clsname, attr) in race_cfg.race_exempt:
            continue
        if (clsname, attr) in tlocal:
            continue  # threading.local: per-thread by construction
        if attr in cfg.lock_attrs.get(clsname, set()) or _looks_like_lock(
                attr):
            continue  # the lock IS the synchronization
        # anchor at the first write site in qualname order
        site = None
        for info in checker.funcs:
            if info.cls != clsname:
                continue
            if info.node.name in cfg.init_methods:
                continue
            for ev in info.events:
                if ev.kind == "write" and ev.name == attr:
                    cand = (info.mod.relpath, ev.line, info.qualname)
                    if site is None or cand < site:
                        site = cand
        if site is None:
            continue
        relpath, line, sym = site
        out.append(Finding(
            "MTR001", relpath, line,
            f"{clsname}.{attr} is written from {len(roots)} thread entry "
            f"points ({', '.join(sorted(roots))}) with no common lock and "
            f"no guard declaration (guarded_attrs/holds) — invisible to "
            f"MTL003 and to `race` instrumentation",
            symbol=sym, detail=attr))
    return [f for f in out if not _suppressed(modules, f)]


def _suppressed(modules: List[LintModule], f: Finding) -> bool:
    for mod in modules:
        if mod.relpath == f.file:
            return mod.suppressed(f.line, f.rule)
    return False
