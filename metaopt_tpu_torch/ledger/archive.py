"""Columnar archive for completed trials — flat RSS at millions of trials.

Port of ``metaopt_tpu/ledger/archive.py`` (numpy only, no torch), with
the snapshot-manifest exports that the coordinator's incremental snapshots
read.

``completed`` is a terminal status (ledger/trial.py ``_TRANSITIONS``): once
a trial lands there the only thing that ever touches it again is a read
(fetch / export / observe) or an explicit revival (``db set`` /
``put_trial`` replay rewriting it back to ``new``). Keeping each one as a
resident :class:`Trial` object costs ~1.5 KB of Python object graph per
trial; a million-trial experiment is gigabytes of dicts that are never
mutated. This module stores them structure-of-arrays instead:

* a bounded mutable **head** accumulates raw trial docs as they complete;
* at ``segment_rows`` the head is **sealed** into an immutable
  :class:`_Segment` — numpy columns for params (the ``Space.stack_points``
  column contract: one column per param key), objective, the four
  timestamps, and the 24-hex ids (a fixed-width ``S24`` byte column —
  one shared Python str per trial is most of the RSS the columns save);
  uniform object columns (lineage / result name / worker / exit code)
  constant-fold to a single scalar;
* the sealed-row **id index** is a pair of parallel sorted numpy arrays
  (``S24`` key → packed ``segment << 40 | row`` int64) merged on each
  seal — ~32 bytes per trial where a dict of str→tuple costs ~200. Only
  the unsealed head keeps a real dict; ids that don't fit the fixed
  24-byte ASCII shape fall back to a tiny overflow dict;
* materialization is **lazy and bit-identical**: sealing decodes every row
  back and compares it to the original ``to_dict`` output — any row the
  columns cannot represent exactly (multi-objective results, non-empty
  ``resources``, a promoted ``parent``, NaN values, foreign key orders)
  drops to a per-row ``overflow`` doc instead of being approximated. There
  is no conformance assumption to get wrong: the verify IS the contract.
* **revival** is a liveness flip, not a rewrite: ``discard`` removes the
  id from the position index and marks the row dead; a re-completion
  appends a fresh row. Segment columns are append-only and immutable,
  which is what lets the snapshot manifest reference sealed segments by
  id and write each segment file exactly once (coord/server.py
  incremental snapshots).

Locking: every public method takes the internal segment lock; the owning
:class:`MemoryLedger` additionally serializes callers under its own
``_lock`` (lock order: ``MemoryLedger._lock`` →
``ExperimentArchive._seg_lock``, never the reverse — the archive never
calls back into the ledger).
"""

from __future__ import annotations

import sys
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from metaopt_tpu_torch.ledger.trial import Trial, _copy_json_tree

#: ``Trial.to_dict`` key order — materialized docs must reproduce it so a
#: sealed/unsealed trial serializes identically to the resident one
_TIME_KEYS = ("submit_time", "start_time", "end_time", "heartbeat")

#: packed sealed position: ``segment_index << _ROW_BITS | row``
_ROW_BITS = 40
_ROW_MASK = (1 << _ROW_BITS) - 1


def _id_key(trial_id: str) -> Optional[bytes]:
    """``trial_id`` as a sorted-index key, or None if it doesn't fit the
    fixed-width column (non-ASCII, empty, longer than 24 bytes, or ending
    in a NUL — numpy ``S24`` pads with NULs and strips them on read, so a
    trailing NUL wouldn't round-trip)."""
    try:
        b = trial_id.encode("ascii")
    except UnicodeEncodeError:
        return None
    if not b or len(b) > 24 or b[-1:] == b"\x00":
        return None
    return b


class _Segment:
    """One sealed batch of completed-trial rows.

    Columns are immutable after sealing; the only mutable member is
    ``dead`` — the append-only set of rows whose trial was revived (the
    id now lives elsewhere). ``overflow`` maps row→original doc for rows
    the columnar encoding could not reproduce bit-identically.
    """

    __slots__ = ("seg_id", "experiment", "count", "ids", "key_order",
                 "pcols", "lineage", "res_name", "objective", "times",
                 "tmask", "worker", "exit_code", "overflow", "dead")

    @staticmethod
    def _cell(col, row):
        """Object-column accessor: a uniform column constant-folds to its
        single value at seal, so it's either a list or that scalar."""
        return col[row] if isinstance(col, list) else col

    def decode(self, row: int) -> Dict[str, Any]:
        """Reconstruct row ``row``'s ``to_dict`` doc — a fresh tree every
        call (callers mutate trials; clone-on-read is the ledger contract).
        """
        over = self.overflow.get(row)
        if over is not None:
            return _copy_json_tree(over)
        params: Dict[str, Any] = {}
        for k in self.key_order:
            col = self.pcols[k]
            v = col[row]
            params[k] = v.item() if isinstance(col, np.ndarray) \
                else _copy_json_tree(v)
        doc: Dict[str, Any] = {
            "id": self.ids[row].decode(),
            "lineage": self._cell(self.lineage, row),
            "experiment": self.experiment,
            "params": params,
            "status": "completed",
            "results": [{"name": self._cell(self.res_name, row),
                         "type": "objective",
                         "value": float(self.objective[row])}],
        }
        for tk in _TIME_KEYS:
            doc[tk] = None if self.tmask[tk][row] \
                else float(self.times[tk][row])
        doc["worker"] = self._cell(self.worker, row)
        doc["resources"] = {}
        doc["parent"] = None
        doc["exit_code"] = self._cell(self.exit_code, row)
        return doc

    def worker_of(self, row: int) -> Optional[str]:
        over = self.overflow.get(row)
        if over is not None:
            return over.get("worker")
        return self._cell(self.worker, row)

    def submit_time_of(self, row: int) -> Optional[float]:
        over = self.overflow.get(row)
        if over is not None:
            return over.get("submit_time")
        if self.tmask["submit_time"][row]:
            return None
        return float(self.times["submit_time"][row])


def _seal_segment(experiment: str, seg_id: str,
                  docs: List[Dict[str, Any]]) -> _Segment:
    """Encode ``docs`` into columns, then verify each row decodes back to
    EXACTLY its source doc; rows that don't go whole into ``overflow``."""
    n = len(docs)
    seg = _Segment()
    seg.seg_id = seg_id
    seg.experiment = experiment
    seg.count = n
    # fixed-width byte column; an id the S24 shape can't round-trip
    # stores as b"" and the decode-and-compare gate overflows its row
    seg.ids = np.array([_id_key(d["id"]) or b"" for d in docs],
                       dtype="S24")
    seg.overflow = {}
    seg.dead = set()
    key_order = tuple(docs[0]["params"].keys())
    seg.key_order = key_order

    # structural conformance; anything subtler (NaN, int-typed objective,
    # numpy leftovers) is caught by the decode-and-compare below
    conforming = [False] * n
    for i, d in enumerate(docs):
        try:
            r = d["results"]
            conforming[i] = (
                tuple(d["params"].keys()) == key_order
                and d.get("status") == "completed"
                and d.get("experiment") == experiment
                and d.get("parent") is None
                and not d.get("resources")
                and type(d.get("lineage")) is str
                and type(d.get("id")) is str
                and (d.get("worker") is None or type(d["worker"]) is str)
                and (d.get("exit_code") is None
                     or type(d["exit_code"]) is int)
                and type(r) is list and len(r) == 1
                and type(r[0]) is dict
                and tuple(r[0].keys()) == ("name", "type", "value")
                and r[0]["type"] == "objective"
                and type(r[0]["name"]) is str
                # exact type, not ==: an int objective would round-trip
                # the f8 column as an equal-but-float 7.0 and change the
                # doc's JSON serialization
                and type(r[0]["value"]) is float
            )
        except (TypeError, KeyError, AttributeError):
            conforming[i] = False

    # params: float64 / int64 when every conforming value is that exact
    # python type (so the numpy round-trip is lossless by construction),
    # an object list otherwise — object columns hold the values verbatim
    seg.pcols = {}
    for k in key_order:
        vals = [d["params"][k] if conforming[i] else None
                for i, d in enumerate(docs)]
        live = [v for i, v in enumerate(vals) if conforming[i]]
        if live and all(type(v) is float for v in live):
            seg.pcols[k] = np.array(
                [v if conforming[i] else 0.0
                 for i, v in enumerate(vals)], dtype=np.float64)
        elif live and all(type(v) is int
                          and -2 ** 63 <= v < 2 ** 63 for v in live):
            seg.pcols[k] = np.array(
                [v if conforming[i] else 0
                 for i, v in enumerate(vals)], dtype=np.int64)
        else:
            seg.pcols[k] = vals

    seg.lineage = [sys.intern(d["lineage"])
                   if conforming[i] and d["lineage"] else ""
                   for i, d in enumerate(docs)]
    seg.res_name = [sys.intern(d["results"][0]["name"])
                    if conforming[i] else ""
                    for i, d in enumerate(docs)]
    obj = np.empty(n, dtype=np.float64)
    seg.times = {tk: np.zeros(n, dtype=np.float64) for tk in _TIME_KEYS}
    seg.tmask = {tk: np.zeros(n, dtype=bool) for tk in _TIME_KEYS}
    seg.worker = [None] * n
    seg.exit_code = [None] * n
    for i, d in enumerate(docs):
        if not conforming[i]:
            obj[i] = 0.0
            continue
        try:
            obj[i] = d["results"][0]["value"]
            for tk in _TIME_KEYS:
                v = d.get(tk)
                if v is None:
                    seg.tmask[tk][i] = True
                else:
                    seg.times[tk][i] = v
            w = d.get("worker")
            seg.worker[i] = sys.intern(w) if w is not None else None
            seg.exit_code[i] = d.get("exit_code")
        except (TypeError, ValueError):
            conforming[i] = False
    seg.objective = obj

    # the unconditional bit-identity gate: a row survives columnar only if
    # its decode equals its source doc (dict ==, the Trial.from_dict
    # equality contract — and stronger: key orders match by construction)
    for i, d in enumerate(docs):
        if not conforming[i] or seg.decode(i) != d:
            seg.overflow[i] = d

    # uniform object columns collapse to their single value (res_name and
    # exit_code almost always; worker/lineage on single-worker runs)
    for attr in ("lineage", "res_name", "worker", "exit_code"):
        col = getattr(seg, attr)
        first = col[0]
        if all(v == first for v in col):
            setattr(seg, attr, first)
    return seg


class ExperimentArchive:
    """Per-experiment columnar store for sealed completed trials."""

    def __init__(self, experiment: str, segment_rows: int = 4096) -> None:
        self.experiment = experiment
        self.segment_rows = max(int(segment_rows), 1)
        self._seg_lock = threading.RLock()
        self._uid = uuid.uuid4().hex[:12]
        self._seg_seq = 0
        self._segments: List[_Segment] = []
        #: mutable head — raw docs awaiting sealing; discard tombstones to
        #: None, so live entries are exactly the non-None ones
        self._head: List[Optional[Dict[str, Any]]] = []
        self._head_live = 0
        #: id → head index, head rows ONLY (bounded by segment_rows).
        #: Sealed rows live in the sorted-array index below instead — a
        #: dict entry per sealed trial (str key + tuple value) was ~200
        #: bytes/trial, the bulk of archived RSS
        self._head_pos: Dict[str, int] = {}
        #: parallel sorted arrays: S24 id key → packed seg<<40|row. Keys
        #: of revived (dead) rows stay behind — liveness is decided
        #: against the segment's dead set at lookup, and a re-completed
        #: id just gains a second entry (at most one is ever live)
        self._skeys = np.empty(0, dtype="S24")
        self._svals = np.empty(0, dtype=np.int64)
        #: sealed ids the S24 shape can't hold (see ``_id_key``) → packed
        self._odd: Dict[str, int] = {}
        self._live_sealed = 0

    # -- writes (under the owning ledger's lock) --------------------------
    def append(self, doc: Dict[str, Any]) -> None:
        """Archive one completed-trial doc. The archive takes ownership of
        a deep copy (callers keep mutating their trial objects)."""
        with self._seg_lock:
            self._discard_locked(doc["id"])
            self._head.append(_copy_json_tree(doc))
            self._head_pos[doc["id"]] = len(self._head) - 1
            self._head_live += 1
            if self._head_live >= self.segment_rows:
                self._seal_locked()

    def replace(self, trial_id: str, doc: Dict[str, Any]) -> None:
        """Re-archival of an already-completed trial (an in-place update
        that stays ``completed``): liveness moves to the new row."""
        self.append(doc)

    def discard(self, trial_id: str) -> bool:
        """Revival: drop ``trial_id`` from the live set. Head rows
        tombstone in place; sealed rows join the segment's dead set."""
        with self._seg_lock:
            return self._discard_locked(trial_id)

    # mtpu: holds(_seg_lock)
    def _discard_locked(self, trial_id: str) -> bool:
        row = self._head_pos.pop(trial_id, None)
        if row is not None:
            self._head[row] = None
            self._head_live -= 1
            return True
        pos = self._sealed_pos_locked(trial_id)
        if pos is None:
            return False
        seg_idx, row = pos
        self._segments[seg_idx].dead.add(row)
        self._live_sealed -= 1
        return True

    # mtpu: holds(_seg_lock)
    def _sealed_pos_locked(
        self, trial_id: str
    ) -> Optional[Tuple[int, int]]:
        """(segment index, row) of the LIVE sealed row for ``trial_id``,
        or None. Revived ids resolve dead and re-completions append a
        fresh entry, so equal keys hold at most one live row — scan the
        run."""
        packed = self._odd.get(trial_id)
        if packed is None:
            key = _id_key(trial_id)
            if key is None or not len(self._skeys):
                return None
            i = int(np.searchsorted(self._skeys, key))
            nk = len(self._skeys)
            while i < nk and self._skeys[i] == key:
                packed = int(self._svals[i])
                seg_idx, row = packed >> _ROW_BITS, packed & _ROW_MASK
                if row not in self._segments[seg_idx].dead:
                    return seg_idx, row
                i += 1
            return None
        seg_idx, row = packed >> _ROW_BITS, packed & _ROW_MASK
        if row in self._segments[seg_idx].dead:
            return None
        return seg_idx, row

    def seal(self) -> None:
        """Force-seal the head (tests and snapshot determinism)."""
        with self._seg_lock:
            self._seal_locked()

    # mtpu: holds(_seg_lock)
    def _seal_locked(self) -> None:
        docs = [d for d in self._head if d is not None]
        self._head = []
        self._head_pos = {}
        self._head_live = 0
        if not docs:
            return
        seg_id = f"{self._uid}-{self._seg_seq:06d}"
        self._seg_seq += 1
        seg_idx = len(self._segments)
        seg = _seal_segment(self.experiment, seg_id, docs)
        keys: List[bytes] = []
        vals: List[int] = []
        for row, d in enumerate(docs):
            packed = (seg_idx << _ROW_BITS) | row
            key = _id_key(d["id"])
            if key is None:
                self._odd[d["id"]] = packed
            else:
                keys.append(key)
                vals.append(packed)
        if keys:
            nk = np.array(keys, dtype="S24")
            nv = np.array(vals, dtype=np.int64)
            order = np.argsort(nk, kind="stable")
            nk, nv = nk[order], nv[order]
            # one O(total) merge per seal keeps the arrays sorted without
            # re-sorting the whole index
            ins = np.searchsorted(self._skeys, nk)
            self._skeys = np.insert(self._skeys, ins, nk)
            self._svals = np.insert(self._svals, ins, nv)
        self._live_sealed += len(docs)
        self._segments.append(seg)

    # -- reads ------------------------------------------------------------
    def __len__(self) -> int:
        with self._seg_lock:
            return self._head_live + self._live_sealed

    def contains(self, trial_id: str) -> bool:
        with self._seg_lock:
            return (trial_id in self._head_pos
                    or self._sealed_pos_locked(trial_id) is not None)

    def worker_of(self, trial_id: str) -> Optional[str]:
        with self._seg_lock:
            row = self._head_pos.get(trial_id)
            if row is not None:
                return self._head[row].get("worker")
            pos = self._sealed_pos_locked(trial_id)
            if pos is None:
                return None
            return self._segments[pos[0]].worker_of(pos[1])

    def get_doc(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """A fresh ``to_dict`` tree for a live archived trial, or None."""
        with self._seg_lock:
            row = self._head_pos.get(trial_id)
            if row is not None:
                return _copy_json_tree(self._head[row])
            pos = self._sealed_pos_locked(trial_id)
            if pos is None:
                return None
            return self._segments[pos[0]].decode(pos[1])

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        doc = self.get_doc(trial_id)
        return Trial.from_dict_trusted(doc) if doc is not None else None

    def entry(self, trial_id: str):
        """Batch entry for :class:`CompletedBatch` — ``("d", doc)`` for a
        head row (the archive-owned doc: the batch copies on access) or
        ``("s", segment, row)`` for a sealed one; None if not live."""
        with self._seg_lock:
            row = self._head_pos.get(trial_id)
            if row is not None:
                return ("d", self._head[row])
            pos = self._sealed_pos_locked(trial_id)
            if pos is None:
                return None
            return ("s", self._segments[pos[0]], pos[1])

    def iter_docs(self) -> Iterator[Dict[str, Any]]:
        """Fresh docs for every live row, in archival order (segments then
        head) — the fetch path."""
        with self._seg_lock:
            segments = list(self._segments)
            head = [d for d in self._head if d is not None]
        for seg in segments:
            for row in range(seg.count):
                if row not in seg.dead:
                    yield seg.decode(row)
        for d in head:
            yield _copy_json_tree(d)

    # -- snapshot manifest support ----------------------------------------
    def segment_refs(self) -> List[Dict[str, Any]]:
        """Manifest entries for sealed segments: id, row count, and the
        (monotonically growing) dead-row list. Segment content is
        immutable, so a file written once per ``seg`` id stays valid; only
        this ref list is reserialized per snapshot."""
        with self._seg_lock:
            return [{"seg": seg.seg_id, "rows": seg.count,
                     "dead": sorted(seg.dead)} for seg in self._segments]

    def export_segment_docs(self, seg_id: str) -> List[Dict[str, Any]]:
        """ALL rows of one sealed segment (dead ones included — the
        manifest's dead list is what excludes them at restore), decoded to
        docs. Written to the segment file exactly once."""
        with self._seg_lock:
            seg = next((s for s in self._segments if s.seg_id == seg_id),
                       None)
        if seg is None:
            raise KeyError(f"unknown segment {seg_id!r}")
        return [seg.decode(row) for row in range(seg.count)]

    def head_docs(self) -> List[Dict[str, Any]]:
        """Fresh docs for the unsealed head rows (the mutable part a
        snapshot must reserialize every time)."""
        with self._seg_lock:
            return [_copy_json_tree(d) for d in self._head if d is not None]

    def stats(self) -> Dict[str, Any]:
        with self._seg_lock:
            return {
                "live": self._head_live + self._live_sealed,
                "segments": len(self._segments),
                "sealed_rows": sum(s.count for s in self._segments),
                "dead_rows": sum(len(s.dead) for s in self._segments),
                "head_rows": self._head_live,
                "overflow_rows": sum(len(s.overflow)
                                     for s in self._segments),
            }


class CompletedBatch(Sequence):
    """Lazy ``Sequence[Trial]`` over a completed-trial delta.

    Entries are ``("t", trial)`` (an already-cloned resident trial),
    ``("d", doc)`` (an archive head doc — copied on access), or
    ``("s", segment, row)`` (a sealed columnar row — decoded on access).
    Materialization happens per index and returns a fresh object each
    time, preserving the ledger's clone-on-read contract; ``columns()``
    hands algorithms the raw columns so the observe path can skip
    materialization entirely.
    """

    def __init__(self, entries: List[tuple]) -> None:
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._materialize(e) for e in self._entries[idx]]
        return self._materialize(self._entries[idx])

    def __iter__(self) -> Iterator[Trial]:
        for e in self._entries:
            yield self._materialize(e)

    def __eq__(self, other):
        # drop-in for the list the pre-archive fetch_completed_since
        # returned (callers compare deltas to [] / to list literals)
        if isinstance(other, (list, tuple, CompletedBatch)):
            return list(self) == list(other)
        return NotImplemented

    __hash__ = None

    @staticmethod
    def _materialize(e) -> Trial:
        kind = e[0]
        if kind == "t":
            return e[1]
        if kind == "d":
            return Trial.from_dict_trusted(_copy_json_tree(e[1]))
        _, seg, row = e
        return Trial.from_dict_trusted(seg.decode(row))

    def columns(self) -> Optional[Tuple[List[str], Dict[str, list],
                                        np.ndarray]]:
        """``(ids, param_columns, objectives)`` for the whole batch, or
        None if ANY entry resists (no objective, mismatched param keys,
        overflow row). All-or-nothing on purpose: a partial columnar
        ingest would reorder the observation stream relative to the
        per-trial path, and the bulk path is bit-compatible only when the
        order matches too. Param columns are raw values (numpy scalars
        for sealed numeric columns, python values otherwise) in batch
        order; the UnitCube's vectorized transform does the encoding.
        """
        n = len(self._entries)
        if n == 0:
            return None
        ids: List[str] = [""] * n
        y = np.empty(n, dtype=np.float64)
        keys: Optional[frozenset] = None
        cols: Dict[str, list] = {}
        for i, e in enumerate(self._entries):
            kind = e[0]
            if kind == "s":
                _, seg, row = e
                if row in seg.overflow:
                    return None
                row_keys = frozenset(seg.key_order)
                if keys is None:
                    keys = row_keys
                    cols = {k: [None] * n for k in keys}
                elif row_keys != keys:
                    return None
                for k in keys:
                    cols[k][i] = seg.pcols[k][row]
                ids[i] = seg.ids[row].decode()
                y[i] = seg.objective[row]
                continue
            if kind == "d":
                doc = e[1]
                r = doc.get("results")
                if (type(r) is not list or len(r) != 1
                        or r[0].get("type") != "objective"):
                    return None
                val = r[0].get("value")
                params = doc["params"]
                tid = doc["id"]
            else:
                t = e[1]
                val = t.objective
                params = t.params
                tid = t.id
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                return None
            row_keys = frozenset(params)
            if keys is None:
                keys = row_keys
                cols = {k: [None] * n for k in keys}
            elif row_keys != keys:
                return None
            for k in keys:
                cols[k][i] = params[k]
            ids[i] = tid
            y[i] = val
        return ids, cols, y
