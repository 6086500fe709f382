"""Live experiment hand-off between coordinator shards (port of
``metaopt_tpu/coord/handoff.py``).

The migration primitive under failover and rebalancing: move ONE
experiment from its owning shard to another **with zero
acked-write loss** while both shards keep serving everything else. The
protocol is three idempotent admin ops over the ordinary frame protocol,
orchestrated from outside the shards (the supervisor or the
``rebalance`` CLI):

1. ``handoff_prepare`` (source) — fence the experiment (new ops get a
   retryable ``Migrating`` reply; the fence itself is journaled so it
   survives a source crash), wait for in-flight ops to drain, then
   capture the experiment doc + trial docs + control signals + the
   reply-cache entries and WAL tail that keep exactly-once retries
   alive. The capture is returned in the reply — "shipping" is the
   orchestrator carrying it to the destination.
2. ``handoff_apply`` (destination) — journal + adopt the shipped state
   (every piece an upsert: blind retries through a chaos kill are safe),
   adopt the bumped shard map, fsync, ack.
3. ``shard_map_update`` (source, then every other shard) — the ownership
   COMMIT: adopting the bumped map makes the source answer
   ``WrongShardError`` for the moved experiment (clients re-learn the
   map and follow), the local copy is deleted, the fence lifted.

Crash matrix (each barrier has an armed chaos fault —
``crash_handoff_source`` / ``crash_handoff_dest`` / ``torn_handoff_ship``
in :mod:`metaopt_tpu_torch.executor.faults`):

========================  ==================================================
crash point               recovery
========================  ==================================================
source pre-snapshot       nothing shipped; fence record not yet durable —
                          source recovers un-fenced and keeps ownership;
                          orchestrator retries prepare from scratch
source post-snapshot      fence IS durable (the capture's tail extraction
                          flushed it); recovered source answers
                          ``Migrating`` — no write can slip into the
                          captured-but-uncommitted window; orchestrator
                          retries prepare (idempotent re-capture)
dest pre-commit           nothing applied; retry apply verbatim
mid-ship (torn)           a prefix of the docs is journaled; every record
                          is an upsert so the retried apply completes
dest post-commit          state + map durable, ack lost; retried apply
                          re-upserts the same state — same result
source commit lost        orchestrator retries ``shard_map_update`` inside
                          the window; until it lands the source (fenced,
                          durably) keeps answering ``Migrating``
========================  ==================================================

:func:`recover_shard_state` is the offline half used by supervisor
failover: read a DEAD shard's snapshot + WAL straight off disk (no
process to ask) and rebuild the same per-experiment state dicts
``handoff_prepare`` would have returned, so survivors adopt a dead
shard's experiments through the identical ``handoff_apply`` path.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from metaopt_tpu_torch.coord.protocol import (
    HAVE_WIRE_V2,
    ProtocolError,
    encode_msg,
    encode_request_v2,
    recv_msg,
    send_msg,
    send_payload,
)
from metaopt_tpu_torch.coord.wal import read_records

log = logging.getLogger(__name__)

Addr = Tuple[str, int]

#: per-address negotiated wire for the admin plane; learned by a v1 ping
#: on each fresh connection's first use of an address, forgotten on any
#: failed call so a rolled-back (JSON-only) peer gets re-probed. The
#: binary wire matters here because the ship leg of a migration carries
#: the whole captured experiment state in one ``handoff_apply`` frame.
_ADDR_WIRE: Dict[Addr, str] = {}
_ADDR_WIRE_LOCK = threading.Lock()


class HandoffError(RuntimeError):
    """A migration step failed past its retry window."""


def _forget_wire(addr: Addr) -> None:
    with _ADDR_WIRE_LOCK:
        _ADDR_WIRE.pop(addr, None)


def _rpc(addr: Addr, op: str, args: Dict[str, Any],
         timeout_s: float = 30.0) -> Dict[str, Any]:
    """One admin-plane request/reply over a fresh connection."""
    with socket.create_connection(addr, timeout=timeout_s) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(timeout_s)
        with _ADDR_WIRE_LOCK:
            wire = _ADDR_WIRE.get(addr)
        if wire is None:
            # first contact: one v1-JSON ping learns whether this peer
            # speaks the binary wire — JSON is what every build answers
            send_msg(s, {"op": "ping", "args": {}})
            pong = recv_msg(s)
            caps = ((pong.get("result") or {}).get("caps") or ()
                    if pong and pong.get("ok") else ())
            wire = "v2" if (HAVE_WIRE_V2 and "wire_v2" in caps) else "v1"
            with _ADDR_WIRE_LOCK:
                _ADDR_WIRE[addr] = wire
        msg = {"op": op, "args": args}
        payload = None
        if wire == "v2":
            try:
                exp = args.get("experiment")
                payload = encode_request_v2(
                    msg, exp if isinstance(exp, str) else "")
            except ProtocolError:
                payload = None  # unencodable: this frame goes JSON
        if payload is None:
            payload = encode_msg(msg)
        send_payload(s, payload)
        reply = recv_msg(s)
    if reply is None:
        raise ConnectionError(f"{op}: connection closed before reply")
    return reply


def call_admin(addr: Addr, op: str, args: Dict[str, Any],
               window_s: float = 30.0) -> Dict[str, Any]:
    """Retry one idempotent admin op through crashes/restarts.

    Connection failures retry with decorrelated jitter inside
    ``window_s`` (a shard respawn + recovery window). Error REPLIES are
    returned to the caller — the orchestrator decides which are fatal.
    """
    from metaopt_tpu_torch.coord.client_backend import decorrelated_jitter

    deadline = time.monotonic() + window_s
    delay = 0.0
    while True:
        try:
            return _rpc(addr, op, args)
        except (ConnectionError, BrokenPipeError, OSError, ProtocolError,
                json.JSONDecodeError) as e:
            # re-probe the wire on the retry: the failure may be a peer
            # that rolled back to a JSON-only build under the same addr
            _forget_wire(addr)
            if time.monotonic() >= deadline:
                raise HandoffError(
                    f"{op} to {addr} failed past the "
                    f"{window_s:.0f}s window: {e}") from e
            delay = decorrelated_jitter(delay)
            time.sleep(delay)


def migrate_experiment(
    experiment: str,
    source_addr: Addr,
    dest_addr: Addr,
    dest_sid: str,
    new_map: Dict[str, Any],
    other_addrs: Iterable[Addr] = (),
    drain_timeout_s: float = 10.0,
    window_s: float = 30.0,
) -> Dict[str, Any]:
    """Run the full three-step migration; returns the apply stats.

    ``new_map`` must already carry the bumped version (see
    :func:`metaopt_tpu_torch.coord.shards.with_override`). ``other_addrs`` are
    the remaining shards, told about the new map after the commit so
    their pings stop teaching clients the stale one.
    """
    t0 = time.monotonic()
    prep = call_admin(source_addr, "handoff_prepare",
                      {"experiment": experiment, "dest": dest_sid,
                       "drain_timeout_s": drain_timeout_s},
                      window_s=window_s)
    if not prep.get("ok"):
        raise HandoffError(
            f"prepare of {experiment!r} failed: "
            f"{prep.get('error')}: {prep.get('msg')}")
    state = prep["result"]
    t1 = time.monotonic()
    try:
        applied = call_admin(dest_addr, "handoff_apply",
                             {"experiment": experiment, "state": state,
                              "shard_map": new_map},
                             window_s=window_s)
        if not applied.get("ok"):
            raise HandoffError(
                f"apply of {experiment!r} on {dest_sid} failed: "
                f"{applied.get('error')}: {applied.get('msg')}")
    except HandoffError:
        # nothing committed: lift the source fence so the experiment
        # resumes serving where it was
        try:
            _rpc(source_addr, "handoff_abort", {"experiment": experiment})
        except Exception:
            log.warning("handoff abort of %r on source failed (fence "
                        "clears on the next successful prepare/commit)",
                        experiment, exc_info=True)
        raise
    t2 = time.monotonic()
    # ownership commit: the source first (it must start answering
    # WrongShardError before anyone relearns the map from it), then the
    # bystander shards
    commit = call_admin(source_addr, "shard_map_update",
                        {"shard_map": new_map, "drop": [experiment]},
                        window_s=window_s)
    if not commit.get("ok"):
        raise HandoffError(
            f"commit of {experiment!r} on source failed: "
            f"{commit.get('error')}: {commit.get('msg')}")
    for addr in other_addrs:
        try:
            call_admin(addr, "shard_map_update", {"shard_map": new_map},
                       window_s=min(window_s, 5.0))
        except HandoffError:
            # a bystander that stays down learns the map on respawn
            # (journaled by whoever told it first) or from its next ping
            log.warning("shard-map broadcast to %s failed", addr,
                        exc_info=True)
    t3 = time.monotonic()
    log.info("migrated %r to %s: prepare %.3f ms, apply %.3f ms, commit "
             "%.3f ms, %d trials shipped", experiment, dest_sid,
             (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
             len(state.get("trials") or ()))
    return applied["result"]


# ---------------------------------------------------------------------------
# offline recovery — the failover half
# ---------------------------------------------------------------------------

def _inflate_v2_readonly(path: str, state: Dict[str, Any]) -> None:
    """Expand a v2 (incremental) manifest in place to the v1 shape
    ``recover_shard_state`` reads: ``experiments`` + ``trials`` built from
    each section's mutable docs plus its referenced segment files, the
    per-segment ``dead`` lists filtering revived rows out. Read-only twin
    of ``CoordServer._inflate_v2`` — it must never truncate or repair the
    dead shard's files."""
    seg_dir = path + ".segments"
    experiments: Dict[str, Any] = {}
    trials: Dict[str, Any] = {}
    for name, sec in (state.get("sections") or {}).items():
        experiments[name] = sec.get("experiment")
        docs = list(sec.get("docs") or [])
        for entry in sec.get("segments") or []:
            fp = os.path.join(seg_dir, entry["file"])
            try:
                with open(fp) as sf:
                    seg_state = json.load(sf)
            except (OSError, ValueError):
                log.error("failover: segment file %s unreadable; its rows "
                          "are lost to this recovery", fp)
                continue
            dead = set(entry.get("dead") or ())
            docs.extend(
                d for i, d in enumerate(seg_state.get("docs") or [])
                if i not in dead)
        trials[name] = docs
    state["experiments"] = experiments
    state["trials"] = trials


def recover_shard_state(
    snapshot_path: Optional[str],
    wal_path: Optional[str],
) -> Dict[str, Dict[str, Any]]:
    """Rebuild a DEAD shard's per-experiment hand-off state from disk.

    ``restore(snapshot) + replay(WAL tail)`` exactly like the shard's own
    recovery would, but offline on plain dicts — the result maps each
    experiment to the same state shape ``handoff_prepare`` returns, ready
    for ``handoff_apply`` on a survivor. Zero acked-write loss holds
    because every acknowledged write was fsynced to this WAL before its
    reply left the dead shard.

    The dead shard's files are never modified (torn tails are skipped in
    memory, not truncated) — a post-mortem must stay a read.
    """
    experiments: Dict[str, Optional[Dict[str, Any]]] = {}
    trials: Dict[str, Dict[str, Dict[str, Any]]] = {}
    signals: Dict[Tuple[str, str], str] = {}
    replies: Dict[str, Tuple[str, Dict[str, Any]]] = {}  # req → (exp, reply)

    def _apply_evict_file(name: str, path: Optional[str]) -> None:
        """Merge one evict file (the full state _evict_fenced captured)
        into the recovery — read-only, captured-state-wins over anything
        journaled BEFORE it (callers invoke this in seq order, so records
        after the evict/hydrate still override below)."""
        if not path or not os.path.exists(path):
            log.error("failover: evict file %r missing; experiment %r "
                      "recovers without its evicted state", path, name)
            return
        try:
            with open(path) as f:
                st = json.load(f)
        except (OSError, json.JSONDecodeError):
            log.exception("failover: evict file %s unreadable; experiment "
                          "%r recovers without its evicted state", path,
                          name)
            return
        if st.get("experiment") is not None:
            experiments[name] = st["experiment"]
        for doc in st.get("trials") or []:
            trials.setdefault(name, {})[doc["id"]] = doc
        for sig in st.get("signals") or []:
            signals[(name, sig["trial_id"])] = sig["signal"]
        for r in st.get("replies") or []:
            replies[r["req"]] = (name, r["reply"])

    snap_seq = 0
    if snapshot_path and os.path.exists(snapshot_path):
        try:
            with open(snapshot_path) as f:
                snap = json.load(f)
        except (OSError, json.JSONDecodeError):
            log.exception("failover: unreadable snapshot %s (recovering "
                          "from WAL alone)", snapshot_path)
            snap = {}
        snap_seq = int(snap.get("wal_seq", 0) or 0)
        if int(snap.get("version", 1) or 1) >= 2:
            # v2 (incremental) manifest: inflate sections + referenced
            # segment files to the v1 shape, read-only (mirrors
            # CoordServer._inflate_v2 — a torn segment file loses only
            # its own rows, never the rest of the manifest)
            _inflate_v2_readonly(snapshot_path, snap)
        for name, cfg in (snap.get("experiments") or {}).items():
            experiments[name] = cfg
        for name, docs in (snap.get("trials") or {}).items():
            trials[name] = {d["id"]: d for d in docs}
        for sig in snap.get("signals") or []:
            signals[(sig["experiment"], sig["trial"])] = sig["signal"]
        for name, stub in (snap.get("evicted") or {}).items():
            # an evicted experiment's docs live ONLY in its evict file
            # once the WAL is compacted — skipping the stub loses every
            # acked write the file holds
            if name not in experiments:
                _apply_evict_file(name, (stub or {}).get("path"))

    def _upsert(doc: Dict[str, Any]) -> None:
        exp = doc.get("experiment")
        if exp:
            trials.setdefault(exp, {})[doc["id"]] = doc

    if wal_path and os.path.exists(wal_path):
        records, torn = read_records(wal_path, truncate_torn=False)
        if torn:
            log.warning("failover: %d torn bytes at the tail of %s "
                        "skipped (never acknowledged)", torn, wal_path)
        for rec in records:
            op = rec.get("op")
            if int(rec.get("seq", 0)) <= snap_seq:
                # records at or below the snapshot bound survive on disk
                # only in the window between a snapshot publish and its
                # compaction finishing. The snapshot does NOT carry the
                # reply cache, so a reply record must still install its
                # cache entry (exactly-once across a crash inside that
                # window). Its embedded doc is already reflected by the
                # snapshot — and may be STALER than it — so only the
                # cache entry is taken.
                if op == "reply" and rec.get("exp"):
                    replies[rec["req"]] = (rec["exp"],
                                           rec.get("reply") or {})
                continue
            if op == "put_trial":
                _upsert(rec["trial"])
            elif op == "create_experiment":
                cfg = rec.get("config") or {}
                name = cfg.get("name")
                if name and experiments.get(name) is None:
                    experiments[name] = cfg
            elif op == "update_experiment":
                cfg = experiments.get(rec["name"])
                if cfg is not None:
                    cfg.update(rec.get("patch") or {})
            elif op == "delete_experiment":
                experiments.pop(rec["name"], None)
                trials.pop(rec["name"], None)
                signals = {k: v for k, v in signals.items()
                           if k[0] != rec["name"]}
            elif op == "set_signal":
                signals[(rec["experiment"], rec["trial_id"])] = (
                    rec["signal"])
            elif op in ("evict", "hydrate"):
                # both record kinds point at the evict file that froze
                # the experiment's full state at evict time; merging it
                # here (captured-state-wins, later records re-override)
                # matches what _apply_wal_record replays live
                _apply_evict_file(rec["experiment"], rec.get("path"))
            elif op == "reply":
                reply = rec.get("reply") or {}
                exp = rec.get("exp")
                if exp:
                    replies[rec["req"]] = (exp, reply)
                # a reply record may be the only journal of its
                # reserve's doc — mirror _apply_wal_record
                res = reply.get("result") if reply.get("ok") else None
                if isinstance(res, dict):
                    if isinstance(res.get("trial"), dict):
                        _upsert(res["trial"])
                    elif ("params" in res and "experiment" in res
                          and "id" in res):
                        _upsert(res)
            # shard_map / handoff_fence / handoff_abort records are the
            # dead shard's private routing history — not state to move

    out: Dict[str, Dict[str, Any]] = {}
    for name, cfg in experiments.items():
        if cfg is None:
            continue
        out[name] = {
            "experiment": cfg,
            "trials": list(trials.get(name, {}).values()),
            "signals": [{"trial_id": t, "signal": s}
                        for (e, t), s in signals.items() if e == name],
            "replies": [{"req": r, "reply": rep}
                        for r, (e, rep) in replies.items() if e == name],
            "wal_tail": [],
        }
    return out


def apply_recovered(
    experiment: str,
    state: Dict[str, Any],
    dest_addr: Addr,
    new_map: Dict[str, Any],
    window_s: float = 30.0,
) -> Dict[str, Any]:
    """Hand one offline-recovered experiment to its new owner."""
    applied = call_admin(dest_addr, "handoff_apply",
                         {"experiment": experiment, "state": state,
                          "shard_map": new_map}, window_s=window_s)
    if not applied.get("ok"):
        raise HandoffError(
            f"failover apply of {experiment!r} failed: "
            f"{applied.get('error')}: {applied.get('msg')}")
    return applied["result"]


__all__ = [
    "HandoffError",
    "apply_recovered",
    "call_admin",
    "migrate_experiment",
    "recover_shard_state",
]
