"""Every chaos barrier of the port's coordinator, armed and fired.

The port's ``coord/server.py`` and ``coord/wal.py`` carry the reference's
``faults.fire`` barriers; each SIGKILLs the process at a crash-consistent
point. The reference arms them in its ``slow`` subprocess chaos suites
(``tests/functional/test_coord_{crash,multitenant,handoff_chaos}.py``);
here each one runs in a short child process that drives an offline
``CoordServer`` (no sockets: requests go straight through ``_handle`` with
the sender's fsync barrier emulated, as ``crashcheck`` does) and prints an
``ACK`` line once a reply would have left. The child dies at the barrier;
the test then checks, on what it left on disk:

* the offline recovery (``recover_shard_state``) holds every acked trial;
* a restarted server recovers the same trials, and after a snapshot and a
  second restart still does (orphans of a torn seal are collected, never
  loaded);
* a hand-off retried against the restarted destination completes the move
  exactly once.

``crashcheck``'s MTP004 counts a barrier armed only when a test of the port
names it, so this file is what keeps those barriers alive.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

from metaopt_tpu_torch.coord.handoff import recover_shard_state
from metaopt_tpu_torch.coord.server import CoordServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, os, sys
from metaopt_tpu_torch.coord.server import CoordServer
from metaopt_tpu_torch.executor.faults import faults
from metaopt_tpu_torch.ledger.trial import Trial

root, scenario, kind, skip = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
kw = json.loads(sys.argv[5])
srv = CoordServer(snapshot_path=os.path.join(root, "snap.json"),
                  snapshot_interval_s=3600.0, host_algorithms=False,
                  wal_group_ms=0.0, **kw)
srv._recover()
n_req = [0]


def call(op, args, ack=None):
    n_req[0] += 1
    reply = srv._handle({"op": op, "args": args, "req": f"q{n_req[0]}"})
    assert isinstance(reply, dict) and reply.get("ok"), reply
    barrier = srv._barrier_seq(op)
    if barrier:
        srv._wal.sync(barrier)
    if ack is not None:
        print("ACK " + json.dumps(ack), flush=True)
    return reply


def doc(exp, tid, x, status="new"):
    t = Trial(params={"x": x}, experiment=exp, id=tid)
    if status == "completed":
        t.transition("reserved")
        t.attach_results([{"name": "o", "type": "objective", "value": x}])
        t.transition("completed")
    return t.to_dict()


def register(exp, tids, status="new"):
    for i, tid in enumerate(tids):
        call("register", {"trial": doc(exp, tid, float(i), status)}, [exp, tid])


for name in ("exp_a", "exp_b"):
    call("create_experiment", {"config": {"name": name}})
if scenario == "wal":
    faults.arm(kind, times=1, skip=skip)
    register("exp_a", [f"a{i}" for i in range(6)])
elif scenario == "snapshot":
    register("exp_a", [f"a{i}" for i in range(3)], "completed")
    srv.snapshot(srv.snapshot_path)            # a first, whole snapshot
    register("exp_a", [f"a{i}" for i in range(3, 6)], "completed")
    faults.arm(kind, times=1, skip=skip)
    srv.snapshot(srv.snapshot_path)
elif scenario == "evict":
    register("exp_a", ["a0"])
    register("exp_b", ["b0", "b1"])
    faults.arm(kind, times=1, skip=skip)
    srv.evict_experiment("exp_b")
elif scenario == "handoff":
    register("exp_a", ["a0"])
    faults.arm(kind, times=1, skip=skip)
    srv._handoff_apply({"experiment": "exp_h", "state": json.loads(sys.argv[6])})
print("SURVIVED", flush=True)
'''

#: what a shard ships in a hand-off: three trials, a signal, a cached reply
SHIPPED = {
    "experiment": {"name": "exp_h"},
    "trials": [{"id": f"h{i}", "experiment": "exp_h", "params": {"x": float(i)},
                "status": "new"} for i in range(3)],
    "signals": [{"trial_id": "h1", "signal": "pause"}],
    "replies": [{"req": "ship-1", "reply": {"ok": True, "result": {"id": "h2"}}}],
    "wal_tail": [],
}

#: (scenario, barrier kind, skip, server keywords)
BARRIERS = [
    ("wal", "torn_wal_tail", 1, {}),
    ("wal", "torn_wal_tail", 4, {}),
    ("snapshot", "partial_snapshot", 0, {}),
    ("snapshot", "partial_snapshot", 0,
     {"snapshot_incremental": True, "archive_segment_rows": 2}),
    ("snapshot", "crash_segment_seal", 0,
     {"snapshot_incremental": True, "archive_segment_rows": 2}),
    ("snapshot", "crash_segment_seal", 1,
     {"snapshot_incremental": True, "archive_segment_rows": 2}),
    ("snapshot", "crash_manifest_commit", 0,
     {"snapshot_incremental": True, "archive_segment_rows": 2}),
    ("evict", "crash_evict", 0, {"evict_dir": "EVICT"}),
    ("evict", "crash_evict", 1, {"evict_dir": "EVICT"}),
    ("handoff", "crash_handoff_dest", 0, {}),
    ("handoff", "crash_handoff_dest", 1, {}),
    ("handoff", "torn_handoff_ship", 0, {}),
]


def _server(root, kw):
    srv = CoordServer(snapshot_path=str(root / "snap.json"), snapshot_interval_s=3600.0,
                      host_algorithms=False, wal_group_ms=0.0, **kw)
    srv._recover()
    return srv


def _ids(srv, exp):
    """The experiment's trial ids, paged back in first if it was evicted."""
    if srv._evict_enabled:
        srv.hydrate_experiment(exp)
    return sorted(t.id for t in srv.inner.fetch(exp)) \
        if srv.inner.load_experiment(exp) is not None else []


@pytest.mark.parametrize("scenario,kind,skip,kw", BARRIERS,
                         ids=[f"{k}@{s}-{sc}" + ("-v2" if kw.get("snapshot_incremental") else "")
                              for sc, k, s, kw in BARRIERS])
def test_the_barrier_fires_and_recovery_keeps_every_ack(tmp_path, scenario, kind, skip, kw):
    kw = {k: (str(tmp_path / "evicted") if v == "EVICT" else v) for k, v in kw.items()}
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("METAOPT_TPU_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp_path), scenario, kind, str(skip),
         json.dumps(kw), json.dumps(SHIPPED)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stdout, proc.stderr[-3000:])
    assert "SURVIVED" not in proc.stdout
    acked = [tuple(json.loads(line[4:])) for line in proc.stdout.splitlines()
             if line.startswith("ACK ")]
    assert acked, proc.stdout

    snap = str(tmp_path / "snap.json")
    offline = recover_shard_state(snap, snap + ".wal")
    for exp, tid in acked:
        assert tid in {d["id"] for d in offline[exp]["trials"]}, (exp, tid)

    srv = _server(tmp_path, kw)
    try:
        for exp, tid in acked:
            assert tid in _ids(srv, exp), (exp, tid)
        if scenario == "handoff":
            out = srv._handoff_apply({"experiment": "exp_h",
                                      "state": json.loads(json.dumps(SHIPPED))})
            assert out.get("ok"), out
            srv._wal.sync(srv._wal.appended_seq)
            assert _ids(srv, "exp_h") == ["h0", "h1", "h2"]
        srv.snapshot(srv.snapshot_path)
        before = {exp: _ids(srv, exp) for exp in ("exp_a", "exp_b", "exp_h")}
    finally:
        srv._wal.close()
    again = _server(tmp_path, kw)
    try:
        assert {exp: _ids(again, exp) for exp in before} == before
    finally:
        again._wal.close()
