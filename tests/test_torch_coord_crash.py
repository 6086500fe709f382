"""``kill -9`` of the port's ``serve`` mid-hunt, then recovery (the shape
of the reference's ``tests/functional/test_coord_crash.py``, one case).

``python -m metaopt_tpu_torch serve --snapshot S`` runs as a subprocess,
hosting on the CPU from a config file's ``coordinator.device``. A 2-worker
hosted random hunt (``hunt --producer coord``) runs against it; once a few
trials have completed the server is SIGKILLed (no shutdown snapshot: the
WAL is the only record of everything since the last periodic one) and
restarted on the same snapshot and port. The workers ride out the outage
through their reconnect window and session resumption, and the hunt
finishes with every trial acknowledged before the kill present once, with
its objective, and no trial completed twice.

Every process runs under a deadline and is killed in a ``finally``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from metaopt_tpu_torch.coord import CoordLedgerClient
from metaopt_tpu_torch.models.objectives import rosenbrock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROSEN = os.path.join(REPO, "metaopt_tpu_torch", "examples", "rosenbrock.py")
MAX_TRIALS = 30


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, METAOPT_TPU_COORD_RETRY_S="60",
               TMPDIR=str(tmp_path), HOME=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("METAOPT_TPU_FAULTS", None)
    return env


def _serve(tmp_path, port, readers, deadline_s=60.0):
    """Start ``serve`` and wait (under a deadline) for its ready line; a
    reader thread drains its output for the rest of its life."""
    cfg = tmp_path / "serve.json"
    cfg.write_text(json.dumps({"coordinator": {"device": "cpu"}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "metaopt_tpu_torch", "serve", "--config", str(cfg),
         "--ledger", "memory",
         "--port", str(port), "--snapshot", str(tmp_path / "snap.json"),
         "--snapshot-interval-s", "3600", "--stale-timeout-s", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(tmp_path), cwd=str(tmp_path))
    lines, ready = [], threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if "coordinator ready" in line:
                ready.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    readers.append(t)
    if not ready.wait(deadline_s):
        proc.kill()
        raise AssertionError(f"serve did not come up: {''.join(lines)}")
    return proc


def test_kill9_mid_hunt_loses_no_acknowledged_trial(tmp_path):
    port = _free_port()
    procs, readers = [], []
    try:
        procs.append(_serve(tmp_path, port, readers))
        hunt = subprocess.Popen(
            [sys.executable, "-m", "metaopt_tpu_torch", "hunt", "-n", "crash",
             "--max-trials", str(MAX_TRIALS), "--pool-size", "2",
             "--ledger", f"coord://127.0.0.1:{port}", "--producer", "coord",
             "--n-workers", "2", "--algo", "random", ROSEN,
             "-x~uniform(-5, 10)", "-y~uniform(-5, 10)"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(tmp_path), cwd=str(tmp_path))
        procs.append(hunt)
        cli = CoordLedgerClient("127.0.0.1", port, io_timeout_s=10.0)
        deadline = time.monotonic() + 60.0
        acked = []
        while time.monotonic() < deadline:
            try:
                acked = cli.fetch("crash", "completed")
            except KeyError:
                acked = []
            if len(acked) >= 8:
                break
            time.sleep(0.05)
        assert len(acked) >= 8, "the hunt never got going"
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=10)
        assert not os.path.exists(tmp_path / "snap.json")  # the WAL is all there is
        procs.append(_serve(tmp_path, port, readers))
        out, _ = hunt.communicate(timeout=120)
        assert hunt.returncode == 0, out[-3000:]

        cli = CoordLedgerClient("127.0.0.1", port, io_timeout_s=10.0)
        done = cli.fetch("crash", "completed")
        ids = [t.id for t in done]
        assert len(ids) == len(set(ids)) == MAX_TRIALS
        by_id = {t.id: t for t in done}
        for t in acked:
            assert by_id[t.id].objective == t.objective
        for t in done:
            assert t.objective == rosenbrock(t.params)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                p.communicate(timeout=10)
            except Exception:
                pass
        for t in readers:
            t.join(timeout=10)
