"""The port's process helpers and provenance stamps against the reference.

The contracts of the reference's ``tests/unit/test_procs.py`` and
``tests/unit/test_procs_sweep.py`` restated against
``metaopt_tpu_torch.utils.{procs,provenance}``: the live tee, a deadline
kill keeping the tail, capture without a tee, labelled children under one
shared deadline with the partial last line flushed, sweep markers
accumulating across nesting, partial output kept, detached grandchildren
reaped, the stamp's shape and the dirty flag on tracked files only. Then
both packages run the same deterministic children: equal ``(rc, output)``
from both ``run_with_deadline``s and both ``run_swept``s, equal labelled
lines from both ``run_many_with_deadline``s, equal stamp keys and equal
``git_commit`` answers.
"""

import os
import subprocess
import sys
import time

import pytest

from metaopt_tpu.utils import procs as ref_procs
from metaopt_tpu.utils import provenance as ref_prov
from metaopt_tpu_torch.utils import procs
from metaopt_tpu_torch.utils import provenance as prov
from metaopt_tpu_torch.utils.procs import (
    kill_by_env_marker,
    marked_pids,
    run_many_with_deadline,
    run_swept,
    run_with_deadline,
)
from metaopt_tpu_torch.utils.provenance import git_commit, provenance

PY = sys.executable
HANG = "import time; print('step-1 done', flush=True); time.sleep(60)"


def alive(pid):
    """True while ``pid`` runs (a zombie awaiting its reaper is dead)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# -- run_with_deadline ---------------------------------------------------------


def test_stream_tees_output_live(capfd):
    code = "print('alpha', flush=True); print('beta', flush=True)"
    rc, out = run_with_deadline([PY, "-c", code], timeout_s=30.0, capture=True,
                                stream=True, poll_s=0.1)
    assert rc == 0
    assert "alpha" in out and "beta" in out
    teed = capfd.readouterr().out
    assert "alpha" in teed and "beta" in teed


def test_stream_survives_deadline_kill(capfd):
    # the child prints progress then hangs: the kill must not eat the progress
    rc, out = run_with_deadline([PY, "-c", HANG], timeout_s=2.0, capture=True,
                                stream=True, poll_s=0.1)
    assert rc is None  # deadline hit
    assert "step-1 done" in out
    assert "step-1 done" in capfd.readouterr().out


def test_capture_without_stream_does_not_tee(capfd):
    rc, out = run_with_deadline([PY, "-c", "print('quiet')"], timeout_s=30.0, capture=True)
    assert rc == 0 and "quiet" in out
    assert capfd.readouterr().out == ""  # no tee unless stream=True


def test_without_capture_the_output_goes_nowhere(capfd):
    rc, out = run_with_deadline([PY, "-c", "print('dropped')"], timeout_s=30.0)
    assert (rc, out) == (0, "")
    assert "dropped" not in capfd.readouterr().out


def test_env_reaches_the_child():
    env = dict(os.environ, MTPU_PROCS_PROBE="seen-here")
    rc, out = run_with_deadline([PY, "-c", "import os; print(os.environ['MTPU_PROCS_PROBE'])"],
                                timeout_s=30.0, env=env, capture=True)
    assert (rc, out) == (0, "seen-here\n")


# -- run_many_with_deadline --------------------------------------------------


def test_many_labels_prefix_and_results(capfd):
    jobs = [
        ("one", [PY, "-c", "print('from-one', flush=True)"], None),
        ("two", [PY, "-c", "print('from-two', flush=True); raise SystemExit(3)"], None),
    ]
    results = run_many_with_deadline(jobs, timeout_s=30.0, poll_s=0.1)
    assert results["one"][0] == 0 and "from-one" in results["one"][1]
    assert results["two"][0] == 3 and "from-two" in results["two"][1]
    teed = capfd.readouterr().out
    assert "[one] from-one" in teed
    assert "[two] from-two" in teed


def test_many_shared_deadline_kills_and_keeps_tail(capfd):
    # the fast job finishes; the hanging job is killed with rc None, and
    # everything it printed before the kill stays visible
    jobs = [
        ("fast", [PY, "-c", "print('fast-done', flush=True)"], None),
        ("hang", [PY, "-c", "import time; print('hang-progress', flush=True); "
                            "time.sleep(60)"], None),
    ]
    results = run_many_with_deadline(jobs, timeout_s=2.0, poll_s=0.1)
    assert results["fast"][0] == 0
    assert results["hang"][0] is None  # shared deadline hit
    assert "hang-progress" in results["hang"][1]
    teed = capfd.readouterr().out
    assert "[fast] fast-done" in teed and "[hang] hang-progress" in teed


def test_many_flushes_partial_last_line(capfd):
    # no trailing newline before the hang: the final drain must still
    # surface the partial line under its label
    jobs = [("p", [PY, "-c", "import sys, time; sys.stdout.write('no-newline'); "
                             "sys.stdout.flush(); time.sleep(60)"], None)]
    results = run_many_with_deadline(jobs, timeout_s=2.0, poll_s=0.1)
    assert results["p"][0] is None
    assert "no-newline" in results["p"][1]
    assert "[p] no-newline" in capfd.readouterr().out


def test_a_failed_launch_leaks_no_started_child():
    marker = f"procs-leak-{os.getpid()}-{time.time_ns()}"
    env = dict(os.environ, MTPU_SWEEP_MARKER=marker)
    jobs = [("sleeper", [PY, "-c", "import time; time.sleep(60)"], env),
            ("missing", ["/nonexistent/interpreter"], env)]
    with pytest.raises(OSError):
        run_many_with_deadline(jobs, timeout_s=30.0, poll_s=0.1)
    assert not marked_pids(marker)


# -- run_swept and kill_by_env_marker ------------------------------------------


def test_markers_accumulate_across_nesting(monkeypatch):
    """An outer sweep marker must survive into children launched by an
    inner run_swept: overwriting it would leave the outer caller's
    deadline sweep nothing to match."""
    monkeypatch.setenv("MTPU_SWEEP_MARKER", "outer-abc")
    rc, out, _ = run_swept([PY, "-c", "import os; print(os.environ['MTPU_SWEEP_MARKER'])"], 30)
    assert rc == 0
    assert out.strip().startswith("outer-abc,")


def test_deadline_preserves_partial_output():
    code = ("import sys, time; print('partial-out', flush=True); "
            "sys.stderr.write('partial-err'); sys.stderr.flush(); time.sleep(60)")
    rc, out, err = run_swept([PY, "-c", code], 2.0)
    assert rc is None
    assert "partial-out" in out
    assert "partial-err" in err


def test_sweep_reaps_detached_grandchildren():
    """start_new_session'd descendants escape any killpg but inherit the
    env marker; the sweep must reach them."""
    marker = f"sweep-test-{os.getpid()}-{time.time_ns()}"
    code = ("import subprocess, sys, time; "
            "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'], "
            "start_new_session=True); print('spawned', flush=True); time.sleep(120)")
    env = dict(os.environ, MTPU_SWEEP_MARKER=marker)
    proc = subprocess.Popen([PY, "-c", code], env=env, start_new_session=True,
                            stdout=subprocess.DEVNULL)
    try:
        # wait until the grandchild exists (environ visible in /proc); both
        # processes sleep long, so there is no lifetime race
        deadline = time.time() + 30
        marked = []
        while time.time() < deadline and len(marked) < 2:
            marked = marked_pids(marker)
            time.sleep(0.2)
        assert len(marked) >= 2, "child + detached grandchild expected"
        assert kill_by_env_marker(marker) >= 2
        proc.wait(timeout=10)
        deadline = time.time() + 10
        while time.time() < deadline and any(alive(p) for p in marked):
            time.sleep(0.1)
        assert not any(alive(p) for p in marked)
    finally:
        # an assertion above must not leak the detached sleepers
        kill_by_env_marker(marker)
        if proc.poll() is None:
            proc.kill()


def test_run_swept_deadline_reaps_the_whole_tree():
    """On its deadline run_swept kills the child and then sweeps: the
    grandchild that started its own session dies too, and what the child
    printed before the deadline is kept."""
    marker = f"swept-tree-{os.getpid()}-{time.time_ns()}"
    code = ("import subprocess, sys, time; "
            "g = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'], "
            "start_new_session=True); print('grandchild', g.pid, flush=True); "
            "time.sleep(120)")
    try:
        rc, out, _ = run_swept([PY, "-c", code], 2.0, marker=marker)
        assert rc is None
        grandchild = int(out.split()[1])
        deadline = time.time() + 10
        while time.time() < deadline and alive(grandchild):
            time.sleep(0.1)
        assert not alive(grandchild)
        assert kill_by_env_marker(marker) == 0
    finally:
        kill_by_env_marker(marker)


def test_no_proc_means_nothing_to_sweep(monkeypatch):
    def no_proc(path):
        raise FileNotFoundError(path)

    monkeypatch.setattr(procs.os, "listdir", no_proc)
    assert kill_by_env_marker("anything") == 0
    assert procs.marked_pids("anything") == []


def test_marked_pids_finds_the_live_carriers_only():
    """The processes that carry a marker, never this one, never a zombie."""
    marker = f"marked-{os.getpid()}-{time.time_ns()}"
    env = dict(os.environ, MTPU_SWEEP_MARKER=marker)
    sleeper = subprocess.Popen([PY, "-c", "import time; time.sleep(60)"], env=env)
    quitter = subprocess.Popen([PY, "-c", "pass"], env=env)
    try:
        deadline = time.time() + 30
        while time.time() < deadline and alive(quitter.pid):
            time.sleep(0.1)
        assert not alive(quitter.pid)  # a zombie until the wait below
        assert marked_pids(marker) == [sleeper.pid]
    finally:
        kill_by_env_marker(marker)
        sleeper.wait(timeout=10)
        quitter.wait(timeout=10)
    assert marked_pids(marker) == []


def test_with_sweep_marker_accumulates_on_a_copy():
    env = {"MTPU_SWEEP_MARKER": "outer", "X": "1"}
    inner = procs.with_sweep_marker(env, "inner")
    assert inner == {"MTPU_SWEEP_MARKER": "outer,inner", "X": "1"}
    assert env == {"MTPU_SWEEP_MARKER": "outer", "X": "1"}
    assert procs.with_sweep_marker({}, "only") == {"MTPU_SWEEP_MARKER": "only"}


# -- provenance --------------------------------------------------------------


def test_stamp_shape():
    p = provenance(backend="cuda")
    assert set(p) == {"commit", "ts", "backend"}
    assert p["backend"] == "cuda"
    time.strptime(p["ts"], "%Y-%m-%dT%H:%M:%SZ")
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert provenance(backend="cuda", card=card)["card"] == card
    assert set(provenance()) == {"commit", "ts"}


def git(*args):
    subprocess.run(["git", *args], check=True, capture_output=True)


@pytest.fixture
def one_commit_repo(tmp_path):
    git("init", "-q", str(tmp_path))
    git("-C", str(tmp_path), "config", "user.email", "t@t")
    git("-C", str(tmp_path), "config", "user.name", "t")
    (tmp_path / "a.txt").write_text("v1")
    git("-C", str(tmp_path), "add", "a.txt")
    git("-C", str(tmp_path), "commit", "-q", "-m", "c1")
    return tmp_path


def test_dirty_flag_tracks_tracked_files_only(one_commit_repo):
    """An untracked file (a run's own logs) must not stamp the capture
    +dirty; a modified TRACKED file must."""
    repo = str(one_commit_repo)
    clean = git_commit(repo)
    assert clean != "unknown" and not clean.endswith("+dirty")
    (one_commit_repo / "untracked.log").write_text("noise")
    assert git_commit(repo) == clean
    (one_commit_repo / "a.txt").write_text("v2")
    assert git_commit(repo) == clean + "+dirty"


def test_outside_a_checkout_the_commit_is_unknown(tmp_path):
    assert git_commit(str(tmp_path)) == "unknown"


# -- against the reference ---------------------------------------------------


DEADLINE_CASES = {
    "lines-and-rc": dict(argv=[PY, "-c", "print('a'); print('b'); raise SystemExit(3)"],
                         timeout_s=30.0, capture=True, poll_s=0.1),
    "utf8-across-ticks": dict(argv=[PY, "-c", "import sys, time; "
                                    "sys.stdout.buffer.write('é'.encode()[:1]); "
                                    "sys.stdout.flush(); time.sleep(0.3); "
                                    "sys.stdout.buffer.write('é'.encode()[1:] + b'!\\n')"],
                              timeout_s=30.0, capture=True, poll_s=0.1),
    "env": dict(argv=[PY, "-c", "import os; print(os.environ['MTPU_PARITY'])"],
                timeout_s=30.0, capture=True, poll_s=0.1,
                env=dict(os.environ, MTPU_PARITY="both")),
    "no-capture": dict(argv=[PY, "-c", "print('x'); raise SystemExit(5)"], timeout_s=30.0,
                       poll_s=0.1),
    "deadline": dict(argv=[PY, "-c", HANG], timeout_s=1.5, capture=True, poll_s=0.1),
}


@pytest.mark.parametrize("case", sorted(DEADLINE_CASES))
def test_run_with_deadline_equals_the_references(case, capfd):
    kw = DEADLINE_CASES[case]
    want = ref_procs.run_with_deadline(**kw)
    got = run_with_deadline(**kw)
    assert got == want
    stream_kw = {**kw, "stream": True}
    capfd.readouterr()
    want_stream = ref_procs.run_with_deadline(**stream_kw)
    want_tee = capfd.readouterr().out
    got_stream = run_with_deadline(**stream_kw)
    assert (got_stream, capfd.readouterr().out) == (want_stream, want_tee)


SWEPT_CASES = {
    "out-err-rc": dict(argv=[PY, "-c", "import sys; print('o'); sys.stderr.write('e'); "
                                       "raise SystemExit(4)"], timeout_s=30.0),
    "nested-marker": dict(argv=[PY, "-c", "import os; print(os.environ['MTPU_SWEEP_MARKER'])"],
                          timeout_s=30.0, marker=f"inner-{os.getpid()}-{time.time_ns()}",
                          env=dict(os.environ, MTPU_SWEEP_MARKER="outer")),
    "cwd": dict(argv=[PY, "-c", "import os; print(os.path.basename(os.getcwd()))"],
                timeout_s=30.0, cwd=os.path.dirname(os.path.abspath(__file__))),
    "deadline": dict(argv=[PY, "-c", "import sys, time; print('partial-out', flush=True); "
                                     "sys.stderr.write('partial-err'); sys.stderr.flush(); "
                                     "time.sleep(60)"], timeout_s=1.5),
}


@pytest.mark.parametrize("case", sorted(SWEPT_CASES))
def test_run_swept_equals_the_references(case):
    kw = SWEPT_CASES[case]
    assert run_swept(**kw) == ref_procs.run_swept(**kw)


def test_run_many_with_deadline_equals_the_references(capfd):
    jobs = [
        ("ok", [PY, "-c", "print('one'); print('two')"], None),
        ("rc", [PY, "-c", "print('three', flush=True); raise SystemExit(2)"], None),
        ("partial", [PY, "-c", "import sys, time; print('four', flush=True); "
                               "sys.stdout.write('tail'); sys.stdout.flush(); "
                               "time.sleep(60)"], None),
    ]
    capfd.readouterr()
    want = ref_procs.run_many_with_deadline(jobs, timeout_s=1.5, poll_s=0.1)
    want_lines = set(capfd.readouterr().out.splitlines())
    got = run_many_with_deadline(jobs, timeout_s=1.5, poll_s=0.1)
    got_lines = set(capfd.readouterr().out.splitlines())
    assert got == want
    assert got_lines == want_lines == {"[ok] one", "[ok] two", "[rc] three",
                                       "[partial] four", "[partial] tail"}


def test_provenance_equals_the_references(one_commit_repo):
    assert set(prov.provenance(backend="cuda", card="c")) == \
        set(ref_prov.provenance(backend="cuda", card="c"))
    assert set(prov.provenance()) == set(ref_prov.provenance())
    assert prov.git_commit() == ref_prov.git_commit()
    repo = str(one_commit_repo)
    assert prov.git_commit(repo) == ref_prov.git_commit(repo)
    (one_commit_repo / "a.txt").write_text("v2")
    assert prov.git_commit(repo) == ref_prov.git_commit(repo)
