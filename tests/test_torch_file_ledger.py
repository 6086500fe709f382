"""The port's ``FileLedger`` against the JAX package's, on one directory.

The two share the on-disk layout (percent-encoded experiment dirs,
``experiment.json``, ``trials/<id>.json``, the status index snapshot and
log, ``<root>/.locks/``), so each must read what the other wrote exactly:
trial documents, statuses, results, counts and the completed log. Also:
two OS processes racing ``reserve()`` never get one trial twice, and the
spec grammar (``memory``, ``file:<dir>``, a bare dir; ``native:`` and
``coord://`` not ported) with a native store refused.
"""

import json
import os
import subprocess
import sys
import time
import urllib.parse
from pathlib import Path

import pytest

from metaopt_tpu.ledger.backends import FileLedger as RefFileLedger
from metaopt_tpu.ledger.experiment import Experiment as RefExperiment
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.ledger import Experiment, FileLedger, MemoryLedger, ledger_from_spec
from metaopt_tpu_torch.space import build_space

REPO = Path(__file__).resolve().parents[1]
SPACE = {"x": "uniform(-5, 10)", "k": "randint(1, 8)", "act": "choices(['a', 'b'])"}
NAMES = ["plain", "with/slash and space%"]


def populate(exp_cls, ledger, space, name, n=12, seed=0):
    """n trials through the writer's own Experiment: 4 completed (with a
    statistic), 2 broken, 2 reserved, 1 interrupted, the rest new."""
    exp = exp_cls(name, ledger, space=space, algorithm={"random": {"seed": seed}},
                  max_trials=50).configure()
    points = space.sample(n, seed=seed)
    exp.register_trials([exp.make_trial(p) for p in points])
    for i in range(9):
        t = exp.reserve_trial(f"w{i % 3}")
        if i < 4:
            assert exp.push_results(t, [
                {"name": "objective", "type": "objective", "value": float(i) - 1.5},
                {"name": "note", "type": "statistic", "value": f"s{i}"}])
        elif i < 6:
            t.transition("broken")
            t.exit_code = 3
            assert ledger.update_trial(t, expected_status="reserved", expected_worker=t.worker)
        elif i == 6:
            t.transition("interrupted")
            assert ledger.update_trial(t, expected_status="reserved")
    return exp


def snapshot(ledger, name):
    """Everything a reader sees of one experiment."""
    docs = sorted((t.to_dict() for t in ledger.fetch(name)), key=lambda d: d["id"])
    counts = {s: ledger.count(name, s)
              for s in ("new", "reserved", "completed", "broken", "interrupted")}
    done, _ = ledger.fetch_completed_since(name, None)
    exp_doc = dict(ledger.load_experiment(name))
    exp_doc["metadata"] = {k: v for k, v in exp_doc["metadata"].items()
                           if k != "framework_version"}
    return {"docs": docs, "counts": counts, "total": ledger.count(name),
            "completed": [t.id for t in done], "experiment": exp_doc,
            "objectives": sorted((t.id, t.objective) for t in ledger.fetch(name, "completed"))}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_reads_what_the_other_wrote(tmp_path, writer, name):
    root = str(tmp_path / "ledger")
    if writer == "reference":
        w_ledger = RefFileLedger(root)
        populate(RefExperiment, w_ledger, ref_build_space(SPACE), name)
        r_ledger = FileLedger(root)
    else:
        w_ledger = FileLedger(root)
        populate(Experiment, w_ledger, build_space(SPACE), name)
        r_ledger = RefFileLedger(root)
    want = snapshot(w_ledger, name)
    got = snapshot(r_ledger, name)
    assert got == want
    assert want["counts"] == {"new": 3, "reserved": 2, "completed": 4, "broken": 2,
                              "interrupted": 1}
    assert r_ledger.list_experiments() == w_ledger.list_experiments() == [name]
    # percent-encoded dir on disk, one lock file per experiment
    assert sorted(os.listdir(root)) == sorted([".locks", urllib.parse.quote(name, safe="")])
    assert os.listdir(os.path.join(root, ".locks")) == [urllib.parse.quote(name, safe="") + ".lock"]

    # the reader now writes; the writer reads it back: reserve the next new
    # trial, complete it, and every view agrees again
    t = r_ledger.reserve(name, "reader")
    assert t is not None and t.status == "reserved"
    t.attach_results([{"name": "objective", "type": "objective", "value": -9.0}])
    t.transition("completed")
    assert r_ledger.update_trial(t, expected_status="reserved", expected_worker="reader")
    assert snapshot(w_ledger, name) == snapshot(r_ledger, name)
    assert w_ledger.count(name, "completed") == 5
    assert w_ledger.get(name, t.id).to_dict() == t.to_dict()


def test_index_log_written_by_one_is_replayed_by_the_other(tmp_path):
    """Interleaved writers on one experiment: each op of one package is
    seen by the other's cached index on its next read (log replay)."""
    root = str(tmp_path / "ledger")
    ref, port = RefFileLedger(root), FileLedger(root)
    exp = populate(Experiment, port, build_space(SPACE), "mix", n=20)
    for i in range(6):
        writer, reader = (ref, port) if i % 2 else (port, ref)
        t = writer.reserve("mix", f"w{i}")
        assert t is not None
        t.attach_results([{"name": "objective", "type": "objective", "value": float(i)}])
        t.transition("completed")
        assert writer.update_trial(t, expected_status="reserved")
        assert reader.count("mix", "completed") == writer.count("mix", "completed")
        assert reader.get("mix", t.id).status == "completed"
    assert snapshot(ref, "mix") == snapshot(port, "mix")
    assert exp.count("completed") == 10


RACER = r'''
import json, os, sys, time
from metaopt_tpu_torch.ledger import FileLedger
led = FileLedger(sys.argv[1])
open(sys.argv[1] + "." + sys.argv[2] + ".ready", "w").close()
while not os.path.exists(sys.argv[1] + ".go"):   # start both at once
    time.sleep(0.001)
got = []
while True:
    t = led.reserve("race", sys.argv[2])
    if t is None:
        break
    got.append(t.id)
print(json.dumps(got))
'''


def test_two_processes_racing_reserve_never_share_a_trial(tmp_path):
    root = str(tmp_path / "ledger")
    port = FileLedger(root)
    exp = Experiment("race", port, space=build_space(SPACE), max_trials=500).configure()
    trials = [exp.make_trial(p) for p in exp.space.sample(400, seed=3)]
    assert len(exp.register_trials(trials)) == 400
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", RACER, root, f"p{i}"], env=env,
                              stdout=subprocess.PIPE, text=True) for i in range(2)]
    deadline = time.time() + 60
    while not all(os.path.exists(f"{root}.p{i}.ready") for i in range(2)):
        assert time.time() < deadline and all(p.poll() is None for p in procs)
        time.sleep(0.01)
    open(root + ".go", "w").close()
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    got = [json.loads(o) for o in outs]
    assert got[0] and got[1], "the two processes did not race"
    assert set(got[0]).isdisjoint(got[1])
    assert sorted(got[0] + got[1]) == sorted(t.id for t in trials)
    assert port.count("race", "reserved") == 400
    owners = {t.id: t.worker for t in port.fetch("race")}
    for i, ids in enumerate(got):
        assert all(owners[tid] == f"p{i}" for tid in ids)


def test_spec_grammar(tmp_path):
    assert isinstance(ledger_from_spec("memory"), MemoryLedger)
    led = ledger_from_spec(f"file:{tmp_path / 'a'}")
    assert isinstance(led, FileLedger) and led.root == str(tmp_path / "a")
    bare = ledger_from_spec(str(tmp_path / "b"))
    assert isinstance(bare, FileLedger) and bare.root == str(tmp_path / "b")
    for spec in (f"native:{tmp_path / 'c'}", "coord://127.0.0.1:5000"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ledger_from_spec(spec)


def test_a_native_store_is_never_hidden(tmp_path):
    root = tmp_path / "ledger"
    (root / "exp").mkdir(parents=True)
    (root / "exp" / "experiment.json").write_text(json.dumps({"name": "exp"}))
    (root / "exp" / "store").mkdir()
    with pytest.raises(RuntimeError, match="native"):
        ledger_from_spec(str(root))
    # an explicit file: spec is the user's own choice of backend
    assert isinstance(ledger_from_spec(f"file:{root}"), FileLedger)
