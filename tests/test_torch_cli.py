"""``python -m metaopt_tpu_torch`` against ``python -m metaopt_tpu``.

Random search draws with numpy only, so the same ``hunt`` command on two
separate file ledgers must give identical (trial id, params, objective,
status) sets — exact equality. The rest are ports of the reference's CLI
cases (``tests/functional/test_demo.py``): broken trials keep their exit
code, ``--n-workers`` never runs a trial twice, ``init-only`` → ``insert``
→ ``status``/``list``, ``insert`` out of space, no priors. TPE (its draws
cannot match threefry) is held to in-space, finite, and reaching EI; the
MLP example trains for real on ``--device=cpu``. Without CUDA, TPE and the
MLP script raise unless asked for the CPU, and such a trial is ``broken``.
"""

import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger
from metaopt_tpu_torch.space import build_space

REPO = Path(__file__).resolve().parents[1]
ROSENBROCK = str(REPO / "metaopt_tpu_torch" / "examples" / "rosenbrock.py")
MLP = str(REPO / "metaopt_tpu_torch" / "examples" / "mlp_mnist.py")

QUAD = '''
import argparse
from metaopt_tpu_torch.client import report_results
p = argparse.ArgumentParser()
p.add_argument("-x", type=float, required=True)
p.add_argument("--fail-above", type=float, default=None)
a = p.parse_args()
if a.fail_above is not None and a.x > a.fail_above:
    raise SystemExit(3)
report_results([{"name": "objective", "type": "objective", "value": (a.x - 1.0) ** 2}])
'''


@pytest.fixture
def quad(tmp_path):
    path = tmp_path / "quad.py"
    path.write_text(QUAD)
    return str(path)


def algo_config(tmp_path, algo):
    path = tmp_path / f"cfg_{list(algo)[0]}.yaml"
    path.write_text(json.dumps({"algorithm": algo}))  # YAML reads JSON
    return str(path)


def ledger_rows(root, name):
    return sorted((t.id, json.dumps(t.params, sort_keys=True), t.objective, t.status)
                  for t in FileLedger(root).fetch(name))


def run_json(capsys, argv, cli=main):
    rc = cli(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_hunt_ledger_matches_reference_cli(tmp_path, quad, capsys):
    cfg = algo_config(tmp_path, {"random": {"seed": 1}})
    args = ["--max-trials", "12", "--pool-size", "3", "--config", cfg,
            quad, "-x~uniform(-50, 50)"]
    ref_led, port_led = f"file:{tmp_path / 'ref'}", f"file:{tmp_path / 'port'}"
    rc_ref, ref_out = run_json(capsys, ["hunt", "-n", "demo", "--ledger", ref_led] + args,
                               cli=ref_main)
    rc, out = run_json(capsys, ["hunt", "-n", "demo", "--ledger", port_led] + args)
    assert rc == rc_ref == 0
    want = ledger_rows(str(tmp_path / "ref"), "demo")
    got = ledger_rows(str(tmp_path / "port"), "demo")
    assert len(got) == 12 and got == want
    assert out["total"] == ref_out["total"] == {"completed": 12}
    assert out["best"] == ref_out["best"]
    # either package's status reads either ledger the same way
    for led in (ref_led, port_led):
        views = [run_json(capsys, ["status", "-n", "demo", "--ledger", led, "--json"], cli=c)
                 for c in (main, ref_main)]
        assert views[0] == views[1] and views[0][1][0]["by_status"] == {"completed": 12}


def test_broken_trials_marked(tmp_path, quad, capsys):
    led = str(tmp_path / "ledger")
    rc, out = run_json(capsys, [
        "hunt", "-n", "brk", "--ledger", led, "--max-trials", "6", "--exp-max-broken", "50",
        "--config", algo_config(tmp_path, {"random": {"seed": 2}}),
        quad, "-x~uniform(-50, 50)", "--fail-above=0"])
    assert rc == 0
    trials = FileLedger(led).fetch("brk")
    broken = [t for t in trials if t.status == "broken"]
    completed = [t for t in trials if t.status == "completed"]
    assert len(completed) == 6 and out["total"]["broken"] == len(broken) > 0
    assert all(t.params["x"] <= 0 for t in completed)
    assert all(t.params["x"] > 0 and t.exit_code == 3 for t in broken)


def test_n_workers_parallel_trials_no_double_execution(tmp_path, quad, capsys):
    led = str(tmp_path / "ledger")
    rc, out = run_json(capsys, [
        "hunt", "-n", "par", "--ledger", led, "--max-trials", "9", "--n-workers", "3",
        "--pool-size", "3", quad, "-x~uniform(-50, 50)"])
    assert rc == 0
    assert out["n_workers"] == 3 and out["failed_workers"] == 0
    assert out["completed_by_worker"] >= 9
    done = [t for t in FileLedger(led).fetch("par") if t.status == "completed"]
    assert len(done) >= 9 and len({t.id for t in done}) == len(done)
    assert all(t.worker and "-w" in t.worker for t in done)


def test_init_only_then_insert_then_status_list_info_resume(tmp_path, quad, capsys):
    led = str(tmp_path / "ledger")
    assert main(["init-only", "-n", "pre", "--ledger", led, "--max-trials", "5",
                 quad, "-x~uniform(-2, 2)"]) == 0
    capsys.readouterr()
    assert main(["insert", "-n", "pre", "--ledger", led, "--params", '{"x": 1.5}']) == 0
    assert "registered trial" in capsys.readouterr().out
    rc, stats = run_json(capsys, ["status", "-n", "pre", "--ledger", led, "--json"])
    assert rc == 0 and stats[0]["trials"] == 1 and stats[0]["by_status"] == {"new": 1}
    rc, rows = run_json(capsys, ["list", "--ledger", led, "--json"])
    assert [r["name"] for r in rows] == ["pre"] and rows[0]["trials"] == 1
    assert not rows[0]["done"] and rows[0]["algorithm"] == "random"
    rc, info = run_json(capsys, ["info", "-n", "pre", "--ledger", led, "--json"])
    assert info["space"] == {"x": "uniform(-2, 2)"} and info["max_trials"] == 5
    assert info["user_args"] == [quad, "-x~uniform(-2, 2)"]
    # the joiner hunt reuses the stored command; the inserted point runs
    # first (the producer registers one suggestion of its own meanwhile)
    rc, out = run_json(capsys, ["hunt", "-n", "pre", "--ledger", led, "--worker-trials", "1"])
    assert out["total"] == {"completed": 1, "new": 1} and out["best"]["params"] == {"x": 1.5}
    assert out["best"]["objective"] == 0.25
    # resume flips a parked trial back to new
    led_ = FileLedger(led)
    (t,) = led_.fetch("pre", "completed")
    t.status = "broken"
    assert led_.update_trial(t)
    assert main(["resume", "-n", "pre", "--ledger", led, "--statuses", "broken"]) == 0
    assert capsys.readouterr().out.strip() == "resumed 1 trial(s)"
    t = led_.get("pre", t.id)
    assert t.status == "new" and t.results == [] and t.worker is None
    assert main(["status", "-n", "pre", "--ledger", led, "--workers"]) == 0
    assert main(["list", "--ledger", led]) == 0
    assert main(["info", "-n", "pre", "--ledger", led]) == 0
    text = capsys.readouterr().out
    assert "pre: 2/5 trials (new:2)" in text and "x~uniform(-2, 2)" in text


def test_insert_rejects_out_of_space(tmp_path, quad, capsys):
    led = str(tmp_path / "ledger")
    main(["init-only", "-n", "pre2", "--ledger", led, quad, "-x~uniform(-2, 2)"])
    with pytest.raises(SystemExit, match="not inside"):
        main(["insert", "-n", "pre2", "--ledger", led, "--params", '{"x": 99.0}'])


def test_hunt_without_priors_errors(tmp_path, quad):
    with pytest.raises(SystemExit, match="no ~priors"):
        main(["init-only", "-n", "nope", "--ledger", str(tmp_path / "l"), quad, "-x", "3"])


def test_on_conflict_fail_and_adopt(tmp_path, quad, capsys):
    led = str(tmp_path / "ledger")
    main(["init-only", "-n", "c", "--ledger", led, quad, "-x~uniform(-2, 2)"])
    with pytest.raises(SystemExit, match="different configuration"):
        main(["init-only", "-n", "c", "--ledger", led, "--on-conflict", "fail",
              quad, "-x~uniform(-3, 3)"])
    capsys.readouterr()
    assert main(["init-only", "-n", "c", "--ledger", led, quad, "-x~uniform(-3, 3)"]) == 0
    assert "uniform(-2, 2)" in capsys.readouterr().out  # the stored config wins


@pytest.mark.parametrize("flags,what", [
    (["--n-chips", "1"], "--n-chips"),
    (["--batch-size", "4"], "batched hunt"),
    (["--vector-objective", "rosenbrock"], "batched hunt"),
    (["--branch-from", "a"], "--branch-from"),
    (["--warm-start", "a"], "--warm-start"),
    (["--on-conflict", "branch"], "--on-conflict branch"),
])
def test_unported_flags_say_so(tmp_path, quad, flags, what):
    with pytest.raises(SystemExit, match="not ported yet") as err:
        main(["hunt", "-n", "np", "--ledger", str(tmp_path / "l")] + flags
             + [quad, "-x~uniform(-2, 2)"])
    assert what in str(err.value)
    for spec in ("native:" + str(tmp_path / "n"), "coord://127.0.0.1:1"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            main(["status", "--ledger", spec])


def test_the_coordinator_producer_is_refused_by_workon(tmp_path, quad):
    with pytest.raises(NotImplementedError, match="'coord': coordinator producer not ported"):
        main(["hunt", "-n", "pc", "--ledger", str(tmp_path / "l"), "--producer", "coord",
              quad, "-x~uniform(-2, 2)"])


def test_an_evc_family_the_reference_wrote_reads_and_joins(tmp_path, quad, capsys):
    # the port does not branch yet: a version family exists only in a ledger
    # the reference's CLI wrote (--on-conflict branch makes name-v2)
    led = f"file:{tmp_path / 'l'}"
    for prior, flags in (("-x~uniform(-2, 2)", []), ("-x~uniform(-3, 3)", ["--on-conflict",
                                                                             "branch"])):
        assert ref_main(["init-only", "-n", "fam", "--ledger", led, "--max-trials", "2"]
                        + flags + [quad, prior]) == 0
    capsys.readouterr()
    assert ref_main(["list", "--ledger", led]) == 0
    want = capsys.readouterr().out
    assert main(["list", "--ledger", led]) == 0
    got = capsys.readouterr().out
    assert got == want and "\n  └─ fam-v2 (v2)" in got  # the child indents under fam
    assert main(["info", "-n", "fam-v2", "--ledger", led]) == 0
    assert "branched from: fam" in capsys.readouterr().out
    # the v2 configuration joins fam-v2, not fam
    assert main(["hunt", "-n", "fam", "--ledger", led, quad, "-x~uniform(-3, 3)"]) == 0
    assert len(FileLedger(str(tmp_path / "l")).fetch("fam-v2")) == 2
    assert FileLedger(str(tmp_path / "l")).fetch("fam") == []


def ei_suggested(trials, n_initial):
    """Trials registered after the algorithm had observed ``n_initial``
    completions: TPE suggests those by EI (one worker, pool 1)."""
    done = sorted(t.end_time for t in trials if t.status == "completed")
    switch = done[n_initial - 1]
    return [t for t in trials if t.submit_time > switch]


def test_tpe_hunt_on_cpu_reaches_ei(tmp_path, quad, capsys):
    led = str(tmp_path / "ledger")
    rc, out = run_json(capsys, [
        "hunt", "-n", "tpe", "--ledger", led, "--max-trials", "7",
        "--config", algo_config(tmp_path, {"tpe": {"seed": 0, "n_initial_points": 3,
                                                    "device": "cpu"}}),
        quad, "-x~uniform(-50, 50)"])
    assert rc == 0 and out["total"] == {"completed": 7}
    trials = FileLedger(led).fetch("tpe")
    space = build_space({"x": "uniform(-50, 50)"})
    assert all(t.params in space and math.isfinite(t.objective) for t in trials)
    assert len(ei_suggested(trials, 3)) >= 4


def test_tpe_hunt_without_cuda_raises(tmp_path, quad):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: TPE runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["hunt", "-n", "tpe-cuda", "--ledger", str(tmp_path / "l"), "--max-trials", "2",
              "--algo", "tpe", quad, "-x~uniform(-50, 50)"])


MLP_PRIORS = ["--lr~loguniform(1e-4, 1e-1)", "--width~uniform(64, 128, discrete=True)",
              "--depth~uniform(1, 2, discrete=True)", "--dropout~uniform(0.0, 0.5)"]


def test_mlp_hunt_on_cpu(tmp_path, capsys):
    led = str(tmp_path / "ledger")
    rc, out = run_json(capsys, ["hunt", "-n", "mlp", "--ledger", led, "--max-trials", "2",
                                MLP, *MLP_PRIORS, "--epochs=1", "--device=cpu"])
    assert rc == 0 and out["total"] == {"completed": 2}
    for t in FileLedger(led).fetch("mlp"):
        stats = {r.name: r.value for r in t.results if r.type == "statistic"}
        assert 0.0 <= t.objective <= 1.0
        assert stats["device"] == "cpu"
        assert 0 < stats["first_device_op_s"] <= stats["first_matmul_s"]
        assert 0 < stats["train_s"] <= stats["train_and_eval_s"]
        assert 0 < stats["optimizer_init_s"] <= stats["setup_s"] <= stats["train_and_eval_s"]
        assert stats["train_ms_per_step"] == pytest.approx(stats["train_s"] / 32 * 1e3)


def test_mlp_trial_without_cuda_is_broken_not_rerun(tmp_path, capsys, caplog):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the trial runs on it")
    led = str(tmp_path / "ledger")
    with caplog.at_level(logging.WARNING):
        rc, out = run_json(capsys, ["hunt", "-n", "mlp", "--ledger", led, "--max-trials", "1",
                                    "--exp-max-broken", "1", MLP, *MLP_PRIORS, "--epochs=1"])
    assert rc == 1 and out["total"] == {"broken": 1} and out["best"] is None
    (t,) = FileLedger(led).fetch("mlp")
    assert t.status == "broken" and t.exit_code == 1 and t.results == []
    assert "CUDA is not available" in caplog.text


def test_python_dash_m_runs_the_cli(tmp_path):
    """``python -m metaopt_tpu_torch``: hunt BASELINE config 1's script,
    then ``status --json`` from a second fresh process agrees."""
    led = f"file:{tmp_path / 'ledger'}"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cfg = algo_config(tmp_path, {"random": {"seed": 0}})
    hunt = subprocess.run(
        [sys.executable, "-m", "metaopt_tpu_torch", "hunt", "-n", "rosen", "--ledger", led,
         "--max-trials", "4", "--n-workers", "2", "--config", cfg, ROSENBROCK,
         "-x~uniform(-5, 10)", "-y~uniform(-5, 10)"],
        env=env, capture_output=True, text=True, timeout=300)
    assert hunt.returncode == 0, hunt.stderr[-2000:]
    out = json.loads(hunt.stdout)
    status = subprocess.run(
        [sys.executable, "-m", "metaopt_tpu_torch", "status", "-n", "rosen", "--ledger", led,
         "--json"], env=env, capture_output=True, text=True, timeout=300, check=True)
    (s,) = json.loads(status.stdout)
    assert s["by_status"] == out["total"] and s["best"] == out["best"]
    assert s["by_status"]["completed"] >= 4
    x, y = s["best"]["params"]["x"], s["best"]["params"]["y"]
    assert s["best"]["objective"] == (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2
