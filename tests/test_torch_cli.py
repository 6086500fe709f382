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
ASHA with ``--n-chips 1`` (each trial pinned to a GPU block) draws with
numpy only, so both CLIs give the same ledger and the same ``status
--rungs``; the ResNet example runs one tiny trial on ``--device=cpu``.
"""

import json
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger, ledger_from_spec
from metaopt_tpu_torch.space import build_space

REPO = Path(__file__).resolve().parents[1]
ROSENBROCK = str(REPO / "metaopt_tpu_torch" / "examples" / "rosenbrock.py")
MLP = str(REPO / "metaopt_tpu_torch" / "examples" / "mlp_mnist.py")
RESNET = str(REPO / "metaopt_tpu_torch" / "examples" / "resnet_cifar.py")

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
    trials = ledger_from_spec(led).fetch("brk")
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
    done = [t for t in ledger_from_spec(led).fetch("par") if t.status == "completed"]
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
    led_ = ledger_from_spec(led)
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
    (["--branch-from", "a"], "branch"),
    (["--warm-start", "a"], "warm_start"),
    (["--on-conflict", "branch"], "branch"),
])
def test_ported_evc_flags_run_and_coord_says_so(tmp_path, quad, flags, what, capsys):
    """The EVC flags are ported: a hunt that names them runs and records
    them in the child's document; ``coord://`` names a coordinator, and
    with none listening the CLI raises the reference's typed error."""
    led = str(tmp_path / "l")
    base = ["--max-trials", "2", "--config", algo_config(tmp_path, {"random": {"seed": 0}})]
    assert main(["hunt", "-n", "a", "--ledger", led] + base + [quad, "-x~uniform(-2, 2)"]) == 0
    name = "a" if flags[0] == "--on-conflict" else "np"
    assert main(["hunt", "-n", name, "--ledger", led] + base + flags
                + [quad, "-x~uniform(-3, 3)"]) == 0
    capsys.readouterr()
    child = "a-v2" if flags[0] == "--on-conflict" else "np"
    doc = ledger_from_spec(led).load_experiment(child)
    assert doc["metadata"].get(what), doc["metadata"]
    assert ledger_from_spec(led).count(child, "completed") == 2
    from metaopt_tpu_torch.coord.client_backend import CoordUnavailableError

    for spec in ("coord://127.0.0.1:1",):
        with pytest.raises(CoordUnavailableError, match="127.0.0.1:1 unreachable"):
            main(["status", "--ledger", spec])


def test_the_coordinator_producer_is_refused_by_workon(tmp_path, quad):
    """``--producer coord`` needs a ``coord://`` ledger, as in the
    reference: on a local ledger ``workon`` refuses it."""
    with pytest.raises(ValueError, match="needs the coord:// ledger backend"):
        main(["hunt", "-n", "pc", "--ledger", str(tmp_path / "l"), "--producer", "coord",
              quad, "-x~uniform(-2, 2)"])


def test_an_evc_family_the_reference_wrote_reads_and_joins(tmp_path, quad, capsys):
    # a version family the reference's CLI wrote (--on-conflict branch
    # makes name-v2) reads and joins in the port
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
    trials = ledger_from_spec(led).fetch("tpe")
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
    for t in ledger_from_spec(led).fetch("mlp"):
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
    (t,) = ledger_from_spec(led).fetch("mlp")
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


ASHA_SCRIPT = '''
import argparse
from metaopt_tpu_torch.client import report_partial, report_results
p = argparse.ArgumentParser()
p.add_argument("-x", type=float, required=True)
p.add_argument("--epochs", type=int, required=True)
a = p.parse_args()
for e in range(1, a.epochs + 1):
    err = (a.x - 1.0) ** 2 + 1.0 / e
    report_partial(err, e)
report_results([{"name": "objective", "type": "objective", "value": err}])
'''
ASHA_PRIORS = ["-x~uniform(-5, 5)", "--epochs~fidelity(1, 4, base=2)"]


@pytest.fixture(scope="module")
def asha_hunts(tmp_path_factory):
    """One ASHA hunt per pool size with ``--n-chips 1`` through each CLI on
    its own file ledger, with the GPU registry in this fixture's TMPDIR."""
    import tempfile

    root = tmp_path_factory.mktemp("asha")
    script = root / "asha_trial.py"
    script.write_text(ASHA_SCRIPT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_SLICE_CHIPS", "1")
        mp.setenv("TMPDIR", str(root))
        mp.setattr(tempfile, "tempdir", str(root))
        for pool in (1, 4):
            cfg = root / f"asha{pool}.json"
            cfg.write_text(json.dumps({"algorithm": {"asha": {"seed": 0}}, "pool_size": pool}))
            for tag, cli in (("ref", ref_main), ("port", main)):
                rc = cli(["hunt", "-n", "asha", "--n-chips", "1", "--max-trials", "12",
                          "--ledger", f"file:{root / f'{tag}{pool}'}", "--config", str(cfg),
                          str(script)] + ASHA_PRIORS)
                assert rc == 0
    return root


def asha_rows(root, name):
    return sorted((t.id, json.dumps(t.params, sort_keys=True), t.objective, t.status,
                   t.lineage, t.parent) for t in FileLedger(root).fetch(name))


@pytest.mark.parametrize("pool", [1, 4])
def test_asha_hunt_on_gpu_blocks_matches_reference_cli(asha_hunts, pool):
    want = asha_rows(str(asha_hunts / f"ref{pool}"), "asha")
    got = asha_rows(str(asha_hunts / f"port{pool}"), "asha")
    assert len(got) == 12 and got == want
    trials = FileLedger(str(asha_hunts / f"port{pool}")).fetch("asha")
    assert all(t.status == "completed" for t in trials)
    # every trial ran pinned to GPU 0, and the registry holds no claim after
    assert all(t.resources["chips"] == [0] and t.resources["env"]["CUDA_VISIBLE_DEVICES"] == "0"
               for t in trials)
    assert json.loads((asha_hunts / "metaopt_tpu_torch-gpus-1.json").read_text()) == {
        "claims": {}}
    # a promotion keeps its parent's lineage: same point, a higher budget
    by_lineage = {}
    for t in trials:
        by_lineage.setdefault(t.lineage, set()).add(t.params["epochs"])
    assert any(len(b) > 1 for b in by_lineage.values())
    budgets = {t.params["epochs"] for t in trials}
    # one worker at pool 4 registers four fresh trials per cycle while it
    # completes one: the budget fills before ASHA reaches the top rung
    assert budgets == ({1, 2, 4} if pool == 1 else {1, 2})


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_status_rungs_matches_reference_cli(asha_hunts, capsys, as_json):
    outs = []
    for tag, cli in (("ref", ref_main), ("port", main)):
        capsys.readouterr()
        argv = ["status", "-n", "asha", "--rungs", "--ledger", f"file:{asha_hunts / f'{tag}1'}"]
        assert cli(argv + (["--json"] if as_json else [])) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    if as_json:
        (s,) = json.loads(outs[1])
        assert [(r["budget"], r["promoted"]) for r in s["rungs"]] == [(1, 0), (2, 0), (4, 0)]
        assert sum(r["n"] for r in s["rungs"]) == 12 and s["rungs"][-1]["n"] >= 1
    else:
        assert "  bracket 0 budget     4: " in outs[1]


def test_resnet_trial_through_the_cli_on_cpu(tmp_path, monkeypatch, capsys):
    import tempfile

    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    led = str(tmp_path / "ledger")
    rc, out = run_json(capsys, [
        "hunt", "-n", "resnet", "--n-chips", "1", "--max-trials", "1", "--ledger", led,
        "--config", str(REPO / "metaopt_tpu_torch" / "examples" / "asha.json"), RESNET,
        "--lr~loguniform(1e-3, 1.0)", "--momentum~uniform(0.8, 0.99)",
        "--weight-decay~loguniform(1e-6, 1e-2)", "--epochs~fidelity(1, 16, base=4)",
        "--device=cpu", "--depth=18", "--width=8", "--hw=8", "--n-train=64", "--n-val=32",
        "--batch-size=32"])
    assert rc == 0 and out["total"] == {"completed": 1}
    (t,) = ledger_from_spec(led).fetch("resnet")
    stats = {r.name: r.value for r in t.results if r.type == "statistic"}
    assert 0.0 <= t.objective <= 1.0 and t.params["epochs"] == 1
    assert stats["device"] == "cpu" and len(stats["epoch_losses"]) == 1
    assert 0 < stats["first_device_op_s"] and 0 < stats["train_s"] and 0 < stats["eval_s"]
    assert stats["train_ms_per_step"] == pytest.approx(stats["train_s"] / 2 * 1e3)
    assert stats["setup_s"] + stats["train_s"] + stats["eval_s"] <= stats["train_and_eval_s"]
    assert t.resources["chips"] == [0]


def test_executor_n_chips_in_the_config_file_pins_trials(tmp_path, quad, capsys, monkeypatch):
    import tempfile

    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    pinned = tmp_path / "pinned.json"
    pinned.write_text(json.dumps({"executor": {"n_chips": 1}}))
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"algorithm": {"random": {"seed": 0}}}))
    for name, cfg, want in (("pinned", pinned, [0]), ("plain", plain, None)):
        led = str(tmp_path / name)
        rc, out = run_json(capsys, ["hunt", "-n", name, "--max-trials", "2", "--ledger", led,
                                    "--config", str(cfg), quad, "-x~uniform(-2, 2)"])
        assert rc == 0 and out["total"] == {"completed": 2}
        # the defaults' executor.n_chips (1) pins nothing; the file's does
        assert all(t.resources.get("chips") == want for t in ledger_from_spec(led).fetch(name))


def _cpu_coord_config(tmp_path):
    path = tmp_path / "coord_cpu.json"
    path.write_text(json.dumps({"coordinator": {"device": "cpu"}}))
    return str(path)


def _serve(argv, env, timeout_s=120.0):
    """Start ``python -m metaopt_tpu_torch serve ...``; return the process
    and its ready line (or the whole output if it exited first)."""
    import threading

    proc = subprocess.Popen([sys.executable, "-m", "metaopt_tpu_torch", "serve"] + argv,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []
    ready = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "coordinator ready" in line:
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + timeout_s
    while not ready.wait(0.05):
        if proc.poll() is not None or time.monotonic() > deadline:
            reader.join(timeout=5)
            break
    return proc, "".join(lines), reader


def test_serve_shards_then_rebalance_through_python_dash_m(tmp_path, quad, capsys):
    """``serve --shards 2`` with ``coordinator.device: cpu``: a hosted hunt
    through the router's public address, then ``rebalance`` moves the
    experiment to the other shard with every completion, in the
    reference's words; a second ``rebalance`` has nothing to do."""
    from metaopt_tpu_torch.coord import CoordLedgerClient
    from metaopt_tpu_torch.coord.shards import ring_of

    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
    snap = tmp_path / "shards"
    snap.mkdir()
    proc, out, reader = _serve(["--shards", "2", "--ledger", "memory", "--snapshot",
                                str(snap), "--config", _cpu_coord_config(tmp_path)], env)
    try:
        assert "coordinator ready at coord://" in out, out[-3000:]
        assert "2 shards: s0=coord://" in out
        addr = out.split("coordinator ready at coord://")[1].split()[0]
        host, port = addr.rsplit(":", 1)
        c = CoordLedgerClient(host, int(port), io_timeout_s=60.0, reconnect_window_s=30.0)
        smap = c.ping()["shard_map"]
        nm = next(f"cli-{i}" for i in range(100) if ring_of(smap).owner(f"cli-{i}") == "s0")
        cfg = algo_config(tmp_path, {"random": {"seed": 2}})
        rc = main(["hunt", "-n", nm, "--ledger", f"coord://{addr}", "--producer", "coord",
                   "--n-workers", "2", "--max-trials", "4", "--config", cfg, quad,
                   "-x~uniform(-3, 3)"])
        assert rc == 0
        capsys.readouterr()
        assert c.count(nm, "completed") == 4
        before = sorted(t.id for t in c.fetch(nm))
        reb = [sys.executable, "-m", "metaopt_tpu_torch", "rebalance", "--coord", addr,
               "--experiment", nm, "--dest", "s1", "--window-s", "30"]
        moved = subprocess.run(reb, env=env, capture_output=True, text=True, timeout=120)
        assert moved.returncode == 0, moved.stderr[-2000:]
        assert moved.stdout.startswith(f"{nm}: s0 -> s1 ({len(before)} trials, ")
        assert moved.stdout.rstrip().endswith("cached replies, map v2)")
        c.ping()
        assert c._ring.owner(nm) == "s1"
        assert sorted(t.id for t in c.fetch(nm)) == before
        assert c.count(nm, "completed") == 4
        again = subprocess.run(reb, env=env, capture_output=True, text=True, timeout=120)
        assert again.returncode == 0
        assert "already lives on s1; nothing to do" in again.stdout
        bad = subprocess.run(reb[:-4] + ["--dest", "s9"], env=env, capture_output=True,
                             text=True, timeout=120)
        assert bad.returncode == 2 and "unknown destination shard 's9'" in bad.stderr
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        reader.join(timeout=10)
    assert proc.returncode == 0


def test_serve_shards_without_cuda_fails_unless_given_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
    proc, out, reader = _serve(["--shards", "2", "--ledger", "memory"], env)
    try:
        assert proc.wait(timeout=60) != 0
    finally:
        if proc.poll() is None:
            proc.kill()
        reader.join(timeout=10)
    out += proc.stdout.read() if not proc.stdout.closed else ""
    assert "CUDA is not available" in out and "coordinator ready" not in out


def test_simulate_json_gives_the_reference_report(tmp_path, capsys):
    """``simulate --json`` on ``coordinator.device: cpu``: the reference
    CLI's report keys and verdict, and for ASHA and Hyperband its event-log
    digest; without the config it raises (no CUDA here)."""
    argv = ["simulate", "--workers", "150", "--algos", "asha", "hyperband",
            "--trials", "16", "--seed", "3", "--json"]
    rc, ours = run_json(capsys, argv + ["--config", _cpu_coord_config(tmp_path)])
    ref_rc, theirs = run_json(capsys, argv, cli=ref_main)
    assert rc == ref_rc == 0 and ours["ok"] is theirs["ok"] is True
    assert ours.keys() == theirs.keys()
    assert ours["config"].keys() == theirs["config"].keys()
    assert ours["crashes"] == theirs["crashes"] == 2
    assert ours["event_log_sha256"] == theirs["event_log_sha256"]
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def _subcommand_options(build_parser, name):
    """(flags, dest, nargs, choices, default, const) of every argument of one
    subcommand, sorted, help texts aside."""
    import argparse

    sub = next(a for a in build_parser()._actions
               if isinstance(a, argparse._SubParsersAction)).choices[name]
    return sorted((tuple(a.option_strings), a.dest, a.nargs,
                   tuple(a.choices) if a.choices else None, repr(a.default), repr(a.const))
                  for a in sub._actions if not isinstance(a, argparse._HelpAction))


@pytest.mark.parametrize("name", ["lint", "race", "crashcheck", "analyze"])
def test_the_checkers_take_the_reference_options(name):
    """``lint``, ``race``, ``crashcheck`` and ``analyze`` parse the reference
    CLI's options; ``race`` adds ``--config``, whose ``coordinator.device``
    places its suites, as ``simulate`` does."""
    from metaopt_tpu.cli.main import build_parser as ref_build_parser
    from metaopt_tpu_torch.cli.main import build_parser

    ours = _subcommand_options(build_parser, name)
    theirs = _subcommand_options(ref_build_parser, name)
    extra = [o for o in ours if o not in theirs]
    assert [o for o in theirs if o not in ours] == []
    assert [o[0] for o in extra] == ([("--config",)] if name == "race" else [])
