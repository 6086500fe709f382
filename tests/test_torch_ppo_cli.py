"""Config 5's and Hyperband's hunts through the CLIs.

``examples/evolution.yaml``'s (EvolutionES seed 0, population 10, pool 5)
and ``examples/hyperband.yaml``'s (Hyperband seed 0, one repetition, pool
4) hunt shapes, over config 5's priors, run through both CLIs with
``--n-chips 1`` on one GPU (``MTPU_SLICE_CHIPS=1``) and a closed-form trial
script that imports neither torch nor jax: the two ledgers are equal, and
so is ``status --rungs``'s text. Then ``metaopt_tpu_torch/examples/
ppo_atari.py`` itself: it raises without CUDA unless given ``--device
cpu``, and with it a short hunt of config 5's command runs through the
port's CLI on the CPU.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger

REPO = Path(__file__).resolve().parents[1]

SCRIPT = '''
import argparse, math
from metaopt_tpu_torch.client import report_results
p = argparse.ArgumentParser()
p.add_argument("--lr", type=float, required=True)
p.add_argument("--clip-eps", type=float, required=True)
p.add_argument("--ent-coef", type=float, required=True)
p.add_argument("--gae-lambda", type=float, required=True)
p.add_argument("--epochs", type=int, required=True)
a = p.parse_args()
neg = ((math.log10(a.lr) + 3.5) ** 2 + (a.clip_eps - 0.2) ** 2 + (a.gae_lambda - 0.95) ** 2
       + abs(math.log10(a.ent_coef) + 2.0) / 10.0 + 8.0 / a.epochs)
report_results([{"name": "neg_return", "type": "objective", "value": neg}])
'''
PRIORS = ["--lr~loguniform(1e-5, 1e-2)", "--clip-eps~uniform(0.05, 0.4)",
          "--ent-coef~loguniform(1e-4, 1e-1)", "--gae-lambda~uniform(0.8, 1.0)"]


def run_status(cli, led, name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli(["status", "-n", name, "--rungs", "--ledger", f"file:{led}"]) == 0
    return out.getvalue()


@pytest.mark.parametrize("algo,fidelity,max_trials,budgets", [
    ({"evolution_es": {"seed": 0, "population_size": 10}}, "fidelity(2, 32, base=2)", 20,
     {2: 10, 4: 10}),
    ({"hyperband": {"seed": 0, "repetitions": 1}}, "fidelity(2, 8, base=2)", 100,
     {2: 4, 4: 5, 8: 5}),
], ids=["config-5-evolution", "hyperband"])
def test_hunt_shapes_give_equal_ledgers_through_both_clis(tmp_path, monkeypatch, algo,
                                                          fidelity, max_trials, budgets):
    import tempfile

    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    script = tmp_path / "trial.py"
    script.write_text(SCRIPT)
    pool = 5 if "evolution_es" in algo else 4   # examples/evolution.yaml, hyperband.yaml
    cfg = tmp_path / "algo.json"
    cfg.write_text(json.dumps({"algorithm": algo, "pool_size": pool}))
    rows, status = {}, {}
    for tag, cli in (("ref", ref_main), ("port", main)):
        led = tmp_path / tag
        assert cli(["hunt", "-n", "c5", "--n-chips", "1", "--max-trials", str(max_trials),
                    "--ledger", f"file:{led}", "--config", str(cfg), str(script)]
                   + PRIORS + [f"--epochs~{fidelity}"]) == 0
        trials = FileLedger(str(led)).fetch("c5")
        rows[tag] = sorted((t.id, json.dumps(t.params, sort_keys=True), t.objective, t.status,
                            t.lineage) for t in trials)
        status[tag] = run_status(cli, led, "c5")
    assert rows["port"] == rows["ref"]
    assert status["port"] == status["ref"]
    assert all(t.status == "completed" for t in trials)
    counts = {}
    for t in trials:
        counts[t.params["epochs"]] = counts.get(t.params["epochs"], 0) + 1
    assert counts == budgets
    if "hyperband" in algo:
        assert len(trials) == 14
        assert "bracket 2 budget     8: 3 completed, 3/3 assigned" in status["port"]


def test_example_raises_without_cuda_unless_given_cpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               METAOPT_TPU_RESULTS_PATH=str(tmp_path / "results.json"))
    script = str(REPO / "metaopt_tpu_torch" / "examples" / "ppo_atari.py")
    bad = subprocess.run([sys.executable, script, "--lr=1e-3", "--epochs=2"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "CUDA is not available" in bad.stderr
    assert not (tmp_path / "results.json").exists()


def test_example_hunts_through_the_port_cli_on_the_cpu(tmp_path, monkeypatch):
    """Config 5's command, cut to 2 trials of 2 iterations on the CPU."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each trial process's torch
    led = tmp_path / "ledger"
    assert main(["hunt", "-n", "ppo", "--max-trials", "2", "--ledger", f"file:{led}",
                 "--config", str(REPO / "metaopt_tpu_torch/examples/evolution.json"),
                 str(REPO / "metaopt_tpu_torch/examples/ppo_atari.py"), "--device=cpu",
                 "--lr~loguniform(1e-5, 1e-2)", "--clip-eps~uniform(0.05, 0.4)",
                 "--ent-coef~loguniform(1e-4, 1e-1)", "--gae-lambda~uniform(0.8, 1.0)",
                 "--epochs~fidelity(2, 32, base=2)"]) == 0
    trials = FileLedger(str(led)).fetch("ppo")
    assert len(trials) == 2 and all(t.status == "completed" for t in trials)
    assert [t.params["epochs"] for t in trials] == [2, 2]
    for t in trials:
        stats = {r.name: r.value for r in t.results if r.type == "statistic"}
        assert np.isfinite(t.objective) and stats["device"] == "cpu"
        assert stats["ms_per_iteration"] > 0 and stats["first_device_op_s"] > 0
        assert {"setup_s", "train_s", "train_call_s"} <= stats.keys()
