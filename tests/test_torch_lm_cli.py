"""The decoder-only LM's trial script through both CLIs, on the CPU.

Random search (seed 0) draws with numpy only, so ``hunt`` of the port's
``metaopt_tpu_torch/examples/lm_causal.py`` and of the reference's
``examples/lm_causal.py`` with the same priors (the example's ``lr``,
``dropout`` and ``n_layers``) on separate file ledgers gives the same trials:
ids, points and status. The objectives differ (each package draws its own
synthetic streams) and are held finite. Each trial is a fresh process at a
tiny width that trains with dropout and, orchestrated, publishes its
checkpoint under ``--ckpt-root``. TPE (``metaopt_tpu_torch/examples/
tpe.json`` with ``"device": "cpu"``) drives the port's script too.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger
from metaopt_tpu_torch.models.checkpoint import has_state
from metaopt_tpu_torch.models.transformer import CKPT_FILE

REPO = Path(__file__).resolve().parents[1]
PORT_SCRIPT = REPO / "metaopt_tpu_torch" / "examples" / "lm_causal.py"
REF_SCRIPT = REPO / "examples" / "lm_causal.py"
PRIORS = ["--lr~loguniform(1e-4, 1e-1)", "--dropout~uniform(0.0, 0.3)",
          "--n-layers~uniform(1, 4, discrete=True)"]
TINY = ["--d-model", "32", "--d-ff", "64", "--seq-len", "16", "--steps", "3"]


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each trial process's torch
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def rows(led):
    return sorted((t.id, json.dumps(t.params, sort_keys=True), t.status)
                  for t in FileLedger(str(led)).fetch("lm"))


def test_both_clis_run_the_lm_example_to_the_same_trials(isolated, capsys):
    cfg = isolated / "random.json"
    cfg.write_text(json.dumps({"algorithm": {"random": {"seed": 0}}}))
    common = ["--max-trials", "3", "--config", str(cfg)]
    ref_led, port_led = isolated / "ref", isolated / "port"
    assert ref_main(["hunt", "-n", "lm", "--ledger", f"file:{ref_led}", *common,
                     str(REF_SCRIPT), *TINY, *PRIORS]) == 0
    assert main(["hunt", "-n", "lm", "--ledger", f"file:{port_led}", "--ckpt-root",
                 str(isolated / "ckpt"), *common, str(PORT_SCRIPT), *TINY, "--device=cpu",
                 *PRIORS]) == 0
    capsys.readouterr()
    assert rows(port_led) == rows(ref_led)
    trials = FileLedger(str(port_led)).fetch("lm")
    assert len(trials) == 3 and all(t.status == "completed" for t in trials)
    ref_trials = FileLedger(str(ref_led)).fetch("lm")
    assert all(math.isfinite(t.objective) for t in trials + ref_trials)
    for t in trials:
        stats = {r.name: r.value for r in t.results if r.type == "statistic"}
        assert stats["device"] == "cpu" and stats["torch_dynamo_imported"] is False
        assert stats["restored"] is False and stats["updates"] == 3
        assert has_state(str(isolated / "ckpt" / t.id / CKPT_FILE)), t.id


def test_tpe_drives_the_port_lm_example(isolated, capsys):
    cfg = isolated / "tpe.json"
    tpe = json.loads((REPO / "metaopt_tpu_torch" / "examples" / "tpe.json").read_text())
    tpe["algorithm"]["tpe"].update(device="cpu", n_initial_points=2)
    cfg.write_text(json.dumps(tpe))
    assert main(["hunt", "-n", "lm", "--ledger", f"file:{isolated / 'led'}", "--max-trials",
                 "3", "--config", str(cfg), str(PORT_SCRIPT), *TINY, "--device=cpu",
                 "--n-experts", "4", *PRIORS]) == 0
    capsys.readouterr()
    trials = FileLedger(str(isolated / "led")).fetch("lm")
    assert len(trials) == 3 and all(t.status == "completed" for t in trials)
    assert all(math.isfinite(t.objective) and 1 <= t.params["n-layers"] <= 4 for t in trials)


@pytest.mark.parametrize("args,message", [
    (["--lr=1e-3"], "CUDA is not available"),
    (["--lr=1e-3", "--device=cpu", "--sp=2"], "1 devices not divisible by fixed axes 2"),
], ids=["no-cuda", "sp-2"])
def test_example_raises_without_cuda_or_with_a_mesh(tmp_path, args, message):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               METAOPT_TPU_RESULTS_PATH=str(tmp_path / "results.json"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    bad = subprocess.run([sys.executable, str(PORT_SCRIPT), *args, *TINY], env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and message in bad.stderr
    assert not (tmp_path / "results.json").exists()


@pytest.mark.parametrize("script,args", [
    ("transformer_wmt.py", ["--tp", "1", "--n-layers", "1", "--steps-per-epoch", "2"]),
    ("lm_causal.py", ["--n-layers", "2", "--seq-len", "16", "--steps", "2"]),
])
def test_the_examples_train_with_moe_feed_forwards(tmp_path, script, args):
    """``--n-experts`` swaps the feed-forwards for a MoE in both examples."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               METAOPT_TPU_RESULTS_PATH=str(tmp_path / "results.json"))
    run = subprocess.run([sys.executable, str(REPO / "metaopt_tpu_torch" / "examples" / script),
                          "--lr=1e-3", "--d-model=64", "--d-ff=64", "--device=cpu",
                          "--n-experts=4", *args],
                         env=env, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-2000:]
    results = json.loads((tmp_path / "results.json").read_text())
    assert results[0]["name"] == "loss" and math.isfinite(results[0]["value"])
