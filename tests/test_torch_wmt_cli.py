"""BASELINE config 4's hunt shape through the port's CLI, on the CPU.

Hyperband (``examples/hyperband.json``: seed 0, one repetition, pool 4) on
``metaopt_tpu_torch/examples/transformer_wmt.py`` with config 4's priors,
``--n-chips 1`` on one GPU slot (``MTPU_SLICE_CHIPS=1``), at a tiny width
and 2 steps per epoch, and ``epochs~fidelity(1, 3, base=3)``: 3 trials at 1
epoch promote 1 to 3, and bracket 1 runs 2 more at 3. Each trial is a
fresh process that trains with dropout and publishes its checkpoint under
``--ckpt-root``.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from metaopt_tpu_torch.algo import make_algorithm
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import Experiment, FileLedger
from metaopt_tpu_torch.models.checkpoint import has_state
from metaopt_tpu_torch.models.transformer import CKPT_FILE

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "metaopt_tpu_torch" / "examples"


def test_config4_hyperband_hunt_on_the_cpu(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each trial process's torch
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    led, ckpt = tmp_path / "ledger", tmp_path / "ckpt"
    assert main(["hunt", "-n", "wmt", "--n-chips", "1", "--ledger", f"file:{led}",
                 "--ckpt-root", str(ckpt), "--config", str(EXAMPLES / "hyperband.json"),
                 str(EXAMPLES / "transformer_wmt.py"), "--tp", "1", "--d-model", "64",
                 "--n-layers", "1", "--d-ff", "64", "--steps-per-epoch", "2", "--device=cpu",
                 "--lr~loguniform(1e-4, 5e-3)", "--dropout~uniform(0.0, 0.3)",
                 "--warmup~uniform(100, 4000, discrete=True)",
                 "--epochs~fidelity(1, 3, base=3)"]) == 0

    trials = FileLedger(str(led)).fetch("wmt")
    assert len(trials) == 6 and all(t.status == "completed" for t in trials)
    assert sorted(t.params["epochs"] for t in trials) == [1, 1, 1, 3, 3, 3]
    assert all(math.isfinite(t.objective) and t.params["dropout"] > 0 for t in trials)

    exp = Experiment("wmt", FileLedger(str(led))).configure()
    replay = make_algorithm(exp.space, exp.algorithm)
    replay.observe(exp.fetch_completed_trials())
    assert [(r["bracket"], r["budget"], r["capacity"]) for r in replay.rung_table] == [
        (0, 1, 3), (0, 3, 1), (1, 3, 2)]
    assert all(r["assigned"] == r["capacity"] == r["completed"] for r in replay.rung_table)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["status", "-n", "wmt", "--rungs", "--json", "--ledger", f"file:{led}"]) == 0
    assert json.loads(out.getvalue())[0]["rungs"] == replay.rung_table

    for t in trials:
        assert has_state(str(ckpt / t.id / CKPT_FILE)), t.id
        assert [p.name for p in (ckpt / t.id).iterdir()] == [CKPT_FILE]
        stats = {r.name: r.value for r in t.results if r.type == "statistic"}
        assert stats["device"] == "cpu" and stats["torch_dynamo_imported"] is False
        assert stats["restored"] is False and stats["ms_per_step"] > 0


@pytest.mark.parametrize("args,message", [
    (["--lr=1e-3", "--tp=1"], "CUDA is not available"),
    (["--lr=1e-3", "--device=cpu"], "1 devices not divisible by fixed axes 2"),
], ids=["no-cuda", "tp-2-default"])
def test_example_raises_without_cuda_or_at_the_reference_tp(tmp_path, args, message):
    """Without CUDA the example raises unless given ``--device cpu``; at the
    reference's default ``--tp 2`` on one device (no block of two chips) it
    raises the reference's mesh error (tp 2 on two chips:
    tests/test_torch_mesh_cli.py). Neither reports a result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               METAOPT_TPU_RESULTS_PATH=str(tmp_path / "results.json"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    bad = subprocess.run([sys.executable, str(EXAMPLES / "transformer_wmt.py"), *args,
                          "--d-model=64", "--n-layers=1", "--d-ff=64", "--steps-per-epoch=1"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and message in bad.stderr
    assert not (tmp_path / "results.json").exists()
