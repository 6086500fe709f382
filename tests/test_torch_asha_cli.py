"""BASELINE config 3's hunt at its own shape, through both CLIs.

``examples/asha.yaml`` (ASHA seed 0, pool 4) over config 3's priors (lr,
momentum, weight decay, ``epochs~fidelity(1, 16, base=4)``) with
``--n-chips 1`` on one GPU (``MTPU_SLICE_CHIPS=1``), the trial a torch-free
script that streams a closed-form partial per epoch. Both CLIs must give
the same ledger. At the example's pool of 4 and its 64 trials one worker
never reaches 16 epochs: every cycle registers a full pool of fresh
1-epoch trials while the worker completes one, so the budget fills before
ASHA can promote. At a pool of 1, 21 trials reach 16 epochs whatever the
objectives (the cut config 3 runs with on the card): ASHA promotes at
least a quarter of a rung's results, so 16 one-epoch results put four
trials at 4 epochs and their results put one at 16. With this script's
objective the 17th trial is already at 16.
"""

import collections
import json

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger

SCRIPT = '''
import argparse, math
from metaopt_tpu_torch.client import report_partial, report_results
p = argparse.ArgumentParser()
p.add_argument("--lr", type=float, required=True)
p.add_argument("--momentum", type=float, required=True)
p.add_argument("--weight-decay", type=float, required=True)
p.add_argument("--epochs", type=int, required=True)
a = p.parse_args()
for e in range(1, a.epochs + 1):
    err = ((math.log10(a.lr) + 1.0) ** 2 + (a.momentum - 0.9) ** 2
           + abs(math.log10(a.weight_decay) + 4.0) / 10.0 + 1.0 / e)
    report_partial(err, e)
report_results([{"name": "objective", "type": "objective", "value": err}])
'''
PRIORS = ["--lr~loguniform(1e-3, 1.0)", "--momentum~uniform(0.8, 0.99)",
          "--weight-decay~loguniform(1e-6, 1e-2)", "--epochs~fidelity(1, 16, base=4)"]


@pytest.mark.parametrize("pool,max_trials,budgets", [
    (4, 64, {1: 59, 4: 5}),
    (1, 21, {1: 15, 4: 5, 16: 1}),
], ids=["asha.yaml-pool-4", "pool-1"])
def test_config_3_budgets_reached_by_both_clis(tmp_path, monkeypatch, pool, max_trials,
                                               budgets):
    import tempfile

    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    script = tmp_path / "trial.py"
    script.write_text(SCRIPT)
    cfg = tmp_path / "asha.json"
    cfg.write_text(json.dumps({"algorithm": {"asha": {"seed": 0}}, "pool_size": pool}))
    rows = {}
    for tag, cli in (("ref", ref_main), ("port", main)):
        led = str(tmp_path / tag)
        assert cli(["hunt", "-n", "c3", "--n-chips", "1", "--max-trials", str(max_trials),
                    "--ledger", f"file:{led}", "--config", str(cfg), str(script)] + PRIORS) == 0
        trials = FileLedger(led).fetch("c3")
        rows[tag] = sorted((t.id, json.dumps(t.params, sort_keys=True), t.objective, t.status,
                            t.lineage, t.parent) for t in trials)
    assert rows["port"] == rows["ref"]
    assert all(t.status == "completed" for t in trials) and len(trials) == max_trials
    assert dict(collections.Counter(t.params["epochs"] for t in trials)) == budgets
    order = [t.params["epochs"] for t in sorted(trials, key=lambda t: t.submit_time)]
    assert 16 not in order or order.index(16) == 16
    assert json.loads((tmp_path / "metaopt_tpu_torch-gpus-1.json").read_text()) == {
        "claims": {}}
