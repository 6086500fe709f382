"""The ported algorithms through both CLIs: ``hunt --algo NAME``.

``--algo`` reaches every registered algorithm with no further change.
Grid search, CMA-ES, DEHB and PBT draw with numpy only, so the port's CLI
and the reference's, run with the same ``--algo`` and example config
(``metaopt_tpu_torch/examples/{cmaes,dehb,pbt}.json``, the values of
``examples/*.yaml``) on the same torch-free script, leave the same ledger:
ids, params, objectives, statuses, lineages and PBT's ``parent`` links.
PBT runs ``metaopt_tpu_torch/examples/pbt_sgd.py`` with ``--ckpt-root``:
every continuation restores its parent's weights. GP-BO and MOTPE draw
their EI candidates from torch's generators, so only their random phases
(``n_initial_points``) equal the reference's; past it, the port's CLI must
complete the trials with EI on the CPU (``"device": "cpu"``).
"""

import json
import os
from pathlib import Path

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger

EXAMPLES = Path(__file__).resolve().parents[1] / "metaopt_tpu_torch" / "examples"
ROSEN = [str(EXAMPLES / "rosenbrock.py"), "-x~uniform(-5, 10)", "-y~uniform(-5, 10)"]
SGD = [str(EXAMPLES / "pbt_sgd.py"), "--lr~loguniform(1e-3, 1.0)",
       "--steps~fidelity(4, 64, base=2)"]
MULTIOBJ = [str(EXAMPLES / "multiobj.py"), "-x~uniform(0, 1)", "-y~uniform(0, 1)"]


def rows(led, name):
    return sorted((t.id, json.dumps(t.params, sort_keys=True), t.objective, t.status,
                   t.lineage, t.parent, json.dumps([r.to_dict() for r in t.results]))
                  for t in FileLedger(led).fetch(name))


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("algo,config,script,max_trials", [
    ("grid_search", None, ROSEN, 12),
    ("cmaes", "cmaes.json", ROSEN, 16),
    ("dehb", "dehb.json", SGD, 20),
    ("pbt", "pbt.json", SGD, 20),
], ids=["grid_search", "cmaes", "dehb", "pbt"])
def test_both_clis_leave_the_same_ledger(isolated, algo, config, script, max_trials):
    out = {}
    for tag, cli in (("ref", ref_main), ("port", main)):
        led = str(isolated / tag)
        args = ["hunt", "-n", algo, "--algo", algo, "--max-trials", str(max_trials),
                "--ledger", f"file:{led}", "--ckpt-root", str(isolated / f"ckpt-{tag}")]
        if config:
            args += ["--config", str(EXAMPLES / config)]
        assert cli(args + script) == 0
        out[tag] = rows(led, algo)
    assert out["port"] == out["ref"]
    trials = FileLedger(str(isolated / "port")).fetch(algo)
    assert len(trials) == max_trials and all(t.status == "completed" for t in trials)
    if algo == "pbt":
        by_id = {t.id: t for t in trials}
        conts = [t for t in trials if t.parent]
        assert conts, "PBT continued no member"
        for t in conts:
            assert {s.name: s.value for s in t.statistics}["warm"] == 1  # restored
            assert os.path.isfile(isolated / "ckpt-port" / t.parent / "w.json")
        assert any(by_id[t.parent].lineage != t.lineage for t in conts), "no exploit"


@pytest.mark.parametrize("algo,config,script,max_trials,n_initial", [
    ("gp", {"seed": 0, "n_initial_points": 8, "fit_iters": 60}, ROSEN, 11, 8),
    ("motpe", {"seed": 0, "n_objectives": 2, "n_initial_points": 12, "gamma": 0.3},
     MULTIOBJ, 15, 12),
], ids=["gp", "motpe"])
def test_device_algorithms_through_the_port_cli(isolated, algo, config, script, max_trials,
                                                n_initial):
    cfg = isolated / f"{algo}.json"
    cfg.write_text(json.dumps({"algorithm": {algo: {**config, "device": "cpu"}}}))
    for tag, cli in (("ref", ref_main), ("port", main)):
        led = str(isolated / tag)
        assert cli(["hunt", "-n", algo, "--algo", algo, "--max-trials", str(max_trials),
                    "--ledger", f"file:{led}", "--config", str(cfg)] + script) == 0
    port = FileLedger(str(isolated / "port")).fetch(algo)
    ref = FileLedger(str(isolated / "ref")).fetch(algo)
    assert len(port) == max_trials and all(t.status == "completed" for t in port)

    def first(trials):
        return [json.dumps(t.params, sort_keys=True)
                for t in sorted(trials, key=lambda t: t.submit_time)[:n_initial]]

    assert first(port) == first(ref)
    if algo == "motpe":
        assert all(len(t.objectives) == 2 for t in port)
