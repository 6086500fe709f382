"""``hunt --vector-objective NAME --batch-size K|auto`` through both CLIs.

The batched hunt runs no trial process: pools of trials evaluate in-process
through a ``BatchedExecutor``, here on the CPU (the config file's
``executor.device``, a key the reference ignores and neither package
stores). The same command on two file ledgers gives the same experiment
document (apart from its creation time), the same trial ids, params and
statuses, and objectives within 1e-5 relative (both packages evaluate the
batch forms in f32):

- CMA-ES on Rastrigin with ``--batch-size auto`` (the algorithm's
  population), so the objectives feed back into the next generation;
- random search on the MLP zoo at ``--batch-size 16``, the port given the
  reference's four threefry draws (``GivenZooDraws``). Rows whose training
  diverged (reference loss > 100) are held only to having diverged in the
  port too: there f32 rounding decides the trajectory, and the reference's
  own per-trial and vmapped forms differ by up to 41%
  (``tests/test_torch_batched_tasks.py``).

Also the reference's refusals, word for word, and a fresh process running
the batched MLP hunt without importing ``torch._dynamo``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metaopt_tpu.cli import main as ref_main  # noqa: E402
from metaopt_tpu_torch.cli import main  # noqa: E402
from metaopt_tpu_torch.ledger import FileLedger  # noqa: E402
from metaopt_tpu_torch.models import objectives as obj  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def config(tmp_path, algorithm=None, device="cpu"):
    doc = {"executor": {"device": device}}
    if algorithm:
        doc["algorithm"] = algorithm
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(doc))
    return str(path)


def ledger_of(root, name):
    led = FileLedger(str(root))
    doc = led.load_experiment(name)
    doc["metadata"].pop("datetime")
    trials = sorted(led.fetch(name), key=lambda t: t.id)
    return doc, trials


def hunt_both(tmp_path, capsys, argv):
    outs = []
    for cli, sub in ((ref_main, "ref"), (main, "port")):
        rc = cli(["hunt", "--ledger", f"file:{tmp_path / sub}"] + argv)
        outs.append((rc, json.loads(capsys.readouterr().out)))
    name = argv[argv.index("-n") + 1]
    return outs, ledger_of(tmp_path / "ref", name), ledger_of(tmp_path / "port", name)


def test_cmaes_rastrigin_auto_equals_the_reference(tmp_path, capsys):
    cfg = config(tmp_path, {"cmaes": {"seed": 0, "population_size": 8}})
    argv = ["-n", "rast", "--config", cfg, "--vector-objective", "rastrigin",
            "--batch-size", "auto", "--max-trials", "40"]
    ((rc_ref, out_ref), (rc, out)), (rdoc, rtrials), (pdoc, ptrials) = hunt_both(
        tmp_path, capsys, argv)
    assert rc == rc_ref == 0
    assert pdoc == rdoc
    assert pdoc["user_args"] == ["batched:rastrigin", "x0~uniform(-5.12, 5.12)",
                                 "x1~uniform(-5.12, 5.12)"]
    assert [(t.id, t.params, t.status) for t in ptrials] == \
        [(t.id, t.params, t.status) for t in rtrials]
    assert len(ptrials) == 40 and {t.status for t in ptrials} == {"completed"}
    np.testing.assert_allclose([t.objective for t in ptrials],
                               [t.objective for t in rtrials], rtol=1e-5, atol=0)
    assert out["total"] == out_ref["total"] == {"completed": 40}
    assert out["completed_by_worker"] == 40


@pytest.fixture
def reference_zoo_draws(monkeypatch):
    kx, kt, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 4)
    given = obj.GivenZooDraws(*(np.asarray(jax.random.normal(k, shape, jnp.float32))
                                for k, shape in ((kx, (64, 8)), (kt, (8,)),
                                                 (k1, (8, 16)), (k2, (16,)))))
    monkeypatch.setattr(obj, "ZooDraws", lambda seed=0: given)


def test_mlp_zoo_at_batch_16_equals_the_reference(tmp_path, capsys, reference_zoo_draws):
    cfg = config(tmp_path, {"random": {"seed": 4}})
    argv = ["-n", "zoo", "--config", cfg, "--vector-objective", "mlp",
            "--batch-size", "16", "--max-trials", "32"]
    ((rc_ref, _), (rc, out)), (rdoc, rtrials), (pdoc, ptrials) = hunt_both(
        tmp_path, capsys, argv)
    assert rc == rc_ref == 0 and pdoc == rdoc
    assert pdoc["user_args"] == ["batched:mlp", "lr~loguniform(0.001, 1.0)",
                                 "init~uniform(0.1, 2.0)"]
    assert [(t.id, t.params, t.status) for t in ptrials] == \
        [(t.id, t.params, t.status) for t in rtrials]
    got = np.asarray([t.objective for t in ptrials])
    want = np.asarray([t.objective for t in rtrials])
    ok = want <= 100.0
    assert len(got) == 32 and ok.sum() >= 24
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=0)
    assert np.all(got[~ok] >= 10.0)


def test_n_workers_share_one_executor(tmp_path, capsys):
    cfg = config(tmp_path, {"random": {"seed": 2}})
    rc = main(["hunt", "-n", "w", "--ledger", f"file:{tmp_path / 'l'}", "--config", cfg,
               "--vector-objective", "sphere", "--batch-size", "4", "--max-trials", "24",
               "--n-workers", "3"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["failed_workers"] == 0
    done = [t for t in FileLedger(str(tmp_path / "l")).fetch("w") if t.status == "completed"]
    assert len(done) >= 24 and len({t.id for t in done}) == len(done)


REFUSALS = [
    (["--batch-size", "4", "SCRIPT", "-x~uniform(-2, 2)"],
     "--batch-size needs --vector-objective NAME"),
    (["--vector-objective", "nope"], "unknown vectorized objective 'nope'"),
    (["--vector-objective", "zdt1"], "benchmark task 'zdt1' has no vectorized form"),
]


@pytest.mark.parametrize("flags,what", REFUSALS, ids=["no-vector-objective", "unknown", "zdt1"])
def test_refusals_are_the_references(tmp_path, flags, what):
    flags = [str(tmp_path / "quad.py") if f == "SCRIPT" else f for f in flags]
    msgs = []
    for cli in (ref_main, main):
        with pytest.raises(SystemExit) as err:
            cli(["hunt", "-n", "r", "--ledger", f"file:{tmp_path / 'l'}"] + flags)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and what in msgs[1], msgs


def test_without_cuda_the_batched_hunt_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["hunt", "-n", "nc", "--ledger", f"file:{tmp_path / 'l'}",
              "--vector-objective", "sphere", "--max-trials", "4"])


def test_a_batched_mlp_hunt_imports_no_torch_dynamo(tmp_path):
    cfg = config(tmp_path, {"cmaes": {"seed": 0, "population_size": 16}})
    code = (
        "import sys\n"
        "from metaopt_tpu_torch.cli import main\n"
        f"rc = main(['hunt', '-n', 'd', '--ledger', 'file:{tmp_path / 'l'}', '--config', "
        f"'{cfg}', '--vector-objective', 'mlp', '--batch-size', 'auto', "
        "'--max-trials', '32'])\n"
        "assert rc == 0, rc\n"
        "assert 'torch' in sys.modules\n"
        "print('DYNAMO', 'torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "DYNAMO False"
    done = [t for t in FileLedger(str(tmp_path / "l")).fetch("d") if t.status == "completed"]
    assert len(done) == 32
