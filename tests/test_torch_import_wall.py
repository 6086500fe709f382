"""The port stands alone: no JAX stack, nothing of ``metaopt_tpu``.

An AST scan covers every file of ``metaopt_tpu_torch/`` and
``chip_smoke.py``; a subprocess (this test process already imported jax in
tests/conftest.py) then makes those imports fail with a ``sys.meta_path``
hook, imports every module of the port, runs one CPU ``workon`` and one
``hunt`` of the port's Rosenbrock example through ``cli.main`` (its trial
processes start outside the wall).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "metaopt_tpu")
PORT_FILES = sorted((REPO / "metaopt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for must in ("metaopt_tpu_torch/ops/attention.py",
                 "metaopt_tpu_torch/models/transformer.py",
                 "metaopt_tpu_torch/client/api.py", "metaopt_tpu_torch/algo/tpe.py",
                 "metaopt_tpu_torch/ops/tpe_math.py", "metaopt_tpu_torch/models/mlp.py",
                 "metaopt_tpu_torch/cli/main.py", "metaopt_tpu_torch/executor/subproc.py",
                 "metaopt_tpu_torch/client/__init__.py", "metaopt_tpu_torch/__main__.py",
                 "metaopt_tpu_torch/examples/rosenbrock.py",
                 "metaopt_tpu_torch/examples/mlp_mnist.py", "metaopt_tpu_torch/algo/asha.py",
                 "metaopt_tpu_torch/executor/topology.py", "metaopt_tpu_torch/executor/gpu.py",
                 "metaopt_tpu_torch/models/resnet.py",
                 "metaopt_tpu_torch/examples/resnet_cifar.py", "chip_smoke.py"):
        assert must in names


WALLED = r'''
import importlib, pkgutil, sys
FORBIDDEN = %r
for name in list(sys.modules):
    if name.split(".")[0] in FORBIDDEN:
        del sys.modules[name]

class Wall:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"import of {name} is walled off")
        return None

sys.meta_path.insert(0, Wall())

import metaopt_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(metaopt_tpu_torch.__path__,
                                               "metaopt_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401

from metaopt_tpu_torch import build_experiment
from metaopt_tpu_torch.models.transformer import train_and_eval

tiny = {"vocab": 32, "d_model": 64, "n_heads": 2, "n_layers": 1, "d_ff": 64,
        "max_len": 8, "dropout": 0.0}
exp = build_experiment("walled", space={"lr": "loguniform(1e-4, 1e-2)"},
                       algorithm={"random": {"seed": 0}}, max_trials=1)
stats = exp.workon(lambda p: train_and_eval({**p, **tiny}, n_train=8, batch_size=4,
                                            seq_len=8, steps=2, device="cpu"))
assert stats.completed == 1, stats.events

import json, os, sys, tempfile
from metaopt_tpu_torch.cli import main
root = tempfile.mkdtemp()
cfg = os.path.join(root, "random.json")
with open(cfg, "w") as f:
    json.dump({"algorithm": {"random": {"seed": 0}}}, f)
rosen = os.path.join(os.path.dirname(metaopt_tpu_torch.__file__), "examples", "rosenbrock.py")
rc = main(["hunt", "-n", "rosen", "--ledger", "file:" + os.path.join(root, "ledger"),
           "--max-trials", "2", "--config", cfg, rosen,
           "-x~uniform(-5, 10)", "-y~uniform(-5, 10)"])
assert rc == 0, rc
leaked = sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
assert not leaked, leaked
print("WALL-OK", len(mods))
''' % (FORBIDDEN,)


def test_port_runs_with_jax_unimportable():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", WALLED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WALL-OK" in proc.stdout
    assert '"completed": 2' in proc.stdout


HANDSHAKE = r'''
import sys
import metaopt_tpu_torch.client
import metaopt_tpu_torch.models.objectives
loaded = sorted(n for n in sys.modules if n.split(".")[0] == "torch")
assert not loaded, loaded
assert "metaopt_tpu_torch.client.api" not in sys.modules
print("NO-TORCH")
'''


def test_the_trial_handshake_loads_no_torch():
    """Every trial process imports the client to report; a closed-form
    objective (config 1) must not pay ``import torch`` for it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", HANDSHAKE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO-TORCH" in proc.stdout
