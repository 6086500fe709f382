"""The port stands alone: no JAX stack, nothing of ``metaopt_tpu``.

An AST scan covers every file of ``metaopt_tpu_torch/`` and
``chip_smoke.py``; a subprocess (this test process already imported jax in
tests/conftest.py) then makes those imports fail with a ``sys.meta_path``
hook, imports every module of the port (the decoder-only LM, the MoE and
the blocked xent among them), runs one CPU ``workon`` of the Transformer,
two steps of the MoE LM under remat, one ``workon`` of BOHB on PPO, one
each of GP-BO and CMA-ES, one ``hunt`` of the port's Rosenbrock example
through ``cli.main`` (its trial processes start outside the wall), the
batched hunt of the MLP zoo and one ``benchmark`` study, and a hunt and an
EVC branch on the native engine behind a bare path, whose library must be
the port's own build under ``metaopt_tpu_torch/_build/`` (never the
reference's ``libledgerstore.so``), and a hosted TPE hunt through the
coordinator that ``serve`` runs (``hunt --producer coord``, two workers,
the fleet-fused plane on), a live hand-off between two in-process shards
(``coord/handoff.py``), the shard process's entry point refusing ``cuda``
without CUDA, a small simulation (``sim/``) with a hosted TPE, and the
read side: ``io/webapi.py``'s server answering ``/importance`` and ``plot
pdp``, both fitting ``algo/gp_bo.py``'s ARD surrogate
(``ard_importance``, ``partial_dependence``) on the CPU.
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
                 "metaopt_tpu_torch/examples/resnet_cifar.py",
                 "metaopt_tpu_torch/algo/evolution_es.py", "metaopt_tpu_torch/algo/hyperband.py",
                 "metaopt_tpu_torch/algo/bohb.py", "metaopt_tpu_torch/models/ppo.py",
                 "metaopt_tpu_torch/examples/ppo_atari.py", "chip_smoke.py",
                 "metaopt_tpu_torch/models/checkpoint.py",
                 "metaopt_tpu_torch/examples/transformer_wmt.py",
                 "metaopt_tpu_torch/algo/gp_bo.py", "metaopt_tpu_torch/algo/cmaes.py",
                 "metaopt_tpu_torch/algo/dehb.py", "metaopt_tpu_torch/algo/pbt.py",
                 "metaopt_tpu_torch/algo/motpe.py", "metaopt_tpu_torch/algo/grid_search.py",
                 "metaopt_tpu_torch/algo/gradient_descent.py",
                 "metaopt_tpu_torch/examples/multiobj.py",
                 "metaopt_tpu_torch/examples/pbt_sgd.py", "metaopt_tpu_torch/models/lm.py",
                 "metaopt_tpu_torch/models/moe.py", "metaopt_tpu_torch/ops/xent.py",
                 "metaopt_tpu_torch/examples/lm_causal.py",
                 "metaopt_tpu_torch/executor/batched.py",
                 "metaopt_tpu_torch/benchmark/__init__.py",
                 "metaopt_tpu_torch/benchmark/tasks.py",
                 "metaopt_tpu_torch/benchmark/assessments.py",
                 "metaopt_tpu_torch/benchmark/benchmark.py",
                 "metaopt_tpu_torch/models/objectives.py",
                 "metaopt_tpu_torch/io/webapi.py",
                 "metaopt_tpu_torch/ledger/archive.py",
                 "metaopt_tpu_torch/ledger/native.py",
                 "metaopt_tpu_torch/ledger/evc.py",
                 "metaopt_tpu_torch/native/__init__.py",
                 "metaopt_tpu_torch/worker/producer.py",
                 "metaopt_tpu_torch/utils/fsjournal.py",
                 "metaopt_tpu_torch/coord/__init__.py",
                 "metaopt_tpu_torch/coord/protocol.py",
                 "metaopt_tpu_torch/coord/wal.py",
                 "metaopt_tpu_torch/coord/tenancy.py",
                 "metaopt_tpu_torch/coord/shards.py",
                 "metaopt_tpu_torch/coord/fuser.py",
                 "metaopt_tpu_torch/coord/server.py",
                 "metaopt_tpu_torch/coord/client_backend.py",
                 "metaopt_tpu_torch/coord/handoff.py",
                 "metaopt_tpu_torch/sim/__init__.py",
                 "metaopt_tpu_torch/sim/clock.py",
                 "metaopt_tpu_torch/sim/certify.py",
                 "metaopt_tpu_torch/sim/engine.py",
                 "metaopt_tpu_torch/analysis/__init__.py",
                 "metaopt_tpu_torch/analysis/core.py",
                 "metaopt_tpu_torch/analysis/registry.py",
                 "metaopt_tpu_torch/analysis/locks.py",
                 "metaopt_tpu_torch/analysis/durability.py",
                 "metaopt_tpu_torch/analysis/hotpath.py",
                 "metaopt_tpu_torch/analysis/runner.py",
                 "metaopt_tpu_torch/analysis/crashcheck.py",
                 "metaopt_tpu_torch/analysis/dynrace.py",
                 "metaopt_tpu_torch/analysis/suites.py",
                 "metaopt_tpu_torch/parallel/__init__.py",
                 "metaopt_tpu_torch/parallel/launch.py",
                 "metaopt_tpu_torch/parallel/mesh.py",
                 "metaopt_tpu_torch/parallel/collectives.py",
                 "metaopt_tpu_torch/parallel/sharding.py",
                 "metaopt_tpu_torch/parallel/control.py",
                 "metaopt_tpu_torch/parallel/pipeline.py",
                 "metaopt_tpu_torch/ops/ring_attention.py",
                 "metaopt_tpu_torch/ops/ulysses.py",
                 "metaopt_tpu_torch/models/pipeline_lm.py",
                 "metaopt_tpu_torch/coord/pod.py"):
        assert must in names


WALL_PREFIX = r'''
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
''' % (FORBIDDEN,)

WALLED = WALL_PREFIX + r'''

import metaopt_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(metaopt_tpu_torch.__path__,
                                               "metaopt_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"metaopt_tpu_torch.models.lm", "metaopt_tpu_torch.models.moe",
        "metaopt_tpu_torch.ops.xent", "metaopt_tpu_torch.executor.batched",
        "metaopt_tpu_torch.benchmark.tasks", "metaopt_tpu_torch.benchmark.benchmark",
        "metaopt_tpu_torch.benchmark.assessments", "metaopt_tpu_torch.ledger.archive",
        "metaopt_tpu_torch.ledger.native", "metaopt_tpu_torch.native",
        "metaopt_tpu_torch.utils.fsjournal", "metaopt_tpu_torch.coord.protocol",
        "metaopt_tpu_torch.coord.wal", "metaopt_tpu_torch.coord.tenancy",
        "metaopt_tpu_torch.coord.shards", "metaopt_tpu_torch.coord.fuser",
        "metaopt_tpu_torch.coord.server",
        "metaopt_tpu_torch.coord.client_backend",
        "metaopt_tpu_torch.coord.handoff", "metaopt_tpu_torch.sim",
        "metaopt_tpu_torch.sim.clock", "metaopt_tpu_torch.sim.certify",
        "metaopt_tpu_torch.sim.engine", "metaopt_tpu_torch.analysis.runner",
        "metaopt_tpu_torch.analysis.crashcheck", "metaopt_tpu_torch.analysis.dynrace",
        "metaopt_tpu_torch.analysis.suites",
        "metaopt_tpu_torch.analysis.hotpath"} <= set(mods), mods
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

from metaopt_tpu_torch.models.lm import train_lm
loss = train_lm({**tiny, "n_experts": 2, "remat": True, "dropout": 0.1}, n_train=8,
                batch_size=4, seq_len=7, steps=2, device="cpu")
assert loss == loss, loss

from metaopt_tpu_torch.models import ppo
exp = build_experiment("walled-bohb", space={"lr": "loguniform(1e-4, 1e-2)",
                                             "epochs": "fidelity(1, 2, base=2)"},
                       algorithm={"bohb": {"seed": 0, "repetitions": 1, "device": "cpu"}})
stats = exp.workon(ppo.make_objective(n_envs=4, rollout_len=4, ppo_epochs=1, device="cpu"))
assert stats.completed == 5, stats.events

for algo, cfg in (("gp", {"seed": 0, "n_initial_points": 3, "fit_iters": 5, "device": "cpu"}),
                  ("cmaes", {"seed": 0, "population_size": 4})):
    exp = build_experiment("walled-" + algo, space={"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"},
                           algorithm={algo: cfg}, max_trials=5)
    stats = exp.workon(lambda p: (p["x"] - 1) ** 2 + p["y"] ** 2)
    assert stats.completed == 5, stats.events

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
# the batched hunt on the zoo and a benchmark study, in this process
cfg = os.path.join(root, "cmaes.json")
with open(cfg, "w") as f:
    json.dump({"algorithm": {"cmaes": {"seed": 0, "population_size": 8}},
               "executor": {"device": "cpu"}}, f)
rc = main(["hunt", "-n", "zoo", "--ledger", "file:" + os.path.join(root, "ledger"),
           "--max-trials", "16", "--config", cfg, "--vector-objective", "mlp",
           "--batch-size", "auto"])
assert rc == 0, rc
rc = main(["benchmark", "--algos", "random", "cmaes", "--task", "rastrigin",
           "--max-trials", "6", "--repetitions", "1", "--json"])
assert rc == 0, rc
# the read side: a web server's /importance and `plot pdp`, fitted on the CPU
import urllib.request
from metaopt_tpu_torch.algo.gp_bo import (_fit_ard, _fit_surrogate, _mean_from_alpha,
                                          _posterior_alpha, ard_importance,
                                          partial_dependence)
from metaopt_tpu_torch.io.webapi import (_experiment_detail, _surrogate_inputs, importance_series,
                                         lcurve_series, make_server, pareto_series, pdp_series,
                                         start_in_thread)
web_spec = "file:" + os.path.join(root, "web")
exp = build_experiment("walled-imp", space={"a": "uniform(0, 1)", "b": "uniform(0, 1)"},
                       algorithm={"random": {"seed": 0}}, max_trials=6, ledger=web_spec)
stats = exp.workon(lambda p: 5 * (p["a"] - 0.5) ** 2)
assert stats.completed == 6, stats.events
server = make_server(exp.experiment.ledger, device="cpu")
start_in_thread(server)
host, port = server.server_address[:2]
url = f"http://{host}:{port}/experiments/walled-imp/importance"
with urllib.request.urlopen(url, timeout=60) as r:
    assert set(json.loads(r.read())["importance"]) == {"a", "b"}
server.shutdown()
server.server_close()
cfg = os.path.join(root, "surrogate.json")
with open(cfg, "w") as f:
    json.dump({"surrogate": {"device": "cpu"}}, f)
assert main(["plot", "pdp", "-n", "walled-imp", "--ledger", web_spec, "--config", cfg]) == 0
# the native engine behind a bare path, a branch and db test on it
from metaopt_tpu_torch.ledger.native import NativeFileLedger
import metaopt_tpu_torch.native as native
bare = os.path.join(root, "bare")
cfg = os.path.join(root, "random.json")
for name, flags, y in (("rosen", [], "-y~uniform(-5, 10)"),
                       ("child", ["--branch-from", "rosen"], "-y~uniform(-5, 5)")):
    assert main(["hunt", "-n", name, "--ledger", bare, "--max-trials", "3", "--config", cfg]
                + flags + [rosen, "-x~uniform(-5, 10)", y]) == 0
assert main(["db", "test", "--ledger", bare]) == 0
from metaopt_tpu_torch.ledger.backends import ledger_from_spec
assert isinstance(ledger_from_spec(bare), NativeFileLedger)
assert ledger_from_spec(bare).load_experiment("child")["version"] == 2
build = os.path.join(os.path.dirname(metaopt_tpu_torch.__file__), "_build")
assert os.path.dirname(str(native.lib_path)) == build, native.lib_path
with open("/proc/self/maps") as f:
    maps = f.read()
assert "libledgerstore" in maps and "metaopt_tpu/native" not in maps
# a hosted TPE hunt through the coordinator that `serve` runs, two workers
from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
with CoordServer(device="cpu", snapshot_path=os.path.join(root, "snap.json"),
                 fuse_suggest=True) as srv:
    host, port = srv.address
    rc = main(["hunt", "-n", "hosted", "--ledger", f"coord://{host}:{port}",
               "--producer", "coord", "--n-workers", "2", "--max-trials", "8",
               "--algo", "tpe", rosen, "-x~uniform(-5, 10)", "-y~uniform(-5, 10)"])
    assert rc == 0, rc
    cli = CoordLedgerClient(host, port)
    assert cli.count("hosted", "completed") == 8
    algo = srv._producers["hosted"][0].algorithm
    assert type(algo).__name__ == "TPE" and str(algo.device) == "cpu"
# a live hand-off between two in-process shards
from metaopt_tpu_torch.coord.handoff import migrate_experiment
from metaopt_tpu_torch.coord.shards import (_free_port, _shard_main, make_shard_map,
                                            ring_of, with_override)
smap = make_shard_map([(f"s{i}", "127.0.0.1", _free_port()) for i in range(2)])
shards = [CoordServer(device="cpu", host=s["host"], port=s["port"], shard_id=s["id"],
                      shard_map=smap).start() for s in smap["shards"]]
try:
    nm = next(f"h{i}" for i in range(99) if ring_of(smap).owner(f"h{i}") == "s0")
    cli = CoordLedgerClient(*shards[0].address)
    cli.create_experiment({"name": nm, "max_trials": 2})
    res = migrate_experiment(nm, shards[0].address, shards[1].address, "s1",
                             with_override(smap, nm, "s1"), window_s=10.0)
    assert res["map_version"] == 2, res
    assert shards[1].inner.list_experiments() == [nm]
finally:
    for srv in shards:
        srv.stop()
import torch
if not torch.cuda.is_available():
    try:
        _shard_main(["--shard-id", "s0", "--port", str(_free_port())])
        raise AssertionError("a shard on cuda started without CUDA")
    except RuntimeError as err:
        assert "CUDA is not available" in str(err)
# a small simulation with a hosted TPE
from metaopt_tpu_torch.sim import SimConfig, Simulation
rep = Simulation(SimConfig(workers=30, tenants=2, experiments_per_tenant=1,
                           algos=("tpe", "asha"), max_trials=12,
                           faults="sim_crash_server:1@10"), device="cpu").run()
assert rep.ok and rep.crashes == 1 and rep.acked_completions == 24, rep.to_dict()
leaked = sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
assert not leaked, leaked
print("WALL-OK", len(mods))
'''


def test_port_runs_with_jax_unimportable():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", WALLED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WALL-OK" in proc.stdout
    assert '"completed": 2' in proc.stdout


STATIC_CHECKERS = r'''
import sys
from metaopt_tpu_torch.analysis.runner import analyze_main, crashcheck_main, lint_main
assert lint_main(["--format", "json"]) == 0
assert analyze_main([]) == 0
assert crashcheck_main(["--static-only"]) == 0
loaded = sorted(n for n in sys.modules if n.split(".")[0] == "torch")
assert not loaded, loaded
print("NO-TORCH")
'''


def test_the_static_checkers_load_no_torch():
    """``lint``, ``analyze`` and ``crashcheck --static-only`` read source
    text only: none of them imports torch (or the JAX stack)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", WALL_PREFIX + STATIC_CHECKERS], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO-TORCH" in proc.stdout


WEBAPI_IMPORT = r'''
import sys
import metaopt_tpu_torch.io.webapi
loaded = sorted(n for n in sys.modules if n.split(".")[0] == "torch")
assert not loaded, loaded
print("NO-TORCH")
'''


def test_the_webapi_module_loads_no_torch():
    """``io/webapi.py`` backs ``list`` and ``status --workers``: importing it
    loads no torch; its surrogate routes import the GP at their call."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", WEBAPI_IMPORT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO-TORCH" in proc.stdout


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


TORCH_FREE_CLI = r'''
import json, os, sys, tempfile
from metaopt_tpu_torch.cli import main
root = tempfile.mkdtemp()
sgd = os.path.join(os.path.dirname(sys.modules["metaopt_tpu_torch"].__file__), "examples",
                   "pbt_sgd.py")
led = "file:" + os.path.join(root, "ledger")
assert main(["hunt", "-n", "sgd", "--ledger", led, "--max-trials", "3", "--ckpt-root",
             os.path.join(root, "ckpt"), "--config",
             os.path.join(os.path.dirname(sgd), "asha.json"), sgd,
             "--lr~loguniform(1e-3, 1.0)", "--steps~fidelity(4, 16, base=2)"]) == 0
assert main(["status", "-n", "sgd", "--ledger", led, "--rungs", "--json"]) == 0
# a status from a native ledger behind a bare path loads no torch either
bare = os.path.join(root, "bare")
assert main(["hunt", "-n", "sgd", "--ledger", bare, "--max-trials", "2", "--ckpt-root",
             os.path.join(root, "ckpt2"), "--config",
             os.path.join(os.path.dirname(sgd), "asha.json"), sgd,
             "--lr~loguniform(1e-3, 1.0)", "--steps~fidelity(4, 16, base=2)"]) == 0
from metaopt_tpu_torch.ledger.native import NativeFileLedger
from metaopt_tpu_torch.ledger.backends import ledger_from_spec
assert isinstance(ledger_from_spec(bare), NativeFileLedger)
assert main(["status", "-n", "sgd", "--ledger", bare, "--json"]) == 0
try:
    main(["benchmark", "--help"])
except SystemExit as done:
    assert done.code == 0, done.code
loaded = sorted(n for n in sys.modules if n.split(".")[0] == "torch")
assert not loaded, loaded
print("NO-TORCH")
'''


def test_numpy_algorithms_and_status_load_no_torch():
    """A hunt of a numpy algorithm (ASHA) and ``status --rungs`` run without
    ``import torch`` in the CLI process: the algorithm modules load by name
    (``algo.base.BUILTIN_MODULES``), and only TPE, MOTPE, BOHB and GP-BO
    import torch. The same holds for a hunt and a ``status`` on a native
    ledger behind a bare path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", TORCH_FREE_CLI], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO-TORCH" in proc.stdout


def test_builtin_modules_name_every_registered_algorithm():
    """``BUILTIN_MODULES`` (how ``make_algorithm`` finds a module by name)
    and the modules' ``@algo_registry.register`` names agree, and every
    class ``metaopt_tpu_torch.algo`` exports lazily resolves."""
    import importlib

    import metaopt_tpu_torch.algo as algo
    from metaopt_tpu_torch.algo.base import BUILTIN_MODULES, algo_registry

    for mod in sorted(set(BUILTIN_MODULES.values())):
        importlib.import_module(f"metaopt_tpu_torch.algo.{mod}")
    for name in BUILTIN_MODULES:
        cls = algo_registry.get(name)
        assert cls.__module__ == f"metaopt_tpu_torch.algo.{BUILTIN_MODULES[name]}", name
    builtin = {n for n in algo_registry
               if algo_registry.get(n).__module__.startswith("metaopt_tpu_torch.algo.")}
    assert builtin == set(BUILTIN_MODULES)
    for name in algo.__all__:
        assert getattr(algo, name) is not None
