"""The port's ``benchmark`` package and CLI subcommand against the reference.

Tasks, assessments and the orchestration are pure Python over numpy
algorithms, so they are held exactly: the tasks' optima; every assessment
and ``hypervolume_2d`` on the same series; ``Benchmark.process()`` /
``analysis()`` with random search, CMA-ES and grid search giving the
reference's report; the ``benchmark`` subcommand's JSON and text reports
equal to the reference CLI's. Wall-clock fields (the parallel assessment's
``mean_wall_s``, speedup and efficiency) differ from run to run and are left
out of the comparison, as are the 2-worker runs' series (the workers race).
The reference's own cases (``tests/unit/test_benchmark.py``) are restated
against the port.
"""

import json
import math
import sys

import numpy as np
import pytest

from metaopt_tpu import benchmark as ref_bm
from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch import benchmark as bm
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import MemoryLedger


def test_optima():
    assert bm.RosenBrock(dim=3)(dict(x0=1.0, x1=1.0, x2=1.0))[0]["value"] == 0.0
    assert bm.Sphere(dim=2)(dict(x0=0.0, x1=0.0))[0]["value"] == 0.0
    assert bm.Rastrigin(dim=2)(dict(x0=0.0, x1=0.0))[0]["value"] == pytest.approx(0.0)
    assert bm.Branin()(dict(x0=math.pi, x1=2.275))[0]["value"] == pytest.approx(
        0.397887, abs=1e-4)
    out = bm.ZDT1(max_trials=5)({"x0": 0.25, "x1": 0.0})
    assert [r["type"] for r in out] == ["objective", "objective"]
    assert out[1]["value"] == pytest.approx(1.0 - 0.25 ** 0.5)


def random_series(seed, algos=("a", "b", "c"), reps=3, n=6, empty=()):
    rng = np.random.default_rng(seed)
    return {a: [[] if (a, r) in empty else
                list(np.minimum.accumulate(rng.random(n) * 10).tolist())
                for r in range(reps)] for a in algos}


@pytest.mark.parametrize("seed", range(4))
def test_assessments_equal_the_reference(seed):
    series = random_series(seed, empty={("b", 1)} if seed % 2 else ())
    for cls in ("AverageResult", "AverageRank"):
        assert getattr(bm, cls)(3).analyze(series) == getattr(ref_bm, cls)(3).analyze(series)
    hv, ref_hv = bm.Hypervolume(2, [1.0, 10.0]), ref_bm.Hypervolume(2, [1.0, 10.0])
    assert hv.analyze(series) == ref_hv.analyze(series)
    assert hv.configuration == ref_hv.configuration
    par = {f"{a}@w{w}": runs for w in (1, 4) for a, runs in random_series(seed + 10).items()}
    walls = {k: [1.0 + i, 2.0] for i, k in enumerate(par)}
    pa, ref_pa = bm.ParallelAssessment(2, (4, 1, 4)), ref_bm.ParallelAssessment(2, (4, 1, 4))
    assert pa.analyze(par, walls=walls) == ref_pa.analyze(par, walls=walls)
    assert pa.configuration == ref_pa.configuration and pa.worker_counts == [1, 4]


@pytest.mark.parametrize("seed", range(6))
def test_hypervolume_2d_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((40, 2)) * [1.2, 12.0]
    for k in (0, 1, 5, 40):
        assert bm.hypervolume_2d(pts[:k].tolist(), [1.0, 10.0]) == \
            ref_bm.hypervolume_2d(pts[:k].tolist(), [1.0, 10.0])


def test_hypervolume_hand_cases_and_reference_point():
    ref = [1.0, 1.0]
    assert bm.hypervolume_2d([[0.0, 0.0]], ref) == pytest.approx(1.0)
    assert bm.hypervolume_2d([[0.2, 0.5], [0.5, 0.2]], ref) == pytest.approx(0.55)
    assert bm.hypervolume_2d([], ref) == 0.0
    with pytest.raises(ValueError, match="reference_point"):
        bm.Hypervolume(repetitions=1).series(MemoryLedger(), "x", task=bm.Sphere())


def without_walls(report):
    out = json.loads(json.dumps(report))
    for rows in (out.get("algorithms") or {}).values():
        for row in rows.values():
            for key in ("mean_wall_s", "speedup_vs_1w", "efficiency"):
                row.pop(key, None)
    return out


STUDIES = {
    "result-sphere": (lambda m: m.AverageResult(2), lambda m: m.Sphere(max_trials=10),
                      ["random", {"cmaes": {"population_size": 4}}]),
    "rank-branin": (lambda m: m.AverageRank(2), lambda m: m.Branin(max_trials=8),
                    ["random", {"grid_search": {"n_values": 3}}]),
    "hv-zdt1": (lambda m: m.Hypervolume(repetitions=1), lambda m: m.ZDT1(max_trials=10),
                ["random"]),
}


@pytest.mark.parametrize("study", list(STUDIES))
def test_benchmark_report_equals_the_reference(study):
    assess, task, algos = STUDIES[study]
    reports = []
    for mod in (bm, ref_bm):
        bench = mod.Benchmark("t", algorithms=algos,
                              targets=[{"assess": [assess(mod)], "task": [task(mod)]}])
        with pytest.raises(RuntimeError, match="call process"):
            bench.analysis()
        bench.process()
        reports.append((bench.analysis(), bench.configuration,
                        sorted(bench.ledger.list_experiments())))
    assert reports[0] == reports[1]
    (study_report,), _, names = reports[0]
    assert study_report["winner"] is not None and len(names) >= len(algos)


def test_parallel_assessment_runs_both_worker_counts():
    bench = bm.Benchmark("par", algorithms=["random"], targets=[{
        "assess": [bm.ParallelAssessment(1, worker_counts=(1, 2))],
        "task": [bm.RosenBrock(12)]}])
    bench.process()
    (report,) = bench.analysis()
    rows = report["algorithms"]["random"]
    assert set(rows) == {"w1", "w2"} and report["winner"] == "random"
    assert rows["w2"]["mean_wall_s"] is not None and "speedup_vs_1w" in rows["w2"]
    assert bench.ledger.count("par-rosenbrock-parallelassessment-random-rep0",
                              "completed") == 12
    assert bench.ledger.count("par-rosenbrock-parallelassessment-random-rep0-w2",
                              "completed") >= 12


CLI_CASES = {
    "result": ["--algos", "random", "cmaes", "--task", "branin", "--max-trials", "10",
               "--repetitions", "2"],
    "rank": ["--algos", "random", "grid_search", "--task", "sphere", "--max-trials", "8",
             "--repetitions", "2", "--assessment", "rank"],
    "hypervolume": ["--algos", "random", "--task", "zdt1", "--max-trials", "8",
                    "--repetitions", "1", "--assessment", "hypervolume"],
    "parallel": ["--algos", "random", "--task", "sphere", "--max-trials", "8",
                 "--repetitions", "1", "--assessment", "parallel", "--workers", "1"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_benchmark_cli_reports_equal_the_reference(case, capsys):
    argv = ["benchmark"] + CLI_CASES[case]
    outs = []
    for cli in (main, ref_main):
        assert cli(argv + ["--json"]) == 0
        outs.append(without_walls(json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]
    texts = []
    for cli in (main, ref_main):
        assert cli(argv) == 0
        texts.append(capsys.readouterr().out)
    if case == "parallel":   # the text carries the wall: compare all but it
        texts = [t.split(", wall")[0] + t[t.index("winner"):] for t in texts]
    assert texts[0] == texts[1] and texts[0].startswith("task: ")


def test_benchmark_cli_refusals_equal_the_reference(capsys):
    for argv in (["--task", "nope"],
                 ["--algos", "random", "--task", "sphere", "--assessment", "parallel",
                  "--workers", "0", "2"],
                 ["--algos", "random", "--task", "sphere", "--assessment", "hypervolume"]):
        errs = []
        for cli in (main, ref_main):
            assert cli(["benchmark"] + argv) == 2
            errs.append(capsys.readouterr().err)
        assert errs[0] == errs[1] != ""


def test_the_package_loads_no_torch():
    import subprocess

    code = "import sys, metaopt_tpu_torch.benchmark\nprint('torch' in sys.modules)\n"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.stdout.strip() == "False", out.stderr[-2000:]


@pytest.fixture(scope="module")
def hunted_ledgers():
    """The same study run through each package: its experiments and ledger."""
    out = []
    for mod in (bm, ref_bm):
        bench = mod.Benchmark("s", algorithms=["random", {"cmaes": {"population_size": 4}}],
                              targets=[{"assess": [mod.AverageResult(1)],
                                        "task": [mod.RosenBrock(dim=3, max_trials=9)]}])
        bench.process()
        out.append((bench.ledger, sorted(bench.ledger.list_experiments())))
    return out


@pytest.mark.parametrize("series", ["completed_in_order", "regret_series", "parallel_series"])
def test_progress_series_equal_the_reference(series, hunted_ledgers):
    """The port's series read the same as the reference's, on one ledger and
    across the two packages' runs of the same study (trial ids, params and
    objectives are the same; only the wall-clock timestamps differ)."""
    from metaopt_tpu.io import webapi as ref_webapi
    from metaopt_tpu_torch.io import webapi

    def view(out):
        return [t.id for t in out] if series == "completed_in_order" else out

    (ledger, names), (ref_ledger, ref_names) = hunted_ledgers
    assert names == ref_names and len(names) == 2
    for name in names:
        port_out = view(getattr(webapi, series)(ledger, name))
        assert port_out == view(getattr(ref_webapi, series)(ledger, name))
        assert port_out == view(getattr(webapi, series)(ref_ledger, name))
        assert len(port_out[1] if series == "parallel_series" else port_out) == 9
    dims, rows = webapi.parallel_series(ledger, names[0])
    assert dims == ["x0", "x1", "x2"] and set(rows[0]) == {"x0", "x1", "x2", "objective"}
