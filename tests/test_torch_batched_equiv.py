"""Batched ≡ serial, and the port's batched hunt ≡ the reference's.

Restated from the reference's ``tests/functional/test_batched_equiv.py``
(without its coordinator class, whose leg is not ported): an EvolutionES
generation and a CMA-ES pool evaluated through the port's
``BatchedExecutor`` (one launch per cohort, CPU tensors) give the same
trial ids, statuses and objectives (f32 against the scalar float64 form:
1e-4) as the per-trial ``InProcessExecutor`` path, and one NaN row of a
pool breaks alone through the worker loop.

Then the port against the reference: the same algorithm seed through each
package's batched ``workon`` gives the same ids, statuses and params
exactly (the algorithms are numpy, exact against the reference), the
objectives within 1e-5 relative (both evaluate the batch forms in f32),
equal worker statistics and equal ``telemetry()``.
"""

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.benchmark.tasks import task_registry as ref_tasks
from metaopt_tpu.executor import BatchedExecutor as RefBatchedExecutor
from metaopt_tpu.ledger.backends import MemoryLedger as RefMemoryLedger
from metaopt_tpu.ledger.experiment import Experiment as RefExperiment
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu.worker.loop import workon as ref_workon
from metaopt_tpu_torch.algo.base import make_algorithm
from metaopt_tpu_torch.benchmark.tasks import task_registry
from metaopt_tpu_torch.executor import BatchedExecutor, InProcessExecutor
from metaopt_tpu_torch.ledger.backends import MemoryLedger
from metaopt_tpu_torch.ledger.experiment import Experiment
from metaopt_tpu_torch.space import build_space
from metaopt_tpu_torch.worker.loop import workon

PORT = (build_space, MemoryLedger, Experiment, make_algorithm, workon,
        lambda fn, space: BatchedExecutor(fn, space, device="cpu"), task_registry)
REF = (ref_build_space, RefMemoryLedger, RefExperiment, ref_make_algorithm, ref_workon,
       RefBatchedExecutor, ref_tasks)


def run(algorithm, spec, task_name, task_kw, *, batched, max_trials, batch_size=8,
        pkg=PORT, batch_fn=None):
    build, Ledger, Exp, make_algo, work, Batched, tasks = pkg
    task = tasks.get(task_name)(**task_kw)
    space = build(dict(spec))
    ledger = Ledger()
    ledger.create_experiment({"name": "e", "space": dict(spec), "algorithm": algorithm,
                              "max_trials": max_trials})
    exp = Exp("e", ledger, space=space, algorithm=algorithm, max_trials=max_trials)
    algo = make_algo(space, algorithm)
    telemetry = None
    if batched:
        executor = Batched(batch_fn or task.batch, space)
        stats = work(exp, executor, algorithm=algo, batch_size=batch_size,
                     max_idle_cycles=50, max_broken=5)
        telemetry = executor.telemetry()
    else:
        stats = work(exp, InProcessExecutor(lambda p: task(p)[0]["value"]), algorithm=algo,
                     max_idle_cycles=50)
    trials = sorted(ledger.fetch("e", None), key=lambda t: t.id)
    rows = [(t.id, t.status, t.params) for t in trials]
    objectives = np.asarray([np.nan if t.objective is None else t.objective for t in trials])
    return stats, rows, objectives, telemetry


EVO = ({"evolutiones": {"population_size": 8, "seed": 42, "max_generations": 2}},
       "rastrigin", {"dim": 2})
CMA = ({"cmaes": {"population_size": 8, "seed": 7}}, "sphere", {"dim": 3})


def evo_spec():
    spec = dict(task_registry.get("rastrigin")(dim=2).space)
    spec["epochs"] = "fidelity(1, 8, base=2)"
    return spec


def test_evolution_es_generation_batched_equals_serial():
    algorithm, name, kw = EVO
    sb, rb, ob, tel = run(algorithm, evo_spec(), name, kw, batched=True, max_trials=16)
    ss, rs, os_, _ = run(algorithm, evo_spec(), name, kw, batched=False, max_trials=16)
    assert sb.completed == ss.completed == 16 and sb.broken == ss.broken == 0
    assert [r[:2] for r in rb] == [r[:2] for r in rs]
    np.testing.assert_allclose(ob, os_, rtol=1e-4, atol=1e-4)
    # a generation is ONE launch, not population_size dispatches
    assert tel == {"kernel_launches": 2, "rows_evaluated": 16, "pools": 2}


def test_cmaes_pool_batched_equals_serial():
    algorithm, name, kw = CMA
    spec = task_registry.get(name)(**kw).space
    sb, rb, ob, tel = run(algorithm, spec, name, kw, batched=True, max_trials=24)
    ss, rs, os_, _ = run(algorithm, spec, name, kw, batched=False, max_trials=24)
    assert sb.completed == ss.completed == 24
    assert [r[:2] for r in rb] == [r[:2] for r in rs]
    np.testing.assert_allclose(ob, os_, rtol=1e-4, atol=1e-4)
    assert tel["kernel_launches"] == tel["pools"] == 3


def port_poisoned(cols):
    import torch

    out = cols["x0"].to(torch.float32) ** 2 + cols["x1"].to(torch.float32) ** 2
    if out.shape[0] > 1:
        out = out.clone()
        out[0] = float("nan")   # exactly one row of every pool
    return out


def ref_poisoned(cols):
    import jax.numpy as jnp

    out = jnp.asarray(cols["x0"], jnp.float32) ** 2 + jnp.asarray(cols["x1"], jnp.float32) ** 2
    return out.at[0].set(jnp.nan) if out.shape[0] > 1 else out


def test_poisoned_batch_through_the_worker_loop():
    """One NaN row breaks alone; its siblings complete."""
    algorithm = {"random": {"seed": 1}}
    spec = task_registry.get("sphere")(dim=2).space
    stats, rows, objectives, tel = run(algorithm, spec, "sphere", {"dim": 2}, batched=True,
                                       max_trials=8, batch_size=8, batch_fn=port_poisoned)
    assert stats.broken >= 1 and stats.completed >= 6
    statuses = {r[1] for r in rows}
    assert statuses == {"broken", "completed"}
    assert all(np.isfinite(o) for r, o in zip(rows, objectives) if r[1] == "completed")
    assert all(e["pool"] >= 1 for e in stats.events)


CASES = {
    "evolutiones": (EVO[0], evo_spec, EVO[1], EVO[2], 16, 8, None),
    "cmaes": (CMA[0], lambda: dict(task_registry.get("sphere")(dim=3).space), CMA[1], CMA[2],
              24, "auto", None),
    "random-rosenbrock": ({"random": {"seed": 3}},
                          lambda: dict(task_registry.get("rosenbrock")(dim=3).space),
                          "rosenbrock", {"dim": 3}, 20, 6, None),
    "poisoned": ({"random": {"seed": 1}}, lambda: dict(task_registry.get("sphere")(dim=2).space),
                 "sphere", {"dim": 2}, 8, 8, (port_poisoned, ref_poisoned)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_port_equals_the_reference(case):
    algorithm, spec, name, kw, max_trials, batch_size, fns = CASES[case]
    port = run(algorithm, spec(), name, kw, batched=True, max_trials=max_trials,
               batch_size=batch_size, pkg=PORT, batch_fn=fns and fns[0])
    ref = run(algorithm, spec(), name, kw, batched=True, max_trials=max_trials,
              batch_size=batch_size, pkg=REF, batch_fn=fns and fns[1])
    (ps, prows, pobj, ptel), (rs, rrows, robj, rtel) = port, ref
    assert prows == rrows
    np.testing.assert_allclose(pobj, robj, rtol=1e-5, atol=0)
    assert ptel == rtel
    for key in ("reserved", "completed", "broken", "interrupted", "suspended", "pruned"):
        assert getattr(ps, key) == getattr(rs, key), key
    assert [(e["trial"], e["status"], e["pool"], e["note"]) for e in ps.events] == \
        [(e["trial"], e["status"], e["pool"], e["note"]) for e in rs.events]


def test_auto_batch_size_reads_the_cohort_and_needs_execute_batch():
    algorithm, name, kw = CMA
    spec = task_registry.get(name)(**kw).space
    _, _, _, tel = run(algorithm, spec, name, kw, batched=True, max_trials=16,
                       batch_size="auto")
    assert tel == {"kernel_launches": 2, "rows_evaluated": 16, "pools": 2}
    space = build_space(spec)
    ledger = MemoryLedger()
    exp = Experiment("e", ledger, space=space, algorithm=algorithm, max_trials=4).configure()
    with pytest.raises(ValueError, match="needs an executor with execute_batch"):
        workon(exp, InProcessExecutor(lambda p: 0.0), batch_size=4)
    # a non-cohort algorithm falls back to the pool size, at least 8
    rnd = Experiment("r", ledger, space=space, algorithm={"random": {"seed": 0}},
                     max_trials=12).configure()
    task = task_registry.get(name)(**kw)
    ex = BatchedExecutor(task.batch, space, device="cpu")
    stats = workon(rnd, ex, batch_size="auto")
    assert stats.completed == 12 and max(e["pool"] for e in stats.events) == 8


def test_result_name_reaches_the_ledger_as_the_references():
    """``result_name`` is the name on each trial's objective row in the
    ledger, in both packages, for the same pool."""
    algorithm, name, kw = CMA
    rows = {}
    for label, pkg, make in (
            ("port", PORT, lambda fn, s: BatchedExecutor(fn, s, device="cpu",
                                                          result_name="loss")),
            ("ref", REF, lambda fn, s: RefBatchedExecutor(fn, s, result_name="loss"))):
        build, Ledger, Exp, make_algo, work, _, tasks = pkg
        task = tasks.get(name)(**kw)
        space = build(dict(task.space))
        ledger = Ledger()
        ledger.create_experiment({"name": "e", "space": dict(task.space),
                                  "algorithm": algorithm, "max_trials": 8})
        exp = Exp("e", ledger, space=space, algorithm=algorithm, max_trials=8)
        work(exp, make(task.batch, space), algorithm=make_algo(space, algorithm),
             batch_size=8, max_idle_cycles=50, max_broken=5)
        rows[label] = [(t.id, t.status, [(r.name, r.type) for r in t.results])
                       for t in sorted(ledger.fetch("e", None), key=lambda t: t.id)]
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]) == 8
    assert all(results == [("loss", "objective")] for _, _, results in rows["port"])
