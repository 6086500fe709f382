"""The port's ``BatchedExecutor``: the reference's contracts
(``tests/unit/test_batched_exec.py::TestBatchedExecutor``) restated on CPU
tensors, and the port's own parts.

A pool is one launch with the scalar form's values; a NaN row breaks alone;
an objective that raises breaks its chunk, never the worker; heartbeats are
checked before each chunk and again after its results land; a mixed
fidelity pool splits into one launch per rung; ``telemetry()`` counts one
launch per chunk. The port's own: the columns reach the objective as
tensors on the executor's device, the values come back in one
device-to-host copy per chunk (no per-row ``.item()``), and without CUDA an
executor built without ``device`` raises instead of running on the CPU.
"""

import threading

import numpy as np
import pytest
import torch

from metaopt_tpu_torch.benchmark.tasks import task_registry
from metaopt_tpu_torch.executor import BatchedExecutor
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space


def trials_of(space, n, seed=0):
    return [Trial(params=p, experiment="e") for p in space.sample(n, seed=seed)]


def setup(n=8, dim=3, **kw):
    task = task_registry.get("sphere")(dim=dim)
    space = build_space(task.space)
    return BatchedExecutor(task.batch, space, device="cpu", **kw), task, trials_of(space, n, 5)


def test_pool_is_one_launch_with_parity():
    ex, task, trials = setup(n=8)
    results = ex.execute_batch(trials)
    assert [r.status for r in results] == ["completed"] * 8
    for t, r in zip(trials, results):
        assert r.exit_code == 0 and r.results[0]["name"] == "objective"
        assert r.results[0]["value"] == pytest.approx(task(t.params)[0]["value"], rel=1e-6)
    assert ex.telemetry() == {"kernel_launches": 1, "rows_evaluated": 8, "pools": 1}


def test_poisoned_batch_isolates_to_one_broken():
    ex, task, trials = setup(n=6)
    trials[2].params["x0"] = float("nan")
    results = ex.execute_batch(trials)
    statuses = [r.status for r in results]
    assert statuses[2] == "broken" and "non-finite" in results[2].note
    assert statuses[:2] + statuses[3:] == ["completed"] * 5
    assert ex.telemetry()["kernel_launches"] == 1


def test_single_execute_contract():
    ex, task, trials = setup(n=1)
    r = ex.execute(trials[0])
    assert r.status == "completed" and r.exit_code == 0


def test_heartbeat_checked_between_chunks():
    ex, task, trials = setup(n=6, chunk_size=2)
    calls = {"n": 0}

    def beat():
        calls["n"] += 1
        return calls["n"] <= 4   # pre-chunk + post-eval checks of chunk 1 pass

    results = ex.execute_batch(trials, heartbeats=[beat] * 6)
    assert [r.status for r in results[:2]] == ["completed"] * 2
    assert {r.status for r in results[2:]} == {"interrupted"}
    assert [r.note for r in results[2:]] == ["lost reservation"] * 4
    # chunks whose trials all lost their reservation never launch
    assert ex.telemetry()["kernel_launches"] == 1


def test_lost_reservation_after_eval_never_completes():
    ex, task, trials = setup(n=2)
    flips = iter([True, True, False, False])  # pre-checks pass, post-checks fail
    results = ex.execute_batch(trials, heartbeats=[lambda: next(flips)] * 2)
    assert {r.status for r in results} == {"interrupted"}
    assert all("during evaluation" in r.note for r in results)


def test_mixed_fidelity_pool_splits_into_cohorts():
    space = build_space({"x0": "uniform(-5, 5)", "epochs": "fidelity(1, 8, base=2)"})
    seen = []

    def square(cols):
        seen.append(sorted(cols))
        return cols["x0"] ** 2

    ex = BatchedExecutor(square, space, device="cpu")
    trials = [Trial(params={"x0": float(i), "epochs": 2 if i < 3 else 8}, experiment="e")
              for i in range(6)]
    results = ex.execute_batch(trials)
    assert [r.status for r in results] == ["completed"] * 6
    assert [r.results[0]["value"] for r in results] == [float(i) ** 2 for i in range(6)]
    assert ex.telemetry()["kernel_launches"] == 2
    assert seen == [["x0"], ["x0"]]   # the fidelity travels out of band


def test_objective_exception_breaks_chunk_not_worker():
    space = build_space({"x0": "uniform(0, 1)"})

    def boom(cols):
        raise RuntimeError("bad trace")

    ex = BatchedExecutor(boom, space, device="cpu")
    results = ex.execute_batch(trials_of(space, 3, seed=1))
    assert {r.status for r in results} == {"broken"}
    assert all("bad trace" in r.note for r in results)
    assert ex.telemetry()["kernel_launches"] == 0


def test_a_wrong_number_of_values_breaks_the_chunk():
    space = build_space({"x0": "uniform(0, 1)"})
    ex = BatchedExecutor(lambda cols: cols["x0"][:1], space, device="cpu")
    results = ex.execute_batch(trials_of(space, 3, seed=1))
    assert {r.status for r in results} == {"broken"}
    assert "1 values for 3 rows" in results[0].note


def test_rejects_unvectorizable_space_and_bad_chunk():
    with pytest.raises(ValueError, match="not vectorizable"):
        BatchedExecutor(lambda c: c, build_space({"w": "normal(0, 1, shape=[2])"}),
                        device="cpu")
    with pytest.raises(ValueError, match="chunk_size must be >= 1"):
        BatchedExecutor(lambda c: c, build_space({"x": "uniform(0, 1)"}), chunk_size=0,
                        device="cpu")
    ex, _, trials = setup(n=2)
    with pytest.raises(ValueError, match="2 trials but 1 heartbeats"):
        ex.execute_batch(trials, heartbeats=[None])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
def test_without_cuda_an_executor_without_device_raises():
    space = build_space({"x": "uniform(0, 1)"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedExecutor(lambda c: c["x"], space)


def test_columns_arrive_as_tensors_with_the_stacked_dtypes():
    space = build_space({"lr": "loguniform(1e-4, 1)", "k": "uniform(1, 9, discrete=True)",
                         "act": "choices(['relu', 'tanh', 'gelu'])"})
    got = {}

    def fn(cols):
        got.update(cols)
        return cols["lr"] * 0 + cols["k"] + cols["act"]

    ex = BatchedExecutor(fn, space, device="cpu")
    trials = trials_of(space, 5, seed=2)
    results = ex.execute_batch(trials)
    assert ex.device == torch.device("cpu")
    assert {n: t.dtype for n, t in got.items()} == {
        "lr": torch.float64, "k": torch.int32, "act": torch.int32}
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in got.values())
    opts = ["relu", "tanh", "gelu"]
    assert [r.results[0]["value"] for r in results] == [
        float(t.params["k"] + opts.index(t.params["act"])) for t in trials]


def test_one_device_to_host_copy_per_chunk_and_no_item(monkeypatch):
    ex, task, trials = setup(n=10, chunk_size=4)
    copies = {"n": 0}
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies["n"] += 1
        return real_cpu(self, *a, **kw)

    def no_item(self):
        raise AssertionError("per-row .item()")

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    results = ex.execute_batch(trials)
    assert [r.status for r in results] == ["completed"] * 10
    assert copies["n"] == ex.telemetry()["kernel_launches"] == 3


def test_telemetry_is_consistent_across_threads():
    ex, task, _ = setup(n=1)
    space = ex.space

    def work(seed):
        for _ in range(5):
            ex.execute_batch(trials_of(space, 4, seed=seed))

    threads = [threading.Thread(target=work, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ex.telemetry() == {"kernel_launches": 20, "rows_evaluated": 80, "pools": 20}


def test_the_zoo_pool_runs_through_the_executor():
    from metaopt_tpu_torch.models import objectives as obj

    space = build_space(obj.MLP_SPACE)
    ex = BatchedExecutor(obj.make_mlp_batch_objective(), space, device="cpu")
    trials = trials_of(space, 16, seed=4)
    results = ex.execute_batch(trials)
    serial = obj.make_mlp_objective(device="cpu")
    want = np.asarray([serial(t.params) for t in trials])
    got = np.asarray([r.results[0]["value"] if r.status == "completed" else np.nan
                      for r in results])
    ok = want <= 100.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)
