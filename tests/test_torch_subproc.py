"""The port's subprocess executor, client handshake and worker loop.

Ports of the reference's subprocess cases (``tests/functional/test_demo.py``:
judge pruning, the cooperative stop sentinel, injected faults) and of its
device-breaker cases (``tests/unit/test_device_breaker.py``, here keyed on
CUDA), plus the requeue budget of ``worker/loop.py``. One protocol test runs
the reference's own unchanged ``tests/functional/black_box.py`` under the
port's executor: the environment protocol is the same. Outcomes are exact
(statuses, counts, objectives equal to the script's closed form).
"""

import json
import os
import sys
import time
from pathlib import Path

import pytest

from metaopt_tpu_torch import client
from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.executor import ExecutionResult, Executor, SubprocessExecutor
from metaopt_tpu_torch.executor.faults import FaultInjector, faults
from metaopt_tpu_torch.ledger import Experiment, FileLedger, Trial
from metaopt_tpu_torch.space import SpaceBuilder
from metaopt_tpu_torch.utils import procs
from metaopt_tpu_torch.worker import workon

REPO = Path(__file__).resolve().parents[1]
REF_BLACK_BOX = REPO / "tests" / "functional" / "black_box.py"

QUAD = '''
import argparse
from metaopt_tpu_torch.client import report_results
p = argparse.ArgumentParser()
p.add_argument("-x", type=float, required=True)
p.add_argument("--fail-above", type=float, default=None)
a = p.parse_args()
if a.fail_above is not None and a.x > a.fail_above:
    raise SystemExit(3)
report_results([{"name": "objective", "type": "objective", "value": (a.x - 1.0) ** 2}])
'''

STREAMING = '''
import argparse, time
from metaopt_tpu_torch.client import report_partial, report_results, stop_requested
p = argparse.ArgumentParser()
p.add_argument("-x", type=float, required=True)
p.add_argument("--steps", type=int, default=60)
p.add_argument("--cooperative", type=int, default=0)
a = p.parse_args()
obj = (a.x - 1.0) ** 2
for step in range(a.steps):
    report_partial(obj + (a.steps - step - 1) * 0.1, step)
    if a.cooperative and stop_requested():
        report_results([{"name": "objective", "type": "objective", "value": obj},
                        {"name": "clean_exit_at", "type": "statistic", "value": step}])
        raise SystemExit(0)
    time.sleep(0.05)
report_results([{"name": "objective", "type": "objective", "value": obj}])
'''


@algo_registry.register("torch_test_judge")
class JudgeAll(BaseAlgorithm):
    """Random points; the judge stops any trial whose last partial
    objective lies below ``judge_stop_below`` (the reference's DumbAlgo
    judge)."""

    def __init__(self, space, seed=None, judge_stop_below=None, **config):
        super().__init__(space, seed=seed, **config)
        self.judge_stop_below = judge_stop_below

    def suggest(self, num=1):
        return self.space.sample(num, seed=self.rng)

    def judge(self, trial, partial):
        if self.judge_stop_below is not None and partial \
                and partial[-1]["objective"] < self.judge_stop_below:
            return {"stop": True}
        return None


def script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(body)
    return str(path)


def experiment(tmp_path, name, argv, algorithm, max_trials):
    space, template = SpaceBuilder().build(argv)
    exp = Experiment(name, FileLedger(str(tmp_path / "ledger")), space=space,
                     algorithm=algorithm, max_trials=max_trials).configure()
    return exp, template


def test_reference_black_box_runs_under_the_port_executor(tmp_path):
    """The env protocol (results path, trial info, stop path, PYTHONPATH)
    is the reference's: its own script reports through its own client."""
    exp, template = experiment(tmp_path, "proto", [str(REF_BLACK_BOX), "-x~uniform(-5, 5)"],
                               {"random": {"seed": 0}}, 3)
    stats = workon(exp, SubprocessExecutor(template, interpreter=[sys.executable],
                                           poll_interval_s=0.02), "w0")
    assert stats.completed == 3 and stats.broken == 0
    for t in exp.fetch_completed_trials():
        assert t.objective == (t.params["x"] - 1.0) ** 2


def test_broken_trial_keeps_exit_code_and_stderr(tmp_path):
    quad = script(tmp_path, "quad.py", QUAD)
    exp, template = experiment(tmp_path, "brk", [quad, "-x~uniform(-5, 5)", "--fail-above=0"],
                               {"random": {"seed": 2}}, 4)
    stats = workon(exp, SubprocessExecutor(template, interpreter=[sys.executable],
                                           poll_interval_s=0.02), "w0", max_broken=50)
    broken = exp.fetch_trials("broken")
    assert stats.completed == 4 and stats.broken == len(broken) > 0
    assert all(t.exit_code == 3 and t.params["x"] > 0 for t in broken)
    notes = [e["note"] for e in stats.events if e["status"] == "broken"]
    assert all(n.startswith("exit=3, no results reported") for n in notes)


def test_judge_prunes_streaming_trial(tmp_path):
    """report_partial → judge → SIGTERM after the grace → the last partial
    objective is the trial's measurement."""
    stream = script(tmp_path, "stream.py", STREAMING)
    exp, template = experiment(tmp_path, "prune", [stream, "-x~uniform(-2, 2)", "--steps=60"],
                               {"torch_test_judge": {"judge_stop_below": 1e9}}, 2)
    stats = workon(exp, SubprocessExecutor(template, interpreter=[sys.executable],
                                           poll_interval_s=0.05), "w0")
    assert stats.completed == 2 and stats.pruned == 2
    for t in exp.fetch_completed_trials():
        steps = [r.value for r in t.results if r.name == "pruned_at_step"]
        assert steps and steps[0] < 59  # stopped before its last step
        assert t.objective == pytest.approx((t.params["x"] - 1.0) ** 2
                                            + (60 - steps[0] - 1) * 0.1)


def test_pruned_trial_can_exit_cleanly_via_stop_sentinel(tmp_path):
    stream = script(tmp_path, "stream.py", STREAMING)
    exp, template = experiment(
        tmp_path, "coop", [stream, "-x~uniform(-2, 2)", "--steps=60", "--cooperative=1"],
        {"torch_test_judge": {"judge_stop_below": 1e9}}, 1)
    stats = workon(exp, SubprocessExecutor(template, interpreter=[sys.executable],
                                           poll_interval_s=0.05, prune_grace_s=10.0), "w0")
    assert stats.completed == 1 and stats.pruned == 1
    (t,) = exp.fetch_completed_trials()
    # the script's OWN final report landed, not the SIGTERM fallback's
    assert any(r.name == "clean_exit_at" for r in t.results)
    assert not any(r.name == "pruned_at_step" for r in t.results)
    assert t.objective == (t.params["x"] - 1.0) ** 2


def test_hunt_completes_under_injected_faults(tmp_path):
    """Spawn failures and mid-run kills surface as broken trials, never
    stall the loop, and the experiment still reaches max_trials."""
    quad = script(tmp_path, "quad.py", QUAD)
    faults.reset()
    faults.arm("spawn_fail", times=1)
    faults.arm("kill_trial", times=2)
    try:
        exp, template = experiment(tmp_path, "chaos", [quad, "-x~uniform(-5, 5)"],
                                   {"random": {"seed": 4}}, 6)
        stats = workon(exp, SubprocessExecutor(template, interpreter=[sys.executable],
                                               poll_interval_s=0.02), "w0", max_broken=10)
        assert stats.broken == 3          # 1 spawn_fail + 2 kill_trial
        assert exp.count("completed") == 6 and exp.is_done
        assert faults.fired("spawn_fail") == 1 and faults.fired("kill_trial") == 2
    finally:
        faults.reset()


def test_dropped_heartbeat_interrupts_the_trial(tmp_path):
    stream = script(tmp_path, "stream.py", STREAMING)
    exp, template = experiment(tmp_path, "beat", [stream, "-x~uniform(-2, 2)", "--steps=40"],
                               {"random": {"seed": 5}}, 1)
    faults.reset()
    faults.arm("drop_heartbeat", times=1)
    try:
        ex = SubprocessExecutor(template, interpreter=[sys.executable],
                                poll_interval_s=0.02, heartbeat_every_s=0.1)
        stats = workon(exp, ex, "w0", worker_trials=1)
    finally:
        faults.reset()
    assert stats.interrupted == 1
    assert exp.fetch_trials("interrupted")[0].id == stats.events[0]["trial"]
    assert stats.events[0]["note"] == "lost reservation"


def test_fault_spec_grammar():
    inj = FaultInjector("kill_trial:2@1,spawn_fail,bad:x,drop_heartbeat:p=1@3")
    assert [inj.fire("kill_trial") for _ in range(4)] == [False, True, True, False]
    assert inj.fire("spawn_fail") and not inj.fire("spawn_fail")
    assert all(inj.fire("drop_heartbeat") for _ in range(3))
    assert inj.fired("kill_trial") == 2 and inj.fired("drop_heartbeat") == 3
    assert not inj.fire("bad")


# -- the device circuit breaker ------------------------------------------


def breaker(monkeypatch, probe, cuda_env=True, **kw):
    monkeypatch.setattr(SubprocessExecutor, "_device_expected", staticmethod(lambda: cuda_env))
    _, template = SpaceBuilder().build(["t.py", "-x~uniform(0, 1)"])
    return SubprocessExecutor(template, probe_fn=probe, **kw)


def reserved_trial(i=0):
    t = Trial(params={"x": 0.5}, experiment="e")
    t.id = f"breaker-{i:04d}"
    t.transition("reserved")
    return t


def timeout_inner(monkeypatch):
    monkeypatch.setattr(
        SubprocessExecutor, "_execute_inner",
        lambda self, t, heartbeat=None, judge=None: ExecutionResult(
            "broken", note="timeout after 900.0s"))


def test_breaker_timeout_with_live_card_stays_broken(monkeypatch):
    ex = breaker(monkeypatch, probe=lambda **_: True)
    timeout_inner(monkeypatch)
    res = ex.execute(reserved_trial())
    assert res.status == "broken" and not ex._suspect_device


def test_breaker_timeout_with_dead_card_reclassifies_and_parks(monkeypatch):
    calls = []

    def probe(**kw):
        calls.append(kw["timeout_s"])
        return False

    ex = breaker(monkeypatch, probe=probe, park_max_s=0.0, park_poll_s=0.01,
                 device_probe_timeout_s=7.0)
    timeout_inner(monkeypatch)
    res = ex.execute(reserved_trial(0))
    assert res.status == "interrupted" and res.requeue
    assert "attributed to a device wedge" in res.note and "CUDA" in res.note
    assert ex._suspect_device
    # the next launch parks on the armed suspicion; the budget is spent at once
    res = ex.execute(reserved_trial(1))
    assert res.status == "interrupted" and res.requeue and "parked" in res.note
    assert calls == [7.0, 7.0]


def test_breaker_recovers_when_the_card_answers(monkeypatch):
    verdicts = iter([False, True])
    ex = breaker(monkeypatch, probe=lambda **_: next(verdicts))
    timeout_inner(monkeypatch)
    assert ex.execute(reserved_trial(0)).status == "interrupted"
    monkeypatch.setattr(SubprocessExecutor, "_execute_inner",
                        lambda self, t, heartbeat=None, judge=None: ExecutionResult(
                            "completed", results=[{"name": "o", "type": "objective",
                                                   "value": 1.0}]))
    assert ex.execute(reserved_trial(1)).status == "completed"
    assert not ex._suspect_device


def test_breaker_ignores_other_breakage_and_cpu_hosts(monkeypatch):
    probed = []
    ex = breaker(monkeypatch, probe=lambda **_: probed.append(1) or False)
    monkeypatch.setattr(SubprocessExecutor, "_execute_inner",
                        lambda self, t, heartbeat=None, judge=None: ExecutionResult(
                            "broken", note="exit=1, no results reported; stderr "
                                           "tail: timeout after 3s"))
    assert ex.execute(reserved_trial()).status == "broken" and not ex._suspect_device
    ex = breaker(monkeypatch, probe=lambda **_: probed.append(1) or False, cuda_env=False)
    timeout_inner(monkeypatch)
    assert ex.execute(reserved_trial()).status == "broken" and not ex._suspect_device
    assert probed == []


@pytest.mark.parametrize("visible,nodes,want", [
    (None, ["/dev/nvidia0"], True), ("0", ["/dev/nvidia0"], True),
    ("", ["/dev/nvidia0"], False), (None, [], False)])
def test_device_expected_reads_cuda_env(monkeypatch, visible, nodes, want):
    import glob

    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(glob, "glob", lambda pat: list(nodes))
    assert SubprocessExecutor._device_expected() is want


class Requeuer(Executor):
    """Every run is an infrastructure failure the executor asks to retry."""

    def __init__(self):
        self.runs = []

    def execute(self, trial, heartbeat=None, judge=None):
        self.runs.append(trial.id)
        return ExecutionResult("interrupted", note="wedge", requeue=True)


def test_requeue_budget_binds_per_trial(tmp_path):
    exp, _ = experiment(tmp_path, "rq", ["t.py", "-x~uniform(0, 1)"], {"random": {"seed": 0}}, 1)
    ex = Requeuer()
    stats = workon(exp, ex, "w0", worker_trials=4)
    (t,) = exp.fetch_trials()
    # 3 requeues back to 'new', then the 4th run lands as interrupted
    assert ex.runs == [t.id] * 4
    assert stats.requeued == 3 and stats.interrupted == 1
    assert t.status == "interrupted" and t.resources == {"requeues": 3}
    assert "requeue budget exhausted" in stats.events[-1]["note"]


def test_workon_refuses_the_coordinator_producer(tmp_path):
    exp, _ = experiment(tmp_path, "pm", ["t.py", "-x~uniform(0, 1)"], {"random": {"seed": 0}}, 1)
    with pytest.raises(NotImplementedError, match="coordinator producer not ported yet"):
        workon(exp, Requeuer(), producer_mode="coord")


# -- probes and the handshake --------------------------------------------


def test_run_with_deadline_kills_a_hung_child():
    t0 = time.time()
    assert procs.run_with_deadline([sys.executable, "-c", "import time; time.sleep(30)"],
                                   timeout_s=1.0, poll_s=0.05) is None
    assert time.time() - t0 < 10
    assert procs.run_with_deadline([sys.executable, "-c", "raise SystemExit(3)"],
                                   timeout_s=30, poll_s=0.05) == 3


def test_cuda_probe_is_false_without_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    t0 = time.time()
    assert procs.cuda_backend_reachable(timeout_s=60) is False
    assert time.time() - t0 < 1.0  # decided without a child
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    import torch

    assert procs.cuda_backend_reachable(timeout_s=120) is torch.cuda.is_available()


def test_client_handshake(tmp_path, monkeypatch):
    monkeypatch.delenv(client.RESULTS_PATH_ENV, raising=False)
    with pytest.raises(client.ReportError):
        client.report_objective(1.0)
    res = tmp_path / "results.json"
    monkeypatch.setenv(client.RESULTS_PATH_ENV, str(res))
    monkeypatch.setenv(client.STOP_PATH_ENV, str(tmp_path / "stop"))
    monkeypatch.setenv(client.TRIAL_INFO_ENV, json.dumps({"id": "t1", "experiment": "e",
                                                          "parent": None}))
    with pytest.raises(client.ReportError):
        client.report_results([{"name": "s", "type": "statistic", "value": 1}])
    client.report_partial(3.0, 1)
    client.report_partial(2.0, 2)
    client.report_results([{"name": "o", "type": "objective", "value": 0.5}])
    assert json.loads(res.read_text()) == [{"name": "o", "type": "objective", "value": 0.5}]
    assert [json.loads(x) for x in (tmp_path / "results.json.partial").read_text().splitlines()] == \
        [{"objective": 3.0, "step": 1}, {"objective": 2.0, "step": 2}]
    assert not os.path.exists(str(res) + ".tmp")
    assert not client.stop_requested()
    (tmp_path / "stop").touch()
    assert client.stop_requested()
    assert client.get_trial_info()["id"] == "t1"
    monkeypatch.setenv(client.CKPT_ROOT_ENV, str(tmp_path / "ck"))
    own, parent = client.checkpoint_paths()
    assert own == str(tmp_path / "ck" / "t1") and parent is None
    with client.profiled():   # no profile dir injected: a no-op
        pass


def test_profiled_writes_a_trace_under_the_profile_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(client.PROFILE_DIR_ENV, str(tmp_path / "prof"))
    monkeypatch.setenv(client.TRIAL_INFO_ENV, json.dumps({"id": "t9"}))
    import torch

    with client.profiled():
        torch.ones(4).sum()
    assert (tmp_path / "prof" / "t9" / "trace.json").stat().st_size > 0
