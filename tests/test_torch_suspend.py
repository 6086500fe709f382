"""``should_suspend``: the algorithm hook, the producer's pass-through and
``workon``'s suspension branch, against the reference's loop.

No algorithm of either package overrides the hook, so a test-only
algorithm does: it scripts its points and parks those it names. A parked
trial is ``suspended`` in the ledger, never executed, counted in
``stats.suspended``, and does not block the experiment's completion; a
resumed one (``suspended → new``) runs. The port's and the reference's
loops are driven with the same script and must leave the same ledger.
"""

from metaopt_tpu.executor import InProcessExecutor as RefInProcessExecutor
from metaopt_tpu.ledger import Experiment as RefExperiment
from metaopt_tpu.ledger import MemoryLedger as RefMemoryLedger
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu.worker import workon as ref_workon
from metaopt_tpu_torch.algo import BaseAlgorithm
from metaopt_tpu_torch.executor import InProcessExecutor
from metaopt_tpu_torch.ledger import Experiment, MemoryLedger
from metaopt_tpu_torch.space import build_space
from metaopt_tpu_torch.worker import Producer, workon

from tests.dumbalgo import DumbAlgo as RefDumbAlgo

SCRIPT = [{"x": 9.0}, {"x": 1.0}, {"x": 2.0}, {"x": 3.0}]


class ScriptedSuspender(BaseAlgorithm):
    """Scripted points; parks every trial whose params match ``suspend_if``;
    done after ``done_after`` observations."""

    def __init__(self, space, scripted=(), suspend_if=None, done_after=None, **config):
        super().__init__(space, **config)
        self.scripted = list(scripted)
        self.suspend_if = suspend_if
        self.done_after = done_after

    def suggest(self, num=1):
        out, self.scripted = self.scripted[:num], self.scripted[num:]
        return out

    def should_suspend(self, trial):
        return bool(self.suspend_if) and all(
            trial.params.get(k) == v for k, v in self.suspend_if.items())

    @property
    def is_done(self):
        if self.done_after is not None:
            return self.n_observed >= self.done_after
        return super().is_done


def test_base_hook_and_producer_pass_through():
    space = build_space({"x": "uniform(-5, 5)"})
    exp = Experiment("p", MemoryLedger(), space=space, max_trials=2,
                     algorithm={"random": {}}).configure()
    algo = ScriptedSuspender(space, suspend_if={"x": 9.0})
    prod = Producer(exp, algo)
    [parked, ran] = [exp.make_trial(p) for p in SCRIPT[:2]]
    assert prod.should_suspend(parked) and not prod.should_suspend(ran)
    plain = make_random(space)
    assert plain.should_suspend(parked) is False


def make_random(space):
    from metaopt_tpu_torch.algo import make_algorithm

    return make_algorithm(space, {"random": {"seed": 0}})


def run_port():
    space = build_space({"x": "uniform(-5, 5)"})
    exp = Experiment("susp", MemoryLedger(), space=space, max_trials=4,
                     algorithm={"random": {}}, pool_size=1).configure()
    algo = ScriptedSuspender(space, scripted=SCRIPT, suspend_if={"x": 9.0}, done_after=3)
    ran = []

    def objective(p):
        ran.append(p["x"])
        return p["x"] ** 2

    stats = workon(exp, InProcessExecutor(objective), "w0", algorithm=algo,
                   max_idle_cycles=20)
    return exp, stats, ran, objective


def test_workon_parks_a_trial_as_suspended():
    exp, stats, ran, objective = run_port()
    assert stats.suspended == 1 and stats.completed == 3 and stats.reserved == 4
    assert 9.0 not in ran
    suspended = exp.fetch_trials("suspended")
    assert len(suspended) == 1 and suspended[0].params == {"x": 9.0}
    assert exp.is_done

    # resume path: suspended → new → reservable and executable again
    t = suspended[0]
    t.transition("new")
    t.worker = None
    assert exp.ledger.update_trial(t, expected_status="suspended")
    exp2 = Experiment("susp", exp.ledger, max_trials=4).configure()
    algo2 = ScriptedSuspender(exp2.space, done_after=0)
    stats2 = workon(exp2, InProcessExecutor(objective), "w1", algorithm=algo2,
                    max_idle_cycles=10)
    assert 9.0 in ran and stats2.completed == 1 and stats2.suspended == 0


def test_same_ledger_as_the_reference_loop():
    exp, stats, _, _ = run_port()
    ref_space = ref_build_space({"x": "uniform(-5, 5)"})
    ref_exp = RefExperiment("susp", RefMemoryLedger(), space=ref_space, max_trials=4,
                            algorithm={"dumbalgo": {}}, pool_size=1).configure()
    ref_algo = RefDumbAlgo(ref_space, scripted=[dict(p) for p in SCRIPT],
                           suspend_if={"x": 9.0}, done_after=3)
    ref_stats = ref_workon(ref_exp, RefInProcessExecutor(lambda p: p["x"] ** 2), "w0",
                           algorithm=ref_algo, max_idle_cycles=20)
    assert (stats.suspended, stats.completed, stats.reserved) == (
        ref_stats.suspended, ref_stats.completed, ref_stats.reserved)

    def rows(e):
        return sorted((t.id, t.status, t.objective, tuple(sorted(t.params.items())))
                      for t in e.fetch_trials())

    assert rows(exp) == rows(ref_exp)
