"""The client's read side: ``pareto_front`` and ``to_pandas`` against the
reference's, on one ledger directory.

An EVC family written through the reference's CLI (``fam``, its branch
``fam-v2`` and a grandchild ``fam-v10`` whose name sorts before its
parent's) with trials in each version: ``to_pandas(with_evc_tree=True)``
from each version gives the reference's DataFrame (``assert_frame_equal``),
and so does the plain frame and the empty one. ``pareto_front`` of a
two-objective run equals the reference's list. Without pandas,
``to_pandas`` raises the reference's ImportError; the frame tests skip
only where pandas is missing.
"""

import sys

import pytest

from metaopt_tpu.cli.main import main as ref_cli
from metaopt_tpu.client.api import build_experiment as ref_build
from metaopt_tpu.ledger.backends import ledger_from_spec as ref_ledger_from_spec
from metaopt_tpu_torch.client import build_experiment


def add_trials(client, xs, values):
    exp = client.experiment
    for x, v in zip(xs, values):
        exp.register_trials([exp.make_trial({"x": x})])
        t = exp.reserve_trial("w")
        exp.push_results(t, [{"name": "o", "type": "objective", "value": v}])


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    led = str(tmp_path_factory.mktemp("frames") / "l")
    ref_cli(["init-only", "-n", "fam", "--ledger", led, "--", "x.py", "-x~uniform(0, 1)"])
    ref_cli(["init-only", "-n", "fam", "--ledger", led, "--on-conflict", "branch",
             "--", "x.py", "-x~uniform(0, 5)"])          # fam-v2
    ledger = ref_ledger_from_spec(led)
    doc = dict(ledger.load_experiment("fam-v2"))
    doc.update(name="fam-v10", version=10, parent="fam-v2")  # sorts before fam-v2
    doc.pop("metadata", None)
    ledger.create_experiment(doc)
    ledger.create_experiment({"name": "other", "space": {"x": "uniform(0, 1)"},
                              "version": 1, "algorithm": {"random": {}}})
    for name, xs in (("fam", [0.1, 0.7]), ("fam-v2", [2.5]), ("fam-v10", [4.0, 1.5, 3.0]),
                     ("other", [0.3])):
        add_trials(ref_build(name, ledger=led), xs, [x * x for x in xs])
    return led


@pytest.mark.parametrize("evc", [False, True], ids=["plain", "evc_tree"])
@pytest.mark.parametrize("name", ["fam", "fam-v2", "fam-v10", "other"])
def test_to_pandas_equals_the_reference(family, name, evc):
    pd = pytest.importorskip("pandas")
    want = ref_build(name, ledger=family).to_pandas(with_evc_tree=evc)
    got = build_experiment(name, ledger=family).to_pandas(with_evc_tree=evc)
    pd.testing.assert_frame_equal(got, want)
    if evc and name != "other":
        assert set(got["experiment"]) == {"fam", "fam-v2", "fam-v10"}


def test_to_pandas_of_an_empty_experiment_keeps_the_schema():
    pd = pytest.importorskip("pandas")
    got = build_experiment("empty", space={"x": "uniform(0, 1)"}, max_trials=4).to_pandas()
    want = ref_build("empty", space={"x": "uniform(0, 1)"}, max_trials=4).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 0 and {"status", "objective"} <= set(got.columns)


def test_to_pandas_without_pandas_raises_the_reference_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    client = build_experiment("nopd", space={"x": "uniform(0, 1)"}, max_trials=1)
    with pytest.raises(ImportError) as got:
        client.to_pandas()
    with pytest.raises(ImportError) as want:
        ref_build("nopd", space={"x": "uniform(0, 1)"}, max_trials=1).to_pandas()
    assert str(got.value) == str(want.value)


def test_pareto_front_equals_the_reference(tmp_path):
    import math

    led = str(tmp_path / "mo")
    ref = ref_build("mo", space={"x": "uniform(0, 1)", "y": "uniform(0, 1)"},
                    algorithm={"random": {"seed": 4}}, max_trials=24, ledger=led)

    def zdt1(p):
        g = 1.0 + 9.0 * p["y"]
        return [{"name": "f1", "type": "objective", "value": p["x"]},
                {"name": "f2", "type": "objective", "value": g * (1 - math.sqrt(p["x"] / g))}]

    ref.workon(zdt1)
    want = ref_build("mo", ledger=led).pareto_front()
    got = build_experiment("mo", ledger=led).pareto_front()
    assert want and got == want
    for params, objs in got:
        assert len(objs) == 2 and set(params) == {"x", "y"}
    assert build_experiment("single", space={"x": "uniform(0, 1)"}).pareto_front() == []
