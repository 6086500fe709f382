"""EVC — branching, warm start and transfer priors — against the reference.

``TrialAdapter``'s five rules (pass, filter, fill, rename, delete) and each
``BranchConflictError`` equal the reference's, message for message. Random
search draws with numpy only, so the same ``hunt`` through both CLIs must
write equal ledgers — trial ids, params, objectives, statuses and the
experiment documents — for ``--branch-from`` (with ``--branch-default`` and
``--branch-rename``), ``--warm-start`` and each ``--on-conflict`` mode.
TPE after the producer's warm start (transfer priors first, then the branch
parent through the adapter, then the warm-start source) holds the
reference's ``n_prior``, observation order, split, weights and bandwidths
within 1e-5.
"""

import json

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.cli import main as ref_main
from metaopt_tpu.ledger.backends import FileLedger as RefFileLedger
from metaopt_tpu.ledger.evc import BranchConflictError as RefConflict
from metaopt_tpu.ledger.evc import TrialAdapter as RefAdapter
from metaopt_tpu.ledger.experiment import Experiment as RefExperiment
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu.worker.producer import Producer as RefProducer
from metaopt_tpu_torch.algo.base import make_algorithm
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import BranchConflictError, Experiment, FileLedger, Trial, TrialAdapter
from metaopt_tpu_torch.space import build_space
from metaopt_tpu_torch.worker.producer import Producer
from test_torch_cli import QUAD, algo_config

PARENT = {"x": "uniform(-5, 10)", "y": "uniform(-5, 10)", "z": "choices(['a', 'b'])",
          "old": "uniform(0, 1)"}
CHILD = {"x": "uniform(-5, 10)", "y": "uniform(-5, 5)", "w": "randint(1, 4)",
         "new": "uniform(0, 1)"}


def parent_trials(n=60, seed=0):
    space = build_space(PARENT)
    out = []
    for i, p in enumerate(space.sample(n, seed=seed)):
        doc = Trial(params=p, experiment="p", status="completed", submit_time=float(i),
                    results=[{"name": "objective", "type": "objective",
                              "value": float(p["x"]) ** 2 + float(i)}]).to_dict()
        out.append(doc)
    return out


def adapted_view(t):
    return None if t is None else (t.id, t.lineage, json.dumps(t.params), t.parent,
                                   [r.to_dict() for r in t.results], t.status)


def test_the_five_rules_match_the_reference():
    args = dict(defaults={"w": 2}, renames={"old": "new"})
    port = TrialAdapter(build_space(PARENT), build_space(CHILD), **args)
    ref = RefAdapter(ref_build_space(PARENT), ref_build_space(CHILD), **args)
    assert port.describe() == ref.describe() == {
        "passed": ["x"], "filtered": ["y"], "filled": {"w": 2}, "renamed": {"old": "new"},
        "deleted": ["z"]}
    docs = parent_trials()
    got = [adapted_view(port.adapt(Trial.from_dict(d))) for d in docs]
    want = [adapted_view(ref.adapt(RefTrial.from_dict(d))) for d in docs]
    assert got == want
    kept = [g for g in got if g is not None]
    assert 0 < len(kept) < len(docs)          # the narrowed y drops some
    for _, _, params, parent, _, _ in kept:
        p = json.loads(params)
        assert set(p) == set(CHILD) and p["w"] == 2 and -5 <= p["y"] <= 5 and parent


CONFLICTS = [
    ({"x": "uniform(0, 1)"}, {"x": "uniform(0, 1)", "y": "uniform(0, 1)"}, {}, {}),
    ({"x": "uniform(0, 1)"}, {"x": "uniform(0, 1)", "y": "uniform(0, 1)"}, {"y": 5.0}, {}),
    ({"x": "uniform(0, 1)"}, {"x": "uniform(0, 1)"}, {"q": 1}, {}),
    ({"x": "uniform(0, 1)"}, {"y": "uniform(0, 1)"}, {}, {"nope": "y"}),
    ({"x": "uniform(0, 1)"}, {"y": "uniform(0, 1)"}, {}, {"x": "nope"}),
    ({"x": "uniform(0, 1)", "v": "uniform(0, 1)"}, {"y": "uniform(0, 1)"}, {},
     {"x": "y", "v": "y"}),
    ({"x": "uniform(0, 1)", "y": "uniform(0, 1)"}, {"y": "uniform(0, 1)"}, {}, {"x": "y"}),
]


@pytest.mark.parametrize("case", range(len(CONFLICTS)))
def test_each_branch_conflict_matches_the_reference(case):
    parent, child, defaults, renames = CONFLICTS[case]
    with pytest.raises(BranchConflictError) as port_err:
        TrialAdapter(build_space(parent), build_space(child), defaults, renames)
    with pytest.raises(RefConflict) as ref_err:
        RefAdapter(ref_build_space(parent), ref_build_space(child), defaults, renames)
    assert str(port_err.value) == str(ref_err.value)


def stored_view(led, name):
    doc = dict(led.load_experiment(name))
    doc["metadata"] = {k: v for k, v in doc["metadata"].items()
                       if k not in ("datetime", "framework_version")}
    doc["user_args"] = [a.rsplit("/", 1)[-1] for a in doc["user_args"]]
    doc["metadata"]["user_args"] = [a.rsplit("/", 1)[-1]
                                    for a in doc["metadata"].get("user_args", [])]
    rows = sorted((t.id, json.dumps(t.params, sort_keys=True), t.objective, t.status)
                  for t in led.fetch(name))
    return doc, rows


def both_clis(tmp_path, steps):
    """Run each argv of ``steps`` through both CLIs on their own file
    ledgers; the two ledgers' every experiment, doc and rows."""
    out = {}
    for tag, cli, led_cls in (("ref", ref_main, RefFileLedger), ("port", main, FileLedger)):
        root = tmp_path / tag
        root.mkdir()
        quad = root / "quad.py"
        quad.write_text(QUAD)
        for argv in steps:
            argv = [a.replace("QUAD", str(quad)) for a in argv]
            argv = argv[:1] + ["--ledger", f"file:{root / 'l'}"] + argv[1:]
            try:
                rc = cli(argv)
            except SystemExit as err:
                rc = f"exit: {err}"
            out.setdefault(tag, {}).setdefault("rcs", []).append(rc)
        led = led_cls(str(root / "l"))
        out[tag]["ledger"] = {n: stored_view(led, n) for n in led.list_experiments()}
    return out["port"], out["ref"]


@pytest.mark.parametrize("mode", ["branch_from", "warm_start", "adopt", "fail", "branch"])
def test_evc_hunts_write_the_reference_clis_ledger(tmp_path, capsys, mode):
    cfg = algo_config(tmp_path, {"random": {"seed": 3}})
    parent = ["hunt", "-n", "p", "--max-trials", "4", "--config", cfg, "QUAD",
              "-x~uniform(-5, 5)"]
    child = {
        "branch_from": ["hunt", "-n", "c", "--max-trials", "3", "--config", cfg,
                        "--branch-from", "p", "--branch-default", "fail-above=0.5", "QUAD",
                        "-x~uniform(-2, 2)", "--fail-above~uniform(0, 1)"],
        "warm_start": ["hunt", "-n", "c", "--max-trials", "3", "--config", cfg,
                       "--warm-start", "p", "QUAD", "-x~uniform(-5, 5)"],
    }.get(mode, ["hunt", "-n", "p", "--max-trials", "6", "--config", cfg,
                 "--on-conflict", mode, "QUAD", "-x~uniform(-3, 3)"])
    again = child if mode == "branch" else []
    steps = [parent, child] + ([again] if again else [])
    got, want = both_clis(tmp_path, steps)
    capsys.readouterr()
    assert got["rcs"] == want["rcs"]
    assert got["ledger"] == want["ledger"]
    names = set(got["ledger"])
    if mode == "branch_from":
        doc = got["ledger"]["c"][0]
        assert doc["version"] == 2 and doc["metadata"]["branch"]["parent"] == "p"
        assert doc["metadata"]["branch"]["adapter"]["filled"] == {"fail-above": 0.5}
        assert sum(row[3] == "completed" for row in got["ledger"]["c"][1]) == 3
    elif mode == "warm_start":
        assert got["ledger"]["c"][0]["metadata"]["warm_start"] == "p"
    elif mode == "branch":
        # the rerun of the same changed command joins the branch it made
        assert names == {"p", "p-v2"} and len(got["ledger"]["p-v2"][1]) == 6
    elif mode == "fail":
        assert "different configuration" in str(got["rcs"][1])
    else:
        assert names == {"p"} and len(got["ledger"]["p"][1]) == 4


def test_branch_rename_through_both_clis(tmp_path, capsys):
    cfg = algo_config(tmp_path, {"random": {"seed": 4}})
    got, want = both_clis(tmp_path, [
        ["init-only", "-n", "p", "--max-trials", "5", "--config", cfg, "QUAD",
         "-x~uniform(-5, 5)"],
        ["hunt", "-n", "p", "--max-trials", "5", "--config", cfg],
        ["init-only", "-n", "c", "--config", cfg, "--branch-from", "p", "--branch-rename",
         "x=xx", "QUAD", "--xx~uniform(-5, 5)"],
    ])
    capsys.readouterr()
    assert got == want
    assert got["ledger"]["c"][0]["metadata"]["branch"]["renames"] == {"x": "xx"}


def warm_tpe(tmp_path, ref: bool, metadata):
    """A child TPE after the producer's one-time warm start."""
    led = (RefFileLedger if ref else FileLedger)(str(tmp_path / "l"))
    exp_cls, space_of, make, prod = (
        (RefExperiment, ref_build_space, ref_make_algorithm, RefProducer) if ref
        else (Experiment, build_space, make_algorithm, Producer))
    name = f"child-{'ref' if ref else 'port'}-{len(metadata)}"
    algo_cfg = {"tpe": {"seed": 0, "n_initial_points": 5}}
    if not ref:
        algo_cfg["tpe"]["device"] = "cpu"
    exp = exp_cls(name, led, space=space_of(CHILD), algorithm=algo_cfg, max_trials=0,
                  metadata=metadata).configure()
    algo = make(exp.space, algo_cfg)
    algo._suggest_ahead_async = lambda: None
    p = prod(exp, algo)
    assert p.produce() == 0
    return algo


def test_tpe_after_a_warm_start_holds_the_reference(tmp_path):
    led = FileLedger(str(tmp_path / "l"))
    for name, space, seed in (("p", PARENT, 0), ("q", CHILD, 1)):
        exp = Experiment(name, led, space=build_space(space), max_trials=100).configure()
        for d in parent_trials(40, seed) if name == "p" else []:
            led.register(Trial.from_dict({**d, "experiment": "p"}))
        if name == "q":
            for i, pt in enumerate(exp.space.sample(30, seed=seed)):
                led.register(Trial(params=pt, experiment="q", status="completed",
                                   submit_time=100.0 + i,
                                   results=[{"name": "o", "type": "objective",
                                             "value": float(i % 7)}]))
    branch = {"parent": "p", "defaults": {"w": 1}, "renames": {"old": "new"}}
    for metadata in ({"transfer_from": "q"},
                     {"branch": branch},
                     {"transfer_from": "q", "branch": branch, "warm_start": "q"}):
        port, ref = warm_tpe(tmp_path, False, metadata), warm_tpe(tmp_path, True, metadata)
        assert port.n_prior == ref.n_prior
        assert port.n_observed == ref.n_observed > 0
        assert np.array_equal(np.stack(port._X), np.stack(ref._X))
        assert port._y == ref._y
        n = len(port._y)
        np.testing.assert_allclose(port._weights(n), ref._weights(n), rtol=1e-5, atol=1e-5)
        below, above = port._split()
        r_below, r_above = ref._split()
        assert np.array_equal(below, r_below) and np.array_equal(above, r_above)
        for idx in (below, above):
            a, b = port._fit_set(idx), ref._fit_set(idx)
            for key in ("mu", "sigma", "logw", "cat_logp", "w"):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5)
        if "transfer_from" in metadata:
            assert port.n_prior == 30
            # the priors are the oldest rows, and their vote is discounted
            assert port._weights(n)[:30].max() <= port.transfer_discount
