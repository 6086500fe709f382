"""The port's read-only web API against the reference's, on the CPU.

Every contract of the reference's ``tests/unit/test_webapi.py`` is
restated against the port's threaded server (its surrogate routes fitted
on ``device="cpu"``). Then one ledger directory written through the
reference is served by both packages' ``make_server``: every route's JSON
is equal, exactly for the routes that read the ledger only, and the
dashboard HTML is the same page. ``/importance`` agrees within 1e-4
(GP-BO's fit bound; measured 5e-7 on the Rosenbrock experiment). ``/pdp``
is held to 2e-3 of the objective's standard deviation, a bound wider than
1e-4: on that experiment (objectives spanning six decades, a fitted
log-noise of -8) the two packages' hyperparameters end 80 Adam steps
1.5e-4 apart, and the near noise-free posterior mean turns that into
6.4e-4 sd (measured), where well-scaled inputs agree within 2e-5
(``test_torch_gp_analysis.py``). The Pareto cases of the reference's
``tests/functional/test_multiobjective.py`` are restated for ``/pareto``.
"""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from metaopt_tpu_torch.io import webapi
from metaopt_tpu_torch.io.webapi import make_server, start_in_thread
from metaopt_tpu_torch.ledger import Experiment, MemoryLedger
from metaopt_tpu_torch.ledger.backends import make_ledger
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space

TOL = 1e-4
PDP_TOL = 2e-3   # of the objective's standard deviation; see the docstring


class Served:
    """A port server on an ephemeral port, shut down on exit."""

    def __init__(self, ledger, make=make_server, **kw):
        self.server = make(ledger, **kw)
        start_in_thread(self.server)
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"

    def __enter__(self):
        return self.url

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


def get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def get_any(url):
    """(status, payload) for any status, error statuses included."""
    try:
        return get(url)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def completed(exp, params, value, worker="w"):
    t = exp.make_trial(params)
    exp.register_trials([t])
    got = exp.reserve_trial(worker)
    exp.push_results(got, [{"name": "o", "type": "objective", "value": value}])


@pytest.fixture
def served():
    ledger = MemoryLedger()
    space = build_space({"x": "uniform(-5, 5)"})
    exp = Experiment("api", ledger, space=space, max_trials=10).configure()
    for i in range(3):
        completed(exp, {"x": float(i)}, float(2 - i))
    exp.register_trials([exp.make_trial({"x": 4.5})])  # one 'new' trial
    with Served(ledger, device="cpu") as url:
        yield url


def test_healthz_and_root(served):
    assert get(f"{served}/healthz") == (200, {"ok": True})
    status, doc = get(f"{served}/")
    assert status == 200 and "/experiments" in doc["routes"]


def test_experiments_listing_and_detail(served):
    status, rows = get(f"{served}/experiments")
    assert status == 200
    assert rows[0]["name"] == "api"
    assert rows[0]["completed"] == 3 and rows[0]["trials"] == 4

    status, doc = get(f"{served}/experiments/api")
    assert status == 200
    assert doc["max_trials"] == 10
    assert doc["stats"]["by_status"] == {"completed": 3, "new": 1}
    assert doc["stats"]["best"]["objective"] == 0.0


def test_trials_with_status_filter(served):
    status, trials = get(f"{served}/experiments/api/trials")
    assert status == 200 and len(trials) == 4
    status, trials = get(f"{served}/experiments/api/trials?status=new")
    assert status == 200 and len(trials) == 1
    with pytest.raises(urllib.error.HTTPError) as err:
        get(f"{served}/experiments/api/trials?status=bogus")
    assert err.value.code == 400


def test_regret_series(served):
    status, doc = get(f"{served}/experiments/api/regret")
    assert status == 200
    bests = [p["best"] for p in doc["regret"]]
    assert bests == [2.0, 1.0, 0.0]


def test_lcurves_endpoint(served):
    # the fixture's space has no fidelity dimension → 400 with a clear error
    with pytest.raises(urllib.error.HTTPError) as err:
        get(f"{served}/experiments/api/lcurves")
    assert err.value.code == 400


def test_lcurves_endpoint_with_fidelity():
    ledger = MemoryLedger()
    space = build_space({"x": "uniform(-5, 5)",
                         "epochs": "fidelity(1, 4, base=2)"})
    exp = Experiment("fid", ledger, space=space, max_trials=10).configure()
    for budget in (1, 2, 4):
        completed(exp, {"x": 1.0, "epochs": budget}, 1.0 / budget)
    with Served(ledger, device="cpu") as url:
        status, doc = get(f"{url}/experiments/fid/lcurves")
    assert status == 200 and doc["fidelity"] == "epochs"
    (curve,) = doc["lcurves"].values()
    assert [p["budget"] for p in curve] == [1, 2, 4]


def test_parallel_endpoint(served):
    status, doc = get(f"{served}/experiments/api/parallel")
    assert status == 200
    assert doc["dimensions"] == ["x"]
    assert len(doc["trials"]) == 3
    assert all(set(r) == {"x", "objective"} for r in doc["trials"])


def test_unknown_routes_404(served):
    for path in ("/experiments/ghost", "/nope", "/experiments/api/nope"):
        with pytest.raises(urllib.error.HTTPError) as err:
            get(f"{served}{path}")
        assert err.value.code == 404


def test_dashboard_serves_html(served):
    with urllib.request.urlopen(f"{served}/dashboard", timeout=10) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/html")
        body = r.read().decode()
    # the page is self-contained: polls the JSON routes, draws the regret
    # SVG, and never references an external asset
    assert "/experiments" in body and "svg" in body.lower()
    assert "http://" not in body.split("<body>")[1]  # no external fetches
    # the pareto section rides the same page (drawn when /pareto is 200)
    assert "drawPareto" in body and 'id="pareto"' in body


def test_importance_endpoint_needs_trials(served):
    # the shared fixture has only 3 completed trials -> clear 400
    with pytest.raises(urllib.error.HTTPError) as err:
        get(f"{served}/experiments/api/importance")
    assert err.value.code == 400


def test_importance_endpoint():
    ledger = MemoryLedger()
    space = build_space({"a": "uniform(0, 1)", "b": "uniform(0, 1)"})
    exp = Experiment("imp", ledger, space=space, max_trials=20).configure()
    rng = np.random.default_rng(2)
    for _ in range(8):
        pt = {"a": float(rng.random()), "b": float(rng.random())}
        completed(exp, pt, 7 * (pt["a"] - 0.5) ** 2)
    with Served(ledger, device="cpu") as url:
        status, doc = get(f"{url}/experiments/imp/importance")
    assert status == 200
    assert abs(sum(doc["importance"].values()) - 1.0) < 1e-6
    assert doc["importance"]["a"] > doc["importance"]["b"]


def test_workers_endpoint(served):
    code, rows = get(served + "/experiments/api/workers")
    assert code == 200
    assert len(rows) == 1 and rows[0]["worker"] == "w"
    assert rows[0]["completed"] == 3
    assert rows[0]["reserved"] == 0 and rows[0]["current"] == []
    assert rows[0]["last_seen_age_s"] is not None


def test_workers_shows_live_reservation():
    ledger = MemoryLedger()
    space = build_space({"x": "uniform(-5, 5)"})
    exp = Experiment("live", ledger, space=space, max_trials=5).configure()
    exp.register_trials([exp.make_trial({"x": 1.0}),
                         exp.make_trial({"x": 2.0})])
    a = exp.reserve_trial("alpha")
    exp.push_results(a, [{"name": "o", "type": "objective", "value": 0.5}])
    b = exp.reserve_trial("beta")   # still holding
    rows = webapi.worker_table(ledger, "live")
    byw = {r["worker"]: r for r in rows}
    assert byw["alpha"]["completed"] == 1 and byw["alpha"]["current"] == []
    assert byw["beta"]["reserved"] == 1 and byw["beta"]["current"] == [b.id]
    # beta heartbeated more recently than alpha finished -> listed first
    assert rows[0]["worker"] == "beta"


def test_dashboard_includes_workers_panel(served):
    with urllib.request.urlopen(served + "/dashboard", timeout=10) as r:
        html = r.read().decode()
    assert 'id="workers"' in html
    assert "drawWorkers" in html
    assert "/workers'" in html or "/workers')" in html.replace('"', "'")


def test_pdp_endpoint(served):
    # the fixture seeds 3 completed trials: below the 4-trial floor
    with pytest.raises(urllib.error.HTTPError) as err:
        get(served + "/experiments/api/pdp")
    assert err.value.code == 400
    ledger = MemoryLedger()
    space = build_space({"x": "uniform(0, 1)"})
    exp = Experiment("p", ledger, space=space, max_trials=10).configure()
    for i in range(6):
        completed(exp, {"x": i / 6 + 0.05}, (i / 6 - 0.5) ** 2)
    code, payload = webapi.pdp_series(ledger, "p", device="cpu")
    assert code == 200
    curve = payload["pdp"]["x"]
    assert len(curve["x"]) == len(curve["mean"]) == 24


def test_surrogate_endpoints_with_fidelity_and_nan():
    """importance/pdp align to cube columns (fidelity excluded) and treat
    NaN-heavy histories as a 400, not a 500."""
    ledger = MemoryLedger()
    space = build_space({"lr": "loguniform(1e-4, 1e-1)",
                         "width": "uniform(8, 64, discrete=True)",
                         "epochs": "fidelity(1, 8, base=2)"})
    exp = Experiment("fid", ledger, space=space, max_trials=30).configure()
    for i in range(8):
        completed(exp, {"lr": 10 ** (-1 - i * 0.3), "width": 8 + 4 * i, "epochs": 8},
                  (i - 3) ** 2 * 0.1)
    code, imp = webapi.importance_series(ledger, "fid", device="cpu")
    assert code == 200
    assert set(imp["importance"]) == {"lr", "width"}  # fidelity excluded
    code, pdp = webapi.pdp_series(ledger, "fid", device="cpu")
    assert code == 200
    assert set(pdp["pdp"]) == {"lr", "width"}
    assert all(math.isfinite(v) for v in pdp["pdp"]["lr"]["mean"])
    # integers come back in native scale
    assert all(isinstance(v, int) for v in pdp["pdp"]["width"]["x"])

    # NaN-heavy history: fewer than 4 finite trials -> clean 400
    exp2 = Experiment("nanex", ledger, space=build_space({"x": "uniform(0, 1)"}),
                      max_trials=30).configure()
    for i in range(6):
        completed(exp2, {"x": i / 7}, float("nan") if i > 1 else 0.5)
    for fn in (webapi.importance_series, webapi.pdp_series):
        code, payload = fn(ledger, "nanex", device="cpu")
        assert code == 400 and "finite" in payload["error"]


def test_make_server_resolves_cuda_and_raises_without_it(monkeypatch):
    """The surrogate's device is resolved once, at construction: ``cuda``
    unless the caller passes another, and no server without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(MemoryLedger())
    server = make_server(MemoryLedger(), device="cpu")
    try:
        assert server.RequestHandlerClass.device == torch.device("cpu")
    finally:
        server.server_close()


# -- one ledger written through the reference, served by both packages ------

ROUTES = ("", "healthz", "experiments", "experiments/ghost", "nope",
          "experiments/{n}/nope", "experiments/{n}/trials?status=bogus")
PER_EXPERIMENT = ("", "/trials", "/trials?status=completed", "/trials?status=new",
                  "/regret", "/lcurves", "/parallel", "/pareto", "/workers",
                  "/importance", "/pdp")


def write_reference_ledger(root: str) -> str:
    """A file ledger at ``root`` written through the reference: a 2-d
    Rosenbrock run with a NaN trial, a fidelity run with lineages, a
    two-objective run and an experiment with too few trials for the
    surrogate."""
    from metaopt_tpu.ledger import Experiment as RefExperiment
    from metaopt_tpu.ledger.backends import make_ledger as ref_make_ledger
    from metaopt_tpu.space import build_space as ref_build_space

    ledger = ref_make_ledger({"type": "file", "path": root})
    rng = np.random.default_rng(11)

    def run(name, space, points, results, workers=("w0", "w1")):
        exp = RefExperiment(name, ledger, space=ref_build_space(space),
                            max_trials=40).configure()
        for i, (p, r) in enumerate(zip(points, results)):
            t = exp.make_trial(p)
            exp.register_trials([t])
            got = exp.reserve_trial(workers[i % len(workers)])
            exp.push_results(got, r)
        return exp

    def obj(v):
        return [{"name": "o", "type": "objective", "value": v}]

    pts = [{"x": float(a), "y": float(b)} for a, b in rng.uniform(-5, 10, (20, 2))]
    vals = [(1 - p["x"]) ** 2 + 100 * (p["y"] - p["x"] ** 2) ** 2 for p in pts]
    vals[4] = float("nan")
    exp = run("rosen", {"x": "uniform(-5, 10)", "y": "uniform(-5, 10)"}, pts,
              [obj(v) for v in vals])
    exp.register_trials([exp.make_trial({"x": 0.5, "y": 0.5})])   # one 'new'
    fpts = [{"lr": float(lr), "epochs": e}
            for lr in 10 ** -rng.uniform(1, 4, 4) for e in (1, 2, 4)]
    run("fid", {"lr": "loguniform(1e-4, 1e-1)", "epochs": "fidelity(1, 4, base=2)"},
        fpts, [obj(math.log10(p["lr"]) ** 2 / p["epochs"]) for p in fpts])
    mpts = [{"x": float(a), "y": float(b)} for a, b in rng.random((16, 2))]
    run("mo", {"x": "uniform(0, 1)", "y": "uniform(0, 1)"}, mpts,
        [[{"name": "f1", "type": "objective", "value": p["x"]},
          {"name": "f2", "type": "objective",
           "value": (1 + 9 * p["y"]) * (1 - math.sqrt(p["x"] / (1 + 9 * p["y"])))}]
         for p in mpts])
    run("few", {"x": "uniform(0, 1)"}, [{"x": 0.1}, {"x": 0.2}], [obj(1.0), obj(2.0)])
    return root


@pytest.fixture(scope="module")
def ref_ledger_dir(tmp_path_factory):
    return write_reference_ledger(str(tmp_path_factory.mktemp("webapi_interop") / "ledger"))


def both_servers(root):
    from metaopt_tpu.io.webapi import make_server as ref_make_server
    from metaopt_tpu.ledger.backends import make_ledger as ref_make_ledger

    return (Served(ref_make_ledger({"type": "file", "path": root}), make=ref_make_server),
            Served(make_ledger({"type": "file", "path": root}), device="cpu"))


def without_ages(payload):
    """/workers' ``last_seen_age_s`` is the age at the request's time."""
    if isinstance(payload, list):
        return [{k: v for k, v in r.items() if k != "last_seen_age_s"}
                if isinstance(r, dict) else r for r in payload]
    return payload


def assert_close(a, b, path="", tol=TOL):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_close(a[k], b[k], f"{path}/{k}", tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]", tol)
    elif isinstance(a, float) and not isinstance(b, bool):
        assert abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_every_route_equals_the_reference_on_its_own_ledger(ref_ledger_dir):
    ref, port = both_servers(ref_ledger_dir)
    ledger = make_ledger({"type": "file", "path": ref_ledger_dir})
    seen_codes = set()
    with ref as ref_url, port as port_url:
        paths = [r.replace("{n}", "rosen") for r in ROUTES]
        paths += [f"experiments/{n}{tail}" for n in ("rosen", "fid", "mo", "few")
                  for tail in PER_EXPERIMENT]
        for path in paths:
            want = get_any(f"{ref_url}/{path}")
            got = get_any(f"{port_url}/{path}")
            seen_codes.add(got[0])
            assert got[0] == want[0], path
            if path.endswith("/pdp") and got[0] == 200:
                (_, _, y), _ = webapi._surrogate_inputs(ledger, path.split("/")[1])
                assert_close(got[1], want[1], path, PDP_TOL * float(y.std() + 1e-8))
            elif path.endswith("/importance") and got[0] == 200:
                assert_close(got[1], want[1], path)
            else:
                assert without_ages(got[1]) == without_ages(want[1]), path
        with urllib.request.urlopen(f"{ref_url}/dashboard") as a, \
                urllib.request.urlopen(f"{port_url}/dashboard") as b:
            assert a.headers["Content-Type"] == b.headers["Content-Type"]
            assert a.read() == b.read()
    assert seen_codes == {200, 400, 404}


def test_the_native_engine_serves_the_same_json(tmp_path, ref_ledger_dir):
    """The port's server over its native engine (loaded from the
    reference's archive by ``db load``) answers as over the file ledger."""
    from metaopt_tpu_torch.cli import main
    from metaopt_tpu_torch.ledger.backends import ledger_from_spec
    from metaopt_tpu_torch.ledger.native import NativeFileLedger

    dump = tmp_path / "dump.json"
    assert main(["db", "dump", "--ledger", f"file:{ref_ledger_dir}", "-o", str(dump)]) == 0
    bare = str(tmp_path / "native")
    assert main(["db", "load", "--ledger", bare, "--file", str(dump)]) == 0
    native = ledger_from_spec(bare)
    assert isinstance(native, NativeFileLedger)
    file_led = make_ledger({"type": "file", "path": ref_ledger_dir})
    for name in ("rosen", "fid", "mo"):
        assert webapi.regret_series(native, name) == webapi.regret_series(file_led, name)
        assert webapi.lcurve_series(native, name) == webapi.lcurve_series(file_led, name)
        assert webapi.pareto_series(native, name) == webapi.pareto_series(file_led, name)
        assert (webapi.importance_series(native, name, "cpu")
                == webapi.importance_series(file_led, name, "cpu"))


# -- /pareto: the reference's multi-objective cases ---------------------------

def mo_ledger(tmp_path, name, vectors):
    ledger = make_ledger({"type": "file", "path": str(tmp_path / "ledger")})
    ledger.create_experiment({"name": name, "space": {}, "version": 1,
                              "algorithm": {"random": {}}})
    for i, objs in enumerate(vectors):
        t = Trial(params={"x": float(i)}, experiment=name)
        t.transition("reserved")
        t.attach_results([{"name": f"o{j}", "type": "objective", "value": v}
                          for j, v in enumerate(objs)])
        t.transition("completed")
        ledger.register(t)
    return ledger


def test_pareto_route_excludes_short_vectors_not_truncates(tmp_path):
    # a 3-objective run with one 2-vector straggler: the straggler is
    # EXCLUDED (matching motpe), not used to truncate everyone to 2-D;
    # b is nondominated ONLY via the 3rd objective
    ledger = mo_ledger(tmp_path, "m3", [[1.0, 1.0, 5.0], [1.0, 1.0, 1.0], [2.0, 2.0]])
    code, payload = webapi.pareto_series(ledger, "m3")
    assert code == 200
    assert payload["n_objectives"] == 3 and payload["trials"] == 2
    fronts = [r["objectives"] for r in payload["front"]]
    assert [1.0, 1.0, 1.0] in fronts
    assert payload["dominated"] == [[1.0, 1.0, 5.0]]


def test_pareto_route_modal_length_beats_stray_long_vector(tmp_path):
    # one double-reporting trial with a 3-vector must not redefine a
    # 2-objective run's dimensionality (and so evict every 2-vector)
    ledger = mo_ledger(tmp_path, "m2",
                       [[1.0, 2.0], [2.0, 1.0], [3.0, 3.0], [0.5, 0.5, 0.5]])
    code, payload = webapi.pareto_series(ledger, "m2")
    assert code == 200
    assert payload["n_objectives"] == 2  # modal length, not max
    assert payload["trials"] == 4        # the 3-vector ranks truncated
    assert [r["objectives"] for r in payload["front"]] == [[0.5, 0.5]]


def test_pareto_route_rejects_single_objective_runs(tmp_path):
    ledger = mo_ledger(tmp_path, "single", [[1.0], [2.0], [0.5]])
    code, payload = webapi.pareto_series(ledger, "single")
    assert code == 400
    assert "single objective" in payload["error"]
    with Served(ledger, device="cpu") as url:
        assert get_any(f"{url}/experiments/single/pareto") == (code, payload)
