"""``plot`` and ``web`` through the port's CLI against the reference's.

One ledger directory written through the reference (see
``test_torch_webapi.write_reference_ledger``): a Rosenbrock run with a
NaN trial, a fidelity run, a two-objective run and an experiment with
two trials. Each ``plot`` kind on each experiment, ASCII and ``--json``,
goes through both CLIs in this process: the exit code, the ASCII
rendering and the JSON of the kinds that read the ledger only are equal
byte for byte. The ``importance`` and ``pdp`` JSON are held to
``test_torch_webapi``'s bounds; their ASCII is compared byte for byte on
one payload (the reference's, handed to both renderers), because a
rendering prints its numbers to four digits: ``pdp`` on the Rosenbrock
run prints its curve's minimum as 15.21 where the reference prints 26.73,
5e-5 of the objective's spread apart (measured), inside the bound. The
surrogate's device comes from the config file's ``surrogate.device``. The reference's ``plot`` contracts
(``tests/unit/test_cli_info.py``, ``tests/functional/
test_round3_features.py``, ``tests/functional/test_multiobjective.py``)
are restated, and a ``web`` process prints its listening line and
answers ``/healthz`` and ``/importance`` on the CPU.
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.io import webapi
from metaopt_tpu_torch.ledger.backends import make_ledger
from test_torch_webapi import PDP_TOL, TOL, assert_close, write_reference_ledger

REPO = Path(__file__).resolve().parents[1]
KINDS = ("regret", "lcurve", "parallel", "importance", "pdp", "pareto")
NAMES = ("rosen", "fid", "mo", "few")


@pytest.fixture(scope="module")
def led(tmp_path_factory):
    root = tmp_path_factory.mktemp("plot_cli")
    path = write_reference_ledger(str(root / "ledger"))
    cfg = root / "cpu.json"
    cfg.write_text(json.dumps({"surrogate": {"device": "cpu"}}))
    return f"file:{path}", str(cfg)


def run(cli, argv, capsys):
    """(exit code, stdout) of one in-process CLI call; SystemExit's message
    counts as its output."""
    try:
        rc = cli(argv)
    except SystemExit as done:
        rc, msg = 2, str(done.code)
        return rc, capsys.readouterr().out + msg
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("as_json", [False, True], ids=["ascii", "json"])
@pytest.mark.parametrize("kind", KINDS)
def test_plot_equals_the_reference_cli(led, kind, as_json, capsys, monkeypatch):
    from metaopt_tpu.io import webapi as ref_webapi
    from metaopt_tpu.ledger.backends import make_ledger as ref_make_ledger

    spec, cfg = led
    surrogate = kind in ("importance", "pdp")
    for name in NAMES:
        argv = ["plot", kind, "-n", name, "--ledger", spec] + (["--json"] if as_json else [])
        want = run(ref_main, argv, capsys)
        if surrogate and not as_json:
            # one payload, the reference's, through both renderers
            series = f"{kind}_series"
            payload = getattr(ref_webapi, series)(
                ref_make_ledger({"type": "file", "path": spec[len("file:"):]}), name)
            monkeypatch.setattr(webapi, series, lambda *a: payload)
        got = run(main, argv + ["--config", cfg], capsys)
        assert got[0] == want[0], (kind, name, got, want)
        if as_json and surrogate and got[0] == 0:
            tol = TOL
            if kind == "pdp":
                ledger = make_ledger({"type": "file", "path": spec[len("file:"):]})
                (_, _, y), _ = webapi._surrogate_inputs(ledger, name)
                tol = PDP_TOL * float(y.std() + 1e-8)
            assert_close(json.loads(got[1]), json.loads(want[1]), f"{kind} {name}", tol)
        else:
            assert got[1] == want[1], (kind, name)


def test_plot_regret_and_lcurve_contracts(led, capsys):
    spec, _ = led
    assert main(["plot", "regret", "-n", "rosen", "--ledger", spec, "--json"]) == 0
    bests = [p["best"] for p in json.loads(capsys.readouterr().out)["regret"]]
    assert bests == sorted(bests, reverse=True)   # regret never worsens
    assert main(["plot", "regret", "-n", "rosen", "--ledger", spec]) == 0
    out = capsys.readouterr().out
    assert "final best:" in out and "*" in out
    assert main(["plot", "lcurve", "-n", "fid", "--ledger", spec, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["fidelity"] == "epochs" and len(doc["lcurves"]) == 4
    for pts in doc["lcurves"].values():
        assert [p["budget"] for p in pts] == [1, 2, 4]
    with pytest.raises(SystemExit, match="no fidelity dimension"):
        main(["plot", "lcurve", "-n", "rosen", "--ledger", spec])
    with pytest.raises(SystemExit, match="no such experiment"):
        main(["plot", "regret", "-n", "ghost", "--ledger", spec])


def test_plot_parallel_and_pareto_contracts(led, capsys):
    spec, _ = led
    assert main(["plot", "parallel", "-n", "rosen", "--ledger", spec, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["dimensions"] == ["x", "y"] and len(doc["trials"]) == 20
    assert main(["plot", "parallel", "-n", "rosen", "--ledger", spec]) == 0
    assert capsys.readouterr().out.splitlines()[0].startswith("x")  # table header
    assert main(["plot", "pareto", "-n", "mo", "--ledger", spec, "--json"]) == 0
    front = [r["objectives"] for r in json.loads(capsys.readouterr().out)["front"]]
    assert front
    for a in front:
        assert not any(all(x <= y for x, y in zip(b, a)) and b != a for b in front)
    assert main(["plot", "pareto", "-n", "mo", "--ledger", spec]) == 0
    assert f"{len(front)} nondominated of 16" in capsys.readouterr().out
    assert main(["plot", "pareto", "-n", "rosen", "--ledger", spec]) == 1
    assert "single objective" in capsys.readouterr().out


def test_plot_surrogates_without_cuda_raise_unless_given_cpu(led, capsys, monkeypatch):
    import torch

    spec, cfg = led
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("importance", "pdp"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["plot", kind, "-n", "rosen", "--ledger", spec])
        assert main(["plot", kind, "-n", "rosen", "--ledger", spec, "--config", cfg]) == 0
    capsys.readouterr()


def spawn_web(args, env):
    return subprocess.Popen([sys.executable, "-m", "metaopt_tpu_torch", "web"] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=REPO)


def web_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_web_process_serves_importance_on_the_cpu(led):
    spec, cfg = led
    proc = spawn_web(["--ledger", spec, "--config", cfg, "--port", "0"], web_env())
    try:
        line = proc.stdout.readline()
        assert line.startswith("webapi listening on http://127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        url = line.split()[-1]
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(f"{url}/experiments/rosen/importance", timeout=60) as r:
            served = json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    ledger = make_ledger({"type": "file", "path": spec[len("file:"):]})
    assert served == webapi.importance_series(ledger, "rosen", "cpu")[1]


def test_web_without_cuda_refuses_to_start_unless_given_cpu(led):
    spec, _ = led
    proc = spawn_web(["--ledger", spec, "--port", "0"], web_env())
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in err
    assert "listening" not in out
