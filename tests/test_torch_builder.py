"""The port's ``SpaceBuilder``/``CommandTemplate`` and layered config against
the JAX package's.

Parsing is host code with no randomness, so everything here is held to
exact equality: the space's configuration, the rendered argv, the
materialized config file's bytes, and the resolved config dict.
"""

import importlib
import json

import pytest
import yaml

from metaopt_tpu.space.builder import PriorSyntaxError as RefPriorSyntaxError
from metaopt_tpu.space.builder import SpaceBuilder as RefSpaceBuilder
from metaopt_tpu_torch.io import converters
from metaopt_tpu_torch.space import PriorSyntaxError, SpaceBuilder

# ``metaopt_tpu.io`` re-exports the function under the module's name
ref_rc = importlib.import_module("metaopt_tpu.io.resolve_config")
port_rc = importlib.import_module("metaopt_tpu_torch.io.resolve_config")

PARAMS = {"lr": 0.00123, "width": 256, "depth": 3, "dropout": 0.25,
          "act": "gelu", "x": -1.5, "wlr": 0.5, "steps": 8, "opt": "sgd"}

ARGV_CASES = {
    "dashes": ["train.py", "--lr~loguniform(1e-5, 1e-1)",
               "--width~uniform(64, 1024, discrete=True)", "--fixed=3"],
    "short-and-bare": ["t.py", "-x~uniform(-5, 10)", "depth~randint(1, 6)", "pos"],
    "choices-fidelity": ["t.py", "--act~choices(['relu', 'gelu'])",
                         "--steps~fidelity(2, 8, base=2)",
                         "--opt~choices({'adam': 0.7, 'sgd': 0.3})"],
}


def build_both(argv):
    ref_space, ref_tmpl = RefSpaceBuilder().build(argv)
    space, tmpl = SpaceBuilder().build(argv)
    return (ref_space, ref_tmpl), (space, tmpl)


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_argv_template_matches_reference(case):
    argv = ARGV_CASES[case]
    (ref_space, ref_tmpl), (space, tmpl) = build_both(argv)
    assert space.configuration == ref_space.configuration
    params = {k: PARAMS[k] for k in space.configuration}
    assert tmpl.format(params) == ref_tmpl.format(params)
    assert tmpl.param_names == ref_tmpl.param_names
    assert not tmpl.has_config and not ref_tmpl.has_config


def test_format_renders_dashed_slots_as_one_token():
    _, tmpl = SpaceBuilder().build(["t.py", "-x~uniform(-5, 10)",
                                    "--lr~loguniform(1e-4, 1)"])
    assert tmpl.format({"x": 2.5, "lr": 0.01}) == ["t.py", "-x=2.5", "--lr=0.01"]


def write_templates(tmp_path):
    nested = {"model": {"lr": "~loguniform(1e-5, 1e-1)",
                        "width": "width~uniform(64, 1024, discrete=True)"},
              "data": {"path": "/data", "batch": 32}}
    (tmp_path / "c.json").write_text(json.dumps(nested))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(nested))
    (tmp_path / "c.ini").write_text(
        "[opt]\nlr = lr~loguniform(1e-5, 1e-1)\nwlr = wlr~uniform(0, 1)\n"
        "note = see y~f(x)\n")
    return {ext: str(tmp_path / f"c.{ext}") for ext in ("json", "yaml", "ini")}


@pytest.mark.parametrize("ext", ["json", "yaml", "ini"])
def test_config_template_matches_reference(tmp_path, ext):
    path = write_templates(tmp_path)[ext]
    argv = ["train.py", path, "--dropout~uniform(0.0, 0.5)"]
    (ref_space, ref_tmpl), (space, tmpl) = build_both(argv)
    assert space.configuration == ref_space.configuration
    assert tmpl.has_config and tmpl.config_path == path
    params = {k: PARAMS[k] for k in space.configuration}
    out_ref = str(tmp_path / f"ref_out.{ext}")
    out = str(tmp_path / f"port_out.{ext}")
    assert tmpl.format(params, config_out=out) == \
        [a.replace(out_ref, out) for a in ref_tmpl.format(params, config_out=out_ref)]
    ref_tmpl.materialize_config(params, out_ref)
    tmpl.materialize_config(params, out)
    with open(out_ref, "rb") as f_ref, open(out, "rb") as f:
        assert f.read() == f_ref.read()


def test_two_config_templates_with_priors_is_an_error(tmp_path):
    paths = write_templates(tmp_path)
    argv = ["train.py", paths["json"], paths["yaml"]]
    with pytest.raises(RefPriorSyntaxError, match="two config templates"):
        RefSpaceBuilder().build(argv)
    with pytest.raises(PriorSyntaxError, match="two config templates"):
        SpaceBuilder().build(argv)


@pytest.mark.parametrize("token,raises", [
    ("--lr~loguniform(low=1e-5, high=__import__('os'))", True),   # not a literal
    ("--lr~nosuchprior(1, 2)", True),
    ("--n~normal(0, 1, discrete=True)", True),
    ("--lr~uniform(1e-3, 1e-1", False),   # no token: passes through as argv
])
def test_malformed_priors_raise_like_reference(token, raises):
    argv = ["t.py", token]
    if not raises:
        (ref_space, ref_tmpl), (space, tmpl) = build_both(argv)
        assert len(space) == len(ref_space) == 0 and tmpl.argv == ref_tmpl.argv
        return
    with pytest.raises(RefPriorSyntaxError) as ref_err:
        RefSpaceBuilder().build(argv)
    with pytest.raises(PriorSyntaxError) as err:
        SpaceBuilder().build(argv)
    assert str(err.value) == str(ref_err.value)


def test_yaml_converter_names_missing_module(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    path = tmp_path / "c.yaml"
    path.write_text("a: 1\n")
    with pytest.raises(ImportError, match="PyYAML"):
        converters.infer_converter(str(path)).parse(str(path))
    # a .json framework config still resolves without PyYAML
    cfg = tmp_path / "algo.json"
    cfg.write_text(json.dumps({"algorithm": {"tpe": {"seed": 0}}}))
    assert port_rc.resolve_config({}, str(cfg))["algorithm"] == {"tpe": {"seed": 0}}
    with pytest.raises(ImportError, match="yaml"):
        port_rc.resolve_config({}, str(path))


ENV_CASES = {
    "none": {},
    "name-and-budget": {"METAOPT_TPU_NAME": "from-env", "METAOPT_TPU_MAX_TRIALS": "7",
                        "METAOPT_TPU_POOL_SIZE": "2"},
    "ledger": {"METAOPT_TPU_LEDGER_TYPE": "file", "METAOPT_TPU_LEDGER_PATH": "/tmp/l",
               "METAOPT_TPU_COORD_PORT": "1234"},
}
FILE_CASES = {
    "none": None,
    "algo": {"algorithm": {"tpe": {"seed": 0, "n_initial_points": 10}}, "max_trials": 40},
    "nested": {"ledger": {"path": "/x"}, "coordinator": {"host": "h"}, "heartbeat_s": 5.0,
               "name": "from-file"},
}
ARG_CASES = {
    "none": {},
    "argv": {"name": "from-argv", "max_trials": 3, "pool_size": None},
}


@pytest.mark.parametrize("env", sorted(ENV_CASES))
@pytest.mark.parametrize("file", sorted(FILE_CASES))
@pytest.mark.parametrize("args", sorted(ARG_CASES))
def test_resolve_config_layers_match_reference(tmp_path, monkeypatch, env, file, args):
    for var in port_rc.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, val in ENV_CASES[env].items():
        monkeypatch.setenv(var, val)
    path = None
    if FILE_CASES[file] is not None:
        path = str(tmp_path / "cfg.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(FILE_CASES[file], f)
    got = port_rc.resolve_config(dict(ARG_CASES[args]), path)
    want = ref_rc.resolve_config(dict(ARG_CASES[args]), path)
    assert got == want
    assert port_rc.DEFAULTS == ref_rc.DEFAULTS and port_rc.ENV_VARS == ref_rc.ENV_VARS
    # precedence: argv > file > env > defaults
    if args == "argv":
        assert got["name"] == "from-argv"
    elif file == "nested":
        assert got["name"] == "from-file"
    elif env == "name-and-budget":
        assert got["name"] == "from-env"
