"""``lint`` and ``analyze`` on the port: the checkers against the reference's,
and the port's own clean gate.

* **Fixtures.** ``tests/torch_fixtures/lint/`` is a copy of the reference's
  ``tests/unit/lint_fixtures/``. Both packages' lock (MTL001-004) and
  durability (MTD001-004) checkers run on every file with the same
  declarations and must report the same rule ids, lines and fingerprints;
  the port's per-family expectations are the reference's
  (``tests/unit/test_lint_checkers.py``), restated.
* **The reference's tree.** The port's static checkers over ``metaopt_tpu/``
  with the reference's own declarations report exactly what the
  reference's checkers report there, family by family (MTL, MTD, MTP and
  MTR001).
* **The registries.** ``coord/protocol.py``'s journaling registries and
  durable sequences equal the reference's.
* **MTJ003 in PyTorch** (``analysis/hotpath.py``): a fixture fires on each
  call of the host-sync set and its clean twin stays silent.
* **The clean gate.** ``lint`` and ``analyze`` over ``metaopt_tpu_torch``
  exit 0 against the port's baselines, which are empty.

Fixtures are parsed, never imported.
"""

import dataclasses
import json
import os
from collections import Counter

import pytest

from metaopt_tpu.analysis import crashcheck as ref_crash
from metaopt_tpu.analysis import dynrace as ref_dynrace
from metaopt_tpu.analysis import registry as ref_registry
from metaopt_tpu.analysis.core import load_paths as ref_load
from metaopt_tpu.analysis.durability import check_durability as ref_durability
from metaopt_tpu.analysis.locks import LockChecker as RefLockChecker
from metaopt_tpu.analysis.locks import check_locks as ref_locks
from metaopt_tpu_torch.analysis import crashcheck, dynrace, registry
from metaopt_tpu_torch.analysis.core import load_paths
from metaopt_tpu_torch.analysis.durability import check_durability
from metaopt_tpu_torch.analysis.hotpath import check_hotpath
from metaopt_tpu_torch.analysis.locks import LockChecker, check_locks
from metaopt_tpu_torch.analysis.registry import LintConfig, default_config
from metaopt_tpu_torch.analysis.runner import (
    DEFAULT_BASELINE, DEFAULT_CRASH_BASELINE, DEFAULT_RACE_BASELINE, analyze_main,
    diff_baseline, lint_main, load_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "lint")
HOT = os.path.join(REPO, "tests", "torch_fixtures", "hotpath")
LINT_FIXTURES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _fixture_cfg(cls):
    """Declarations for the fixture classes (the reference test's), built
    in either package's LintConfig."""
    cfg = cls()
    cfg.lock_attrs = {
        "Inverted": {"_a_lock", "_b_lock"},
        "Journal": {"_buf_lock"},
        "ReplyCache": {"_replies_lock"},
        "Orderly": {"_a_lock", "_b_lock", "_replies_lock"},
    }
    cfg.no_block_locks = {"Journal._buf_lock", "Orderly._a_lock", "Orderly._b_lock",
                          "Orderly._replies_lock"}
    cfg.guarded_attrs = {
        "ReplyCache": {"_replies": "ReplyCache._replies_lock"},
        "Orderly": {"_replies": "Orderly._replies_lock"},
    }
    cfg.journaled_ops = frozenset({"register"})
    return cfg


def _mods(name):
    return load_paths([os.path.join(FIXTURES, name)], root=FIXTURES)


def _key(findings):
    return sorted((f.rule, f.line, f.fingerprint()) for f in findings)


def _as_port(obj, cls):
    """The reference's declarations as the port's dataclass (fields both
    have; the reference's JAX-only knobs have no port field)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
                  if f.name in names})


# -- fixtures: the same findings from both packages ------------------------
@pytest.mark.parametrize("name", LINT_FIXTURES)
@pytest.mark.parametrize("family", ["locks", "durability"])
def test_fixture_findings_equal_the_reference(name, family):
    ref_mods = ref_load([os.path.join(FIXTURES, name)], root=FIXTURES)
    if family == "locks":
        want = ref_locks(ref_mods, _fixture_cfg(ref_registry.LintConfig))
        got = check_locks(_mods(name), _fixture_cfg(LintConfig))
    else:
        want = ref_durability(ref_mods, _fixture_cfg(ref_registry.LintConfig))
        got = check_durability(_mods(name), _fixture_cfg(LintConfig))
    assert _key(got) == _key(want)


def test_lock_inversion_fires():
    fs = check_locks(_mods("bad_lock_inversion.py"), _fixture_cfg(LintConfig))
    assert {f.detail for f in fs if f.rule == "MTL001"} == {
        "Inverted._a_lock->Inverted._b_lock", "Inverted._b_lock->Inverted._a_lock"}


def test_super_inversion_fires_on_inherited_lock():
    fs = [f for f in check_locks(_mods("bad_super_inversion.py"), _fixture_cfg(LintConfig))
          if f.rule == "MTL001"]
    assert {f.detail for f in fs} == {"BaseAlgo._a_lock->BaseAlgo._b_lock",
                                      "BaseAlgo._b_lock->BaseAlgo._a_lock"}
    assert any(f.symbol == "SubAlgo.snapshot_wrapped" for f in fs)


def test_blocking_under_lock_fires_direct_and_transitive():
    fs = check_locks(_mods("bad_blocking_under_lock.py"), _fixture_cfg(LintConfig))
    syms = {f.symbol for f in fs if f.rule == "MTL002"}
    assert {"Journal.flush_holding_lock", "Journal.nap_holding_lock",
            "Journal.indirect"} <= syms


def test_guarded_write_outside_guard_fires():
    fs = check_locks(_mods("bad_guarded_write.py"), _fixture_cfg(LintConfig))
    syms = {f.symbol for f in fs if f.rule == "MTL003"}
    assert {"ReplyCache.put_unguarded", "ReplyCache.evict_unguarded"} <= syms
    assert not {"ReplyCache.put_guarded", "ReplyCache.__init__"} & syms


def test_unjournaled_op_and_wire_drift_fire():
    fs = check_durability(_mods("bad_unjournaled_op.py"), _fixture_cfg(LintConfig))
    assert {"MTD001", "MTD002"} <= {f.rule for f in fs}
    assert [f.detail for f in fs if f.rule == "MTD001"] == ["register"]
    fs = check_durability(_mods("bad_wire_opcode_drift.py"), _fixture_cfg(LintConfig))
    assert {f.detail for f in fs} == {"missing|register", "dup|2", "reserved|probe"}


@pytest.mark.parametrize("checker", [check_locks, check_durability, check_hotpath])
def test_clean_fixture_is_silent(checker):
    fs = checker(_mods("clean_module.py"), _fixture_cfg(LintConfig))
    assert fs == [], "\n".join(f.render() for f in fs)


# -- MTJ003, the PyTorch host-sync rule ------------------------------------
def test_host_sync_fires_on_every_pytorch_sync():
    fs = check_hotpath(load_paths([os.path.join(HOT, "bad_host_sync.py")], root=HOT),
                       LintConfig())
    assert all(f.rule == "MTJ003" for f in fs)
    assert [f.detail for f in fs if f.symbol == "readback"] == [
        "item", "cpu", "tolist", "numpy", "torch.cuda.synchronize", "float", "int",
        "bool", "np.asarray", "np.array"]
    assert [f.symbol for f in fs if f.symbol != "readback"] == ["Pool.eval"]


def test_host_sync_clean_twin_is_silent():
    mods = load_paths([os.path.join(HOT, "clean_host_sync.py")], root=HOT)
    assert check_hotpath(mods, LintConfig()) == []


def test_the_port_marks_its_four_hot_functions():
    mods = load_paths([os.path.join(REPO, "metaopt_tpu_torch")], root=REPO)
    hot = sorted(mod.qualname(fn) for mod in mods for fn, _ in mod.functions()
                 if mod.is_hotpath(fn))
    assert hot == ["BatchedExecutor._pool_eval", "ObservationBuffer._append_rows",
                   "blocked_softmax_xent", "ei_scores"]
    assert [f for f in check_hotpath(mods, default_config())] == []


# -- the reference's tree through both packages' checkers ------------------
@pytest.fixture(scope="module")
def reference_tree_findings():
    """Every static family over ``metaopt_tpu/`` with the reference's own
    declarations, through the reference's checkers and through the port's."""
    path = [os.path.join(REPO, "metaopt_tpu")]
    tests = os.path.join(REPO, "tests")
    rcfg, rrace = ref_registry.default_config(), ref_registry.default_race_config()
    rcrash = ref_registry.default_crash_config()
    rmods = ref_load(path, root=REPO)
    rchecker = RefLockChecker(rmods, rcfg)
    want = {"MTL": rchecker.run(), "MTD": ref_durability(rmods, rcfg),
            "MTP": ref_crash.check_crash(rmods, rcrash, tests_dir=tests),
            "MTR001": ref_dynrace.check_shared(rmods, rcfg, rrace, checker=rchecker)}
    pcfg = _as_port(rcfg, LintConfig)
    prace = _as_port(rrace, registry.RaceConfig)
    pcrash = _as_port(rcrash, registry.CrashConfig)
    pcrash.seam_module = "metaopt_tpu.utils.fsjournal"
    pmods = load_paths(path, root=REPO)
    pchecker = LockChecker(pmods, pcfg)
    got = {"MTL": pchecker.run(), "MTD": check_durability(pmods, pcfg),
           "MTP": crashcheck.check_crash(pmods, pcrash, tests_dir=tests),
           "MTR001": dynrace.check_shared(pmods, pcfg, prace, checker=pchecker)}
    return want, got


@pytest.mark.parametrize("family", ["MTL", "MTD", "MTP", "MTR001"])
def test_the_reference_tree_gives_the_reference_findings(reference_tree_findings, family):
    want, got = reference_tree_findings
    assert _key(got[family]) == _key(want[family])


def test_a_stricter_declaration_gives_the_same_findings_on_the_reference_tree():
    """The reference's tree is clean under its own declarations, so the
    parity above compares empty lists there. Declaring ``__init__`` an
    ordinary method (its writes now count) and every lock no-block makes
    both packages' lock and shared-attribute checkers report hundreds of
    findings on the same tree: they must be the same ones."""
    rcfg, rrace = ref_registry.default_config(), ref_registry.default_race_config()
    rcfg.init_methods = {"__new__"}
    rcfg.no_block_locks = {f"{c}.{a}" for c, attrs in rcfg.lock_attrs.items()
                           for a in attrs} | {ref_registry.EXP_LOCK}
    path = [os.path.join(REPO, "metaopt_tpu")]
    rmods = ref_load(path, root=REPO)
    rchecker = RefLockChecker(rmods, rcfg)
    want = rchecker.run() + ref_dynrace.check_shared(rmods, rcfg, rrace, checker=rchecker)
    pcfg = _as_port(rcfg, LintConfig)
    pmods = load_paths(path, root=REPO)
    pchecker = LockChecker(pmods, pcfg)
    got = pchecker.run() + dynrace.check_shared(
        pmods, pcfg, _as_port(rrace, registry.RaceConfig), checker=pchecker)
    assert len(want) > 100
    assert {f.rule for f in want} >= {"MTL002", "MTL003"}
    assert _key(got) == _key(want)


# -- the registries ---------------------------------------------------------
def test_the_protocol_registries_equal_the_reference():
    from metaopt_tpu.coord import protocol as ref_protocol
    from metaopt_tpu_torch.coord import protocol

    for name in ("JOURNALED_OPS", "REPLY_JOURNALED_OPS", "NESTED_JOURNALED_OPS",
                 "DURABLE_SEQUENCES", "WIRE_OPCODES"):
        assert getattr(protocol, name) == getattr(ref_protocol, name), name
    mods = load_paths([os.path.join(REPO, "metaopt_tpu_torch", "coord", "protocol.py")],
                      root=REPO)
    got = registry.registry_frozensets(mods[0], {"JOURNALED_OPS", "REPLY_JOURNALED_OPS",
                                                 "NESTED_JOURNALED_OPS"})
    assert got["JOURNALED_OPS"] == ref_protocol.JOURNALED_OPS
    assert crashcheck.load_durable_sequences(mods, registry.default_crash_config()) == \
        ref_protocol.DURABLE_SEQUENCES


def test_every_declared_lock_and_guarded_attribute_exists_in_the_port():
    """``default_config`` names the port's classes: each lock and guarded
    attribute is assigned on ``self`` somewhere in its class."""
    import ast

    assigned = {}
    for mod in load_paths([os.path.join(REPO, "metaopt_tpu_torch")], root=REPO):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                assigned.setdefault(node.name, set()).update(
                    n.attr for n in ast.walk(node)
                    if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
                    and isinstance(n.value, ast.Name) and n.value.id == "self")
    cfg = default_config()
    for cls, attrs in cfg.lock_attrs.items():
        assert attrs <= assigned[cls], (cls, attrs - assigned[cls])
    for cls, guards in cfg.guarded_attrs.items():
        assert set(guards) <= assigned[cls], (cls, set(guards) - assigned[cls])
        for guard in set(guards.values()) - {registry.EXP_LOCK}:
            owner, attr = guard.split(".")
            assert attr in cfg.lock_attrs[owner], guard
    assert set(registry.default_race_config().monitor_modules) <= set(assigned)


# -- the port's clean gate ---------------------------------------------------
def test_the_port_baselines_are_empty():
    for path in (DEFAULT_BASELINE, DEFAULT_RACE_BASELINE, DEFAULT_CRASH_BASELINE):
        with open(path) as f:
            assert json.load(f) == {"findings": [], "version": 1}, path


def test_lint_is_clean_over_the_port(monkeypatch, capsys):
    """Every finding counts: the port's baseline is empty, and ``lint``
    without it exits 0 too."""
    monkeypatch.chdir(REPO)
    assert lint_main(["metaopt_tpu_torch", "--no-baseline", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["total"] == 0
    assert load_baseline(DEFAULT_BASELINE) == Counter()


def test_analyze_json_reports_both_runtimes(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert analyze_main(["--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["total"] == 0
    assert doc["lint_runtime_s"] >= 0.0 and doc["crashcheck_runtime_s"] >= 0.0


def test_baseline_counts_cap_repeat_findings():
    """A grandfathered fingerprint covers only its captured count."""
    fs = check_locks(_mods("bad_lock_inversion.py"), _fixture_cfg(LintConfig))
    baseline = Counter(f.fingerprint() for f in fs)
    assert diff_baseline(fs, baseline) == []
    assert diff_baseline(fs + fs[:1], baseline) == fs[:1]
