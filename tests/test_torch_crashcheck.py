"""``crashcheck`` on the port: the MTP checkers against the reference's, the
recording journal, and the five crash suites over the port's durable paths.

* **Fixtures.** ``tests/torch_fixtures/crashcheck/`` is a copy of the
  reference's ``tests/unit/crashcheck_fixtures/``: both packages' MTP001-004
  report the same rule ids, lines and fingerprints on every file, and the
  port's per-rule expectations are the reference's
  (``tests/unit/test_crashcheck.py``), restated.
* **The journal.** ``utils/fsjournal.py``'s recording journal enumerates
  every byte cut, a recorded WAL compaction carries the ``wal_compacted``
  mark, and a mixed v1/v2 WAL tail recovers at every cut.
* **The clean gate.** The static checks over ``metaopt_tpu_torch`` and the
  five suites (``wal``, ``snapshot``, ``archive``, ``evict``,
  ``handoff``) certify more than 500 crash states with no finding; the
  crash baseline is empty.
* **MTP004 counts the port's tests only.** The tests tree also holds the
  reference's tests: a barrier that only a reference test names is
  reported.
"""

import json
import os
import textwrap

import pytest

from metaopt_tpu.analysis import crashcheck as ref_crash
from metaopt_tpu.analysis import registry as ref_registry
from metaopt_tpu.analysis.core import load_paths as ref_load
from metaopt_tpu_torch.analysis.core import load_paths
from metaopt_tpu_torch.analysis.crashcheck import SUITES, check_crash, run_suite
from metaopt_tpu_torch.analysis.registry import CrashConfig, default_crash_config
from metaopt_tpu_torch.analysis.runner import (
    DEFAULT_CRASH_BASELINE, crashcheck_main, diff_baseline, load_baseline, run_crashcheck)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "crashcheck")
CRASH_FIXTURES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))

#: the fixture-local twin of protocol.DURABLE_SEQUENCES' "evict" entry
_EVICT_SEQ = {
    "evict": {
        "function": "Server.evict",
        "steps": ["publish:.tmp", "wal.append:evict", "wal.sync", "call:delete_experiment"],
        "optional": [3],
    },
}


#: the fixtures are the reference's files and name the reference's seam
REF_SEAM = "metaopt_tpu.utils.fsjournal"


def _run(fname, **cfg_kw):
    mods = load_paths([os.path.join(FIXTURES, fname)], root=FIXTURES)
    cfg = CrashConfig(**cfg_kw) if cfg_kw else default_crash_config()
    cfg.seam_module = REF_SEAM
    return check_crash(mods, cfg)


def _key(findings):
    return sorted((f.rule, f.line, f.fingerprint()) for f in findings)


# -- fixtures: the same findings from both packages ------------------------
@pytest.mark.parametrize("name", CRASH_FIXTURES)
def test_fixture_findings_equal_the_reference(name):
    seqs = _EVICT_SEQ if "sequence" in name else None
    want = ref_crash.check_crash(
        ref_load([os.path.join(FIXTURES, name)], root=FIXTURES),
        ref_registry.CrashConfig(durable_sequences=seqs))
    got = check_crash(load_paths([os.path.join(FIXTURES, name)], root=FIXTURES),
                      CrashConfig(durable_sequences=seqs, seam_module=REF_SEAM))
    assert _key(got) == _key(want)
    assert ("bad_" in name) == bool(got)


def test_the_port_seam_is_the_default(tmp_path):
    """``good_publish.py`` through the port's own seam is clean under the
    port's declarations, and is not through another seam."""
    with open(os.path.join(FIXTURES, "good_publish.py")) as f:
        src = f.read().replace("metaopt_tpu.utils", "metaopt_tpu_torch.utils")
    (tmp_path / "good_publish.py").write_text(src)
    mods = load_paths([str(tmp_path / "good_publish.py")], root=str(tmp_path))
    assert check_crash(mods, default_crash_config()) == []
    assert {f.rule for f in check_crash(mods, CrashConfig(seam_module=REF_SEAM))} == {"MTP001"}


def test_publish_without_fsync_rediscovered():
    findings = _run("bad_publish_no_fsync.py")
    assert {f.rule for f in findings} == {"MTP001"}
    assert sorted(f.detail.split("|", 1)[0] for f in findings) == ["nodirfsync", "nofsync"]


def test_pragma_suppresses_with_doctrine(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""\
        import os

        def publish(path, text):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)  # mtpu: lint-ok MTP001 rebuildable
    """))
    mods = load_paths([str(tmp_path / "mod.py")], root=str(tmp_path))
    assert check_crash(mods, default_crash_config()) == []


def test_ack_before_sync_rediscovered_and_scoped():
    findings = _run("bad_ack_before_sync.py")
    assert [f.rule for f in findings] == ["MTP002"]
    assert findings[0].symbol == "CoordServer._serve_conn._sender"
    assert _run("bad_ack_before_sync.py", ack_publishers={"Nowhere._nothing"}) == []


def test_sequence_reorder_and_skip_rediscovered():
    findings = _run("bad_sequence_reorder.py", durable_sequences=_EVICT_SEQ)
    assert [f.rule for f in findings] == ["MTP003"]
    assert "wal.append:evict" in findings[0].message
    assert [f.rule for f in _run("bad_sequence_skip.py", durable_sequences=_EVICT_SEQ)] \
        == ["MTP003"]


# -- MTP004: the port's tests arm the port's barriers ----------------------
def _barrier_pkg(tmp_path, kind):
    pkg = tmp_path / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(f"def f():\n    if faults.fire('{kind}'):\n        pass\n")
    tests = tmp_path / "tests"
    (tests / "unit").mkdir(parents=True)
    (tests / "unit" / "test_reference.py").write_text(f"ARM = '{kind}:1'\n")
    (tests / "test_torch_x.py").write_text("def test_ok():\n    pass\n")
    return load_paths([str(pkg)], root=str(tmp_path)), str(tests)


def test_a_barrier_only_a_reference_test_names_is_reported(tmp_path):
    mods, tests = _barrier_pkg(tmp_path, "only_in_reference")
    findings = check_crash(mods, default_crash_config(), tests_dir=tests)
    assert [(f.rule, f.detail) for f in findings] == [("MTP004", "only_in_reference")]
    # the reference's scope (every file of the tree) would count it armed
    assert check_crash(mods, CrashConfig(), tests_dir=tests) == []


def test_a_port_test_or_fixture_arms_a_barrier(tmp_path):
    mods, tests = _barrier_pkg(tmp_path, "armed_here")
    (tmp_path / "tests" / "test_torch_x.py").write_text("ARM = 'armed_here:1'\n")
    assert check_crash(mods, default_crash_config(), tests_dir=tests) == []
    mods, tests = _barrier_pkg(tmp_path / "b", "armed_by_fixture")
    fixture = tmp_path / "b" / "tests" / "torch_fixtures"
    fixture.mkdir()
    (fixture / "chaos.py").write_text("SPEC = 'armed_by_fixture:2'\n")
    assert check_crash(mods, default_crash_config(), tests_dir=tests) == []


def test_the_port_barriers_need_the_port_tests():
    """Without the port's tests (here: a tests directory holding only the
    fixtures) the port's chaos barriers are dead; with them, the clean gate
    below finds none."""
    mods = load_paths([os.path.join(REPO, "metaopt_tpu_torch")], root=REPO)
    kinds = {f.detail for f in check_crash(mods, default_crash_config(),
                                           tests_dir=os.path.join(FIXTURES))}
    assert {"torn_wal_tail", "crash_evict", "crash_handoff_dest"} <= kinds


# -- the recording journal ---------------------------------------------------
def test_every_byte_cut_enumerated(tmp_path):
    from metaopt_tpu_torch.utils import fsjournal as fsj

    root = str(tmp_path)
    with fsj.recording(root) as journal:
        fsj.write_file(os.path.join(root, "a"), b"abcdef")
    states = list(fsj.enumerate_crash_states(journal.snapshot(), torn_cuts=None))
    cuts = [s for s in states if "+" in s[0]]
    assert sorted(s[2]["a"] for s in cuts) == [b"a", b"ab", b"abc", b"abcd", b"abcde"]
    assert [s[0] for s in states if "+" not in s[0]] == ["@0", "@1", "@2"]


def test_the_journal_equals_the_reference_journal(tmp_path):
    """The same effects recorded through both seams give the same trace and
    the same crash states."""
    from metaopt_tpu.utils import fsjournal as ref_fsj
    from metaopt_tpu_torch.utils import fsjournal as fsj

    traces = []
    for mod, sub in ((ref_fsj, "r"), (fsj, "p")):
        root = tmp_path / sub
        root.mkdir()
        with mod.recording(str(root)) as journal:
            mod.write_file(str(root / "x.tmp"), b"12345")
            mod.replace(str(root / "x.tmp"), str(root / "x"))
            mod.fsync_dir(str(root / "x"))
            with open(root / "log", "ab") as f:
                mod.append(f, str(root / "log"), b"abc")
            mod.mark("acked", seq=1)
            mod.truncate(str(root / "log"), 2)
            mod.unlink(str(root / "x"))
        traces.append(journal.snapshot())
    assert traces[0] == traces[1]
    assert list(ref_fsj.enumerate_crash_states(traces[0])) == \
        list(fsj.enumerate_crash_states(traces[1]))


def test_a_recorded_compaction_carries_the_wal_compacted_mark(tmp_path):
    from metaopt_tpu_torch.coord.wal import WriteAheadLog, read_records
    from metaopt_tpu_torch.utils import fsjournal as fsj

    path = str(tmp_path / "log.wal")
    with fsj.recording(str(tmp_path)) as journal:
        wal = WriteAheadLog(path, group_window_s=0.0).open()
        seqs = [wal.append({"op": "set_signal", "experiment": "e", "trial_id": f"t{i}",
                            "signal": "stop"}) for i in range(4)]
        wal.sync(seqs[-1])
        wal.compact(seqs[1])
        wal.close()
    events = journal.snapshot()
    marks = [i for i, e in enumerate(events) if e["kind"] == "mark"]
    assert [events[i] for i in marks] == [{"kind": "mark", "label": "wal_compacted",
                                           "upto": seqs[1]}]
    # after the compacted tmp is written and before the rename publishes it
    assert events[marks[0] - 1]["kind"] == "fsync"
    assert events[marks[0] + 1]["kind"] == "replace"
    assert [r["seq"] for r in read_records(path)[0]] == seqs[2:]


def test_mixed_v1_v2_torn_tail_through_the_seam(tmp_path):
    from metaopt_tpu_torch.coord.wal import WriteAheadLog, read_records
    from metaopt_tpu_torch.utils import fsjournal as fsj

    root = str(tmp_path / "w")
    os.makedirs(root)
    path = os.path.join(root, "log.wal")
    with fsj.recording(root) as journal:
        wal = WriteAheadLog(path, group_window_s=0.0).open()
        acked = []
        for i in range(2):
            seq = wal.append({"op": "set_signal", "experiment": "e", "trial_id": f"t{i}",
                              "signal": "stop"})
            wal.sync(seq)
            acked.append(seq)
        seq = wal.append({"op": "x", "n": 1 << 70})  # a v1 frame mid-log
        wal.sync(seq)
        acked.append(seq)
        wal.close()
        events = journal.snapshot()
    for label, upto, files in fsj.enumerate_crash_states(events, torn_cuts=None):
        if "log.wal" not in files:
            continue
        fsj.write_tree(files, root)
        recs, _torn = read_records(path, truncate_torn=True)
        fsyncs = sum(1 for e in events[:upto] if e["kind"] == "fsync")
        assert set(acked[:fsyncs]) <= {r.get("seq") for r in recs}, label
        recs2, torn2 = read_records(path, truncate_torn=True)
        assert torn2 == 0 and [r.get("seq") for r in recs2] == [r.get("seq") for r in recs]


# -- the clean gate ----------------------------------------------------------
def test_the_crash_suites_certify_the_port():
    findings, stats = run_crashcheck(list(SUITES))
    new = diff_baseline(findings, load_baseline(DEFAULT_CRASH_BASELINE))
    assert not new, "\n".join(f.render() for f in new)
    assert stats["crash_states"] > 500
    assert set(SUITES) == {"wal", "snapshot", "archive", "evict", "handoff"}
    for name in SUITES:
        assert stats[f"suite_{name}_s"] >= 0.0


def test_the_wal_suite_enumerates_beyond_prefixes():
    findings, stats = run_suite("wal")
    assert findings == []
    assert stats["crash_states"] > 10 * stats["events"]


def test_crashcheck_cli_exit_code(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert crashcheck_main(["--suite", "handoff", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["suites"] == ["handoff"]
    assert doc["stats"]["crash_states"] > 0


def test_dynamic_findings_never_in_the_baseline():
    assert [fp for fp in load_baseline(DEFAULT_CRASH_BASELINE) if fp.startswith("MTP1")] == []
