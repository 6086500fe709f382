"""``db`` through the port's CLI against the reference's.

``dump`` writes the same JSON from either package; ``load`` under each
``--resolve`` policy, ``set`` (experiment fields and a trial's status),
``release``, ``rm --force`` and ``compact`` leave equal ledgers and print
the same lines; ``db test`` passes on the memory, file and native
backends, and ``rm`` without ``--force`` refuses as the reference does.
"""

import json
import shutil

import pytest

from metaopt_tpu.cli import main as ref_main
from metaopt_tpu.ledger.backends import ledger_from_spec as ref_ledger_from_spec
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger.backends import ledger_from_spec
from test_torch_cli import QUAD, algo_config


def view(led, heartbeat=True):
    """Every experiment's document (minus its creation stamp and package
    version) and every trial document, of one ledger. The native engine
    prints heartbeats to the microsecond, so a view across engines drops
    them (``heartbeat=False``)."""
    out = {}
    for name in led.list_experiments():
        doc = dict(led.load_experiment(name))
        doc["metadata"] = {k: v for k, v in (doc.get("metadata") or {}).items()
                           if k not in ("datetime", "framework_version")}
        docs = [t.to_dict() for t in led.fetch(name)]
        if not heartbeat:
            for d in docs:
                d.pop("heartbeat")
        out[name] = (doc, sorted(json.dumps(d, sort_keys=True) for d in docs))
    return out


@pytest.fixture
def seeded(tmp_path):
    """A file ledger with two finished random hunts, and an inserted trial
    of the first held by a worker that died (for ``release``)."""
    quad = tmp_path / "quad.py"
    quad.write_text(QUAD)
    led = f"file:{tmp_path / 'src'}"
    cfg = algo_config(tmp_path, {"random": {"seed": 5}})
    for name, n in (("a", 4), ("b", 3)):
        assert main(["hunt", "-n", name, "--ledger", led, "--max-trials", str(n), "--config",
                     cfg, str(quad), "-x~uniform(-4, 4)"]) == 0
    src = ledger_from_spec(led)
    assert main(["insert", "-n", "a", "--ledger", led, "--params", '{"x": 0.25}']) == 0
    t = src.reserve("a", "stuck-worker")
    assert t is not None
    return tmp_path, led


def run_both(capsys, argv_of):
    """``argv_of(tag)`` through both CLIs: [(rc or exit text, stdout)] port, ref."""
    res = []
    for tag, cli in (("port", main), ("ref", ref_main)):
        try:
            rc = cli(argv_of(tag))
        except SystemExit as err:
            rc = f"exit: {err}"
        res.append((rc, capsys.readouterr().out))
    return res


def test_dump_writes_the_same_json(seeded, capsys):
    root, led = seeded
    got, want = run_both(capsys, lambda tag: ["db", "dump", "--ledger", led, "-o",
                                              str(root / f"{tag}.json")])
    assert got[1].replace("port.json", "X") == want[1].replace("ref.json", "X")
    assert got[0] == want[0] == 0
    text = (root / "port.json").read_text()
    assert text == (root / "ref.json").read_text()
    archive = json.loads(text)
    assert archive["format"] == "metaopt-tpu-archive" and len(archive["experiments"]) == 2
    one = run_both(capsys, lambda tag: ["db", "dump", "--ledger", led, "-n", "b"])
    assert one[0] == one[1]


@pytest.mark.parametrize("resolve", ["fail", "ignore", "overwrite", "bump"])
def test_load_under_each_resolve_policy(seeded, capsys, resolve):
    root, led = seeded
    assert main(["db", "dump", "--ledger", led, "-o", str(root / "arch.json")]) == 0
    capsys.readouterr()
    for tag in ("port", "ref"):
        shutil.copytree(root / "src", root / tag)   # both start with a and b present
    got, want = run_both(capsys, lambda tag: ["db", "load", "--ledger", f"file:{root / tag}",
                                              "--file", str(root / "arch.json"),
                                              "--resolve", resolve])
    assert got == want
    assert view(ledger_from_spec(f"file:{root / 'port'}")) == \
        view(ref_ledger_from_spec(f"file:{root / 'ref'}"))
    names = ledger_from_spec(f"file:{root / 'port'}").list_experiments()
    assert names == (["a", "a-v2", "b", "b-v2"] if resolve == "bump" else ["a", "b"])
    # into an empty native store: every experiment and trial arrives
    got, want = run_both(capsys, lambda tag: ["db", "load", "--ledger",
                                              f"native:{root / (tag + '-n')}", "--file",
                                              str(root / "arch.json"), "--resolve", resolve])
    assert got == want and got[0] == 0
    assert view(ledger_from_spec(f"native:{root / 'port-n'}")) == \
        view(ref_ledger_from_spec(f"native:{root / 'ref-n'}"))
    assert view(ledger_from_spec(f"native:{root / 'port-n'}"), heartbeat=False) == \
        view(ledger_from_spec(led), heartbeat=False)


@pytest.mark.parametrize("action", ["set_fields", "set_trial", "release", "rm", "compact"])
def test_admin_actions_leave_equal_ledgers(seeded, capsys, action):
    root, led = seeded
    for tag in ("port", "ref"):
        shutil.copytree(root / "src", root / tag)
    src = ledger_from_spec(led)
    done = sorted(t.id for t in src.fetch("a", "completed"))
    argv = {
        "set_fields": [["db", "set", "-n", "a", "max_trials=9", "pool_size=2"],
                       ["db", "set", "-n", "a", "space=x"], ["db", "set", "-n", "a", "pool_size=0"]],
        "set_trial": [["db", "set", "-n", "a", "--trial", done[0][:10], "status=new"],
                      ["db", "set", "-n", "a", "--trial", done[1][:10], "status=broken"],
                      ["db", "set", "-n", "a", "--trial", "", "status=new"]],
        "release": [["db", "release", "-n", "a", "--trial", "zzz"], ["db", "release", "-n", "a"],
                    ["db", "release", "-n", "b", "x=1"]],
        "rm": [["db", "rm", "-n", "b"], ["db", "rm", "-n", "b", "--force"],
               ["db", "rm", "-n", "nope", "--force"]],
        "compact": [["db", "compact"], ["db", "compact", "-n", "a"]],
    }[action]
    for args in argv:
        got, want = run_both(capsys, lambda tag: args[:2] + ["--ledger", f"file:{root / tag}"]
                             + args[2:])
        assert got == want, args
    assert view(ledger_from_spec(f"file:{root / 'port'}")) == \
        view(ref_ledger_from_spec(f"file:{root / 'ref'}"))
    port = ledger_from_spec(f"file:{root / 'port'}")
    if action == "release":
        assert port.count("a", "reserved") == 0 and port.count("a", "new") == 1
    elif action == "rm":
        assert port.list_experiments() == ["a"]
    elif action == "set_trial":
        assert port.get("a", done[0]).status == "new"
        assert port.get("a", done[1]).status == "broken"


def test_compact_on_native_stores_of_both_packages(seeded, capsys):
    """A native ledger's compaction by either package keeps its live state;
    each package's compaction of a store the other wrote reclaims bytes."""
    root, led = seeded
    assert main(["db", "dump", "--ledger", led, "-o", str(root / "arch.json")]) == 0
    for tag, cli in (("port", main), ("ref", ref_main)):
        assert cli(["db", "load", "--ledger", f"native:{root / tag}", "--file",
                    str(root / "arch.json")]) == 0
    capsys.readouterr()
    before = view(ledger_from_spec(f"native:{root / 'port'}"))
    for tag, cli in (("port", ref_main), ("ref", main)):   # each compacts the other's
        assert cli(["db", "compact", "--ledger", f"native:{root / tag}"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[-1].startswith("total reclaimed: ") and int(lines[-1].split()[2]) > 0
    assert view(ledger_from_spec(f"native:{root / 'ref'}")) == before == \
        view(ref_ledger_from_spec(f"native:{root / 'port'}"))


@pytest.mark.parametrize("spec", ["memory", "file", "native", "bare"])
def test_db_test_passes_on_every_backend(tmp_path, capsys, spec):
    led = {"memory": "memory", "file": f"file:{tmp_path / 'f'}",
           "native": f"native:{tmp_path / 'n'}", "bare": str(tmp_path / 'b')}[spec]
    assert main(["db", "test", "--ledger", led, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["passed"] == report["total"] == 14 and report["cleaned"]
    assert report["backend"] == {"memory": "MemoryLedger", "file": "FileLedger"}.get(
        spec, "NativeFileLedger")
