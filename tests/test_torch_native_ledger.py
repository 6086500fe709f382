"""The port's native ledgerstore engine against the JAX package's.

``NativeFileLedger`` keeps the reference's store byte for byte (the same
engine source, the same payloads and experiment documents), so each
package's engine reads, writes, compacts and sweeps the other's stores:
trial documents, statuses, counts, the completed log and the
``fetch_completed_since`` cursors must agree exactly. Reserve is one CAS
across processes of both packages. A bare path resolves as the
reference's ``local_ledger`` does in its three cases, ``native:<dir>``
raises where ``g++`` cannot build the engine, and the loaded library is
the port's own build under ``metaopt_tpu_torch/_build/``.
"""

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from metaopt_tpu.ledger import backends as ref_backends
from metaopt_tpu.ledger.experiment import Experiment as RefExperiment
from metaopt_tpu.ledger.native import NativeFileLedger as RefNative
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch import native
from metaopt_tpu_torch.ledger import Experiment, FileLedger, backends
from metaopt_tpu_torch.ledger.native import NativeFileLedger
from metaopt_tpu_torch.space import build_space
from metaopt_tpu_torch.utils import cuda_build
from test_torch_file_ledger import NAMES, SPACE, populate, snapshot

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_engine_reads_what_the_other_wrote(tmp_path, writer, name):
    root = str(tmp_path / "ledger")
    ref, port = RefNative(root), NativeFileLedger(root)
    if writer == "reference":
        populate(RefExperiment, ref, ref_build_space(SPACE), name)
        w_ledger, r_ledger = ref, port
    else:
        populate(Experiment, port, build_space(SPACE), name)
        w_ledger, r_ledger = port, ref
    assert snapshot(w_ledger, name) == snapshot(r_ledger, name)
    # the reader writes on; the writer sees it
    t = r_ledger.reserve(name, "reader")
    t.attach_results([{"name": "objective", "type": "objective", "value": 9.5}])
    t.transition("completed")
    assert r_ledger.update_trial(t, expected_status="reserved", expected_worker="reader")
    assert snapshot(w_ledger, name) == snapshot(r_ledger, name)
    assert w_ledger.get(name, t.id).to_dict() == t.to_dict()


def test_cursors_stale_release_and_compaction_agree(tmp_path):
    """``fetch_completed_since`` gives both engines the same delta and the
    same cursor; a stale reservation released by one is re-reserved by
    the other; ``compact`` by either keeps the live state and the
    cursors' epoch changes for both."""
    root = str(tmp_path / "ledger")
    ref, port = RefNative(root), NativeFileLedger(root)
    populate(Experiment, port, build_space(SPACE), "c", n=16)
    p_done, p_cur = port.fetch_completed_since("c", None)
    r_done, r_cur = ref.fetch_completed_since("c", None)
    assert [t.to_dict() for t in p_done] == [t.to_dict() for t in r_done]
    assert list(p_cur) == list(r_cur) and len(p_done) == 4
    t = ref.reserve("c", "w9")
    t.attach_results([{"name": "objective", "type": "objective", "value": -3.0}])
    t.transition("completed")
    assert ref.update_trial(t, expected_status="reserved", expected_worker="w9")
    for led, cur in ((port, p_cur), (ref, r_cur)):
        delta, nxt = led.fetch_completed_since("c", cur)
        assert [d.id for d in delta] == [t.id]
    assert list(port.fetch_completed_since("c", p_cur)[1]) == \
        list(ref.fetch_completed_since("c", r_cur)[1])
    # stale release: backdate a reservation's heartbeat through the port
    held = port.fetch("c", "reserved")[0]
    held.heartbeat = time.time() - 10_000
    assert port.update_trial(held)
    released = ref.release_stale("c", 60.0)
    assert [r.id for r in released] == [held.id]
    assert port.get("c", held.id).status == "new"
    before = snapshot(ref, "c")
    freed = port.compact("c")
    assert freed > 0
    assert snapshot(ref, "c") == before == snapshot(port, "c")
    # a compaction is a new log epoch: held cursors refetch everything
    full, cur2 = ref.fetch_completed_since("c", r_cur)
    assert len(full) == 5 and list(cur2) != list(r_cur)
    assert ref.compact("c") == 0 and snapshot(port, "c") == before


def test_delete_and_recreate_on_either_engine(tmp_path):
    root = str(tmp_path / "ledger")
    ref, port = RefNative(root), NativeFileLedger(root)
    populate(RefExperiment, ref, ref_build_space(SPACE), "d")
    assert port.delete_experiment("d") and not port.delete_experiment("d")
    assert ref.load_experiment("d") is None and ref.count("d") == 0
    populate(Experiment, port, build_space(SPACE), "d", n=10, seed=1)
    assert ref.count("d") == 10 and snapshot(ref, "d") == snapshot(port, "d")


RACER = r'''
import json, os, sys, time
if sys.argv[3] == "reference":
    from metaopt_tpu.ledger.native import NativeFileLedger
else:
    from metaopt_tpu_torch.ledger.native import NativeFileLedger
led = NativeFileLedger(sys.argv[1])
open(sys.argv[1] + "." + sys.argv[2] + ".ready", "w").close()
while not os.path.exists(sys.argv[1] + ".go"):
    time.sleep(0.001)
got = []
while True:
    t = led.reserve("race", sys.argv[2])
    if t is None:
        break
    got.append(t.id)
print(json.dumps(got))
'''


def test_reserve_cas_has_one_winner_across_processes_of_both_packages(tmp_path):
    root = str(tmp_path / "ledger")
    port = NativeFileLedger(root)
    exp = Experiment("race", port, space=build_space(SPACE), max_trials=500).configure()
    assert len(exp.register_trials([exp.make_trial(p)
                                    for p in exp.space.sample(300, seed=3)])) == 300
    env = dict(os.environ, PYTHONPATH=str(REPO))
    kinds = ["port", "reference", "port", "reference"]
    procs = [subprocess.Popen([sys.executable, "-c", RACER, root, f"p{i}", kind], env=env,
                              stdout=subprocess.PIPE, text=True)
             for i, kind in enumerate(kinds)]
    deadline = time.time() + 60
    while not all(os.path.exists(f"{root}.p{i}.ready") for i in range(len(kinds))):
        assert time.time() < deadline and all(p.poll() is None for p in procs)
        time.sleep(0.01)
    open(root + ".go", "w").close()
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    got = [json.loads(o) for o in outs]
    ids = [tid for g in got for tid in g]
    assert len(ids) == len(set(ids)) == 300
    assert sum(bool(g) for g in got) >= 2, "the processes did not race"
    owners = {t.id: t.worker for t in port.fetch("race")}
    for i, g in enumerate(got):
        assert all(owners[tid] == f"p{i}" for tid in g)


def kind_of(led):
    return type(led).__name__


@pytest.mark.parametrize("case", ["empty", "file_docs", "doc_only"])
def test_bare_path_resolves_as_the_reference_does(tmp_path, case):
    """An empty dir and a doc-only experiment (``experiment.json``, an
    empty ``trials/``, no ``store/`` yet) get the engine; a dir holding
    the file backend's per-trial documents keeps the file backend."""
    root = tmp_path / "ledger"
    root.mkdir()
    if case == "file_docs":
        populate(Experiment, FileLedger(str(root)), build_space(SPACE), "f")
    elif case == "doc_only":
        (root / "e" / "trials").mkdir(parents=True)
        (root / "e" / "experiment.json").write_text(json.dumps({"name": "e"}))
    want = {"empty": "NativeFileLedger", "file_docs": "FileLedger",
            "doc_only": "NativeFileLedger"}[case]
    assert kind_of(backends.local_ledger(str(root))) == want
    assert kind_of(backends.ledger_from_spec(str(root))) == want
    assert kind_of(ref_backends.local_ledger(str(root))) == want
    assert backends._has_python_file_store(str(root)) == \
        ref_backends._has_python_file_store(str(root)) == (case == "file_docs")


@pytest.fixture
def no_gxx(tmp_path, monkeypatch):
    """A fresh engine state whose build finds no ``g++``."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "lib_path", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")

    def missing():
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(cuda_build, "find_gxx", missing)


def test_native_spec_raises_without_gxx_and_a_bare_path_falls_back(tmp_path, no_gxx, caplog):
    with pytest.raises(RuntimeError, match="native ledgerstore unavailable"):
        backends.ledger_from_spec(f"native:{tmp_path / 'n'}")
    with caplog.at_level(logging.WARNING):
        led = backends.ledger_from_spec(str(tmp_path / "b"))
    assert type(led) is FileLedger
    assert "native engine unavailable" in caplog.text
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").glob("*.so"))


def test_the_library_is_the_ports_own_build(tmp_path):
    NativeFileLedger(str(tmp_path / "l"))
    assert native.lib_path is not None
    assert native.lib_path.parent == REPO / "metaopt_tpu_torch" / "_build"
    assert native.lib_path == cuda_build.host_library_path("ledgerstore", [native.SOURCE])
    with open("/proc/self/maps") as f:
        mapped = {line.split()[-1] for line in f if "libledgerstore" in line}
    assert str(native.lib_path) in mapped


def test_a_later_build_never_replaces_a_published_library(tmp_path, monkeypatch):
    """Two builds of one source into one ``_build/``, both past the check
    for a built library: the first publishes and is loaded, and when the
    second finishes it finds the name taken and keeps the first file, so
    the first file's inode and this process's mapping of it stay."""
    import ctypes

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    out = cuda_build.host_library_path("ledgerstore", [native.SOURCE])
    first = {}

    def cmd_of(tmp):  # the second build's compiler starts once the first is loaded
        first["path"] = cuda_build.build_host("ledgerstore", [native.SOURCE])
        first["lib"] = ctypes.CDLL(str(first["path"]))
        first["ino"] = os.stat(first["path"]).st_ino
        return [cuda_build.find_gxx(), *cuda_build.HOST_FLAGS, str(native.SOURCE), "-o", tmp]

    assert cuda_build._compile("ledgerstore", out, cmd_of, timeout=120) == out
    assert first["path"] == out and os.stat(out).st_ino == first["ino"]
    with open("/proc/self/maps") as f:
        mapped = [line.split(maxsplit=5)[-1].strip() for line in f if str(out) in line]
    assert mapped and set(mapped) == {str(out)}  # none "(deleted)"
    assert sorted(p.suffix for p in out.parent.iterdir()) == [".log", ".so"]


BUILDER = r'''
import sys
from metaopt_tpu_torch.utils import cuda_build
from metaopt_tpu_torch import native
cuda_build.BUILD_DIR = cuda_build.Path(sys.argv[1])
print(cuda_build.build_host("ledgerstore", [native.SOURCE]))
'''


def test_concurrent_first_builds_publish_one_whole_library(tmp_path):
    """Four processes building at once into an empty build dir each get a
    loadable library at the hashed path, and no temporary file is left."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    build = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(build)], env=env,
                              stdout=subprocess.PIPE, text=True) for _ in range(4)]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(outs) == 1
    (so,) = outs
    assert Path(so).parent == build and Path(so).exists()
    assert sorted(p.suffix for p in build.iterdir()) == [".log", ".so"]
    import ctypes
    ctypes.CDLL(so).ls_open
