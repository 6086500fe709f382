"""GPU trial placement: the buddy allocator, the GPU registry (in-process
and flock'd), the pinning env and the GPU executor.

The contracts of the reference's ``tests/unit/test_topology.py`` restated
against the port (its buddy-allocator cases against ``BuddyAllocator``,
the registry without a state file and the registry's state file), 1000
seeded allocate and free operations through both packages' allocators
with identical answers at every step, plus what changed for the GPU: ``CUDA_VISIBLE_DEVICES``
mapped through this process's own list, ``detect_slice_size`` raising
where it finds no GPU, and ``GPUExecutor`` returning its block on every
exit path (completed, broken, pruned by the judge, timed out, SIGINT, an
exception). Every test that touches the default registry file points
``TMPDIR`` at its own ``tmp_path``.
"""

import json
import os
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from metaopt_tpu.executor import topology as ref_topology
from metaopt_tpu_torch.executor import GPUExecutor, SubprocessExecutor
from metaopt_tpu_torch.executor.topology import (
    BuddyAllocator,
    ChipRegistry,
    SubSlice,
    chip_env,
    detect_slice_size,
    next_pow2,
)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space.builder import SpaceBuilder


@pytest.fixture
def own_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def registry(tmp_path, total):
    return ChipRegistry(total, state_path=str(tmp_path / "gpus.json"))


class TestBuddyAllocator:
    """The reference's buddy cases, against the allocator and against the
    registry without a state file (which runs on it)."""

    @pytest.fixture(params=["BuddyAllocator", "ChipRegistry"])
    def make(self, request):
        return BuddyAllocator if request.param == "BuddyAllocator" else ChipRegistry

    def test_allocate_aligned_contiguous(self, make):
        a = make(8)
        blocks = [a.allocate(4), a.allocate(2), a.allocate(2)]
        assert {tuple(b.chips) for b in blocks} == {(0, 1, 2, 3), (4, 5), (6, 7)}
        assert a.n_free_chips == 0
        assert a.allocate(1) is None

    def test_rounds_up_to_pow2(self, make):
        b = make(8).allocate(3)  # 3 -> 4
        assert b.size == 4 and b.start % 4 == 0

    def test_free_coalesces_buddies(self, make):
        a = make(8)
        blocks = [a.allocate(1) for _ in range(8)]
        for b in blocks:
            a.free(b)
        assert a.n_free_chips == 8
        whole = a.allocate(8)  # only possible if every buddy re-merged
        assert whole.start == 0 and whole.size == 8

    def test_oversized_request_raises(self, make):
        with pytest.raises(ValueError):
            make(4).allocate(5)
        with pytest.raises(ValueError):
            make(3)  # not a power of two

    def test_a_registry_without_a_state_file_is_in_process(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        r = ChipRegistry(4)
        assert r.state_path is None
        b = r.allocate(2, owner="t")
        r.heartbeat(b)  # a lease needs no beat in-process
        assert r.n_free_chips == 2
        r.free(b)
        assert r.n_free_chips == 4
        assert list(tmp_path.iterdir()) == []  # no state file, no lock file

    def test_threads_never_share_a_block(self):
        a = BuddyAllocator(16)
        held, lock, errors = set(), threading.Lock(), []

        def worker(seed):
            rng = np.random.default_rng(seed)
            for _ in range(200):
                b = a.allocate(int(rng.integers(1, 5)))
                if b is None:
                    continue
                with lock:
                    if held & set(b.chips):
                        errors.append(b)
                    held.update(b.chips)
                with lock:
                    held.difference_update(b.chips)
                a.free(b)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert a.n_free_chips == 16 and a.allocate(16) == SubSlice(0, 16)


@pytest.mark.parametrize("kind", ["BuddyAllocator", "ChipRegistry"])
@pytest.mark.parametrize("total", [1, 2, 8, 32])
def test_allocations_equal_the_references(kind, total):
    """1000 seeded allocate and free operations through both packages'
    allocators: the same blocks, the same Nones, the same refusals of
    oversized requests and the same free counts at every step."""
    ref = getattr(ref_topology, kind)(total)
    port = BuddyAllocator(total) if kind == "BuddyAllocator" else ChipRegistry(total)
    rng = np.random.default_rng(total)
    held = []
    for step in range(1000):
        if held and rng.random() < 0.45:
            i = int(rng.integers(len(held)))
            r_block, p_block = held.pop(i)
            ref.free(r_block)
            port.free(p_block)
        else:
            n = int(rng.integers(1, 2 * total + 1))
            try:
                r_block = ref.allocate(n)
            except ValueError:
                with pytest.raises(ValueError):
                    port.allocate(n)
                continue
            p_block = port.allocate(n)
            if r_block is None:
                assert p_block is None, step
            else:
                assert (p_block.start, p_block.size) == (r_block.start, r_block.size), step
                held.append((r_block, p_block))
        assert port.n_free_chips == ref.n_free_chips, step


class TestAlignedBlocks:
    def test_allocate_aligned_contiguous(self, tmp_path):
        r = registry(tmp_path, 8)
        blocks = [r.allocate(4), r.allocate(2), r.allocate(2)]
        assert {tuple(b.chips) for b in blocks} == {(0, 1, 2, 3), (4, 5), (6, 7)}
        assert r.n_free_chips == 0
        assert r.allocate(1) is None

    def test_rounds_up_to_pow2(self, tmp_path):
        b = registry(tmp_path, 8).allocate(3)  # 3 -> 4
        assert b.size == 4 and b.start % 4 == 0

    def test_freed_blocks_merge_back(self, tmp_path):
        r = registry(tmp_path, 8)
        blocks = [r.allocate(1) for _ in range(8)]
        for b in blocks:
            r.free(b)
        assert r.n_free_chips == 8
        whole = r.allocate(8)  # only possible if every single GPU came back
        assert whole.start == 0 and whole.size == 8

    def test_oversized_request_raises(self, tmp_path):
        with pytest.raises(ValueError):
            registry(tmp_path, 4).allocate(5)
        with pytest.raises(ValueError):
            registry(tmp_path, 3)  # not a power of two


class TestChipRegistryFile:
    def test_two_registries_share_one_host(self, tmp_path):
        path = str(tmp_path / "gpus.json")
        r1, r2 = ChipRegistry(8, state_path=path), ChipRegistry(8, state_path=path)
        b1 = r1.allocate(4, owner="t1")
        b2 = r2.allocate(4, owner="t2")
        assert not set(b1.chips) & set(b2.chips)
        assert r1.allocate(1) is None  # exhausted, seen by BOTH
        assert r2.n_free_chips == 0
        r1.free(b1)
        assert r2.n_free_chips == 4  # the free is visible cross-instance

    def test_concurrent_allocation_no_overlap(self, tmp_path):
        path = str(tmp_path / "gpus.json")
        got, lock = [], threading.Lock()

        def worker():
            b = ChipRegistry(16, state_path=path).allocate(2, owner="w")
            if b is not None:
                with lock:
                    got.append(b)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        chips = [c for b in got for c in b.chips]
        assert len(got) == 8 and len(chips) == len(set(chips)) == 16

    def test_dead_pid_claims_are_reaped(self, tmp_path):
        path = str(tmp_path / "gpus.json")
        r = ChipRegistry(4, state_path=path)
        with open(path, "w") as f:  # a dead pid holding every GPU
            json.dump({"claims": {"0:4": {"pid": 2 ** 30, "owner": "ghost", "t": 0}}}, f)
        b = r.allocate(4, owner="fresh")  # reap happens on allocate
        assert b is not None and b.size == 4

    def test_stale_heartbeat_claims_are_reaped(self, tmp_path):
        path = str(tmp_path / "gpus.json")
        r = ChipRegistry(4, state_path=path, stale_s=0.0)
        with open(path, "w") as f:  # a LIVE pid whose heartbeat lapsed
            json.dump({"claims": {"0:4": {"pid": os.getpid(), "owner": "me", "t": 0}}}, f)
        assert r.allocate(1, owner="fresh") is not None

    def test_heartbeat_refreshes_claim(self, tmp_path):
        path = str(tmp_path / "gpus.json")
        r = ChipRegistry(4, state_path=path, stale_s=3600.0)
        b = r.allocate(2, owner="t")
        r.heartbeat(b)
        with open(path) as f:
            assert json.load(f)["claims"][f"{b.start}:{b.size}"]["t"] > 0


class TestChipEnv:
    def test_pinning_env(self, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        env = chip_env(SubSlice(4, 4))
        assert env == {"MTPU_ASSIGNED_CHIPS": "4,5,6,7", "CUDA_VISIBLE_DEVICES": "4,5,6,7"}
        assert not any(k.startswith("TPU_") for k in env)

    def test_maps_through_the_parents_visible_devices(self, monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
        assert chip_env(SubSlice(0, 1))["CUDA_VISIBLE_DEVICES"] == "2"
        assert chip_env(SubSlice(1, 1)) == {"MTPU_ASSIGNED_CHIPS": "1",
                                            "CUDA_VISIBLE_DEVICES": "3"}
        assert chip_env(SubSlice(0, 2))["CUDA_VISIBLE_DEVICES"] == "2,3"
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-aa, GPU-bb")
        assert chip_env(SubSlice(1, 1))["CUDA_VISIBLE_DEVICES"] == "GPU-bb"
        with pytest.raises(ValueError, match="not all in this process's"):
            chip_env(SubSlice(2, 2))

    def test_next_pow2(self):
        assert [next_pow2(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


class TestDetectSliceSize:
    def test_env_override_wins(self, monkeypatch):
        monkeypatch.setenv("MTPU_SLICE_CHIPS", "4")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert detect_slice_size() == 4

    def test_counts_cuda_devices(self, monkeypatch):
        monkeypatch.delenv("MTPU_SLICE_CHIPS", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert detect_slice_size() == 2

    def test_raises_without_a_gpu_and_no_override(self, monkeypatch):
        monkeypatch.delenv("MTPU_SLICE_CHIPS", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device visible"):
            detect_slice_size()
        monkeypatch.setenv("MTPU_SLICE_CHIPS", "0")
        with pytest.raises(RuntimeError, match="no CUDA device visible"):
            detect_slice_size()


# -- GPUExecutor --------------------------------------------------------------

SCRIPT = r'''
import argparse, json, os, sys, time
from metaopt_tpu_torch.client import report_partial, report_results, stop_requested
p = argparse.ArgumentParser()
p.add_argument("--x", type=float, required=True)
p.add_argument("--mode", default="ok")
a = p.parse_args()
if a.mode == "broken":
    sys.exit(3)
if a.mode in ("hang", "prune"):
    for step in range(1, 10 ** 6):
        report_partial(a.x, step)
        if stop_requested():
            sys.exit(0)
        time.sleep(0.05)
report_results([
    {"name": "objective", "type": "objective", "value": a.x},
    {"name": "env", "type": "statistic", "value": {
        k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES", "MTPU_ASSIGNED_CHIPS")}},
])
'''


@pytest.fixture
def script(tmp_path):
    path = tmp_path / "trial.py"
    path.write_text(SCRIPT)
    return str(path)


def make_executor(script, mode="ok", **kw):
    _, template = SpaceBuilder().build([script, "--x~uniform(0, 1)", f"--mode={mode}"])
    kw.setdefault("probe_fn", lambda **_: True)
    return GPUExecutor(template, n_chips=1, interpreter=[sys.executable],
                       poll_interval_s=0.05, **kw)


def reserved_trial(i=0):
    t = Trial(params={"x": 0.5}, experiment="e")
    t.id = f"gpu-{i:04d}"
    t.transition("reserved")
    return t


def claims(ex):
    with open(ex.registry.state_path) as f:
        return json.load(f)["claims"]


@pytest.mark.parametrize("mode,kw,status,note", [
    ("ok", {}, "completed", ""),
    ("broken", {}, "broken", "exit=3, no results reported"),
    ("prune", {"judge": lambda t, partial: {"stop": True} if len(partial) >= 2 else None},
     "completed", "pruned by judge"),
    ("hang", {"timeout_s": 0.5}, "broken", "timeout after 0.5s"),
])
def test_every_exit_path_returns_the_block(own_tmpdir, monkeypatch, script, mode, kw,
                                           status, note):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    judge = kw.pop("judge", None)
    ex = make_executor(script, mode, **kw)
    assert ex.registry.state_path == str(own_tmpdir / "metaopt_tpu_torch-gpus-1.json")
    res = ex.execute(reserved_trial(), judge=judge)
    assert res.status == status and res.note.startswith(note), res.note
    assert claims(ex) == {} and ex.registry.n_free_chips == 1


def test_sigint_and_an_exception_return_the_block(own_tmpdir, monkeypatch, script):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    ex = make_executor(script, "hang")

    def interrupt(*_a, **_k):
        raise KeyboardInterrupt

    monkeypatch.setattr(SubprocessExecutor, "_read_partial", staticmethod(interrupt))
    res = ex.execute(reserved_trial(1))
    assert res.status == "interrupted" and res.note == "SIGINT"
    assert claims(ex) == {}

    def boom(self, trial, heartbeat=None, judge=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(SubprocessExecutor, "_execute_inner", boom)
    with pytest.raises(RuntimeError, match="boom"):
        ex.execute(reserved_trial(2))
    assert claims(ex) == {}


def test_trial_sees_its_gpu_and_resources_merge(own_tmpdir, monkeypatch, script):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    ex = make_executor(script)
    t = reserved_trial()
    t.resources["requeues"] = 1  # the worker loop's requeue budget survives
    held = ex.registry.allocate(1, owner="other")  # GPU 0 busy: the trial gets GPU 1
    res = ex.execute(t)
    assert res.status == "completed"
    env = next(r["value"] for r in res.results if r["name"] == "env")
    assert env == {"CUDA_VISIBLE_DEVICES": "7", "MTPU_ASSIGNED_CHIPS": "1"}
    assert t.resources["requeues"] == 1 and t.resources["chips"] == [1]
    assert t.resources["env"]["CUDA_VISIBLE_DEVICES"] == "7"
    assert list(claims(ex)) == [f"{held.start}:{held.size}"]


def test_the_lease_beats_while_the_trial_runs(own_tmpdir, monkeypatch, script):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    beats = []

    class Counting(ChipRegistry):
        def heartbeat(self, block):
            beats.append(block)
            super().heartbeat(block)

    reg = Counting(1, state_path=str(own_tmpdir / "gpus.json"))
    ex = make_executor(script, "hang", registry=reg, timeout_s=0.6, heartbeat_every_s=0.1)
    ex.execute(reserved_trial())
    assert len(beats) >= 3 and claims(ex) == {}


def test_no_block_within_the_deadline_interrupts(own_tmpdir, monkeypatch, script):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "1")
    ex = make_executor(script, allocate_timeout_s=0.3, allocate_poll_s=0.05)
    ex.registry.allocate(1, owner="other")
    res = ex.execute(reserved_trial())
    assert res.status == "interrupted" and "no 1-GPU block" in res.note


def test_total_chips_and_registry_path_as_the_reference_takes_them(own_tmpdir, monkeypatch,
                                                                    script):
    # no device count is asked for when the caller gives the total
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("MTPU_SLICE_CHIPS", raising=False)
    path = str(own_tmpdir / "gpus.json")
    ex = make_executor(script, total_chips=6, registry_path=path)
    assert ex.registry.total == 4  # rounded down to a power of two
    assert ex.registry.state_path == path
    assert make_executor(script, total_chips=2).registry.state_path == os.path.join(
        str(own_tmpdir), "metaopt_tpu_torch-gpus-2.json")


def test_default_registry_is_shared_per_host(own_tmpdir, monkeypatch, script):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "8")
    ex1, ex2 = make_executor(script), make_executor(script)
    assert ex1.registry.state_path == ex2.registry.state_path
    b1 = ex1.registry.allocate(4, owner="a")
    b2 = ex2.registry.allocate(4, owner="b")
    assert not set(b1.chips) & set(b2.chips)
    assert ex1.registry.allocate(1) is None
