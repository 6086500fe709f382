"""The columnar archive and ``MemoryLedger`` on it, against the reference.

The same operation sequences (register new or completed, reserve,
complete, revive, a ``db set`` of any status, incremental fetches, forced
seals) go through the reference's and the port's ``MemoryLedger`` at small
``archive_segment_rows``, on trials that include every row the columns
cannot represent (multi-objective results, NaN, an int objective, a
promoted ``parent``, non-empty ``resources``, a foreign key order). The
documents, counts, ``fetch_completed_since`` deltas and
``CompletedBatch.columns()`` must be equal, exactly. Both packages' trial
clocks are replaced by counters that tick alike, so time stamps agree
too. Then the seal's overflow rules one by one, and TPE's columnar ingest
(``_observe_batch``) reached from the producer.
"""

import itertools
import json
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import metaopt_tpu.ledger.archive as ref_archive
import metaopt_tpu.ledger.backends as ref_backends
import metaopt_tpu.ledger.trial as ref_trial
import metaopt_tpu_torch.ledger.archive as archive
import metaopt_tpu_torch.ledger.backends as backends
import metaopt_tpu_torch.ledger.trial as trial
from metaopt_tpu_torch import build_experiment
from metaopt_tpu_torch.algo.tpe import TPE
from metaopt_tpu_torch.ledger import MemoryLedger

PKGS = {"ref": (ref_trial, ref_backends), "port": (trial, backends)}
POINTS = [{"x": float(i) / 7 - 1.0, "k": i % 5, "c": "ab"[i % 2]} for i in range(12)]
KINDS = ["plain", "nan", "multi", "int", "parent", "resources", "reorder"]
STATUSES = ["new", "reserved", "completed", "interrupted", "broken", "suspended"]


class Tick:
    """A trial clock that advances by one second a call."""

    def __init__(self):
        self.now = itertools.count(1000)

    def time(self):
        return float(next(self.now))


def results_of(kind, i):
    if kind == "nan":
        return [{"name": "objective", "type": "objective", "value": math.nan}]
    if kind == "multi":
        return [{"name": "a", "type": "objective", "value": float(i)},
                {"name": "b", "type": "objective", "value": -float(i)}]
    if kind == "int":
        return [{"name": "objective", "type": "objective", "value": i}]
    return [{"name": "objective", "type": "objective", "value": float(i) * 0.5 - 2.0}]


def make(pkg, i, status, kind):
    params = dict(POINTS[i])
    if kind == "reorder":
        params = dict(reversed(list(params.items())))
    extra = {}
    if kind == "parent":
        extra["parent"] = "f" * 24
    if kind == "resources":
        extra["resources"] = {"chips": [0]}
    if status == "completed":
        extra.update(results=results_of(kind, i), start_time=float(i) + 0.5,
                     end_time=float(i) + 0.75, worker=f"w{i % 2}")
    return pkg.Trial(params=params, experiment="e", status=status, submit_time=float(i),
                     **extra)


def run(ops, which, rows):
    """Apply ``ops`` to one package's MemoryLedger; the observable record."""
    tmod, bmod = PKGS[which]
    saved = tmod._CLOCK
    tmod._CLOCK = Tick()
    try:
        led = bmod.MemoryLedger(archive_segment_rows=rows)
        led.create_experiment({"name": "e"})
        cursor, out = None, []
        for op in ops:
            kind = op[0]
            if kind == "register":
                try:
                    led.register(make(tmod, op[1], op[2], op[3]))
                    out.append("ok")
                except bmod.DuplicateTrialError:
                    out.append("dup")
            elif kind == "reserve":
                t = led.reserve("e", f"w{op[1]}")
                out.append(t.to_dict() if t is not None else None)
            elif kind in ("complete", "revive", "set"):
                want = {"complete": "reserved", "revive": "completed"}.get(kind)
                pool = sorted((t for t in led.fetch("e") if want in (None, t.status)),
                              key=lambda t: t.id)
                if not pool:
                    out.append("empty")
                    continue
                t = pool[op[1] % len(pool)]
                was = t.status
                if kind == "complete":
                    t.attach_results(results_of(op[2], op[1]))
                    t.transition("completed")
                    ok = led.update_trial(t, expected_status="reserved",
                                          expected_worker=t.worker)
                elif kind == "revive":
                    t.reset_to_new()
                    ok = led.update_trial(t, expected_status="completed")
                else:  # db set --trial ID status=S: an admin override
                    t.status = op[2]
                    ok = led.update_trial(t, expected_status=was)
                out.append((t.id, ok))
            elif kind == "since":
                batch, cursor = led.fetch_completed_since("e", cursor)
                cols = batch.columns() if hasattr(batch, "columns") else None
                if cols is not None:
                    ids, pcols, y = cols
                    cols = (ids, {k: [(type(v).__name__, repr(v)) for v in vs]
                                  for k, vs in sorted(pcols.items())},
                            [repr(v) for v in y.tolist()])
                out.append(([json.dumps(t.to_dict()) for t in batch], cols))
            elif kind == "seal":
                led.seal_archive("e")
            counts = {s: led.count("e", s) for s in STATUSES}
            out.append((counts, led.count("e")))
        docs = sorted(json.dumps(t.to_dict()) for t in led.fetch("e"))
        out.append((docs, led.archive_stats("e")))
        return out
    finally:
        tmod._CLOCK = saved


OP = st.one_of(
    st.tuples(st.just("register"), st.integers(0, len(POINTS) - 1),
              st.sampled_from(["new", "completed"]), st.sampled_from(KINDS)),
    st.tuples(st.just("reserve"), st.integers(0, 2)),
    st.tuples(st.just("complete"), st.integers(0, 20), st.sampled_from(KINDS[:4])),
    st.tuples(st.just("revive"), st.integers(0, 20)),
    st.tuples(st.just("set"), st.integers(0, 20), st.sampled_from(STATUSES)),
    st.tuples(st.just("since")),
    st.tuples(st.just("seal")),
)


@settings(max_examples=80, deadline=None)
@given(ops=st.lists(OP, max_size=40), rows=st.sampled_from([1, 2, 3, 4096]))
def test_memory_ledgers_agree_op_for_op(ops, rows):
    assert run(ops, "port", rows) == run(ops, "ref", rows)


def test_a_fixed_sequence_seals_overflows_and_revives():
    """Hand-picked: completes enough to seal several segments, including
    every overflow kind, then revives a sealed row and re-completes it."""
    ops = [("register", i, "new", "plain") for i in range(10)]
    ops += [("reserve", i % 3) for i in range(10)]
    ops += [("complete", 0, k) for k in ("plain", "nan", "multi", "int")] * 2
    ops += [("since",), ("seal",), ("revive", 3), ("reserve", 0), ("complete", 0, "plain"),
            ("since",), ("set", 1, "broken"), ("set", 2, "completed"), ("since",)]
    ops += [("register", 10, "completed", k) for k in ("parent",)]
    ops += [("register", 11, "completed", "resources"), ("since",), ("seal",), ("since",)]
    got, want = run(ops, "port", 3), run(ops, "ref", 3)
    assert got == want
    assert got[-1][1]["segments"] >= 2 and got[-1][1]["overflow_rows"] >= 3


@pytest.mark.parametrize("kind", KINDS)
def test_each_unrepresentable_row_overflows_as_in_the_reference(kind):
    docs = [make(trial, i, "completed", "plain").to_dict() for i in range(3)]
    docs.append(make(trial, 3, "completed", kind).to_dict())
    seg = archive._seal_segment("e", "s0", [dict(d) for d in docs])
    ref = ref_archive._seal_segment("e", "s0", [dict(d) for d in docs])
    assert sorted(seg.overflow) == sorted(ref.overflow)
    assert (3 in seg.overflow) == (kind not in ("plain",))
    for row, doc in enumerate(docs):
        assert json.dumps(seg.decode(row)) == json.dumps(doc) == json.dumps(ref.decode(row))
    assert seg.ids.tolist() == ref.ids.tolist()
    for k in seg.pcols:
        a, b = seg.pcols[k], ref.pcols[k]
        assert type(a) is type(b)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)


@pytest.mark.parametrize("tid", ["a" * 24, "a" * 25, "", "é" * 3, "x\x00", "0123abcd"])
def test_id_keys_match(tid):
    assert archive._id_key(tid) == ref_archive._id_key(tid)


def test_tpe_ingests_the_producers_batches_through_columns():
    """The producer's ``fetch_completed_since`` on a ``MemoryLedger`` hands
    TPE a ``CompletedBatch``; TPE's columnar ``_observe_batch`` takes it
    whole, and its rows equal the per-trial transform."""
    seen = []
    real = TPE._observe_batch

    def spy(self, trials):
        ok = real(self, trials)
        seen.append((type(trials).__name__, ok, len(trials)))
        return ok

    TPE._observe_batch = spy
    try:
        exp = build_experiment(
            "cols", space={"x": "uniform(-5, 5)", "k": "randint(1, 6)"},
            algorithm={"tpe": {"seed": 0, "n_initial_points": 4, "device": "cpu"}},
            max_trials=8)
        stats = exp.workon(lambda p: (p["x"] - 1.0) ** 2 + p["k"])
    finally:
        TPE._observe_batch = real
    assert stats.completed == 8
    assert any(name == "CompletedBatch" and ok for name, ok, _ in seen), seen
    led = exp.experiment.ledger
    assert isinstance(led, MemoryLedger) and led.archive_stats("cols")["live"] == 8
    batch, _ = led.fetch_completed_since("cols", None)
    ids, cols, y = batch.columns()
    tpe = TPE(exp.space, seed=0, device="cpu")
    tpe._suggest_ahead_async = lambda: None
    tpe.observe(batch)
    per_trial = TPE(exp.space, seed=0, device="cpu")
    per_trial._suggest_ahead_async = lambda: None
    per_trial.observe(list(batch))
    assert np.array_equal(np.stack(tpe._X), np.stack(per_trial._X))
    assert tpe._y == per_trial._y == y.tolist()
