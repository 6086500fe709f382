"""The port's vectorization contract (``Space.why_not_vectorizable``,
``vectorizable``, ``stack_points``, ``unstack_points``) against the
reference's.

These are numpy, so they are held exactly: on seeded mixed spaces (reals,
log reals, integers, categoricals of several option types, a fidelity)
both packages give the same columns, dtypes (float64 Real, int32 Integer,
int32 Categorical indices), fidelity value and points back, and refuse the
same inputs with the same messages. The reference's own cases
(``tests/unit/test_batched_exec.py::TestSpaceStacking``) are restated
against the port.
"""

import numpy as np
import pytest

from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.space import build_space

MIXED = [
    {"lr": "loguniform(1e-4, 1)", "width": "uniform(4, 64, discrete=True)",
     "act": "choices(['relu', 'tanh'])", "epochs": "fidelity(1, 8)"},
    {"x": "uniform(-5, 10)", "k": "uniform(1, 9, discrete=True)",
     "opt": "choices(['sgd', 1, 2.5, None])", "m": "normal(0, 1)"},
    {"a": "uniform(0, 1)", "b": "choices({'u': 0.3, 'v': 0.7})",
     "steps": "fidelity(2, 32, base=2)"},
]


def both(spec):
    return ref_build_space(spec), build_space(spec)


@pytest.mark.parametrize("spec", MIXED, ids=["lr-width-act-epochs", "x-k-opt-m", "a-b-steps"])
@pytest.mark.parametrize("seed", [0, 7])
def test_stack_and_unstack_equal_the_reference(spec, seed):
    ref, port = both(spec)
    assert port.vectorizable() and ref.vectorizable()
    assert port.why_not_vectorizable() is None
    pts = ref.sample(32, seed=seed)
    assert pts == port.sample(32, seed=seed)
    ref_cols, ref_fid = ref.stack_points(pts)
    cols, fid = port.stack_points(pts)
    assert fid == ref_fid and type(fid) is type(ref_fid)
    assert list(cols) == list(ref_cols)
    for name in cols:
        assert cols[name].dtype == ref_cols[name].dtype, name
        np.testing.assert_array_equal(cols[name], ref_cols[name])
    for name, dim in port.items():
        if name in cols:
            want = {"real": np.float64, "integer": np.int32,
                    "categorical": np.int32}[dim.type]
            assert cols[name].dtype == want, name
    back = port.unstack_points(cols, fid)
    ref_back = ref.unstack_points(ref_cols, ref_fid)
    assert back == ref_back
    assert [[type(v) for v in p.values()] for p in back] == \
        [[type(v) for v in p.values()] for p in ref_back]
    # without a fidelity value the fidelity column stays out of the points
    assert port.unstack_points(cols) == ref.unstack_points(ref_cols)


def refusal(space, *args):
    with pytest.raises(ValueError) as err:
        space.stack_points(*args)
    return str(err.value)


def test_refusals_equal_the_reference():
    shaped = {"w": "normal(0, 1, shape=[3])"}
    ref, port = both(shaped)
    assert not port.vectorizable()
    assert port.why_not_vectorizable() == ref.why_not_vectorizable()
    assert "array-valued" in port.why_not_vectorizable()
    assert refusal(port, [{"w": np.zeros(3)}]) == refusal(ref, [{"w": np.zeros(3)}])

    ref, port = both({"x": "uniform(0, 1)", "epochs": "fidelity(1, 8)"})
    mixed = [{"x": 0.1, "epochs": 2}, {"x": 0.2, "epochs": 8}]
    assert refusal(port, mixed) == refusal(ref, mixed)
    assert "constant per batch" in refusal(port, mixed)
    assert refusal(port, []) == refusal(ref, []) == "cannot stack an empty pool"

    ref, port = both({"c": "choices(['a', 'b'])"})
    assert refusal(port, [{"c": "z"}]) == refusal(ref, [{"c": "z"}])

    ref, port = both({"x": "uniform(0, 1)", "y": "uniform(0, 1)"})
    ragged = {"x": np.zeros(2), "y": np.zeros(3)}
    for space in (port, ref):
        with pytest.raises(ValueError, match=r"ragged columns: lengths \[2, 3\]"):
            space.unstack_points(ragged)


def test_a_pool_without_the_fidelity_key_stacks_with_none():
    ref, port = both({"x": "uniform(0, 1)", "epochs": "fidelity(1, 8)"})
    pts = [{"x": 0.25}, {"x": 0.5}]
    assert port.stack_points(pts)[1] is None is ref.stack_points(pts)[1]
