"""Typed dimensions over named priors.

ref: src/metaopt/algo/space.py — the lineage wraps scipy.stats distributions
and stores (prior name, args) for reproducibility. Here each prior is
implemented directly against ``numpy.random.Generator`` (uniform, loguniform,
normal, randint, choices) so sampling is dependency-light and exactly
reproducible from (prior, args, seed); the stored ``configuration`` round-trips
through the ``name~prior(...)`` DSL.

Supported priors (DSL names):

- ``uniform(low, high)``            → Real on [low, high)
- ``loguniform(low, high)``         → Real, log-uniform on [low, high)
- ``normal(loc, scale)``            → Real, unbounded
- ``uniform(low, high, discrete=True)`` → Integer on {low..high}
- ``randint(low, high)``            → Integer on {low..high-1} (numpy conv.)
- ``choices([...])`` / ``choices({opt: prob, ...})`` → Categorical
- ``fidelity(low, high, base=b)``   → Fidelity (the budget axis for ASHA/HB)

Every dimension supports ``sample(n, rng)``, ``interval()``, ``__contains__``,
an optional ``default_value``, and a ``shape`` for array-valued params.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

_RNG = np.random.Generator


def _as_rng(seed_or_rng) -> _RNG:
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(seed_or_rng)


class Dimension:
    """One named axis of the search space.

    Subclasses implement ``_sample_one(rng, size)`` returning a numpy array of
    ``size`` draws, plus containment and interval logic.
    """

    #: DSL type tag used in configuration round-trips.
    type: str = "dimension"

    def __init__(
        self,
        name: str,
        prior_name: str,
        *args: Any,
        default_value: Any = None,
        shape: Optional[Tuple[int, ...]] = None,
        **kwargs: Any,
    ) -> None:
        if not name or not isinstance(name, str):
            raise ValueError(f"dimension name must be a non-empty str, got {name!r}")
        self.name = name
        self.prior_name = prior_name
        self.args = tuple(args)
        self.kwargs = dict(kwargs)
        self.shape = tuple(shape) if shape else ()
        self.default_value = default_value
        if default_value is not None and default_value not in self:
            raise ValueError(
                f"default_value {default_value!r} not inside dimension {self!r}"
            )

    # -- sampling ---------------------------------------------------------
    def _sample_scalar(self, rng: _RNG, size: int) -> np.ndarray:
        raise NotImplementedError

    def sample(self, n: int = 1, seed=None) -> List[Any]:
        """Draw ``n`` values (each of ``self.shape``) as Python/numpy values."""
        rng = _as_rng(seed)
        count = n * self.n_elements
        flat = self._sample_scalar(rng, count)
        if self.shape:
            return list(flat.reshape((n,) + self.shape))
        return [self._to_py(v) for v in flat]

    @staticmethod
    def _to_py(v):
        return v.item() if hasattr(v, "item") else v

    # -- geometry ---------------------------------------------------------
    def interval(self) -> Tuple[Any, Any]:
        raise NotImplementedError

    def __contains__(self, value: Any) -> bool:
        raise NotImplementedError

    @property
    def n_elements(self) -> int:
        """Scalar count of one value of this dimension (1 unless shaped)."""
        return max(1, int(np.prod(self.shape)) if self.shape else 1)

    def _each(self, value) -> Iterable[Any]:
        if self.shape:
            # object dtype: mixed-type categorical options (e.g. [1, 'a'])
            # must not coerce to a common dtype during the check
            arr = np.asarray(value, dtype=object)
            if arr.shape != self.shape:
                return iter(())  # wrong shape → nothing to check → not contained
            return arr.flat
        return (value,)

    # -- config -----------------------------------------------------------
    @property
    def configuration(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {
            "type": self.type,
            "prior": self.prior_name,
            "args": list(self.args),
            "kwargs": dict(self.kwargs),
        }
        if self.shape:
            cfg["shape"] = list(self.shape)
        if self.default_value is not None:
            cfg["default_value"] = self.default_value
        return cfg

    def get_prior_string(self) -> str:
        """Round-trip back to the DSL text, e.g. ``uniform(-5, 5)``."""
        parts = [repr(a) for a in self.args]
        parts += [f"{k}={v!r}" for k, v in self.kwargs.items()]
        if self.shape:
            parts.append(f"shape={list(self.shape)!r}")
        if self.default_value is not None:
            parts.append(f"default_value={self.default_value!r}")
        return f"{self.prior_name}({', '.join(parts)})"

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r}, {self.get_prior_string()})"

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.name == other.name
            and self.prior_name == other.prior_name
            and self.args == other.args
            and self.kwargs == other.kwargs
            and self.shape == other.shape
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.name, self.prior_name, self.args))

    @property
    def cardinality(self) -> float:
        return math.inf


class Real(Dimension):
    """Continuous dimension: uniform, loguniform, or normal prior."""

    type = "real"

    def __init__(self, name: str, prior_name: str, *args, precision: Optional[int] = None, **kwargs):
        self.precision = precision
        if prior_name in ("uniform", "loguniform"):
            if len(args) != 2:
                raise ValueError(f"{prior_name} takes (low, high), got {args}")
            low, high = float(args[0]), float(args[1])
            if not low < high:
                raise ValueError(f"{prior_name} needs low < high, got ({low}, {high})")
            if prior_name == "loguniform" and low <= 0:
                raise ValueError(f"loguniform needs low > 0, got {low}")
            self._low, self._high = low, high
        elif prior_name == "normal":
            if len(args) != 2:
                raise ValueError(f"normal takes (loc, scale), got {args}")
            self._loc, self._scale = float(args[0]), float(args[1])
            if self._scale <= 0:
                raise ValueError(f"normal needs scale > 0, got {self._scale}")
        else:
            raise ValueError(f"unknown real prior {prior_name!r}")
        super().__init__(name, prior_name, *args, **kwargs)
        if precision is not None:
            self.kwargs["precision"] = precision

    def _sample_scalar(self, rng: _RNG, size: int) -> np.ndarray:
        if self.prior_name == "uniform":
            out = rng.uniform(self._low, self._high, size)
        elif self.prior_name == "loguniform":
            out = np.exp(rng.uniform(math.log(self._low), math.log(self._high), size))
        else:  # normal
            out = rng.normal(self._loc, self._scale, size)
        if self.precision is not None:
            out = np.asarray([float(f"%.{self.precision}g" % v) for v in out])
            if self.prior_name != "normal":
                # %g rounding can step just past a bound; clip back inside
                out = np.clip(out, self._low, self._high)
        return out

    def interval(self) -> Tuple[float, float]:
        if self.prior_name == "normal":
            return (-math.inf, math.inf)
        return (self._low, self._high)

    def __contains__(self, value) -> bool:
        low, high = self.interval()
        try:
            return all(low <= float(v) <= high for v in self._each(value))
        except (TypeError, ValueError):
            return False


class Integer(Dimension):
    """Discrete numeric dimension on an inclusive integer range."""

    type = "integer"

    def __init__(self, name: str, prior_name: str, *args, **kwargs):
        kwargs.pop("discrete", None)  # the DSL flag that routed us here
        if prior_name in ("uniform", "randint"):
            if len(args) != 2:
                raise ValueError(f"{prior_name} takes (low, high), got {args}")
            low, high = int(args[0]), int(args[1])
            if prior_name == "randint":
                high -= 1  # numpy-style exclusive high → inclusive
            if not low <= high:
                raise ValueError(f"integer range empty: ({args[0]}, {args[1]})")
            self._low, self._high = low, high
        else:
            raise ValueError(f"unknown integer prior {prior_name!r}")
        super().__init__(name, prior_name, *args, **kwargs)
        if prior_name == "uniform":
            # so configuration/DSL round-trips route back to Integer
            self.kwargs["discrete"] = True

    def _sample_scalar(self, rng: _RNG, size: int) -> np.ndarray:
        return rng.integers(self._low, self._high + 1, size)

    def interval(self) -> Tuple[int, int]:
        return (self._low, self._high)

    def __contains__(self, value) -> bool:
        def ok(v) -> bool:
            try:
                return float(v) == int(v) and self._low <= int(v) <= self._high
            except (TypeError, ValueError):
                return False

        return all(ok(v) for v in self._each(value))

    @property
    def cardinality(self) -> float:
        return float(self._high - self._low + 1) ** self.n_elements


class Categorical(Dimension):
    """Finite unordered set of options, optionally with probabilities.

    DSL: ``choices(['a', 'b'])`` or ``choices({'a': 0.7, 'b': 0.3})`` or
    ``choices('a', 'b')``.
    """

    type = "categorical"

    def __init__(self, name: str, prior_name: str = "choices", *args, **kwargs):
        if len(args) == 1 and isinstance(args[0], dict):
            options = list(args[0].keys())
            probs = np.asarray([float(p) for p in args[0].values()], dtype=float)
            if not math.isclose(probs.sum(), 1.0, rel_tol=1e-6):
                raise ValueError(f"choice probabilities must sum to 1, got {probs.sum()}")
            probs = probs / probs.sum()
        else:
            if len(args) == 1 and isinstance(args[0], (list, tuple)):
                options = list(args[0])
            else:
                options = list(args)
            if not options:
                raise ValueError("choices() needs at least one option")
            probs = np.full(len(options), 1.0 / len(options))
        if len(set(map(repr, options))) != len(options):
            raise ValueError(f"duplicate options in {options!r}")
        self.options = options
        self.probabilities = probs
        super().__init__(name, prior_name, *args, **kwargs)

    def _sample_scalar(self, rng: _RNG, size: int) -> np.ndarray:
        idx = rng.choice(len(self.options), size=size, p=self.probabilities)
        return np.asarray([self.options[i] for i in idx], dtype=object)

    @staticmethod
    def _to_py(v):
        return v

    def interval(self) -> Tuple[Any, ...]:
        return tuple(self.options)

    def __contains__(self, value) -> bool:
        return all(any(v == opt for opt in self.options) for v in self._each(value))

    @property
    def cardinality(self) -> float:
        # like Integer: a shaped dim is the product over its elements
        return float(len(self.options)) ** self.n_elements


class Fidelity(Dimension):
    """The budget axis (epochs/steps) consumed by multi-fidelity algorithms.

    ref: the lineage's Fidelity dimension (post-v0; mandated by
    BASELINE.json's ASHA/Hyperband configs). ``base`` is the reduction factor
    eta used to derive rung levels: low, low*base, low*base^2, ... capped at
    high. Not sampled — algorithms assign fidelity explicitly; plain
    ``sample`` returns the maximum budget so fidelity-unaware algorithms run
    full-budget trials.
    """

    type = "fidelity"

    def __init__(self, name: str, prior_name: str = "fidelity", *args, base: int = 2, **kwargs):
        if len(args) != 2:
            raise ValueError(f"fidelity takes (low, high), got {args}")
        low, high = int(args[0]), int(args[1])
        if not (1 <= low <= high):
            raise ValueError(f"fidelity needs 1 <= low <= high, got ({low}, {high})")
        if base < 1:
            raise ValueError(f"fidelity base must be >= 1, got {base}")
        self.low, self.high, self.base = low, high, int(base)
        kwargs["base"] = int(base)
        super().__init__(name, prior_name, *args, **kwargs)

    def rungs(self) -> List[int]:
        """Budget levels from low to high by powers of base (high always last)."""
        if self.base == 1:
            return [self.high]
        levels = []
        b = self.low
        while b < self.high:
            levels.append(int(b))
            b *= self.base
        levels.append(self.high)
        return levels

    def _sample_scalar(self, rng: _RNG, size: int) -> np.ndarray:
        return np.full(size, self.high, dtype=int)

    def interval(self) -> Tuple[int, int]:
        return (self.low, self.high)

    def __contains__(self, value) -> bool:
        try:
            return all(self.low <= int(v) <= self.high for v in self._each(value))
        except (TypeError, ValueError):
            return False

    @property
    def cardinality(self) -> float:
        return float(len(self.rungs()))
