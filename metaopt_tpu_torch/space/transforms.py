"""Space → unit-cube vectorization for algorithm math.

Port of ``metaopt_tpu/space/transforms.py`` (``UnitCube``), host numpy and
scipy as there: every searchable dimension maps to one column in [0, 1], so
the surrogate (TPE's Parzen estimators) is plain array math. The same
points give bit-identical vectors in both packages.

Column semantics per dimension type:

- Real uniform       → linear rescale
- Real loguniform    → log-linear rescale
- Real normal        → Gaussian CDF (scipy.special.ndtr)
- Integer            → linear rescale over [low - 0.5, high + 0.5], rounded on
                       the way back (so each integer owns an equal-width bin)
- Categorical        → bin center (i + .5)/k, floor on the way back; columns
                       carrying categoricals are flagged in ``categorical_mask``
- Fidelity           → excluded (budget is assigned by the algorithm, not
                       searched)
- array-shaped dims  → one column per element (``w[0, 1]``-style names),
                       reassembled into arrays on the way back
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
from scipy.special import ndtr, ndtri

from metaopt_tpu_torch.space.dimensions import Categorical, Fidelity, Integer, Real
from metaopt_tpu_torch.space.space import Space

_EPS = 1e-12


class UnitCube:
    """Bijection between space points (dicts) and vectors in [0, 1]^d."""

    def __init__(self, space: Space):
        self.space = space
        #: (dimension, element-index-or-None) per cube column: scalar dims
        #: own one column, array-shaped dims expand to one column per
        #: element so surrogate math never sees a ragged structure
        self.columns = []
        for d in space.values():
            if isinstance(d, Fidelity):
                continue
            if d.shape:
                for idx in np.ndindex(d.shape):
                    self.columns.append((d, idx))
            else:
                self.columns.append((d, None))
        #: per-column dimension objects (a shaped dim repeats)
        self.dims = [d for d, _ in self.columns]
        self.names = [
            d.name if idx is None else f"{d.name}{list(idx)}"
            for d, idx in self.columns
        ]
        self.categorical_mask = np.asarray(
            [isinstance(d, Categorical) for d in self.dims]
        )
        #: number of categories per column (1 for non-categorical)
        self.n_choices = np.asarray(
            [len(d.options) if isinstance(d, Categorical) else 1 for d in self.dims]
        )

    @property
    def n_dims(self) -> int:
        return len(self.dims)

    # -- forward ----------------------------------------------------------
    def _fwd_one(self, dim, value) -> float:
        if isinstance(dim, Categorical):
            i = next(j for j, opt in enumerate(dim.options) if opt == value)
            return (i + 0.5) / len(dim.options)
        if isinstance(dim, Integer):
            low, high = dim.interval()
            return (float(value) - (low - 0.5)) / ((high + 0.5) - (low - 0.5))
        assert isinstance(dim, Real)
        if dim.prior_name == "uniform":
            low, high = dim.interval()
            return min(1.0, max(0.0, (float(value) - low) / (high - low)))
        if dim.prior_name == "loguniform":
            low, high = dim.interval()
            return min(
                1.0,
                max(
                    0.0,
                    (math.log(float(value)) - math.log(low))
                    / (math.log(high) - math.log(low)),
                ),
            )
        # normal
        return float(ndtr((float(value) - dim._loc) / dim._scale))

    def transform(self, point: Mapping[str, Any]) -> np.ndarray:
        """Point dict → vector in [0,1]^d (fidelity dropped)."""
        out = []
        arrays: Dict[str, np.ndarray] = {}  # one conversion per shaped dim
        for d, idx in self.columns:
            if idx is None:
                value = point[d.name]
            else:
                arr = arrays.get(d.name)
                if arr is None:
                    # object dtype for categoricals: mixed-type options
                    # must not coerce
                    arr = np.asarray(
                        point[d.name],
                        dtype=object if isinstance(d, Categorical) else None,
                    )
                    arrays[d.name] = arr
                value = arr[idx]
            out.append(self._fwd_one(d, value))
        return np.asarray(out)

    def transform_many(self, points: Sequence[Mapping[str, Any]]) -> np.ndarray:
        """Points → ``(n, n_dims)``, row i being ``transform(points[i])``;
        ``(0, n_dims)`` for no points."""
        if not points:
            return np.zeros((0, self.n_dims))
        return np.stack([self.transform(p) for p in points])

    def transform_columns(
        self, cols: Mapping[str, Sequence[Any]], n: int
    ) -> np.ndarray:
        """Column-major forward transform: per-param value columns (one
        sequence of ``n`` raw values each, the shape ``CompletedBatch.
        columns()`` hands over) → an ``(n, n_dims)`` matrix bit-identical
        row-for-row to ``transform(point)``.

        Uniform reals and integers vectorize over the column — the
        elementwise IEEE ops match the scalar path exactly. Loguniform
        and normal go through the SAME per-element ``math.log`` / scalar
        ``ndtr`` calls as ``_fwd_one`` (a vectorized np.log can differ in
        the last ulp, and the surrogate replay contract is bit-identity
        with the per-point stream). Categorical and array-shaped columns
        reuse ``_fwd_one`` per element: option equality is arbitrary-
        object equality, nothing to vectorize.
        """
        out = np.empty((n, self.n_dims), dtype=np.float64)
        for j, (d, idx) in enumerate(self.columns):
            col = cols[d.name]
            if idx is not None:
                for i in range(n):
                    arr = np.asarray(
                        col[i],
                        dtype=object if isinstance(d, Categorical) else None,
                    )
                    out[i, j] = self._fwd_one(d, arr[idx])
                continue
            if isinstance(d, Real) and d.prior_name == "uniform":
                low, high = d.interval()
                vals = np.asarray([float(v) for v in col], dtype=np.float64)
                np.clip((vals - low) / (high - low), 0.0, 1.0, out=out[:, j])
            elif isinstance(d, Integer):
                low, high = d.interval()
                vals = np.asarray([float(v) for v in col], dtype=np.float64)
                out[:, j] = (vals - (low - 0.5)) / ((high + 0.5) - (low - 0.5))
            else:
                for i in range(n):
                    out[i, j] = self._fwd_one(d, col[i])
        return out

    # -- backward ---------------------------------------------------------
    def _bwd_one(self, dim, u: float):
        u = min(1.0 - _EPS, max(_EPS, float(u)))
        if isinstance(dim, Categorical):
            i = min(len(dim.options) - 1, int(u * len(dim.options)))
            return dim.options[i]
        if isinstance(dim, Integer):
            low, high = dim.interval()
            v = (low - 0.5) + u * ((high + 0.5) - (low - 0.5))
            return int(min(high, max(low, round(v))))
        assert isinstance(dim, Real)
        if dim.prior_name == "uniform":
            low, high = dim.interval()
            return low + u * (high - low)
        if dim.prior_name == "loguniform":
            low, high = dim.interval()
            return math.exp(math.log(low) + u * (math.log(high) - math.log(low)))
        return dim._loc + dim._scale * float(ndtri(u))

    def untransform(self, vec: np.ndarray) -> Dict[str, Any]:
        """Vector in [0,1]^d → point dict (without fidelity)."""
        vec = np.asarray(vec)
        if vec.shape != (self.n_dims,):
            raise ValueError(f"expected shape ({self.n_dims},), got {vec.shape}")
        out: Dict[str, Any] = {}
        pending: Dict[str, Dict[tuple, Any]] = {}
        for (d, idx), u in zip(self.columns, vec):
            if idx is None:
                out[d.name] = self._bwd_one(d, u)
            else:
                pending.setdefault(d.name, {})[idx] = self._bwd_one(d, u)
        for (d, idx) in self.columns:  # reassemble shaped dims
            if idx is None or d.name in out:
                continue
            elems = pending[d.name]
            arr = np.empty(d.shape, dtype=object)
            for i, v in elems.items():
                arr[i] = v
            if isinstance(d, Integer):
                arr = arr.astype(np.int64)
            elif isinstance(d, Real):
                arr = arr.astype(np.float64)
            else:
                # Categorical: nested list, NOT np.asarray — mixed-type
                # options (e.g. [1, 'a']) must not coerce to one dtype
                arr = arr.tolist()
            out[d.name] = arr
        return out

    def untransform_many(self, mat: np.ndarray) -> List[Dict[str, Any]]:
        return [self.untransform(row) for row in np.asarray(mat)]
