"""The joint search space: an ordered mapping of named dimensions.

ref: src/metaopt/algo/space.py (``Space`` as an ordered dict of Dimensions;
joint ``sample`` returns per-dimension tuples). Points here are plain dicts
``{name: value}`` — friendlier than positional tuples and unambiguous under
space transforms.

Port of ``metaopt_tpu/space/space.py``, with the vectorization contract
(``why_not_vectorizable``, ``stack_points``, ``unstack_points``) that the
batched executor reads: numpy columns, the reference's dtypes and errors.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from metaopt_tpu_torch.space.dimensions import (
    Categorical,
    Dimension,
    Fidelity,
    Integer,
    Real,
)
from metaopt_tpu_torch.utils.hashing import point_hash

# fidelity-cache sentinel (None is a valid cached value); a str is
# deepcopy-atomic, so a copied Space still compares ``is _UNSET`` correctly
_UNSET = "__fidelity_unset__"


class Space:
    """Ordered collection of :class:`Dimension`, keyed by name."""

    def __init__(self, dimensions: Optional[Mapping[str, Dimension] | List[Dimension]] = None):
        self._dims: Dict[str, Dimension] = {}
        self._fidelity_cache: Any = _UNSET
        if dimensions:
            items = (
                dimensions.values() if isinstance(dimensions, Mapping) else dimensions
            )
            for dim in items:
                self.register(dim)

    # -- container --------------------------------------------------------
    def register(self, dim: Dimension) -> None:
        if dim.name in self._dims:
            raise ValueError(f"dimension {dim.name!r} already in space")
        self._dims[dim.name] = dim
        self._fidelity_cache = _UNSET

    def __getitem__(self, name: str) -> Dimension:
        return self._dims[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._dims)

    def __len__(self) -> int:
        return len(self._dims)

    def items(self):
        return self._dims.items()

    def values(self):
        return list(self._dims.values())

    def keys(self):
        return list(self._dims)

    # -- fidelity ---------------------------------------------------------
    @property
    def fidelity(self) -> Optional[Fidelity]:
        """The (single) fidelity dimension, if any.

        Cached (``register`` invalidates): ``hash_point`` reads this on
        every trial-identity hash, which is per-registration hot.
        """
        if self._fidelity_cache is _UNSET:
            fids = [d for d in self._dims.values() if isinstance(d, Fidelity)]
            if len(fids) > 1:
                raise ValueError(
                    f"multiple fidelity dimensions: {[f.name for f in fids]}"
                )
            self._fidelity_cache = fids[0] if fids else None
        return self._fidelity_cache

    @property
    def searchable(self) -> List[Dimension]:
        """Dimensions the optimizer actually searches (everything non-fidelity)."""
        return [d for d in self._dims.values() if not isinstance(d, Fidelity)]

    # -- sampling / geometry ----------------------------------------------
    def sample(self, n: int = 1, seed=None) -> List[Dict[str, Any]]:
        """Joint sample of ``n`` points as dicts (fidelity set to max budget)."""
        rng = np.random.default_rng(seed) if not isinstance(seed, np.random.Generator) else seed
        cols = {name: dim.sample(n, rng) for name, dim in self._dims.items()}
        return [{name: cols[name][i] for name in self._dims} for i in range(n)]

    def __contains__(self, point) -> bool:
        if isinstance(point, str):
            return point in self._dims
        if not isinstance(point, Mapping):
            return False
        if set(point) != set(self._dims):
            return False
        return all(point[name] in dim for name, dim in self._dims.items())

    def hash_point(self, point: Mapping[str, Any], *, with_fidelity: bool = False) -> str:
        """Identity hash of a point; by default fidelity is excluded so a

        promoted trial (same params, higher budget) shares a lineage id with
        its parent — the key ASHA bookkeeping invariant.
        """
        fid = self.fidelity
        ignore = () if (with_fidelity or fid is None) else (fid.name,)
        return point_hash(point, ignore=ignore)

    @property
    def cardinality(self) -> float:
        card = 1.0
        for dim in self._dims.values():
            card *= dim.cardinality
        return card

    # -- vectorization ----------------------------------------------------
    def why_not_vectorizable(self) -> Optional[str]:
        """Reason this space cannot stack into device arrays, or None.

        A space is vectorizable when every dimension is a scalar
        Real/Integer/Categorical/Fidelity: reals and ints lower to float
        columns, categoricals to index columns (branchless ``torch.take`` /
        ``torch.where`` on the objective side), and the single fidelity dim
        is carried out-of-band (it must be constant per batch anyway).
        Shaped dimensions would need ragged stacking, so they opt out.
        """
        for name, dim in self._dims.items():
            if dim.shape:
                return f"dimension {name!r} is array-valued (shape={dim.shape})"
            if not isinstance(dim, (Real, Integer, Categorical, Fidelity)):
                return f"dimension {name!r} has unsupported type {dim.type!r}"
        return None

    def vectorizable(self) -> bool:
        """True when a pool of points can stack into homogeneous arrays."""
        return self.why_not_vectorizable() is None

    def stack_points(
        self, points: Sequence[Mapping[str, Any]]
    ) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
        """Stack a homogeneous pool of points into per-dimension columns.

        Returns ``(cols, fidelity)`` where ``cols`` maps each non-fidelity
        dimension name to a ``(B,)`` numpy column — float64 for Real,
        int32 for Integer, int32 *option indices* for Categorical — and
        ``fidelity`` is the batch's single budget value (None if the space
        has no fidelity dim). Raises ValueError when the space is not
        vectorizable, the pool is empty, or fidelity varies across the
        batch: a mixed-fidelity pool is two device programs, not one.
        """
        reason = self.why_not_vectorizable()
        if reason is not None:
            raise ValueError(f"space is not vectorizable: {reason}")
        if not points:
            raise ValueError("cannot stack an empty pool")
        cols: Dict[str, np.ndarray] = {}
        fid = self.fidelity
        fid_value: Optional[int] = None
        if fid is not None:
            budgets = {int(p[fid.name]) for p in points if fid.name in p}
            if len(budgets) > 1:
                raise ValueError(
                    f"fidelity {fid.name!r} must be constant per batch, "
                    f"got {sorted(budgets)}"
                )
            fid_value = budgets.pop() if budgets else None
        for name, dim in self._dims.items():
            if isinstance(dim, Fidelity):
                continue
            raw = [p[name] for p in points]
            if isinstance(dim, Categorical):
                index = {repr(opt): i for i, opt in enumerate(dim.options)}
                try:
                    cols[name] = np.asarray(
                        [index[repr(v)] for v in raw], dtype=np.int32
                    )
                except KeyError as exc:
                    raise ValueError(
                        f"value {exc} not an option of {name!r}"
                    ) from None
            elif isinstance(dim, Integer):
                cols[name] = np.asarray([int(v) for v in raw], dtype=np.int32)
            else:
                cols[name] = np.asarray([float(v) for v in raw], dtype=np.float64)
        return cols, fid_value

    def unstack_points(
        self,
        cols: Mapping[str, np.ndarray],
        fidelity: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Inverse of :meth:`stack_points`: columns back to point dicts.

        Categorical index columns are mapped back to their option objects;
        the fidelity value (if given) is broadcast into every point.
        """
        sizes = {len(np.asarray(c)) for c in cols.values()}
        if len(sizes) != 1:
            raise ValueError(f"ragged columns: lengths {sorted(sizes)}")
        (batch,) = sizes
        fid = self.fidelity
        points: List[Dict[str, Any]] = []
        for i in range(batch):
            pt: Dict[str, Any] = {}
            for name, dim in self._dims.items():
                if isinstance(dim, Fidelity):
                    if fidelity is not None:
                        pt[name] = int(fidelity)
                    continue
                v = np.asarray(cols[name])[i]
                if isinstance(dim, Categorical):
                    pt[name] = dim.options[int(v)]
                elif isinstance(dim, Integer):
                    pt[name] = int(v)
                else:
                    pt[name] = float(v)
            points.append(pt)
        return points

    # -- config -----------------------------------------------------------
    @property
    def configuration(self) -> Dict[str, Any]:
        return {name: dim.get_prior_string() for name, dim in self._dims.items()}

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}: {d.get_prior_string()}" for n, d in self._dims.items())
        return f"Space({{{inner}}})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Space) and list(self.items()) == list(other.items())
