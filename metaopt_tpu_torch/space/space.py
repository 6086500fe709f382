"""The joint search space: an ordered mapping of named dimensions.

ref: src/metaopt/algo/space.py (``Space`` as an ordered dict of Dimensions;
joint ``sample`` returns per-dimension tuples). Points here are plain dicts
``{name: value}`` — friendlier than positional tuples and unambiguous under
space transforms.

Port of ``metaopt_tpu/space/space.py`` without the vectorization helpers
(``why_not_vectorizable``, ``stack_points``, ``unstack_points``), which only
the batched executor and the fleet-fused suggest plane reach.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np

from metaopt_tpu_torch.space.dimensions import Dimension, Fidelity
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

    # -- config -----------------------------------------------------------
    @property
    def configuration(self) -> Dict[str, Any]:
        return {name: dim.get_prior_string() for name, dim in self._dims.items()}

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}: {d.get_prior_string()}" for n, d in self._dims.items())
        return f"Space({{{inner}}})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Space) and list(self.items()) == list(other.items())
