"""Grid search: deterministic sweep over a lattice of the search space.

Port of ``metaopt_tpu/algo/grid_search.py``, unchanged. The grid is uniform
in the unit cube and mapped back through each dimension's transform, so
log-scaled dimensions get log-spaced grids and integer/categorical
dimensions enumerate their (capped) distinct values at cell centers.

The lattice is enumerated lazily by mixed-radix index (never materialized),
so ``suggest`` walks the first ``max_trials``-worth of points and
``is_done`` flips when the cursor runs off the end.

Config: ``n_values`` (points per dimension), ``seed``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.space import Space, UnitCube


@algo_registry.register("grid_search")
class GridSearch(BaseAlgorithm):
    def __init__(
        self,
        space: Space,
        n_values: int = 10,
        seed: Optional[int] = None,
        **config: Any,
    ):
        super().__init__(space, n_values=n_values, seed=seed, **config)
        self.n_values = int(n_values)
        self.cube = UnitCube(space)

        # per-dimension grid coordinates in the unit cube
        self._axes: List[np.ndarray] = []
        for j in range(self.cube.n_dims):
            k = int(self.cube.n_choices[j])
            if k > 1:  # categorical: every choice, at its bucket center
                self._axes.append((np.arange(k) + 0.5) / k)
            else:
                card = self._dim_cardinality(j)
                n = self.n_values if card is None else min(self.n_values, card)
                n = max(2, int(n)) if (card is None or card > 1) else 1
                # cell centers, not endpoints: round-trips exactly through
                # integer quantization and avoids doubled boundary points
                self._axes.append((np.arange(n) + 0.5) / n)
        self._sizes = [len(a) for a in self._axes]
        # exact Python-int product: np.prod would silently wrap int64 for
        # big lattices and truncate the sweep
        self._total = math.prod(self._sizes)
        self._cursor = 0

    def _dim_cardinality(self, j: int) -> Optional[int]:
        """Per-COLUMN (element) cardinality — a shaped dim's column owns one
        element, not the whole array's cartesian product."""
        from metaopt_tpu_torch.space.dimensions import Integer

        dim = self.cube.dims[j]
        if isinstance(dim, Integer):
            low, high = dim.interval()
            return int(high - low + 1)
        card = getattr(dim, "cardinality", None)
        if card is None or card == float("inf"):
            return None
        return int(card)

    def _point_at(self, index: int) -> Dict[str, Any]:
        vec = np.empty(self.cube.n_dims)
        rem = index
        for j in range(self.cube.n_dims - 1, -1, -1):
            rem, digit = divmod(rem, self._sizes[j])
            vec[j] = self._axes[j][digit]
        point = self.cube.untransform(vec)
        fid = self.space.fidelity
        if fid is not None:
            point[fid.name] = fid.high
        return point

    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        out = []
        while len(out) < num and self._cursor < self._total:
            out.append(self._point_at(self._cursor))
            self._cursor += 1
        return out

    @property
    def is_done(self) -> bool:
        return self._cursor >= self._total or super().is_done

    # -- persistence --------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["cursor"] = self._cursor
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._cursor = int(state.get("cursor", 0))
