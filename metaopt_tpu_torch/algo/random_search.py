"""Random search.

ref: src/metaopt/algo/random.py — ``space.sample(num, seed)``, stateless
(SURVEY.md §2.3, BASELINE config 1).
"""

from __future__ import annotations

from typing import Any, Dict, List

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry


@algo_registry.register("random")
class Random(BaseAlgorithm):
    """Uniform joint sampling from the space priors."""

    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        return self.space.sample(num, seed=self.rng)
