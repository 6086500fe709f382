"""Optimization algorithms (port of ``metaopt_tpu.algo``).

Only what is ported is registered: the :class:`BaseAlgorithm` contract, the
registry, :func:`make_algorithm` and :class:`Random`. The others (TPE and
the rest) are queued in ROADMAP.md.
"""

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry, make_algorithm
from metaopt_tpu_torch.algo.random_search import Random

__all__ = ["BaseAlgorithm", "algo_registry", "make_algorithm", "Random"]
