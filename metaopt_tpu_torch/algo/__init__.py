"""Optimization algorithms (port of ``metaopt_tpu.algo``).

Only what is ported is registered: the :class:`BaseAlgorithm` contract with
the :class:`SuggestAhead` mixin, the registry, :func:`make_algorithm`,
:class:`Random`, :class:`TPE` and :class:`ASHA`. The others are queued in
ROADMAP.md.
"""

from metaopt_tpu_torch.algo.base import (
    BaseAlgorithm,
    SuggestAhead,
    algo_registry,
    make_algorithm,
)
from metaopt_tpu_torch.algo.asha import ASHA
from metaopt_tpu_torch.algo.obs_buffer import ObservationBuffer
from metaopt_tpu_torch.algo.random_search import Random
from metaopt_tpu_torch.algo.tpe import TPE

__all__ = ["ASHA", "BaseAlgorithm", "SuggestAhead", "algo_registry", "make_algorithm",
           "ObservationBuffer", "Random", "TPE"]
