"""Optimization algorithms (port of ``metaopt_tpu.algo``).

The :class:`BaseAlgorithm` contract (``suggest / observe / is_done / score
/ judge / should_suspend / configuration / seed_rng``, with
``state_dict`` / ``load_state_dict``), the :class:`SuggestAhead` mixin,
the registry and :func:`make_algorithm`, and every algorithm of the
reference: :class:`Random`, :class:`GridSearch` (lazy lattice over the
UnitCube), :class:`GradientDescent` (the gradient-result protocol),
:class:`TPE` (EI on the card), :class:`Hyperband`, :class:`ASHA`,
:class:`BOHB`, :class:`EvolutionES`, :class:`PBT` (exploit/explore with
checkpoint lineage), :class:`DEHB`, :class:`CMAES`, :class:`GPBO` (GP-EI
with the incremental Cholesky factor on the card) and :class:`MOTPE`
(NSGA-II ordering fed to TPE). Not ported yet: the coordinator's
fleet-fused hooks.

The algorithm modules load on first use: a class imported from here, or a
name built by :func:`make_algorithm`. Only TPE, MOTPE, BOHB and GP-BO (and
the observation buffer) import torch.
"""

import importlib

from metaopt_tpu_torch.algo.base import (
    BaseAlgorithm,
    SuggestAhead,
    algo_registry,
    make_algorithm,
)

#: class name → the module that defines it, imported on first access
#: (``make_algorithm`` loads them by registered name: see
#: ``base.BUILTIN_MODULES``)
_LAZY = {
    "ASHA": "asha", "BOHB": "bohb", "CMAES": "cmaes", "DEHB": "dehb",
    "EvolutionES": "evolution_es", "GPBO": "gp_bo", "GradientDescent": "gradient_descent",
    "GridSearch": "grid_search", "Hyperband": "hyperband", "MOTPE": "motpe",
    "ObservationBuffer": "obs_buffer", "PBT": "pbt", "Random": "random_search", "TPE": "tpe",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BaseAlgorithm", "SuggestAhead", "algo_registry", "make_algorithm", *_LAZY]
