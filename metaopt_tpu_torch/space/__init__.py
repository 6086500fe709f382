"""Typed search space (port of ``metaopt_tpu.space``).

Sampling is host-side control-plane work over ``numpy.random.Generator``,
so the port draws exactly the reference's points for a given seed.
"""

from metaopt_tpu_torch.space.dimensions import (
    Categorical,
    Dimension,
    Fidelity,
    Integer,
    Real,
)
from metaopt_tpu_torch.space.space import Space
from metaopt_tpu_torch.space.builder import PriorSyntaxError, build_space, parse_prior
from metaopt_tpu_torch.space.transforms import UnitCube

__all__ = [
    "Dimension",
    "Real",
    "Integer",
    "Categorical",
    "Fidelity",
    "Space",
    "PriorSyntaxError",
    "parse_prior",
    "build_space",
    "UnitCube",
]
