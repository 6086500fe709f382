"""Closed-form CPU objectives (BASELINE config 1 and test fodder).

Port of ``metaopt_tpu/models/objectives.py``, trimmed to the scalar
functions; their column forms come with the batched executor. Pure
Python: importing this module loads no ``torch``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict


def rosenbrock(params: Dict[str, Any]) -> float:
    """Rosenbrock-2D: minimum 0 at (a, a^2); classic a=1, b=100."""
    x, y = float(params["x"]), float(params["y"])
    a, b = 1.0, 100.0
    return (a - x) ** 2 + b * (y - x * x) ** 2


def rosenbrock_nd(params: Dict[str, Any]) -> float:
    """N-D Rosenbrock over params named x0..xN sorted by index."""
    xs = [float(v) for _, v in sorted(params.items()) if _.startswith("x")]
    return sum(
        100.0 * (xs[i + 1] - xs[i] ** 2) ** 2 + (1.0 - xs[i]) ** 2
        for i in range(len(xs) - 1)
    )


def sphere(params: Dict[str, Any]) -> float:
    return sum(float(v) ** 2 for v in params.values())


def branin(params: Dict[str, Any]) -> float:
    """Branin-Hoo on x∈[-5,10], y∈[0,15]; min ≈ 0.397887."""
    x, y = float(params["x"]), float(params["y"])
    a, b, c = 1.0, 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return a * (y - b * x * x + c * x - r) ** 2 + s * (1 - t) * math.cos(x) + s


def make_objective(name: str) -> Callable[[Dict[str, Any]], float]:
    table = {
        "rosenbrock": rosenbrock,
        "rosenbrock_nd": rosenbrock_nd,
        "sphere": sphere,
        "branin": branin,
    }
    return table[name]
