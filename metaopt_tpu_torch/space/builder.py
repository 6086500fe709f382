"""The ``name~prior(...)`` DSL: parse prior expressions into a Space.

Port of ``metaopt_tpu/space/builder.py``, trimmed to what
``build_experiment`` reaches: :func:`parse_prior` and :func:`build_space`.
The command-line scanner (``SpaceBuilder``) and ``CommandTemplate`` come
with the ``hunt`` CLI.

Prior expressions are evaluated with a restricted AST walker (literals
only), never ``eval``.
"""

from __future__ import annotations

import ast
from typing import Any, Mapping

from metaopt_tpu_torch.space.dimensions import (
    Categorical,
    Dimension,
    Fidelity,
    Integer,
    Real,
)
from metaopt_tpu_torch.space.space import Space

#: prior-name → dimension class routing (``discrete=True`` reroutes to Integer)
_REAL_PRIORS = {"uniform", "loguniform", "normal"}
_INT_PRIORS = {"randint"}


class PriorSyntaxError(ValueError):
    pass


def _literal(node: ast.expr, src: str) -> Any:
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        raise PriorSyntaxError(
            f"prior arguments must be literals, got {ast.dump(node)} in {src!r}"
        ) from None


def parse_prior(name: str, expr: str) -> Dimension:
    """``parse_prior('lr', 'loguniform(1e-5, 1e-1)')`` → a typed Dimension.

    The expression is parsed as a single call with literal args/kwargs only —
    a restricted, safe replacement for the lineage's eval-against-scipy-names.
    """
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError as e:
        raise PriorSyntaxError(f"cannot parse prior {expr!r} for {name!r}: {e}") from None
    call = tree.body
    if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Name):
        raise PriorSyntaxError(f"prior must be a simple call, got {expr!r}")
    prior = call.func.id.lower()
    args = [_literal(a, expr) for a in call.args]
    kwargs = {}
    for kw in call.keywords:
        if kw.arg is None:
            raise PriorSyntaxError(f"**kwargs not allowed in prior {expr!r}")
        kwargs[kw.arg] = _literal(kw.value, expr)

    shape = kwargs.pop("shape", None)
    if shape is not None:
        shape = tuple(shape) if isinstance(shape, (list, tuple)) else (int(shape),)
    default_value = kwargs.pop("default_value", None)
    common = dict(shape=shape, default_value=default_value)

    if prior == "fidelity":
        return Fidelity(name, prior, *args, **{**kwargs, **common})
    if prior == "choices":
        return Categorical(name, prior, *args, **{**kwargs, **common})
    if prior in _INT_PRIORS or (prior in _REAL_PRIORS and kwargs.pop("discrete", False)):
        if prior == "normal":
            raise PriorSyntaxError("normal prior cannot be discrete")
        return Integer(name, prior, *args, **{**kwargs, **common})
    if prior in _REAL_PRIORS:
        return Real(name, prior, *args, **{**kwargs, **common})
    raise PriorSyntaxError(
        f"unknown prior {prior!r} in {expr!r}; known: uniform, loguniform, "
        f"normal, randint, choices, fidelity"
    )


def build_space(spec: Mapping[str, str]) -> Space:
    """Build a Space from ``{name: 'prior(...)'}`` (configuration round-trip)."""
    space = Space()
    for name, expr in spec.items():
        expr = expr.strip()
        if expr.startswith("~"):
            expr = expr[1:]
        space.register(parse_prior(name, expr))
    return space
