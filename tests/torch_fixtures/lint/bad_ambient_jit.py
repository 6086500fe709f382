"""Lint fixture: jit body reading ambient mutable context at trace time.

``kernel`` is jitted and calls ``active_mesh()``; ``helper`` shows the
transitive case — it is only traced because ``kernel`` calls it.
"""

import jax


def active_mesh():
    return None


def helper(x):
    return x if active_mesh() is None else x * 2


@jax.jit
def kernel(x):
    return helper(x) + 1
