"""Lint fixture: unhashable literal bound to a static_argnames param."""

import functools

import jax


@functools.partial(jax.jit, static_argnames=("shape",))
def filled(x, shape=None):
    return x


def caller(x):
    return filled(x, shape=[4, 4])
