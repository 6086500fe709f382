"""Lint fixture: reading a buffer after passing it in a donated slot.

``scaled`` donates argument 0; ``caller`` keeps using ``buf`` after the
call without reassigning it — on device the buffer is already gone.
"""

import functools

import jax


@functools.partial(jax.jit, donate_argnums=(0,))
def scaled(buf, v):
    return buf * v


def caller(buf):
    out = scaled(buf, 2.0)
    return out + buf.sum()
