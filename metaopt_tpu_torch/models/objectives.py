"""Closed-form CPU objectives (BASELINE config 1 and test fodder), and the
vectorized zoo the batched hunt evaluates.

Port of ``metaopt_tpu/models/objectives.py``. The scalar functions are pure
Python; the column forms and the MLP zoo are ``torch``, imported inside the
functions: importing this module loads no ``torch``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple


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


# -- vectorized zoo -------------------------------------------------------
#
# Column-form variants for the BatchedExecutor: each takes the
# ``Space.stack_points`` layout ``{name: (B,) column}`` and returns a
# ``(B,)`` float32 tensor on the columns' device, so an entire suggestion
# pool is one call. The mlp objective is the "zoo" flavor: a tiny
# regression net whose init and train steps run for the whole pool at once
# — k trials' parameters stacked along a leading axis and trained together.

#: search-space DSL for the batched mlp train objective
MLP_SPACE: Dict[str, str] = {
    "lr": "loguniform(0.001, 1.0)",
    "init": "uniform(0.1, 2.0)",
}


def f32_column(col):
    """A column (numpy or tensor) as a float32 tensor on its own device —
    cast before any arithmetic, as the reference's ``jnp.asarray(c,
    jnp.float32)`` does."""
    import torch

    return torch.as_tensor(col).to(torch.float32)


def rosenbrock_batch(cols) -> Any:
    """Column form of :func:`rosenbrock` over ``{'x','y'}``."""
    x, y = f32_column(cols["x"]), f32_column(cols["y"])
    return (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2


def sphere_batch(cols) -> Any:
    """Column form of :func:`sphere` over any all-real column dict."""
    return sum(f32_column(c) ** 2 for c in cols.values())


def branin_batch(cols) -> Any:
    """Column form of :func:`branin` over ``{'x','y'}``."""
    import torch

    x, y = f32_column(cols["x"]), f32_column(cols["y"])
    b, c = 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
    s, t = 10.0, 1.0 / (8 * math.pi)
    return (y - b * x * x + c * x - 6.0) ** 2 + s * (1 - t) * torch.cos(x) + s


class ZooDraws:
    """The zoo's four draws — the data ``X`` (n, d), the target weights
    (d,), the first layer ``W1`` (d, width) and the readout ``w2`` (width,),
    standard normal f32 — from a CPU ``torch.Generator`` seeded with
    ``seed``, so every device gets the same ones. The reference draws them
    from threefry ``PRNGKey(0)`` split in four; its arrays come in through
    :class:`GivenZooDraws`."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def take(self, n: int, d: int, width: int) -> Tuple[Any, Any, Any, Any]:
        import torch

        g = torch.Generator().manual_seed(self.seed)
        return tuple(torch.randn(shape, generator=g)
                     for shape in ((n, d), (d,), (d, width), (width,)))


class GivenZooDraws:
    """The zoo's four draws fixed in advance (the tests feed the reference's
    threefry arrays), checked against the shapes the zoo asks for."""

    def __init__(self, X, target, W1, w2):
        self._arrays = (X, target, W1, w2)

    def take(self, n: int, d: int, width: int) -> Tuple[Any, Any, Any, Any]:
        import numpy as np
        import torch

        out = tuple(torch.tensor(np.asarray(a, dtype=np.float32))
                    for a in self._arrays)
        want = ((n, d), (d,), (d, width), (width,))
        if tuple(tuple(t.shape) for t in out) != want:
            raise ValueError(f"given draws of shapes {[tuple(t.shape) for t in out]}, "
                             f"the zoo needs {list(want)}")
        return out


def _mlp_core(width: int, steps: int, n: int, d: int, draws=None):
    """The pool's train core: (lr, init_scale) ``(B,)`` f32 columns →
    ``(B,)`` final train losses, on the columns' device.

    Each trial is the reference's: a tanh MLP on a fixed synthetic
    regression set (``y = tanh(X @ target)``), initialized as ``W1 *
    init``, ``w2 * init`` and zero biases, trained by ``steps`` plain
    gradient steps at its own ``lr`` (the reference's ``scan`` of
    ``jax.grad``), the loss taken after the last. The pool's parameters
    are stacked along a leading axis: ``(B, d, width)``, ``(B, width)``,
    ``(B, width)`` and ``(B,)``. The trials are independent, so the
    gradient of the summed losses, slice by slice, is each trial's own.
    It is taken with ``torch.autograd.grad``, never ``torch.func.grad``,
    whose first call imports ``torch._dynamo`` (~11 s in a fresh process
    on the card's host). The products are plain ``torch.matmul``, as the
    reference computes them in XLA.
    """
    import torch

    base = (draws if draws is not None else ZooDraws()).take(n, d, width)
    on_device: Dict[Any, Sequence[Any]] = {}

    def loss(X, y, W1, b1, w2, b2):
        h = torch.tanh(torch.matmul(X, W1) + b1[:, None, :])          # (B, n, width)
        pred = torch.matmul(h, w2[:, :, None])[..., 0] + b2[:, None]  # (B, n)
        return ((pred - y) ** 2).mean(-1)                             # (B,)

    def core(lr, init_scale):
        dev = lr.device
        if dev not in on_device:
            X, target, W1, w2 = (t.to(dev) for t in base)
            on_device[dev] = (X, torch.tanh(X @ target), W1, w2)
        X, y, W1, w2 = on_device[dev]
        b = lr.shape[0]
        s = init_scale[:, None]
        params = [W1 * s[:, :, None], torch.zeros(b, width, device=dev),
                  w2 * s, torch.zeros(b, device=dev)]
        rates = [lr[:, None, None], lr[:, None], lr[:, None], lr]
        with torch.enable_grad():
            for _ in range(steps):
                p = [q.detach().requires_grad_() for q in params]
                grads = torch.autograd.grad(loss(X, y, *p).sum(), p)
                params = [q.detach() - r * g for q, r, g in zip(p, rates, grads)]
        with torch.no_grad():
            return loss(X, y, *params)

    return core


def make_mlp_objective(
    width: int = 16, steps: int = 12, n: int = 64, d: int = 8,
    device=None, draws=None,
) -> Callable[[Dict[str, Any]], float]:
    """Per-trial zoo objective: the pool core at B = 1, one call and one
    device-to-host copy per evaluation (the reference's jitted dispatch
    per trial). Runs on ``device`` (default ``cuda``; raises without it)."""
    import torch

    from metaopt_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    core = _mlp_core(width, steps, n, d, draws)

    def objective(params: Dict[str, Any]) -> float:
        col = lambda v: torch.tensor([float(v)], dtype=torch.float32, device=dev)  # noqa: E731
        return float(core(col(params["lr"]), col(params["init"]))[0])

    return objective


def make_mlp_batch_objective(
    width: int = 16, steps: int = 12, n: int = 64, d: int = 8, draws=None,
):
    """Vectorized zoo objective: init + train of the whole pool at once, on
    the device its columns lie on."""
    core = _mlp_core(width, steps, n, d, draws)

    def batch(cols):
        return core(f32_column(cols["lr"]), f32_column(cols["init"]))

    return batch


def make_batch_objective(name: str):
    """Vectorized objective lookup, mirroring :func:`make_objective`."""
    if name == "mlp":
        return make_mlp_batch_objective()
    table = {
        "rosenbrock": rosenbrock_batch,
        "sphere": sphere_batch,
        "branin": branin_batch,
    }
    return table[name]
