"""Placement of batches and parameters on a mesh (port of
``metaopt_tpu/parallel/sharding.py``).

Under GSPMD a tensor is one global array laid out by a ``PartitionSpec``;
here each rank holds its own slice, cut explicitly:

- :func:`shard_batch` — this rank's rows of a batch (batch over ``dp``);
- :func:`replicate` — the whole tree on this rank;
- :func:`shard_params` — the weights-across function: the full parameters
  (``models/transformer.py::params_from_flax`` gives them) cut to this
  rank's ``tp``/``ep``/``pp`` slice, laid out as the reference's partition
  specs lay out that device's shard (:func:`model_spec`).

The reference's ``MeshTolerantPartitioned`` (axis names a partial mesh
lacks stay replicated) and ``pin_batch_layout`` (a constraint that stops
GSPMD from re-partitioning a derived token tensor) are flax/XLA layout
devices with no counterpart: the explicit slicing skips axes the mesh
lacks (:meth:`MeshAxes.size` is 1 there) and every tensor already lives
where its rank computes it.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from metaopt_tpu_torch.parallel.mesh import axes_group, axis_index, axis_size

#: the reference's axis names
AXES = ("dp", "tp", "sp", "ep", "pp")

Spec = Tuple[Optional[str], ...]


class MeshAxes:
    """One rank's view of a mesh (None: one rank): each axis's size, this
    rank's index on it and its group, and the two composite groups the
    models use — ``data`` (the ranks that hold other tokens: dp × sp) and
    ``expert`` (the ranks that share tokens but hold other expert or hidden
    slices: ep × tp). Built on every rank in the same order (it creates the
    composite groups)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = {a: axis_size(mesh, a) for a in AXES}
        self.index = {a: axis_index(mesh, a) for a in AXES}
        self.groups = {a: axes_group(mesh, (a,)) for a in AXES}
        self.data = axes_group(mesh, ("dp", "sp"))
        self.expert = axes_group(mesh, ("ep", "tp"))

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def chunk(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` over ``axis``."""
        n = self.sizes[axis]
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(t.shape)} does not split over "
                             f"{axis} = {n}")
        step = t.shape[dim] // n
        return t.narrow(dim, self.index[axis] * step, step)

    def local(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """``t`` cut along every dim whose spec names an axis."""
        for dim, axis in enumerate(spec):
            if axis == "pp":
                t = pp_slice(t, self.sizes["pp"], self.index["pp"])
            elif axis is not None:
                t = self.chunk(t, dim, axis)
        return t


def pp_slice(t: torch.Tensor, n_stages: int, d: int) -> torch.Tensor:
    """Device ``d``'s logical stages d, P + d, 2P + d, … of a (P·V, ...)
    stack: the reference's (V, P, ...) reshape with the P axis sharded."""
    if t.shape[0] % n_stages:
        raise ValueError(f"{t.shape[0]} stages do not split over pp = {n_stages}")
    return t.view(t.shape[0] // n_stages, n_stages, *t.shape[1:])[:, d]


# the reference's partition specs in the port's parameter layout: torch
# Linear weights are (out, in); the MoE tables keep flax's (E, in, out)
_SPECS = (
    (r"\.(q|k|v)\.weight$", ("tp", None)),
    (r"\.(q|k|v)\.bias$", ("tp",)),
    (r"\.out\.weight$", (None, "tp")),
    (r"mlp\.wi\.weight$", ("tp", None)),
    (r"mlp\.wi\.bias$", ("tp",)),
    (r"mlp\.wo\.weight$", (None, "tp")),
    (r"mlp\.wi$", ("ep", None, "tp")),
    (r"mlp\.wo$", ("ep", "tp", None)),
)


def model_spec(name: str, leaf: torch.Tensor) -> Optional[Spec]:
    """The Transformer and LM rule: Megatron's column split of q/k/v and wi
    over ``tp`` and row split of out and wo, the experts over ``ep``;
    everything else (embeddings, norms, the router, row-split biases)
    replicated (None)."""
    for pattern, spec in _SPECS:
        if re.search(pattern, name) and len(spec) == leaf.dim():
            return spec
    return None


def batch_spec(mesh) -> Spec:
    """Batch over ``dp`` (leading dim), replicated elsewhere."""
    return ("dp",) if axis_size(mesh, "dp") > 1 else ()


def shard_batch(mesh, batch: Any, device=None) -> Any:
    """This rank's ``dp`` rows of a batch (a tensor or a tuple/list of them)."""
    axes = MeshAxes(mesh) if not isinstance(mesh, MeshAxes) else mesh
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(axes, b, device) for b in batch)
    out = axes.chunk(batch, 0, "dp")
    return out if device is None else out.to(device)


def replicate(mesh, tree: Any, device=None) -> Any:
    """The whole tree on this rank (each rank holds its own copy)."""
    if device is None:
        return tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, t, device) for t in tree)
    if isinstance(tree, Mapping):
        return {k: replicate(mesh, v, device) for k, v in tree.items()}
    return tree.to(device)


def shard_params(mesh, params: Mapping[str, torch.Tensor],
                 rule: Optional[Callable[[str, torch.Tensor], Optional[Spec]]] = model_spec
                 ) -> Dict[str, torch.Tensor]:
    """This rank's slice of every parameter, by ``rule(name, leaf)`` → a
    spec (an axis name or None per dim); None replicates. The default is
    :func:`model_spec`."""
    axes = MeshAxes(mesh) if not isinstance(mesh, MeshAxes) else mesh
    out = {}
    for name, leaf in params.items():
        spec = rule(name, leaf) if rule else None
        out[name] = leaf if spec is None else axes.local(leaf, spec).contiguous()
    return out


def local_sizes(axes: MeshAxes, **sizes: Tuple[int, str]) -> Dict[str, int]:
    """``local_sizes(axes, heads=(8, "tp"))`` → {"heads": 8 / tp}, raising
    where a size does not split over its axis."""
    out = {}
    for key, (n, axis) in sizes.items():
        k = axes.size(axis)
        if n % k:
            raise ValueError(f"{key} = {n} does not split over {axis} = {k}")
        out[key] = n // k
    return out

