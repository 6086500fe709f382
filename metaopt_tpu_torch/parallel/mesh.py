"""Device meshes over a trial's ranks (port of ``metaopt_tpu/parallel/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks that :mod:`metaopt_tpu_torch.parallel.launch` started, one rank per
device, with the reference's axis names (``dp``, ``tp``, ``sp``, ``ep``,
``pp``). It is built inside the ranks: every rank calls :func:`make_mesh`
with the same axes, in the same order, as every rank calls a collective.

:func:`trial_devices` is the block the executor assigned the trial
(``MTPU_ASSIGNED_CHIPS`` and ``CUDA_VISIBLE_DEVICES``, as
``executor/topology.py::chip_env`` sets them), one device each; it refuses
to put one device into a mesh twice, as the reference does. Ranks that
share a GPU exist only where a caller passes ``devices=`` explicitly.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from metaopt_tpu_torch.parallel import launch

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("mtpu_active_mesh",
                                                             default=None)
_MESHES: Dict[tuple, object] = {}       # (device type, names, sizes) -> DeviceMesh
_GROUPS: Dict[tuple, object] = {}       # (mesh id, axis names) -> process group


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh: the model layers read it through :func:`active_mesh`."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    """The mesh the current trial runs under, or None outside any mesh."""
    return _ACTIVE_MESH.get()


def trial_devices(device=None) -> List[torch.device]:
    """The devices this trial process may use, one rank each.

    ``device`` is the type the trial runs on (``cuda`` unless the caller
    asks for the CPU). On ``cuda`` the ids of ``MTPU_ASSIGNED_CHIPS`` name
    visible GPUs, or index the visible list, or (a runtime that already
    renumbered them under ``CUDA_VISIBLE_DEVICES``) are the visible set
    itself; never modulo-wrapped. On the CPU the trial gets one CPU rank per
    assigned chip, or one without an assignment.
    """
    kind = torch.device("cuda" if device is None else device).type
    spec = os.environ.get("MTPU_ASSIGNED_CHIPS")
    want = [int(s) for s in spec.split(",") if s != ""] if spec else None
    if want is not None and len(set(want)) != len(want):
        raise ValueError(f"MTPU_ASSIGNED_CHIPS={spec!r} repeats a chip id")
    if kind == "cpu":
        return [torch.device("cpu")] * (len(want) if want else 1)
    if kind != "cuda":
        raise ValueError(f"no trial devices of type {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not want:
        return devices
    if all(i < len(devices) for i in want):
        return [devices[i] for i in want]
    if len(want) == len(devices):
        # CUDA_VISIBLE_DEVICES already holds exactly the block, renumbered
        return devices
    raise ValueError(
        f"MTPU_ASSIGNED_CHIPS={spec!r} matches no visible device id, exceeds "
        f"the visible index range, and its size differs from the "
        f"{len(devices)} visible devices — cannot map safely")


def mesh_sizes(axes: Sequence[Tuple[str, int]], n_devices: int) -> List[Tuple[str, int]]:
    """The axes with a ``-1`` filled from ``n_devices``, checked: the
    reference's errors."""
    names = [a for a, _ in axes]
    sizes = [int(s) for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n_devices % known:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {known}")
        sizes[sizes.index(-1)] = n_devices // known
    if math.prod(sizes) != n_devices:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} "
                         f"devices, have {n_devices}")
    return list(zip(names, sizes))


def make_mesh(axes: Sequence[Tuple[str, int]], devices: Optional[Sequence] = None):
    """``make_mesh([("dp", 2), ("tp", 4)])`` → a 2×4 DeviceMesh over the ranks.

    Axis sizes must multiply to the device count; ``-1`` fills with what
    remains (at most one axis). ``devices`` defaults to the launched ranks'
    devices inside ranks, else :func:`trial_devices`. Must be called inside
    ranks started by :mod:`~metaopt_tpu_torch.parallel.launch`, one per
    device, by all of them."""
    devs = [torch.device(d) for d in (devices if devices is not None else
                                      launch.rank_devices() if launch.in_rank()
                                      else trial_devices())]
    sized = mesh_sizes(axes, len(devs))
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh builds a torch.distributed mesh: call it inside "
                           "ranks started by metaopt_tpu_torch.parallel.launch")
    if dist.get_world_size() != len(devs):
        raise ValueError(f"{len(devs)} devices for a world of {dist.get_world_size()} ranks")
    kind = devs[dist.get_rank()].type
    names = tuple(n for n, _ in sized)
    sizes = tuple(s for _, s in sized)
    key = (kind, names, sizes)
    if key not in _MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _MESHES[key] = DeviceMesh(kind, torch.arange(len(devs)).reshape(sizes),
                                  mesh_dim_names=names)
    return _MESHES[key]


def trial_mesh(tp: int = 1, extra_axes: Sequence[Tuple[str, int]] = ()):
    """The canonical trial mesh: data-parallel over the ranks, with a
    tensor-parallel inner axis — ``trial_mesh(tp=2)`` over 4 ranks gives a
    ("dp", 2) × ("tp", 2) mesh."""
    return make_mesh([("dp", -1), ("tp", tp), *extra_axes])


def forget_meshes() -> None:
    """Drop the cached meshes and groups (their process group is going away)."""
    _MESHES.clear()
    _GROUPS.clear()


# ---------------------------------------------------------------------------
# reading a mesh (None = one rank, every axis of size 1)


def axis_size(mesh, name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def mesh_shape(mesh) -> Dict[str, int]:
    return {} if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))


def axes_group(mesh, names: Sequence[str]):
    """The process group of the ranks that differ only along ``names`` (the
    axes the mesh lacks are skipped); None when that group is one rank.
    Every rank must ask for the same groups in the same order."""
    present = tuple(n for n in names if axis_size(mesh, n) > 1)
    if not present:
        return None
    if len(present) == 1:
        return mesh.get_group(present[0])
    key = (id(mesh), present)
    if key not in _GROUPS:
        import torch.distributed as dist

        dims = [mesh.mesh_dim_names.index(n) for n in present]
        grid = mesh.mesh.cpu()
        keep = [d for d in range(grid.dim()) if d not in dims]
        # one group per combination of the other axes; each rank joins its own
        flat = grid.permute(*keep, *dims).reshape(-1, math.prod(grid.shape[d] for d in dims))
        mine = None
        me = dist.get_rank()
        for row in flat.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]

