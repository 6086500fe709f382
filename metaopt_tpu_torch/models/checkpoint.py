"""Per-trial model checkpoints (port of ``metaopt_tpu/models/checkpoint.py``).

The ledger checkpoints the SEARCH; this module checkpoints a TRIAL's
training state, so that a re-run trial resumes its own state and a PBT
continuation inherits its parent's (``client.checkpoint_paths``).

A checkpoint is one file written by ``torch.save``: a dict of CPU tensors
holding one or more named trees (a trial's ``params`` and ``opt_state``),
each leaf keyed ``f"{tree}/{i:05d}"``, as the reference names its leaves
by index, so the leaf order is explicit. The reference saves one orbax
directory per tree instead: neither package reads the other's checkpoints.

A checkpoint is written under a temporary name in its directory, flushed
to disk, and published by ``os.replace`` onto its final name, after which
the directory entry is flushed too. All its trees go in that one file, so
a reader sees the previous checkpoint or the new one, never half of one
and never one tree of each, and :func:`has_state` accepts only a published
checkpoint (the reference's accepts any non-empty directory, so also a
half-written one).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Mapping, Sequence

import torch

_TMP_PREFIX = ".tmp-"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_state(path: str, trees: Mapping[str, Sequence[torch.Tensor]]) -> None:
    """Publish ``trees`` (tree name → flat sequence of tensors) as the
    checkpoint at ``path``, replacing any earlier one."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    payload: Dict[str, torch.Tensor] = {
        f"{name}/{i:05d}": t.detach().to("cpu", copy=True)
        for name, leaves in trees.items() for i, t in enumerate(leaves)}
    fd, tmp = tempfile.mkstemp(prefix=_TMP_PREFIX + os.path.basename(path) + ".", dir=parent)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(parent)


def restore_state(path: str, like: Mapping[str, Sequence[torch.Tensor]]
                  ) -> Dict[str, List[torch.Tensor]]:
    """The checkpoint at ``path`` as tree name → list of tensors shaped like
    ``like``'s, each on its ``like`` leaf's device and in its dtype."""
    path = os.path.abspath(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, List[torch.Tensor]] = {}
    for name, ref_leaves in like.items():
        leaves = [payload[k] for k in sorted(payload) if k.startswith(name + "/")]
        if len(leaves) != len(ref_leaves):
            raise ValueError(
                f"checkpoint at {path} has {len(leaves)} leaves, expected "
                f"{len(ref_leaves)} — saved from a different architecture?"
            )
        out[name] = []
        for i, (x, ref) in enumerate(zip(leaves, ref_leaves)):
            if x.shape != ref.shape:
                raise ValueError(f"checkpoint at {path}: {name} leaf {i} has shape "
                                 f"{tuple(x.shape)}, expected {tuple(ref.shape)}")
            out[name].append(x.to(device=ref.device, dtype=ref.dtype))
    return out


def has_state(path: str) -> bool:
    """Whether a published checkpoint exists at ``path`` (a temporary file
    left by an interrupted save does not count)."""
    return os.path.isfile(path) and not os.path.basename(path).startswith(_TMP_PREFIX)
