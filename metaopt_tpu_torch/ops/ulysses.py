"""Ulysses sequence parallelism: an all-to-all head/sequence exchange
(port of ``metaopt_tpu/ops/ulysses.py``).

The other long-context strategy beside :mod:`ring_attention`: one
``all_to_all`` re-shards q, k and v from sequence-split to head-split,
every rank runs the port's :func:`~metaopt_tpu_torch.ops.attention.
flash_attention` on H/sp of its heads at the full sequence — so K1–K3 run
there — and a second ``all_to_all`` restores the sequence split. Two
all-to-alls per call, whatever the ring length, at the price of
``heads % sp == 0`` and one full-length sequence per rank. MHA picks
between the two with ``METAOPT_TPU_SP_IMPL`` (:func:`sp_impl`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from metaopt_tpu_torch.ops.attention import flash_attention, shard_philox
from metaopt_tpu_torch.ops.ring_attention import check_seq_axis
from metaopt_tpu_torch.parallel.collectives import all_to_all
from metaopt_tpu_torch.parallel.mesh import axes_group, axis_index


def sp_impl() -> str:
    """Which sequence-parallel attention MHA uses when the mesh has sp > 1.

    ``METAOPT_TPU_SP_IMPL``: ``ring`` (default — lowest per-rank memory) or
    ``ulysses`` (2 all-to-alls, needs local heads % sp == 0)."""
    env = (os.environ.get("METAOPT_TPU_SP_IMPL") or "ring").strip().lower()
    if env in ("ring", "ulysses"):
        return env
    raise ValueError(f"METAOPT_TPU_SP_IMPL={env!r}: expected ring/ulysses")


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    mesh,
    seq_axis: str = "sp",
    batch_axis: Optional[str] = "dp",
    head_axis: Optional[str] = "tp",
    dropout_rate: float = 0.0,
    philox: Optional[Tuple[int, int]] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One rank's share of sequence-parallel attention by head exchange.

    q: (b, Sq/sp, h, D) pre-scaled; k, v: (b, Sk/sp, h, D) — this rank's
    sequence slices; mask: optional (b, Sq, Sk), every row (each rank needs
    the full rows of its heads); ``keep`` (b, h/sp, Sq, Sk), given keep bits
    of the heads this rank attends. h (this rank's tp slice of the heads)
    must divide by sp. Returns (b, Sq/sp, h, D) in q's dtype."""
    sp = check_seq_axis(mesh, seq_axis)
    h_local = q.shape[2]
    if h_local % sp:
        raise ValueError(
            f"ulysses needs per-device heads ({h_local}) divisible by the "
            f"{seq_axis} axis ({sp}); use ring attention for this layout")
    group = axes_group(mesh, (seq_axis,))
    # sequence-split -> head-split: each rank gets h/sp heads, every position
    qg, kg, vg = (all_to_all(t, group, 2, 1) for t in (q, k, v))
    if dropout_rate > 0.0 and philox is not None:
        philox = shard_philox(philox, [axis_index(mesh, a)
                                       for a in (batch_axis, seq_axis, head_axis) if a])
    out = flash_attention(qg, kg, vg, mask, dropout_rate=dropout_rate, philox=philox,
                          keep=keep)
    # head-split -> sequence-split: the inverse exchange
    return all_to_all(out, group, 1, 2)
