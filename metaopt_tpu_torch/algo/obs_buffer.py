"""Device-resident incremental observation buffers.

Port of ``ObservationBuffer`` from ``metaopt_tpu/algo/obs_buffer.py``.
TPE keeps its observations in pow2-padded ``(cap, d)`` / ``(cap,)``
tensors on its device, and the device copy is the durable one:

- ``sync`` copies only the rows the device has not seen, into the
  existing tensors in place — O(d) host→device bytes per observation;
- capacity grows to ``pad_pow2(n + 1)`` exactly (the ``+1`` keeps the
  prior pseudo-component slot), and growth copies device→device — the
  accumulated rows are never re-uploaded;
- ``overlay`` composes the constant-liar augmentation (pending rows with a
  lie objective) as a device-side copy + small H2D of just the lie rows.

Capacity is EXACTLY ``pad_pow2(n + 1)`` after every sync, and rows past
``n`` hold the fill (0.5 / +inf), so launch shapes and contents are a pure
function of the observation list: bit-identical to a full host rebuild.

The buffer meters its host→device payload (``h2d_bytes``), row appends,
bulk uploads and reallocations, as the reference does.

GP-BO keeps a :class:`CholeskyFactor` of its masked gram beside the buffer
(ports of ``_chol_grow`` and ``CholeskyFactor``): anchored by a full
factorization, extended one row per observation, grown by an identity
corner, with the op trace that lets a restored instance replay it bit for
bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from metaopt_tpu_torch.ops.tpe_math import pad_pow2

#: row-count gap above which sync abandons appends for one bulk upload
#: (state restore lands thousands of rows at once)
_BULK_THRESHOLD = 64


def _padded(cap: int, d: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((cap, d), 0.5, dtype=torch.float32, device=device),
            torch.full((cap,), torch.inf, dtype=torch.float32, device=device))


class ObservationBuffer:
    """Incrementally grown device mirror of host observation lists.

    The host lists (kept by the algorithm for state_dict / host-side math)
    remain the source of truth; ``sync`` brings the device copy up to date
    by appending only what is missing. Shrinking never happens — a restored
    or reseeded algorithm calls ``reset()`` and re-syncs from scratch.
    """

    def __init__(self, d: int, device):
        self.d = int(d)
        self.device = torch.device(device)
        self.cap = 0
        self.n = 0                      # rows the device copy holds
        self.Xdev = None
        self.ydev = None
        # telemetry: host→device payload bytes (buffer data only)
        self.h2d_bytes = 0
        self.appends = 0
        self.bulk_uploads = 0
        self.reallocs = 0

    def reset(self) -> None:
        self.cap = 0
        self.n = 0
        self.Xdev = None
        self.ydev = None

    def sync(self, X_rows: List[np.ndarray], y_vals: List[float]) -> None:
        """Append rows [self.n, len(y_vals)) to the device buffers."""
        n = len(y_vals)
        if n < self.n:
            # host lists went backwards (state restore): rebuild
            self.reset()
        need = pad_pow2(n + 1)
        missing = n - self.n
        if missing > _BULK_THRESHOLD or (self.cap == 0 and missing > 0):
            Xb = np.full((need, self.d), 0.5, np.float32)
            yb = np.full((need,), np.inf, np.float32)
            if n:
                Xb[:n] = np.stack(X_rows).astype(np.float32, copy=False)
                yb[:n] = np.asarray(y_vals, np.float32)
            self.Xdev = torch.from_numpy(Xb).to(self.device)
            self.ydev = torch.from_numpy(yb).to(self.device)
            self.cap = need
            self.n = n
            self.h2d_bytes += Xb.nbytes + yb.nbytes
            self.bulk_uploads += 1
            return
        if need != self.cap:
            Xn, yn = _padded(need, self.d, self.device)
            if self.cap:
                Xn[: self.cap] = self.Xdev
                yn[: self.cap] = self.ydev
            self.Xdev, self.ydev = Xn, yn
            self.cap = need
            self.reallocs += 1
        if missing > 0:
            self._append_rows(X_rows, y_vals, n)

    # mtpu: hotpath
    def _append_rows(self, X_rows: List[np.ndarray], y_vals: List[float],
                     n: int) -> None:
        """Rows ``[self.n, n)`` into the padded buffers in place: O(rows·d)
        host→device, no read back (the reference's ``_append_row``)."""
        rows = torch.from_numpy(
            np.stack(X_rows[self.n:n]).astype(np.float32, copy=False))
        vals = torch.tensor(y_vals[self.n:n], dtype=torch.float32)
        self.Xdev[self.n:n] = rows.to(self.device)
        self.ydev[self.n:n] = vals.to(self.device)
        self.h2d_bytes += rows.nbytes + vals.nbytes
        self.appends += n - self.n
        self.n = n

    def mark_stale(self) -> None:
        """Force a full re-upload on the next ``sync`` (for callers that
        rewrite VALUES of already-synced rows: ``sync`` only appends)."""
        self.reset()

    def overlay(self, pend_rows: List[np.ndarray],
                lie: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(Xa, ya, n_eff): base rows + pending lie rows, freshly padded.

        The caller caches the result keyed by (n, pending fingerprint); this
        method does one O(npend·d) H2D per call.
        """
        npend = len(pend_rows)
        ntot = self.n + npend
        pend = np.stack(pend_rows).astype(np.float32, copy=False)
        lies = np.full(npend, lie, np.float32)
        Xa, ya = _padded(pad_pow2(ntot + 1), self.d, self.device)
        Xa[: self.cap] = self.Xdev
        ya[: self.cap] = self.ydev
        Xa[self.n:ntot] = torch.from_numpy(pend).to(self.device)
        ya[self.n:ntot] = torch.from_numpy(lies).to(self.device)
        self.h2d_bytes += pend.nbytes + lies.nbytes
        return Xa, ya, ntot


def _chol_grow(L: torch.Tensor, newcap: int) -> torch.Tensor:
    """Identity-extend a lower-triangular factor to a larger padding.

    The masked gram makes every row ≥ n an exact unit row ``e_i``, so the
    factor of the grown matrix is the old factor with an identity corner —
    no recomputation, a device→device copy only. Returns a new tensor: the
    pending-lie overlay grows a COPY of the live factor, which must survive.
    """
    out = torch.eye(newcap, dtype=L.dtype, device=L.device)
    out[: L.shape[0], : L.shape[1]] = L
    return out


class CholeskyFactor:
    """Device-resident Cholesky factor riding alongside the buffer.

    Owns the factor tensor's lifecycle (anchor / grow / per-row extend) and
    the replay trace; the GP owns the kernel math that produces each new
    ``L`` (the gram row depends on hyperparameters this module must not
    know about). Between full factorizations ("anchors") the factor is
    extended one observation row at a time at O(n²) instead of the O(n³)
    refactorization — the masked gram guarantees the appended row of a
    dead/padding observation is exactly ``e_i``, so extensions and pow2
    growth agree with a from-scratch factorization of the same gram.

    The trace (one anchor + the grow/append ops since, reset at every
    anchor) lets a restored instance REPLAY the exact op sequence at the
    exact historical shapes and recover a bit-identical factor, which keeps
    the suggestion stream exactly resumable across ``state_dict`` round
    trips despite floating-point non-associativity.
    """

    def __init__(self):
        self.L = None
        self.cap = 0
        self.rows = 0        # observation rows folded into the factor
        self.anchor_n = -1   # observation count at the last full refactor
        self.anchor_cap = 0
        self.ops: List[Tuple[str, int]] = []  # ("g", newcap) | ("a", row)
        # telemetry
        self.anchors = 0
        self.extends = 0
        self.grows = 0
        self.drift_refits = 0

    def reset(self) -> None:
        self.L = None
        self.cap = 0
        self.rows = 0
        self.anchor_n = -1
        self.anchor_cap = 0
        self.ops = []

    def anchor(self, L, n: int, cap: int) -> None:
        """Install a fresh full factorization; restarts the replay trace."""
        self.L = L
        self.cap = cap
        self.rows = n
        self.anchor_n = n
        self.anchor_cap = cap
        self.ops = []
        self.anchors += 1

    def grow(self, newcap: int) -> None:
        self.L = _chol_grow(self.L, newcap=newcap)
        self.cap = newcap
        self.ops.append(("g", newcap))
        self.grows += 1

    def current(self, n: int, cap: int) -> bool:
        """True when the factor already covers observation count ``n`` at
        buffer capacity ``cap``: an acquisition launch can consume ``L``
        as it is, with no factor maintenance."""
        return (self.L is not None and self.rows == n
                and self.cap == cap and self.anchor_n >= 0)

    def append_row(self, L, i: int) -> None:
        """Commit the factor extended through observation row ``i``."""
        self.L = L
        self.rows = i + 1
        self.ops.append(("a", i))
        self.extends += 1

    def trace(self) -> Dict[str, Any]:
        """Serializable replay recipe (ints only, no device data)."""
        return {
            "anchor_n": self.anchor_n,
            "anchor_cap": self.anchor_cap,
            "ops": [list(op) for op in self.ops],
        }

    def telemetry(self) -> Dict[str, int]:
        return {
            "chol_anchors": self.anchors,
            "chol_extends": self.extends,
            "chol_grows": self.grows,
            "chol_drift_refits": self.drift_refits,
        }
