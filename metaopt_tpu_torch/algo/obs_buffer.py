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
bulk uploads and reallocations, as the reference does. Not ported yet:
``CholeskyFactor`` (GP-BO).
"""

from __future__ import annotations

from typing import List, Tuple

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
            rows = np.stack(X_rows[self.n:n]).astype(np.float32, copy=False)
            vals = np.asarray(y_vals[self.n:n], np.float32)
            self.Xdev[self.n:n] = torch.from_numpy(rows).to(self.device)
            self.ydev[self.n:n] = torch.from_numpy(vals).to(self.device)
            self.n = n
            self.h2d_bytes += rows.nbytes + vals.nbytes
            self.appends += missing

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
