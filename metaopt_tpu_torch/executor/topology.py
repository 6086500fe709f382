"""GPU topology model + block allocation for trial placement.

Port of ``metaopt_tpu/executor/topology.py``. A trial occupies one GPU or
a power-of-two block of them; a broken trial must hand its GPUs back.
GPUs are addressed by their index in this host's visible order. Blocks are
power-of-two sized and size-aligned, so a classic **buddy allocator** is
the right shape: allocate/free are O(log n), fragmentation is bounded, and
every allocation is aligned. :class:`ChipRegistry` without a state file
arbitrates in-process through a :class:`BuddyAllocator`; with one (the
default of ``GPUExecutor``: several hunt processes or ``--n-workers``
threads on one host share its GPUs) it goes through a flock-guarded JSON
file, the same doctrine as the FileLedger.

Two functions differ from the reference: :func:`detect_slice_size` counts
CUDA devices (``MTPU_SLICE_CHIPS`` first) and raises where it finds none,
and :func:`chip_env` pins a trial with ``CUDA_VISIBLE_DEVICES`` instead of
the ``TPU_*`` variables.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class SubSlice:
    """An allocated, aligned block of GPUs."""

    start: int
    size: int

    @property
    def chips(self) -> List[int]:
        return list(range(self.start, self.start + self.size))


class BuddyAllocator:
    """Power-of-two buddy allocator over ``total`` linearly-ordered GPUs."""

    def __init__(self, total: int):
        if not _is_pow2(total):
            raise ValueError(f"total chips must be a power of two, got {total}")
        self.total = total
        # free lists per block size
        self._free: Dict[int, List[int]] = {total: [0]}
        self._lock = threading.Lock()

    def allocate(self, n: int) -> Optional[SubSlice]:
        """Allocate an aligned block of next_pow2(n) GPUs, or None if full."""
        size = next_pow2(max(1, n))
        if size > self.total:
            raise ValueError(f"requested {n} chips > slice size {self.total}")
        with self._lock:
            return self._alloc_locked(size)

    def _alloc_locked(self, size: int) -> Optional[SubSlice]:
        s = size
        while s <= self.total and not self._free.get(s):
            s *= 2
        if s > self.total or not self._free.get(s):
            return None
        start = self._free[s].pop(0)
        while s > size:  # split down, keeping the upper buddy free
            s //= 2
            self._free.setdefault(s, []).append(start + s)
        return SubSlice(start, size)

    def free(self, block: SubSlice) -> None:
        """Return a block; coalesce with its buddy where possible."""
        with self._lock:
            start, size = block.start, block.size
            while size < self.total:
                buddy = start ^ size
                lst = self._free.get(size, [])
                if buddy in lst:
                    lst.remove(buddy)
                    start = min(start, buddy)
                    size *= 2
                else:
                    break
            self._free.setdefault(size, []).append(start)
            self._free[size].sort()

    @property
    def n_free_chips(self) -> int:
        with self._lock:
            return sum(s * len(lst) for s, lst in self._free.items())


class ChipRegistry:
    """GPU accounting for one host.

    Without ``state_path``, an in-process :class:`BuddyAllocator`. With it,
    cross-process: the state file (flock-guarded JSON) maps claimed blocks
    to (pid, heartbeat), and dead claimants (stale heartbeat or vanished
    pid) are reaped on every allocate — a broken or killed trial can never
    leak its block.

    The two paths can choose different blocks for the same sequence, as
    the reference's do: the allocator takes the best fit from its free
    lists, the file the first free aligned block (with 1 GPU at 3, 2 at 0
    and 4 at 4 free, ``allocate(1)`` gives 3 in-process and 0 from the
    file). Only the file path runs in the port, since ``GPUExecutor``
    always passes a state file; the in-process path keeps the reference's
    ``ChipRegistry(total)``.
    """

    def __init__(self, total: int, state_path: Optional[str] = None,
                 stale_s: float = 120.0):
        if not _is_pow2(total):
            raise ValueError(f"total chips must be a power of two, got {total}")
        self.total = total
        self.state_path = state_path
        self.stale_s = stale_s
        self._local = BuddyAllocator(total) if state_path is None else None

    # -- in-process fast path ---------------------------------------------
    def allocate(self, n: int, owner: str = "") -> Optional[SubSlice]:
        """Claim an aligned block of next_pow2(n) GPUs, or None if full."""
        if self._local is not None:
            return self._local.allocate(n)
        return self._file_op("alloc", n=n, owner=owner)

    def free(self, block: SubSlice) -> None:
        if self._local is not None:
            self._local.free(block)
            return
        self._file_op("free", start=block.start, size=block.size)

    def heartbeat(self, block: SubSlice) -> None:
        if self._local is None:
            self._file_op("beat", start=block.start, size=block.size)

    @property
    def n_free_chips(self) -> int:
        if self._local is not None:
            return self._local.n_free_chips
        state = self._file_op("read")
        # block size lives in the claim KEY ("start:size"), not the value
        used = sum(int(key.split(":")[1]) for key in state["claims"])
        return self.total - used

    # -- file-backed path --------------------------------------------------
    def _file_op(self, op: str, **kw):
        os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
        with open(self.state_path + ".lock", "a+") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                try:
                    with open(self.state_path) as f:
                        state = json.load(f)
                except (FileNotFoundError, json.JSONDecodeError):
                    state = {"claims": {}}
                self._reap(state)
                result = None
                if op == "alloc":
                    result = self._file_alloc(state, kw["n"], kw["owner"])
                elif op == "free":
                    state["claims"].pop(f"{kw['start']}:{kw['size']}", None)
                elif op == "beat":
                    key = f"{kw['start']}:{kw['size']}"
                    if key in state["claims"]:
                        state["claims"][key]["t"] = time.time()
                elif op == "read":
                    return state
                tmp = self.state_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(state, f)
                # atomic, deliberately not durable: claims are leases —
                # a power-lost registry is healed by _reap() on the next
                # flock'd read (stale heartbeats expire the claims)
                os.replace(tmp, self.state_path)  # mtpu: lint-ok MTP001 lease state, heal-on-read
                return result
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def _reap(self, state: Dict) -> None:
        now = time.time()
        dead = []
        for key, claim in state["claims"].items():
            pid_alive = True
            try:
                os.kill(int(claim["pid"]), 0)
            except (ProcessLookupError, ValueError):
                pid_alive = False
            except PermissionError:
                pass
            if not pid_alive or now - claim.get("t", 0) > self.stale_s:
                dead.append(key)
        for key in dead:
            del state["claims"][key]

    def _file_alloc(self, state: Dict, n: int, owner: str) -> Optional[SubSlice]:
        size = next_pow2(max(1, n))
        if size > self.total:
            raise ValueError(f"requested {n} chips > slice size {self.total}")
        used = set()
        for key in state["claims"]:
            start, bsize = (int(v) for v in key.split(":"))
            used.update(range(start, start + bsize))
        for start in range(0, self.total, size):  # aligned scan
            block = range(start, start + size)
            if not used.intersection(block):
                state["claims"][f"{start}:{size}"] = {
                    "pid": os.getpid(),
                    "owner": owner,
                    "t": time.time(),
                }
                return SubSlice(start, size)
        return None


def detect_slice_size() -> int:
    """GPUs visible to this host: ``MTPU_SLICE_CHIPS`` if set, else
    ``torch.cuda.device_count()`` (which honours ``CUDA_VISIBLE_DEVICES``
    and initializes CUDA without creating a context on any card, so this
    process holds no card memory the trials need). Raises when neither
    gives at least one GPU: no silent single chip on a machine without
    one."""
    env = os.environ.get("MTPU_SLICE_CHIPS")
    if env:
        n = int(env)
    else:
        import torch

        n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError(
            "no CUDA device visible for GPU trial placement; set "
            "MTPU_SLICE_CHIPS to the number of GPUs to place trials on"
        )
    return n


def chip_env(block: SubSlice) -> Dict[str, str]:
    """Env vars pinning a trial subprocess to its block of GPUs.

    ``CUDA_VISIBLE_DEVICES`` names the block's GPUs as this process sees
    them: when this process itself runs under ``CUDA_VISIBLE_DEVICES=2,3``,
    GPU 0 of the block is device ``2``. ``MTPU_ASSIGNED_CHIPS`` is the
    framework-level contract (the block's indices in this host's visible
    order, read by ``client.get_trial_info`` users) and works on any
    backend.
    """
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    if parent is None:
        visible = [str(c) for c in block.chips]
    else:
        names = [d.strip() for d in parent.split(",") if d.strip()]
        if block.start + block.size > len(names):
            raise ValueError(
                f"GPUs {block.chips} are not all in this process's "
                f"CUDA_VISIBLE_DEVICES={parent!r}"
            )
        visible = [names[c] for c in block.chips]
    return {
        "MTPU_ASSIGNED_CHIPS": ",".join(str(c) for c in block.chips),
        "CUDA_VISIBLE_DEVICES": ",".join(visible),
    }
