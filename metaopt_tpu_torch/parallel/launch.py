"""Ranks of one trial: the port's counterpart of JAX's devices.

A JAX trial sees its chips as ``jax.devices()`` and runs one program over
them; a PyTorch trial runs one process per device, joined by a
``torch.distributed`` process group. This module starts those processes:

- :func:`launch` runs ``fn(*args)`` on one rank per entry of ``devices``
  and returns rank 0's result;
- :class:`RankPool` keeps the ranks alive between calls, so that a test
  module pays the ~4 s of spawning (each rank imports torch) once.

Each rank joins a process group whose rendezvous is a ``file://`` store in
a fresh temporary directory (no port, so concurrent launches cannot
collide), on the ``gloo`` backend when the ranks are on the CPU or share a
GPU and on ``nccl`` when each rank has a GPU of its own. Inside a rank,
:func:`rank_devices` and :func:`rank` say where it runs; the mesh helpers
(:mod:`metaopt_tpu_torch.parallel.mesh`) read them.

No call degrades: a rank that raises, dies or does not answer within the
call's timeout fails the whole call with that rank's traceback, and a pool
that cannot start raises; nothing ever falls back to fewer ranks. A failed
call that left ranks inside a collective closes the pool.

``fn`` and ``args`` travel by pickle, so ``fn`` must be importable by name
(a module-level function, or a ``functools.partial`` of one) from a module
that imports no JAX. Tensors in a result come back on the CPU.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

#: seconds a call may take before its ranks are killed and the call fails
DEFAULT_TIMEOUT_S = 120.0
#: seconds the ranks wait for one another inside a collective
_PG_TIMEOUT_S = 90.0
#: after one rank fails, seconds the others get to answer before the pool closes
_GRACE_S = 3.0

_WORLD: Optional[dict] = None   # inside a rank: {"rank", "devices", "backend"}


class RankError(RuntimeError):
    """A rank raised, died or timed out; the message holds its traceback."""


def backend_for(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every rank has a GPU of its own, else ``gloo`` (the CPU,
    or ranks sharing a GPU: NCCL refuses two ranks on one device)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({str(d) for d in devs}) == len(devs):
        return "nccl"
    if all(d.type in ("cpu", "cuda") for d in devs):
        return "gloo"
    raise ValueError(f"no process-group backend for devices {devs}")


def in_rank() -> bool:
    return _WORLD is not None


def rank() -> int:
    return _WORLD["rank"] if _WORLD else 0


def rank_devices() -> List[torch.device]:
    """Inside a rank: every rank's device, in rank order."""
    if _WORLD is None:
        raise RuntimeError("not inside a launched rank")
    return list(_WORLD["devices"])


def rank_device() -> torch.device:
    return rank_devices()[rank()]


def _host(obj):
    """A result made safe to send: tensors detached, on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def _rank_main(r: int, devices: List[str], store: str, backend: str,
               inbox, outbox) -> None:
    """A rank's process: join the group, then run tasks until told to stop."""
    global _WORLD
    import torch.distributed as dist

    try:
        devs = [torch.device(d) for d in devices]
        if devs[r].type == "cuda":
            torch.cuda.set_device(devs[r])
        elif "OMP_NUM_THREADS" not in os.environ:
            # one thread a CPU rank: the ranks (and their neighbours on the
            # host) would otherwise oversubscribe its cores
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method="file://" + store,
                                world_size=len(devs), rank=r,
                                timeout=datetime.timedelta(seconds=_PG_TIMEOUT_S))
        _WORLD = {"rank": r, "devices": devs, "backend": backend}
        outbox.put((r, "ready", None))
    except BaseException:
        outbox.put((r, "error", (None, traceback.format_exc())))
        return
    while True:
        task = inbox.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            out = _host(fn(*args, **kwargs))
            pickle.dumps(out)
            outbox.put((r, "ok", out))
        except BaseException as err:
            try:
                blob = pickle.dumps(err)
            except Exception:
                blob = None
            outbox.put((r, "error", (blob, traceback.format_exc())))
    from metaopt_tpu_torch.parallel import mesh as _mesh

    _mesh.forget_meshes()
    dist.destroy_process_group()


class RankPool:
    """``len(devices)`` ranks kept alive between calls; ``run`` sends one
    callable to all of them and returns their results in rank order."""

    def __init__(self, devices: Sequence, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.devices = [str(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a pool needs at least one device")
        self.backend = backend_for(self.devices)
        self.timeout_s = float(timeout_s)
        self._dir = tempfile.mkdtemp(prefix="mtpu-ranks-")
        ctx = mp.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in self.devices]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"mtpu-rank-{r}",
                        args=(r, self.devices, os.path.join(self._dir, "store"),
                              self.backend, self._inboxes[r], self._outbox))
            for r in range(len(self.devices))]
        for p in self._procs:
            p.start()
        try:
            self._collect("start", self.timeout_s)
        except BaseException:
            self.close()
            raise

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def _collect(self, what: str, timeout_s: float) -> List[Any]:
        n = len(self._procs)
        got, failed = {}, {}
        deadline = time.monotonic() + timeout_s
        while len(got) + len(failed) < n and time.monotonic() < deadline:
            try:
                r, status, payload = self._outbox.get(
                    timeout=max(0.01, min(0.5, deadline - time.monotonic())))
            except queue.Empty:
                for i, p in enumerate(self._procs):
                    if not p.is_alive() and i not in got and i not in failed:
                        failed[i] = (None, f"rank {i} exited with code {p.exitcode}")
                        deadline = min(deadline, time.monotonic() + _GRACE_S)
                continue
            if status == "error":
                failed[r] = payload
                deadline = min(deadline, time.monotonic() + _GRACE_S)
            else:
                got[r] = payload
        missing = [i for i in range(n) if i not in got and i not in failed]
        if missing or failed:
            if missing or not self.alive:
                # ranks lost, or still inside a collective: no reuse
                self.close()
            if failed:
                r = min(failed)
                blob, tb = failed[r]
                msg = (f"{what}: rank {r} of {n} failed"
                       + (f"; ranks {missing} did not answer" if missing else "")
                       + f"\n--- rank {r} traceback ---\n{tb}")
                err = pickle.loads(blob) if blob else None
                if isinstance(err, Exception):
                    raise err from RankError(msg)
                raise RankError(msg)
            raise RankError(f"{what}: ranks {missing} of {n} did not answer within "
                            f"{timeout_s:.0f} s; the pool was closed")
        return [got[i] for i in range(n)]

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None,
            **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; their results in rank order."""
        if not self.alive:
            raise RankError("the rank pool is closed or lost a rank")
        for box in self._inboxes:
            box.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", repr(fn)),
                             self.timeout_s if timeout_s is None else timeout_s)

    def close(self) -> None:
        for box, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                try:
                    box.put(None)
                except Exception:
                    pass
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn: Callable, *args, devices: Sequence,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """``fn(*args)`` on one rank per device; rank 0's result."""
    with RankPool(devices, timeout_s=timeout_s) as pool:
        return pool.run(fn, *args)[0]
