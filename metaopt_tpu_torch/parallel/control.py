"""Pod-global control signals as collectives (port of
``metaopt_tpu/parallel/control.py``).

A trial whose ranks run collectives together cannot act on a stop signal
one rank at a time: if one rank leaves the step loop while the others
enter the next all-reduce, they wait forever. So the stop decision is
agreed by all ranks — one all-reduce of a flag — and every rank leaves the
loop at the same step::

    carry, steps, stopped = run_signaled(
        step, carry, mesh=mesh, should_stop=should_stop,
        max_steps=1000, check_every=50,
    )

where rank 0 typically polls the coordinator's signal channel and the
other ranks' ``should_stop`` returns False.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from metaopt_tpu_torch.parallel.collectives import any_flag


def pod_agree(mesh, local_flag: bool) -> bool:
    """Global OR of a per-rank flag over every rank of ``mesh`` (one
    integer all-reduce; every rank reads the same verdict). All ranks must
    call it together: it is itself a collective. Outside any process group
    (one rank, ``mesh`` None) it is the flag."""
    device = None
    if mesh is not None and mesh.device_type == "cuda":
        import torch

        device = torch.device("cuda", torch.cuda.current_device())
    return any_flag(bool(local_flag), None, device)


def run_signaled(
    step_fn: Callable[[Any], Any],
    carry: Any,
    *,
    mesh,
    should_stop: Callable[[], bool],
    max_steps: int,
    check_every: int = 50,
) -> Tuple[Any, int, bool]:
    """Drive ``carry = step_fn(carry)`` with a pod-coherent early stop.

    Every ``check_every`` steps each rank contributes ``should_stop()`` and
    the ranks take the global OR through :func:`pod_agree`, so either every
    rank keeps stepping or every rank stops, at the same step count.
    Returns ``(carry, steps_run, stopped_early)``.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    steps = 0
    while steps < max_steps:
        chunk = min(check_every, max_steps - steps)
        for _ in range(chunk):
            carry = step_fn(carry)
        steps += chunk
        if pod_agree(mesh, bool(should_stop())):
            return carry, steps, True
    return carry, steps, False
