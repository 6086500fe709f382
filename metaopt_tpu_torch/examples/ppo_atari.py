#!/usr/bin/env python
"""BASELINE config 5: EvolutionES population search on PPO.

    python -m metaopt_tpu_torch hunt -n ppo --max-trials 60 --n-chips 1 \
        --config metaopt_tpu_torch/examples/evolution.json \
        metaopt_tpu_torch/examples/ppo_atari.py \
        --lr~'loguniform(1e-5, 1e-2)' \
        --clip-eps~'uniform(0.05, 0.4)' \
        --ent-coef~'loguniform(1e-4, 1e-1)' \
        --gae-lambda~'uniform(0.8, 1.0)' \
        --epochs~'fidelity(2, 32, base=2)'

``--epochs`` is the number of PPO iterations (the fidelity). Trains on
``--device`` (default ``cuda``; without CUDA it raises unless given
``--device cpu``). Besides the objective (the negated mean episode return)
it reports statistics: the device's name, the seconds from this process's
start to its first finished device op (interpreter, ``import torch``, the
CUDA context), the seconds before the first iteration (model, optimizer,
environments), of the iterations, ms per iteration, and the seconds of the
whole ``train`` call.
"""

import argparse
import time

from metaopt_tpu_torch.utils.procs import process_age_s


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--clip-eps", dest="clip_eps", type=float, default=0.2)
    p.add_argument("--ent-coef", dest="ent_coef", type=float, default=0.01)
    p.add_argument("--gae-lambda", dest="gae_lambda", type=float, default=0.95)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    import torch

    from metaopt_tpu_torch.client import report_results
    from metaopt_tpu_torch.models.ppo import train
    from metaopt_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    torch.zeros(1, device=device).sum().item()  # context + first kernel, synchronized
    first_op_s = process_age_s()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    rep = {}
    t0 = time.perf_counter()
    neg_return = train(
        {
            "lr": a.lr, "clip_eps": a.clip_eps, "ent_coef": a.ent_coef,
            "gae_lambda": a.gae_lambda, "hidden": a.hidden,
        },
        iterations=a.epochs, device=device, report=rep,
    )
    call_s = time.perf_counter() - t0
    report_results([
        {"name": "neg_return", "type": "objective", "value": neg_return},
        {"name": "device", "type": "statistic", "value": name},
        {"name": "first_device_op_s", "type": "statistic", "value": first_op_s},
        {"name": "setup_s", "type": "statistic", "value": rep["setup_s"]},
        {"name": "train_s", "type": "statistic", "value": rep["train_s"]},
        {"name": "ms_per_iteration", "type": "statistic", "value": rep["ms_per_iteration"]},
        {"name": "train_call_s", "type": "statistic", "value": call_s},
    ])


if __name__ == "__main__":
    main()
