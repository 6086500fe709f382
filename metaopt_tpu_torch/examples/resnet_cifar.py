#!/usr/bin/env python
"""BASELINE config 3: ASHA on ResNet-50/CIFAR-shaped task (multi-fidelity).

    python -m metaopt_tpu_torch hunt -n resnet --max-trials 64 --n-chips 1 \
        --config metaopt_tpu_torch/examples/asha.json \
        metaopt_tpu_torch/examples/resnet_cifar.py \
        --lr~'loguniform(1e-3, 1.0)' \
        --momentum~'uniform(0.8, 0.99)' \
        --weight-decay~'loguniform(1e-6, 1e-2)' \
        --epochs~'fidelity(1, 16, base=4)'

With one GPU and one worker, add ``--pool-size 1``: at ``asha.json``'s pool
of 4 the worker registers four fresh bottom-rung trials per cycle while it
completes one, so the trial budget fills before ASHA can promote to the
top rung (64 trials reach budget 4 three times and budget 16 never).

Streams per-epoch validation error via report_partial so the judge hook
can prune mid-trial. Trains on ``--device`` (default ``cuda``; without
CUDA it raises unless given ``--device cpu``). Besides the objective it
reports statistics: the device's name, the seconds from this process's
start to its first finished device op (interpreter, ``import torch``, the
CUDA context), the seconds before the training loop (model, data,
optimizer), of the training loops and of the validation passes, ms per
train step, each epoch's mean training loss, and the seconds of the whole
``train_and_eval`` call.
"""

import argparse
import time

from metaopt_tpu_torch.utils.procs import process_age_s


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", dest="weight_decay", type=float, default=1e-4)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--n-train", dest="n_train", type=int, default=4096,
                   help="synthetic train-set size (smoke runs shrink this)")
    p.add_argument("--n-val", dest="n_val", type=int, default=1024)
    p.add_argument("--width", type=int, default=64,
                   help="stem width (CPU smoke runs shrink this)")
    p.add_argument("--hw", type=int, default=32, help="image side length")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    import torch

    from metaopt_tpu_torch.client import report_partial, report_results
    from metaopt_tpu_torch.models.resnet import train_and_eval
    from metaopt_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    torch.zeros(1, device=device).sum().item()  # context + first kernel, synchronized
    first_op_s = process_age_s()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    hp = {
        "lr": a.lr, "momentum": a.momentum, "weight_decay": a.weight_decay,
        "batch_size": a.batch_size, "depth": a.depth, "width": a.width,
    }
    rep = {}
    t0 = time.perf_counter()
    # one continuous run; each epoch streams a partial for the judge/ASHA
    err = train_and_eval(
        hp, epochs=a.epochs, n_train=a.n_train, n_val=a.n_val, hw=a.hw,
        on_epoch=lambda ep, e: report_partial(e, ep), device=device, report=rep,
    )
    call_s = time.perf_counter() - t0
    report_results([
        {"name": "val_error", "type": "objective", "value": err},
        {"name": "device", "type": "statistic", "value": name},
        {"name": "first_device_op_s", "type": "statistic", "value": first_op_s},
        {"name": "setup_s", "type": "statistic", "value": rep["setup_s"]},
        {"name": "train_s", "type": "statistic", "value": rep["train_s"]},
        {"name": "eval_s", "type": "statistic", "value": rep["eval_s"]},
        {"name": "train_ms_per_step", "type": "statistic",
         "value": rep["train_s"] / rep["steps"] * 1e3},
        {"name": "epoch_losses", "type": "statistic", "value": rep["losses"]},
        {"name": "train_and_eval_s", "type": "statistic", "value": call_s},
    ])


if __name__ == "__main__":
    main()
