#!/usr/bin/env python
"""BASELINE config 2: TPE on MLP/MNIST-shaped task (4 hparams, one GPU).

    python -m metaopt_tpu_torch hunt -n mlp --max-trials 40 \
        --config examples/tpe.yaml \
        metaopt_tpu_torch/examples/mlp_mnist.py \
        --lr~'loguniform(1e-4, 1e-1)' \
        --width~'uniform(64, 1024, discrete=True)' \
        --depth~'uniform(1, 6, discrete=True)' \
        --dropout~'uniform(0.0, 0.5)'

Trains on ``--device`` (default ``cuda``; without CUDA it raises unless
given ``--device cpu``). Besides the objective it reports statistics: the
device's name, the seconds from this process's start to its first
finished device op (interpreter, ``import torch``, the CUDA context and
module loading) and to its first finished matrix product (cuBLAS loaded),
the seconds before the training loop (model, data, optimizer) and of
constructing the optimizer alone, the seconds of the training loop, ms per
train step, and the seconds of the whole ``train_and_eval`` call.
"""

import argparse
import time

from metaopt_tpu_torch.utils.procs import process_age_s


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--depth", type=int, required=True)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    import torch

    from metaopt_tpu_torch.client import report_results
    from metaopt_tpu_torch.models.mlp import train_and_eval
    from metaopt_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    torch.zeros(1, device=device).sum().item()  # context + first kernel, synchronized
    first_op_s = process_age_s()
    eye = torch.eye(8, device=device)
    (eye @ eye).sum().item()                     # the BLAS library's first product
    first_matmul_s = process_age_s()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    rep = {}
    t0 = time.perf_counter()
    err = train_and_eval(
        {"lr": a.lr, "width": a.width, "depth": a.depth, "dropout": a.dropout},
        epochs=a.epochs, device=device, report=rep,
    )
    call_s = time.perf_counter() - t0
    report_results([
        {"name": "val_error", "type": "objective", "value": err},
        {"name": "device", "type": "statistic", "value": name},
        {"name": "first_device_op_s", "type": "statistic", "value": first_op_s},
        {"name": "first_matmul_s", "type": "statistic", "value": first_matmul_s},
        {"name": "setup_s", "type": "statistic", "value": rep["setup_s"]},
        {"name": "optimizer_init_s", "type": "statistic", "value": rep["optimizer_init_s"]},
        {"name": "train_s", "type": "statistic", "value": rep["train_s"]},
        {"name": "train_ms_per_step", "type": "statistic",
         "value": rep["train_s"] / rep["steps"] * 1e3},
        {"name": "train_and_eval_s", "type": "statistic", "value": call_s},
    ])


if __name__ == "__main__":
    main()
