#!/usr/bin/env python
"""BASELINE config 4: Hyperband on Transformer-base, on one GPU.

    python -m metaopt_tpu_torch hunt -n wmt --max-trials 27 --n-chips 1 \
        --config metaopt_tpu_torch/examples/hyperband.json \
        metaopt_tpu_torch/examples/transformer_wmt.py --tp 1 \
        --lr~'loguniform(1e-4, 5e-3)' \
        --dropout~'uniform(0.0, 0.3)' \
        --warmup~'uniform(100, 4000, discrete=True)' \
        --epochs~'fidelity(1, 9, base=3)'

The flags and defaults are the reference's (``examples/transformer_wmt.py``),
``--tp 2`` included; the port trains on one device and raises for tp, sp or
ep above 1, so one GPU runs with ``--tp 1``. Attention dropout runs inside
the flash-attention kernels. When orchestrated, the trial saves its
parameters and optimizer state under ``client.checkpoint_paths()``'s own
directory and restores from its parent's (or its own) where one is
published; the checkpoints are the port's own format, not orbax.

Trains on ``--device`` (default ``cuda``; without CUDA it raises unless
given ``--device cpu``). Besides the objective (the last step's loss) it
reports statistics: the device's name, the seconds from this process's
start to its first finished device op (interpreter, ``import torch``, the
CUDA context), the seconds before the training loop (model, optimizer,
restore, data), of the loop, of saving the checkpoint, ms per step, the
first and last losses, whether it restored, the AdamW update count after
the restore and at the end, whether ``torch._dynamo`` was
imported, and the seconds of the whole ``train_and_eval`` call.
"""

import argparse
import sys
import time

from metaopt_tpu_torch import client
from metaopt_tpu_torch.client import report_results
from metaopt_tpu_torch.utils.procs import process_age_s


def _ckpt_kwargs():
    own, parent = client.checkpoint_paths()
    return {"save_dir": own, "restore_dir": parent or own}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--sp", type=int, default=1,
                   help=">1 shards the sequence (not ported: raises)")
    p.add_argument("--ep", type=int, default=1,
                   help=">1 carves an expert-parallel mesh axis (not ported: raises)")
    p.add_argument("--n-experts", dest="n_experts", type=int, default=0,
                   help=">0 swaps FFNs for a top-1-routed MoE with this many experts")
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--d-model", dest="d_model", type=int, default=512,
                   help="model width (smoke runs shrink the base config)")
    p.add_argument("--n-layers", dest="n_layers", type=int, default=6)
    p.add_argument("--d-ff", dest="d_ff", type=int, default=2048)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    import torch

    from metaopt_tpu_torch.models.transformer import train_and_eval
    from metaopt_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    torch.zeros(1, device=device).sum().item()  # context + first kernel, synchronized
    first_op_s = process_age_s()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    rep = {}
    t0 = time.perf_counter()
    loss = train_and_eval(
        {"lr": a.lr, "dropout": a.dropout, "warmup": a.warmup,
         "d_model": a.d_model, "n_layers": a.n_layers, "d_ff": a.d_ff,
         "n_heads": max(1, a.d_model // 64), "n_experts": a.n_experts},
        tp=a.tp,
        sp=a.sp,
        ep=a.ep,
        steps=a.epochs * a.steps_per_epoch,
        device=device,
        report=rep,
        # trial checkpoints: a PBT continuation restores its parent's training
        # state; a re-run trial resumes its OWN (train_and_eval skips the
        # restore where the directory holds no published checkpoint)
        **(_ckpt_kwargs() if client.IS_ORCHESTRATED else {}),
    )
    call_s = time.perf_counter() - t0
    report_results([
        {"name": "loss", "type": "objective", "value": loss},
        {"name": "device", "type": "statistic", "value": name},
        {"name": "first_device_op_s", "type": "statistic", "value": first_op_s},
        {"name": "setup_s", "type": "statistic", "value": rep["setup_s"]},
        {"name": "train_s", "type": "statistic", "value": rep["train_s"]},
        {"name": "save_s", "type": "statistic", "value": rep["save_s"]},
        {"name": "ms_per_step", "type": "statistic",
         "value": rep["train_s"] / rep["steps"] * 1e3},
        {"name": "first_loss", "type": "statistic", "value": rep["losses"][0]},
        {"name": "restored", "type": "statistic", "value": rep["restored"]},
        {"name": "restored_updates", "type": "statistic", "value": rep["restored_updates"]},
        {"name": "updates", "type": "statistic", "value": rep["updates"]},
        {"name": "torch_dynamo_imported", "type": "statistic",
         "value": "torch._dynamo" in sys.modules},
        {"name": "train_and_eval_s", "type": "statistic", "value": call_s},
    ])


if __name__ == "__main__":
    main()
