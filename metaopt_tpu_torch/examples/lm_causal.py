#!/usr/bin/env python
"""Decoder-only causal LM trial, on one GPU.

    python -m metaopt_tpu_torch hunt -n lm --max-trials 20 --n-chips 1 \
        --config metaopt_tpu_torch/examples/tpe.json \
        metaopt_tpu_torch/examples/lm_causal.py \
        --lr~'loguniform(1e-4, 1e-1)' \
        --dropout~'uniform(0.0, 0.3)' \
        --n-layers~'uniform(1, 4, discrete=True)'

(``tpe.json`` holds ``examples/tpe.yaml``'s settings). The flags and
defaults are the reference's (``examples/lm_causal.py``). With ``--tp``,
``--sp`` or ``--ep`` above 1 (or a block of more than one GPU) the trial
runs one rank per GPU of its block (``hunt --n-chips N``) on the mesh those
flags carve, ``dp`` filling the rest. Every attention call runs the
flash-attention kernels under the causal mask (under ``--sp``, Ulysses
attention's; ring attention folds in plain PyTorch). When orchestrated, the trial saves its parameters and
optimizer state under ``client.checkpoint_paths()``'s own directory and
restores from its parent's (or its own) where one is published; the
checkpoints are the port's own format, not orbax.

Trains on ``--device`` (default ``cuda``; without CUDA it raises unless
given ``--device cpu``). Besides the objective (the last step's loss) it
reports the statistics ``transformer_wmt.py`` reports: the device's name,
the seconds from this process's start to its first finished device op, the
seconds before the training loop, of the loop and of saving the
checkpoint, ms per step, the first loss, whether it restored, the mesh it ran on (``dp=1,tp=2``), the AdamW
update count after the restore and at the end, whether ``torch._dynamo``
was imported, and the seconds of the whole ``train_lm`` call.
"""

import argparse
import sys
import time

from metaopt_tpu_torch import client
from metaopt_tpu_torch.client import report_results
from metaopt_tpu_torch.utils.procs import process_age_s


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--n-layers", dest="n_layers", type=int, default=2)
    p.add_argument("--d-model", dest="d_model", type=int, default=128)
    p.add_argument("--d-ff", dest="d_ff", type=int, default=512)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=64)
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1,
                   help=">1 shards the sequence (ring attention over the ranks)")
    p.add_argument("--ep", type=int, default=1,
                   help=">1 carves an expert-parallel mesh axis")
    p.add_argument("--n-experts", dest="n_experts", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    import torch

    from metaopt_tpu_torch.models.lm import train_lm
    from metaopt_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    torch.zeros(1, device=device).sum().item()  # context + first kernel, synchronized
    first_op_s = process_age_s()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    kw = {}
    if client.IS_ORCHESTRATED:
        # trial checkpoints: PBT handoff / suspended-trial resume
        own, parent = client.checkpoint_paths()
        kw = {"save_dir": own, "restore_dir": parent or own}
    rep = {}
    t0 = time.perf_counter()
    loss = train_lm(
        {"lr": a.lr, "dropout": a.dropout, "d_model": a.d_model,
         "n_layers": a.n_layers, "d_ff": a.d_ff,
         "n_heads": max(1, a.d_model // 64), "n_experts": a.n_experts},
        tp=a.tp, sp=a.sp, ep=a.ep,
        seq_len=a.seq_len, steps=a.steps,
        device=device, report=rep,
        **kw,
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
        {"name": "mesh", "type": "statistic",
         "value": ",".join(f"{k}={n}" for k, n in rep["mesh"].items()) or "one rank"},
        {"name": "restored_updates", "type": "statistic", "value": rep["restored_updates"]},
        {"name": "updates", "type": "statistic", "value": rep["updates"]},
        {"name": "torch_dynamo_imported", "type": "statistic",
         "value": "torch._dynamo" in sys.modules},
        {"name": "train_lm_s", "type": "statistic", "value": call_s},
    ])


if __name__ == "__main__":
    main()
