#!/usr/bin/env python
"""PBT demo: SGD on a quadratic with checkpoint handoff between rungs.

    python -m metaopt_tpu_torch hunt -n pbt \
        --config metaopt_tpu_torch/examples/pbt.json \
        --ckpt-root /tmp/pbt-ckpt \
        metaopt_tpu_torch/examples/pbt_sgd.py \
        --lr~'loguniform(1e-3, 1.0)' \
        --steps~'fidelity(4, 64, base=2)'

Each trial continues training the weights its parent left behind
(``client.checkpoint_paths``): a member that survives several rungs has
trained for the SUM of its budgets, which is the point of PBT — the
hyperparameters anneal along the run instead of restarting it. Imports no
``torch``.
"""

import argparse
import json
import os

from metaopt_tpu_torch import client


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--steps", type=int, required=True)
    a = p.parse_args()

    own, parent = client.checkpoint_paths()
    w, warm = 10.0, 0
    if parent:
        with open(os.path.join(parent, "w.json")) as f:
            w, warm = json.load(f)["w"], 1

    for _ in range(a.steps):
        w -= a.lr * 2.0 * (w - 3.0)  # d/dw (w-3)^2

    with open(os.path.join(own, "w.json"), "w") as f:
        json.dump({"w": w}, f)
    client.report_results([
        {"name": "loss", "type": "objective", "value": (w - 3.0) ** 2},
        {"name": "warm", "type": "statistic", "value": warm},
    ])


if __name__ == "__main__":
    main()
