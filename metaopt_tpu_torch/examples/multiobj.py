#!/usr/bin/env python
"""Multi-objective demo: the ZDT1-style bi-objective trade-off.

Trials report TWO objective-typed results (report order = vector order);
the motpe algorithm searches for the Pareto front.

    python -m metaopt_tpu_torch hunt -n mo --max-trials 24 \
        --config metaopt_tpu_torch/examples/motpe.json \
        metaopt_tpu_torch/examples/multiobj.py -x~'uniform(0, 1)' -y~'uniform(0, 1)'

MOTPE's EI launches run on ``cuda``; on a machine without CUDA give the
config's ``motpe`` entry ``"device": "cpu"``. Imports no ``torch``.
"""

import argparse
import math

from metaopt_tpu_torch.client import report_results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-x", type=float, required=True)
    p.add_argument("-y", type=float, required=True)
    a = p.parse_args()
    # ZDT1 with n=2: f1 = x; f2 = g·(1 − sqrt(x/g)), g = 1 + 9·y.
    # The Pareto set is y = 0 with x sweeping the trade-off.
    f1 = a.x
    g = 1.0 + 9.0 * a.y
    f2 = g * (1.0 - math.sqrt(max(f1, 0.0) / g))
    report_results([
        {"name": "f1", "type": "objective", "value": f1},
        {"name": "f2", "type": "objective", "value": f2},
    ])


if __name__ == "__main__":
    main()
