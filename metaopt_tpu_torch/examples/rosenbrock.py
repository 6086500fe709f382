#!/usr/bin/env python
"""BASELINE config 1: Random search on Rosenbrock-2D (CPU-only objective).

    python -m metaopt_tpu_torch hunt -n rosen --max-trials 100 \
        metaopt_tpu_torch/examples/rosenbrock.py \
        -x~'uniform(-5, 10)' -y~'uniform(-5, 10)'

Imports no ``torch``: the trial process pays only the interpreter's start.
"""

import argparse

from metaopt_tpu_torch.client import report_objective
from metaopt_tpu_torch.models.objectives import rosenbrock


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-x", type=float, required=True)
    p.add_argument("-y", type=float, required=True)
    a = p.parse_args()
    report_objective(rosenbrock({"x": a.x, "y": a.y}))


if __name__ == "__main__":
    main()
