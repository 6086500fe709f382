"""Demo model zoo (port of ``metaopt_tpu.models``).

- :mod:`objectives`  — closed-form CPU objectives (Rosenbrock; config 1)
- :mod:`mlp`         — MLP/MNIST-shaped, 4 hparams (BASELINE config 2)
- :mod:`transformer` — Transformer-base on one device (config 4's model)
- :mod:`checkpoint`  — per-trial checkpoints (``torch.save``, published by rename)

Only :mod:`objectives` is imported here: a trial process that reports a
closed-form objective must not pay the ``torch`` import. Import ``mlp`` and
``transformer`` by name.
"""

from metaopt_tpu_torch.models import objectives

__all__ = ["objectives"]
