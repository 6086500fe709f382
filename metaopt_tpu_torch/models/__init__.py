"""Demo model zoo (port of ``metaopt_tpu.models``).

- :mod:`mlp`         — MLP/MNIST-shaped, 4 hparams (BASELINE config 2)
- :mod:`transformer` — Transformer-base on one device (config 4's model)
"""

from metaopt_tpu_torch.models import mlp

__all__ = ["mlp"]
