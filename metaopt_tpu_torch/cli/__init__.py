"""Command-line interface (port of ``metaopt_tpu.cli``).

    python -m metaopt_tpu_torch hunt -n exp ./train.py --lr~'loguniform(1e-5, 1e-1)'

Subcommands: hunt, init-only, insert, resume, list, status, info.
"""

from metaopt_tpu_torch.cli.main import build_parser, main

__all__ = ["main", "build_parser"]
