"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device
(the CPU tests pass ``device="cpu"``). Without CUDA they raise: they never
drift to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
