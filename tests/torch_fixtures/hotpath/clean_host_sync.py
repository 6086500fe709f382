"""Hot-path fixture: the clean counterpart of ``bad_host_sync.py``.

The same work kept on the device: tensor methods that never wait for the
card, casts of constants, and ``.float()`` (a dtype change, not a Python
scalar). The host syncs below sit in a function that is not hot. Parsed,
never imported.
"""

import numpy as np
import torch


# mtpu: hotpath
def on_device(x, n):
    y = torch.where(x > 0, x, torch.zeros_like(x))
    z = y.float() * float("inf") + int(3) + bool(1)
    return z.sum(dim=-1), torch.as_tensor(n, device=x.device)


def cold_readback(x):
    return x.item(), np.asarray(x.cpu())
