"""Hot-path fixture: each PyTorch host sync inside a declared-hot function.

One call per line, in the order of ``LintConfig.host_sync_calls``'s
documentation; ``test_torch_lint.py`` expects MTJ003 on every one of them.
Parsed, never imported.
"""

import numpy as np
import torch


# mtpu: hotpath
def readback(x, n):
    a = x.item()
    b = x.cpu()
    c = x.tolist()
    d = x.detach().numpy()
    torch.cuda.synchronize()
    e = float(x)
    f = int(n)
    g = bool(x.any())
    h = np.asarray(x)
    i = np.array(x)
    return a, b, c, d, e, f, g, h, i


class Pool:
    # mtpu: hotpath
    def eval(self, cols):
        return cols["x"].sum().item()
