"""Lint fixture: host-sync calls inside a declared-hot function."""

import numpy as np


# mtpu: hotpath
def readback(dev_buf):
    host = np.asarray(dev_buf)
    return float(host.item())
