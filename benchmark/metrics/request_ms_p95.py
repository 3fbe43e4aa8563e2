"""The 95th percentile of every request's time in the window, from its
start to its outputs on the host."""

import numpy as np


def read(ctx):
    if not ctx.window.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.window.latencies), 95) * 1e3)
