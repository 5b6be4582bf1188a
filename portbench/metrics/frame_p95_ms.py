"""The 95th percentile of the frames' times (ms, host clock), over every
frame in the part of a traced run's window after the profiler stopped."""

import numpy as np


def read(ctx):
    tail = ctx.tail
    if not tail or len(tail["lat"]) < 20:
        return None
    return float(np.percentile(np.asarray(tail["lat"]) * 1e3, 95))
