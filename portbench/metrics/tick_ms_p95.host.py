"""The 95th percentile of every window tick's latency, in ms, where the
card idles most of the window and the host sets the tick."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.ticks) * 1e3, 95))
