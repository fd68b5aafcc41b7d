"""Device time a tick of the operations launched inside the dense
update's span (the backbone, the binning, the sort and the dense splats):
the union of their intervals, in ms."""

from portbench.reference import trace


def read(run):
    if run.trace is None:
        return None
    launches, us = trace.launched_in(run.trace, "portbench.dense")
    return us * 1e-3 / run.traced_ticks if launches else None
