"""Device time a tick of the operations launched inside the sensor's
span: the union of their intervals, in ms."""

from portbench.reference import trace


def read(run):
    if run.trace is None:
        return None
    launches, us = trace.launched_in(run.trace, "portbench.sensor")
    return us * 1e-3 / run.traced_ticks if launches else None
