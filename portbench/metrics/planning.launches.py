"""Device operations launched a tick inside the planning span."""

from portbench.reference import trace


def read(run):
    if run.trace is None:
        return None
    launches, _ = trace.launched_in(run.trace, "portbench.planning")
    return launches / run.traced_ticks if launches else None
