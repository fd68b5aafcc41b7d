"""The traced ticks' window less the union of kernel, copy and memset
intervals, as a share of the window (%)."""


def read(run):
    if run.trace is None or not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)
