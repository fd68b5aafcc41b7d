"""The dense splat kernel's share of its roofline: the least bytes of the
traced ticks' dense updates (each touched voxel row of F float32 read and
written once, each record's id, weight and pixel read once, each pixel's
feature row read once, by the benchmark's own binning) over the HBM peak,
against the device time of the kernel's records in the traced window,
found by its symbol (``splat_dense_kernel``), in %."""

from portbench.reference import roofline, spans, trace

SYMBOL = "splat_dense_kernel"


def read(run):
    if run.trace is None or not run.dense_bytes:
        return None
    lo, hi = spans.window(run.trace)
    us = sum(min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)
             for e in trace.complete(run.trace, ("kernel",))
             if SYMBOL in e["name"] and e["ts"] < hi
             and e["ts"] + e["dur"] > lo)
    if not us:
        return None
    least_s = run.dense_bytes / roofline.PEAK_HBM_BYTES_PER_S
    return 100.0 * least_s / (us * 1e-6)
