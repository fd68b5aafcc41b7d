"""The map update's share of its roofline: the least bytes of the traced
ticks' updates (each touched voxel row read and written once, each
pixel's depth and class read once, by the benchmark's own binning) over
the HBM peak, against the device time of the update's launches."""

from portbench.reference import roofline, trace


def read(run):
    if run.trace is None or not run.mapping_bytes:
        return None
    launches, us = trace.launched_in(run.trace, "portbench.mapping")
    if not launches:
        return None
    least_s = run.mapping_bytes / roofline.PEAK_HBM_BYTES_PER_S
    return 100.0 * least_s / (us * 1e-6)
