"""The detector's operations a tick (the copied model_flops count) over
the mean tick time and the card's fp32 peak outside the tensor cores
(TF32 is off), as a share (%)."""

from portbench.reference import roofline


def read(run):
    if not run.detector_flops:
        return None
    tick_s = run.window_s / len(run.ticks)
    return (100.0 * run.batch * run.detector_flops
            / (tick_s * roofline.PEAK_FP32_FLOPS))
