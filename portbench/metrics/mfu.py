"""The network's operations a tick over the mean tick time and the card's
fp32 peak outside the tensor cores (TF32 is off), as a share (%): the
detector's (the copied model_flops count) and the stage-1 backbone's
(``reference/resnet.flops``) on each of the B frames, whichever the
configuration runs."""

from portbench.reference import roofline


def read(run):
    flops = run.detector_flops + run.backbone_flops
    if not flops:
        return None
    tick_s = run.window_s / len(run.ticks)
    return (100.0 * run.batch * flops
            / (tick_s * roofline.PEAK_FP32_FLOPS))
