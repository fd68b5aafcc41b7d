"""Seconds from the process's start to the end of the warm-up ticks:
imports, inputs, weights, buffers, set-up folds, kernel builds."""


def read(run):
    return run.setup_s
