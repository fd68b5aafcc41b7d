"""Agent steps a second: B episodes' steps of every tick completed in the
window, over the window's length."""


def read(run):
    return run.batch * len(run.ticks) / run.window_s
