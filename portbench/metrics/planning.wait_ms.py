"""Host time a tick that planning waits on the card: the union of the
program's mass.planning.bfs_check and mass.planning.to_host spans in the
traced window, in ms."""

from portbench.reference import spans

WAITS = ("mass.planning.bfs_check", "mass.planning.to_host")


def read(run):
    if run.trace is None:
        return None
    lo, hi = spans.window(run.trace)
    count, covered = spans.spans(run.trace, lambda name: name in WAITS,
                                 lo, hi)
    return spans.per_tick_ms(run, spans.measure(covered)) if count else None
