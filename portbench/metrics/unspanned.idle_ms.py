"""Time a tick the card idles in the traced window outside every one of
the program's mass.* spans, in ms."""

from portbench.reference import spans


def read(run):
    if run.trace is None:
        return None
    lo, hi = spans.window(run.trace)
    count, covered = spans.spans(run.trace, lambda name: True, lo, hi)
    if not count:
        return None
    outside = spans.complement(covered, lo, hi)
    return spans.per_tick_ms(run, spans.measure(spans.intersect(
        spans.idle(run.trace, lo, hi), outside)))
