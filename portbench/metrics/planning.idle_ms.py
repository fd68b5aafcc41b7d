"""Time a tick the card idles inside the union of the program's
mass.planning.* spans, in ms."""

from portbench.reference import spans


def read(run):
    return spans.idle_inside(
        run, lambda name: name.startswith("mass.planning."))
