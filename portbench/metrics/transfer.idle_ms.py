"""Time a tick the card idles inside the union of the program's copy
spans (mass.*.upload and mass.*.to_host), in ms."""

from portbench.reference import spans


def read(run):
    return spans.idle_inside(
        run, lambda name: name.endswith((".upload", ".to_host")))
