"""Share of the traced window's mass.planning.bfs spans (one a BFS field)
inside which the program launched the BFS kernel: a launch made inside
the span whose device record is the kernel, found by its symbol
(``bfs_field_kernel``), in %.  0 where every field ran without it."""

from portbench.reference import spans, trace

SYMBOL = "bfs_field_kernel"


def read(run):
    if run.trace is None:
        return None
    lo, hi = spans.window(run.trace)
    fields = [(a, b) for a, b in trace.spans(run.trace, "mass.planning.bfs")
              if lo <= a < hi]
    if not fields:
        return None
    kernels = {e.get("args", {}).get("correlation")
               for e in trace.complete(run.trace, ("kernel",))
               if SYMBOL in e["name"]}
    launches = [e["ts"] for e in trace.complete(run.trace, trace.LAUNCH)
                if e.get("args", {}).get("correlation") in kernels]
    hit = sum(any(a <= t <= b for t in launches) for a, b in fields)
    return 100.0 * hit / len(fields)
