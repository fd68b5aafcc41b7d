"""BFS convergence checks a tick: the program's mass.planning.bfs_check
spans in the traced window (a field of c checks relaxes 8c + 1 hops)."""

from portbench.reference import spans


def read(run):
    if run.trace is None:
        return None
    lo, hi = spans.window(run.trace)
    count, _ = spans.spans(run.trace,
                           lambda name: name == "mass.planning.bfs_check",
                           lo, hi)
    return count / run.traced_ticks if count else None
