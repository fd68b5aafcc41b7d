"""Host time a tick of the batched plan and its copy to the host (the
planning span, including its waits on the card), in ms."""


def read(run):
    times = run.spans.get("planning")
    return 1e3 * sum(times) / len(times) if times else None
