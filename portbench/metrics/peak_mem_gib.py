"""The card's peak allocated memory over the run (set-up and window), in
GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
