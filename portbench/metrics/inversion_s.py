"""The window's seconds over the inversions that reached beta = 1 in it."""


def read(record):
    n = record.converged
    return record.window_s / n if n else None
