"""Chain-evaluations of the log-likelihood in the window over the window's
seconds: every stage's evaluations (``profiling.timings``) plus each call's
start population, all the work over all the time."""


def read(record):
    return record.evals / record.window_s if record.window_s > 0 else None
