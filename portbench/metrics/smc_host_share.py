"""Per cent of the window outside the SMC stages' records of
``profiling.timings``: stage transitions, stage-0 evaluations, the set-up
of each call and the wait for its last stage file."""


def read(record):
    if record.window_s <= 0:
        return None
    return 100.0 * (record.window_s - record.stage_s) / record.window_s
