"""Per cent of the profiled sub-window in which no kernel, copy or fill ran
on the device."""


def read(record):
    t = record.trace
    if t is None or t.busy_s is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
