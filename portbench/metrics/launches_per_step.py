"""CUDA calls that hand work to the device (launches, copies, fills) in the
profiled Metropolis steps, over the steps."""


def read(record):
    if record.trace is None or not record.trace_steps:
        return None
    return record.trace.launches / record.trace_steps
