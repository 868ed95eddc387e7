"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up
included, in units of 1e9 bytes (read before the comparison runs)."""


def read(record):
    return None if record.peak_bytes is None else record.peak_bytes / 1e9
