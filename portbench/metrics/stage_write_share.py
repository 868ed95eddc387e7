"""Per cent of the window the saver thread spent in
``SampleStage.save_stage`` (the benchmark's span, by the host clock).
The writes overlap the next stage's device work, so this is the stage
files' load on the host, not time added to the window."""


def read(record):
    if record.save_s is None or record.window_s <= 0:
        return None
    return 100.0 * record.save_s / record.window_s
