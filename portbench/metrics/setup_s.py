"""Seconds from the process's start to the window's opening: imports, CUDA
start-up, the kernels' builds (cached in the checkout after a first run),
the problem's assembly and the warm-up call.  The observed data, which the
plain reference synthesises from the seed, are left out: their seconds
(``inputs_s``) are the reference's, not the program's."""


def read(record):
    return record.setup_s
