"""Seconds from the start of run.py to the first timed call: imports,
the kernels' build or load, the inputs, the warm call."""


def read(run):
    return run.setup_s
