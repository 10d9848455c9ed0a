"""Engine set-up (``last_timing["setup_s"]``: profile configuration,
packing, upload) as a share of the summed walls."""

from hmmbench import readers


def read(run):
    return readers.engine_setup_pct(run)
