"""The median of the calls' walls (seconds): the highest percentile with
at least ten calls beyond it when a window holds about 25 calls."""

from hmmbench import readers


def read(run):
    return readers.percentile([r["wall_s"] for r in run.records], 50)
