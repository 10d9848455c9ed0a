"""Sequences scanned by all the calls over their summed walls."""

from hmmbench import readers


def read(run):
    return readers.rate(run)
