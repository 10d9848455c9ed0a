"""The share of the summed walls in which no operation ran on the card."""

from hmmbench import readers


def read(run):
    return readers.device_idle_pct(run)
