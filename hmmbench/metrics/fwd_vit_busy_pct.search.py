"""The device time of the Forward and Viterbi filter kernels as a share
of the summed walls."""

from hmmbench import readers


def read(run):
    return readers.fwd_vit_busy_pct(run)
