"""The main thread handing jobs to the pool (``submit_s``: building
each job and ``executor.submit``, every stage) as a share of the
summed walls."""

from hmmbench import counters


def read(run):
    return counters.wall_share(run, "submit_s")
