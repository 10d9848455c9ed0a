"""Stage 1's main thread blocked on the exact bias filter's pool jobs
(the ``s1.bias_wait`` span) as a share of the summed walls."""

from hmmbench import counters


def read(run):
    return counters.wall_share(run, "s1.bias_wait_s")
