"""Stage 1 on the host (MSV gate, exact bias filter, routing:
``s1_fetched`` to ``s1_host_done``) as a share of the summed walls."""

from hmmbench import readers


def read(run):
    return readers.s1_host_pct(run)
