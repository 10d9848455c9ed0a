"""Postprocessing (the domain definition pool and the collect loop:
``rows_done`` to ``collect_done``) as a share of the summed walls."""

from hmmbench import readers


def read(run):
    return readers.postproc_pct(run)
