"""The profiles in set-up (the ``setup.profiles`` span: ``model_key``,
both configurations, ``prewarm``, the upload, the pipelines and hit
tables of every chunk) as a share of the summed walls."""

from hmmbench import counters


def read(run):
    return counters.wall_share(run, "setup.profiles_s")
