"""Packing the targets in set-up (the ``setup.pack`` span: ``block_key``,
``_Buckets`` and the upload) as a share of the summed walls."""

from hmmbench import counters


def read(run):
    return counters.wall_share(run, "setup.pack_s")
