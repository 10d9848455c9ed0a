"""HMMER's "Passed MSV filter" as a share: the pairs past the MSV gate
(``n_past_msv``) over the comparisons (``n_seqs_searched``)."""

from hmmbench import counters


def read(run):
    return counters.pass_share(run, "n_past_msv")
