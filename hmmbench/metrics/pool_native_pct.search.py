"""The pool's jobs inside the native C calls (``pool_native_s``:
``hmmdp_domaindef``, ``hmmdp_viterbi``, ``hmmdp_bias_filter_idx``) as a
share of its worker seconds."""

from hmmbench import counters


def read(run):
    return counters.pool_share(run, "pool_native_s")
