"""Survivor pairs a native domaindef call finishes: the pairs that
reached the native domain definition (``dd_pairs``) over the native
calls that ran it (``dd_native_calls``: batch calls and per-pair
calls)."""

from hmmbench import counters


def read(run):
    if not counters.held(run, "dd_pairs"):
        return None
    calls = run.timing_sum("dd_native_calls")
    return run.timing_sum("dd_pairs") / calls if calls > 0 else None
