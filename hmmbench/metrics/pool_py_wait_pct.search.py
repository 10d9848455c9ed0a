"""The pool's jobs waiting outside the native calls, for the GIL or a
core (``pool_py_wait_s``: their wall there less their CPU time) as a
share of its worker seconds."""

from hmmbench import counters


def read(run):
    return counters.pool_share(run, "pool_py_wait_s")
