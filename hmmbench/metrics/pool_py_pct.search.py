"""The pool's jobs running Python on a core (``pool_py_s``: their thread
CPU time outside the native calls) as a share of its worker
seconds."""

from hmmbench import counters


def read(run):
    return counters.pool_share(run, "pool_py_s")
