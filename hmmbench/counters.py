"""Readers of the engine's own spans and counters (``SearchEngine``'s
``last_timing``: the ``<name>_s`` spans of ``engine.span``, the pool's
seconds, HMMER's pipeline statistics).

Each gives None where no call of the run holds the key, as a program
without that span or counter reports none.
"""

from __future__ import annotations

from typing import Optional

from . import readers


def held(run, key: str) -> bool:
    return any(key in r["timing"] for r in run.records)


def wall_share(run, key: str) -> Optional[float]:
    """The calls' sum of ``key`` as a share of their summed walls."""
    return readers.pct(run, run.timing_sum(key)) if held(run, key) else None


def pool_share(run, key: str) -> Optional[float]:
    """The calls' sum of ``key`` as a share of their pools' worker
    seconds (``pool_worker_s``: workers times the pool's lifetime)."""
    if not held(run, key):
        return None
    workers = run.timing_sum("pool_worker_s")
    return 100.0 * run.timing_sum(key) / workers if workers > 0 else None


def pass_share(run, key: str) -> Optional[float]:
    """The calls' sum of ``key`` (a count of pairs past a filter) as a
    share of their comparisons (``n_seqs_searched``)."""
    if not held(run, key):
        return None
    n = run.timing_sum("n_seqs_searched")
    return 100.0 * run.timing_sum(key) / n if n > 0 else None
