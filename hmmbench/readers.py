"""Arithmetic shared by the metric readers of ``hmmbench/metrics``.

A reader takes the run (:class:`hmmbench.harness.Run`) and returns a
number, or None where the run holds nothing to read (an untraced run
has no timeline).  Shares are of the summed walls of the window's calls.
"""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

#: the MSV filter's kernels (``csrc/msv.cu``), and Forward's and
#: Viterbi's (``csrc/fwd.cu``, ``csrc/vit.cu``), by their names in the
#: trace
MSV_KERNELS = r"\b(msv_kernel|msv_cta_kernel|bias_kernel)\b"
FWD_VIT_KERNELS = (r"\b(fwd_kernel|fwd_block_kernel|fwd_cta_kernel"
                   r"|vit_kernel|vit_cta_kernel)\b")


def pct(run, seconds: float) -> Optional[float]:
    return 100.0 * seconds / run.walls_s if run.walls_s > 0 else None


def rate(run) -> Optional[float]:
    """Work of all the calls over their summed walls."""
    work = sum(r["work"] for r in run.records)
    return work / run.walls_s if run.walls_s > 0 and work else None


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (``statistics.quantiles``, exclusive
    method) of ``values``, or None where fewer than ten samples would
    lie beyond it."""
    n = len(values)
    if n * (100 - q) < 1000:
        return None
    cuts = statistics.quantiles(values, n=100)
    return cuts[int(q) - 1]


def engine_setup_pct(run):
    return pct(run, run.timing_sum("setup_s"))


def s1_host_pct(run):
    return pct(run, run.timing_sum("s1_host_done", "s1_fetched"))


def postproc_pct(run):
    return pct(run, run.timing_sum("collect_done", "rows_done"))


def msv_roofline(run):
    """The calls' MSV bound over the device time of the MSV kernels
    (the union of their intervals)."""
    if run.timeline is None:
        return None
    t = run.timeline.busy_s(MSV_KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(r["msv_bound_s"] for r in run.records) / t


def fwd_vit_busy_pct(run):
    if run.timeline is None:
        return None
    return pct(run, run.timeline.busy_s(FWD_VIT_KERNELS))


def device_idle_pct(run):
    if run.timeline is None:
        return None
    busy = pct(run, run.timeline.busy_s())
    return None if busy is None else 100.0 - busy


def peak_device_mib(run):
    return run.peak_bytes / 2.0 ** 20 if run.peak_bytes else None
