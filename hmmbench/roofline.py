"""The card's peaks and the least time a call's MSV filter needs.

A frozen copy of ``chip_smoke.py``'s table and bound (recounted in the
port's PRs 6 and 12).  The MSV filter of one (profile, sequence) pair
needs M x L cells; the DPX kernels issue 1.25 integer instructions a
cell (a VIMNMX.S16x2.RELU, a VIADDMNMX.S16x2 and half a
VIMNMX3.S16x2.RELU for a word of two cells), taken at the integer issue
rate, plus the fused bias filter's 10 float operations a (profile,
residue).  Bytes: each profile's table read once, each residue once,
and three 32-bit outputs a pair written once.  The bound is the larger
of the two times.  Peaks are NVIDIA's for one H100 SXM at its full
700 W power limit.
"""

from __future__ import annotations

from typing import Sequence

HBM_RATE = 3.35e12                    # bytes/s
F32_RATE = 67e12                      # float32 operations/s
INT_RATE = 132 * 64 * 1.98e9          # integer instructions/s
MSV_INSNS = 1.25                      # a cell
BIAS_FLOPS = 10                       # a (profile, residue)
KP = 29                               # residue codes of a profile table
TABLE_BYTES = 2                       # a 16-bit table entry
OUT_BYTES = 12                        # dx, ovf, biaslog a pair


def msv_bound_s(Ms: Sequence[int], Ls: Sequence[int]) -> float:
    """Least seconds the MSV filter of every profile of lengths ``Ms``
    against every sequence of lengths ``Ls`` needs on one H100."""
    sum_m = float(sum(Ms))
    sum_l = float(sum(Ls))
    pairs = float(len(Ms)) * float(len(Ls))
    ops_s = (MSV_INSNS * sum_m * sum_l / INT_RATE
             + BIAS_FLOPS * len(Ms) * sum_l / F32_RATE)
    bytes_s = (KP * TABLE_BYTES * sum_m + sum_l
               + OUT_BYTES * pairs) / HBM_RATE
    return max(ops_s, bytes_s)
