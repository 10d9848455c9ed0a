"""Shared filter-score quantization.

The uint8 MSV quantization (``mf_conversion`` semantics: 1/3-bit units,
base 190, bias = rounded max emission) must be bit-identical between the
NumPy oracle and the batched TPU kernels, so both derive their tensors
here.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass

NEGMASS = -1e30


@dataclass
class MSVQuant:
    """Quantized MSV parameters for one profile."""
    cost: np.ndarray      # [Kp, M] biased emission costs, 0..255 (int32)
    bias_b: int
    base_b: int
    scale_b: float
    tec_b: int            # E->J/C cost
    tbm_b: int            # B->Mk entry cost
    M: int

    def tjb_b(self, L) -> np.ndarray:
        """N->B / J->B move cost for target length(s) L."""
        L = np.asarray(L, dtype=np.float64)
        return np.minimum(255, np.rint(
            -self.scale_b * np.log(3.0 / (L + 3.0)))).astype(np.int32)


def tjb_units(L) -> np.ndarray:
    """N->B / J->B / C->T move cost in 1/3-bit units for length(s) L
    (``p7_oprofile_ReconfigMSVLength`` rounding).  The batched kernels
    return ``xJ - base``; the final usc must charge one more of these
    for the C->T move."""
    scale_b = 3.0 / np.log(2.0)
    L = np.asarray(L, dtype=np.float64)
    return np.minimum(255, np.rint(
        -scale_b * np.log(3.0 / (L + 3.0)))).astype(np.int32)


def quantize_msv(prof) -> MSVQuant:
    """Build the uint8 MSV scoring system for a configured profile
    (cached on the profile: emissions are length-independent)."""
    cached = getattr(prof, "_msv_quant", None)
    if cached is not None and cached.M == prof.M:
        return cached
    scale_b = 3.0 / np.log(2.0)
    base_b = 190
    msc = np.maximum(prof.msc, NEGMASS)          # [Kp, M+1] nats
    maxsc = float(msc[:, 1:].max())
    bias_b = min(255, int(round(scale_b * maxsc)))
    with np.errstate(invalid="ignore"):
        cost = np.rint(-scale_b * msc[:, 1:])
    cost = np.clip(cost + bias_b, 0, 255).astype(np.int32)

    def ub(sc_nats: float) -> int:
        return min(255, int(round(-scale_b * sc_nats)))

    out = MSVQuant(
        cost=cost,
        bias_b=bias_b,
        base_b=base_b,
        scale_b=scale_b,
        tec_b=ub(np.log(0.5)),
        tbm_b=ub(np.log(2.0 / (prof.M * (prof.M + 1.0)))),
        M=prof.M,
    )
    try:
        prof._msv_quant = out
    except AttributeError:
        pass
    return out
