"""E-value statistics: Gumbel and exponential-tail survival functions.

Semantics of Easel's ``esl_gumbel`` / ``esl_exponential`` as used by the
pipeline gates and reporting (``p7_pipeline.c``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["gumbel_surv", "exp_surv", "gumbel_logsurv", "exp_logsurv",
           "gumbel_invsurv"]


def gumbel_invsurv(p, mu, lam):
    """x such that P(S > x) = p for a Gumbel distribution
    (``esl_gumbel_invsurv``)."""
    p = np.asarray(p, dtype=np.float64)
    # invert 1 - exp(-exp(-lam (x - mu))) = p
    return mu - np.log(-np.log1p(-p)) / lam


def gumbel_surv(x, mu, lam):
    """P(S > x) for a Gumbel distribution (``esl_gumbel_surv``)."""
    y = lam * (np.asarray(x, dtype=np.float64) - mu)
    ey = -np.exp(-y)
    # 1 - exp(ey); for small |ey| use -expm1 for precision
    return np.where(np.abs(ey) < 1e-4, -ey, -np.expm1(ey))


def gumbel_logsurv(x, mu, lam):
    """log P(S > x) (``esl_gumbel_logsurv``)."""
    y = lam * (np.asarray(x, dtype=np.float64) - mu)
    ey = -np.exp(-y)
    with np.errstate(divide="ignore"):
        return np.where(
            np.abs(ey) < 1e-4,
            np.log(-ey),
            np.log(-np.expm1(ey)),
        )


def exp_surv(x, tau, lam):
    """P(S > x) for an exponential tail (``esl_exp_surv``)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < tau, 1.0, np.exp(-lam * (x - tau)))


def exp_logsurv(x, tau, lam):
    """log P(S > x) (``esl_exp_logsurv``)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < tau, 0.0, -lam * (x - tau))
