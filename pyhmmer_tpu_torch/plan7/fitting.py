"""Maximum-likelihood fits for E-value calibration distributions.

NumPy ports of the Easel statistics routines the reference's calibration
stack is built on (``esl_gumbel.c`` / ``esl_exponential.c`` roles, used
by ``evalues.c``: ``p7_Lambda`` / ``p7_MSVMu`` / ``p7_ViterbiMu`` /
``p7_Tau``; SURVEY.md section 2.5 Builder row):

* :func:`gumbel_fit_complete` -- full ML fit of (mu, lambda) to complete
  Gumbel-distributed data (``esl_gumbel_FitComplete``): solves
  ``sum x_i exp(-lambda x_i) / sum exp(-lambda x_i) = mean(x) - 1/lambda``
  for lambda by Newton-Raphson (the Lawless 1982 estimating equation),
  then ``mu = -log(mean(exp(-lambda x))) / lambda``.
* :func:`gumbel_fit_complete_loc` -- ML location with known lambda
  (``esl_gumbel_FitCompleteLoc``) -- what the reference's filter-mu
  calibrations actually use, with lambda fixed by ``p7_Lambda``.
* :func:`exp_fit_complete` -- ML fit of an exponential tail
  (``esl_exp_FitComplete``): ``mu = min(x)``,
  ``lambda = 1 / (mean(x) - mu)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gumbel_fit_complete", "gumbel_fit_complete_loc",
           "exp_fit_complete"]


def _gumbel_lawless(x: np.ndarray, lam: float):
    """Lawless (1982) eq. 4.1.5: value and derivative of the Gumbel ML
    estimating function at ``lam`` (zero at the ML lambda)."""
    ex = np.exp(-lam * x)
    esum = ex.sum()
    xesum = (x * ex).sum()
    xxesum = (x * x * ex).sum()
    xsum = x.sum()
    n = len(x)
    fx = (1.0 / lam) - (xsum / n) + (xesum / esum)
    dfx = (xesum * xesum) / (esum * esum) - xxesum / esum - 1.0 / (
        lam * lam)
    return fx, dfx


def gumbel_fit_complete(x: np.ndarray, tol: float = 1e-6,
                        maxit: int = 100):
    """Full ML (mu, lambda) Gumbel fit to complete data
    (``esl_gumbel_FitComplete``).  Newton-Raphson on the Lawless
    estimating equation, with a bisection fallback exactly like Easel's
    implementation.  Returns ``(mu, lambda)``."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 2:
        raise ValueError("need at least 2 samples")
    # Easel's starting guess: lambda = pi / sqrt(6 var)
    var = x.var()
    lam = np.pi / np.sqrt(6.0 * var) if var > 0 else 1.0

    converged = False
    for _ in range(maxit):
        fx, dfx = _gumbel_lawless(x, lam)
        if abs(fx) < tol:
            converged = True
            break
        lam -= fx / dfx
        if lam <= 0.0:
            lam = 0.001
    if not converged:
        # bisection fallback (esl_gumbel.c lawless416 bracket walk)
        left, right = 0.0, lam
        fx, _ = _gumbel_lawless(x, right)
        while fx > 0.0:
            right *= 2.0
            if right > 100.0:
                raise RuntimeError("Gumbel fit failed to bracket")
            fx, _ = _gumbel_lawless(x, right)
        for _ in range(100):
            mid = (left + right) / 2.0
            fx, _ = _gumbel_lawless(x, mid)
            if abs(fx) < tol:
                break
            if fx > 0.0:
                left = mid
            else:
                right = mid
        lam = mid
    esum = np.exp(-lam * x).mean()
    mu = -np.log(esum) / lam
    return float(mu), float(lam)


def gumbel_fit_complete_loc(x: np.ndarray, lam: float) -> float:
    """ML Gumbel location with known lambda
    (``esl_gumbel_FitCompleteLoc``):
    ``mu = -(1/lambda) log( (1/n) sum exp(-lambda x_i) )``.

    Example:
        >>> import numpy
        >>> rng = numpy.random.default_rng(1)
        >>> x = 2.0 - numpy.log(-numpy.log(rng.uniform(size=8000))) / 0.7
        >>> round(gumbel_fit_complete_loc(x, 0.7), 1)
        2.0
    """
    x = np.asarray(x, dtype=np.float64)
    return float(-np.log(np.exp(-lam * x).mean()) / lam)


def exp_fit_complete(x: np.ndarray):
    """ML exponential fit to complete data (``esl_exp_FitComplete``):
    location ``mu = min(x)``, rate ``lambda = 1/(mean(x) - mu)``.
    Returns ``(mu, lambda)``."""
    x = np.asarray(x, dtype=np.float64)
    mu = float(x.min())
    mean_excess = float(x.mean() - mu)
    lam = 1.0 / mean_excess if mean_excess > 0 else np.inf
    return mu, lam
