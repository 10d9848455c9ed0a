"""Search profiles and the null models, in plain NumPy: the benchmark's
reference.

Frozen copies, cut to the protein alphabet, of the host code of
``pyhmmer_tpu_torch``: the amino alphabet's degeneracies and expected
scores (``easel/alphabet.py``), the null1 and composition-bias filter
models (``plan7/background.py``, its NumPy path), a model's occupancy
and composition (``plan7/hmm.py``), the local profile configuration
(``plan7/profile.py``) and the E-value tails (``plan7/evalues.py``).  A
profile is configured from a model's arrays (``t``, ``mat``, ``ins``,
``evparam``), the same arrays the program is handed.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from .dp import rnd

#: amino symbols in Easel's digital order (K = 20 canonical, Kp = 29)
SYMBOLS = "ACDEFGHIKLMNPQRSTVWY-BJZOUX*~"
DEGENERACY = {"B": "DN", "J": "IL", "Z": "EQ", "O": "K", "U": "C",
              "X": "ACDEFGHIKLMNPQRSTVWY"}
#: Swiss-Prot 50.8 amino acid frequencies (p7_AminoFrequencies)
AMINO_FREQUENCIES = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float64)
# transitions of a core model's ``t`` rows
MM, MI, MD, IM, II, DM, DD = range(7)


class Amino:
    """The protein alphabet: ``K``, ``Kp`` and ``degen`` [Kp, K]."""

    K = 20
    Kp = len(SYMBOLS)

    def __init__(self):
        self.degen = np.zeros((self.Kp, self.K), dtype=bool)
        for i in range(self.K):
            self.degen[i, i] = True
        for sym, members in DEGENERACY.items():
            for m in members:
                self.degen[SYMBOLS.index(sym), SYMBOLS.index(m)] = True

    def expect_score_vector(self, sc: np.ndarray, f: np.ndarray
                            ) -> np.ndarray:
        """A K-long score vector extended to Kp: degenerate codes score
        the background-weighted mean of their members; gap, nonresidue
        and missing codes -inf."""
        sc = np.asarray(sc, dtype=np.float64)
        out = np.full(sc.shape[:-1] + (self.Kp,), -np.inf, dtype=np.float64)
        out[..., : self.K] = sc
        for code in range(self.K + 1, self.Kp - 2):
            members = self.degen[code]
            w = f[members]
            out[..., code] = (sc[..., members] * w).sum(axis=-1) / w.sum()
        return out


AMINO = Amino()


def gumbel_invsurv(p, mu, lam):
    p = np.asarray(p, dtype=np.float64)
    return mu - np.log(-np.log1p(-p)) / lam


def gumbel_surv(x, mu, lam):
    """P(S > x) for a Gumbel distribution (``esl_gumbel_surv``)."""
    y = lam * (np.asarray(x, dtype=np.float64) - mu)
    ey = -np.exp(-y)
    return np.where(np.abs(ey) < 1e-4, -ey, -np.expm1(ey))


def exp_surv(x, tau, lam):
    """P(S > x) for an exponential tail (``esl_exp_surv``)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < tau, 1.0, np.exp(-lam * (x - tau)))


class Background:
    """The null1 model and the two-state composition-bias filter."""

    def __init__(self):
        self.residue_frequencies = AMINO_FREQUENCIES.copy()
        self.omega = 1.0 / 256.0
        self._filter_compo: Optional[np.ndarray] = None
        self._filter_odds: Optional[np.ndarray] = None

    @staticmethod
    def null_one(L: int) -> float:
        p1 = float(L) / float(L + 1)
        return L * np.log(p1) + np.log(1.0 - p1)

    def set_filter(self, compo: np.ndarray) -> None:
        self._filter_compo = np.asarray(compo, dtype=np.float64)
        self._filter_odds = None

    def filter_odds_table(self) -> np.ndarray:
        if self._filter_odds is None:
            f = self.residue_frequencies
            K, Kp = AMINO.K, AMINO.Kp
            e1 = np.ones(Kp)
            odds1 = (0.5 * self._filter_compo + 0.5 * f) / f
            e1[:K] = odds1
            for code in range(K + 1, Kp - 2):
                members = AMINO.degen[code]
                w = f[members]
                e1[code] = (odds1[members] * w).sum() / w.sum()
            e1[K] = e1[Kp - 2] = e1[Kp - 1] = 1.0
            self._filter_odds = e1
        return self._filter_odds

    def filter_score(self, dsq: np.ndarray) -> float:
        """The bias filter's score of a digital sequence, in nats: the
        Forward score of a two-state HMM (background, and the model's
        composition smoothed with the background, dwelling about 50
        residues) with the null1 length model on top
        (``p7_bg_FilterScore``'s shape, as the program calibrates it)."""
        L = len(dsq)
        e1 = self.filter_odds_table()
        e0 = np.ones_like(e1)
        p1 = float(L) / float(L + 1)
        t00, t01 = p1, 1.0 - p1
        mean1 = 50.0
        t11 = mean1 / (mean1 + 1.0)
        t10 = 1.0 - t11
        a = np.array([0.999 * e0[dsq[0]], 0.001 * e1[dsq[0]]])
        logsc = 0.0
        T = np.array([[t00, t01], [t10, t11]])
        for i in range(1, L):
            a = rnd(a @ T)
            a[0] *= e0[dsq[i]]
            a[1] *= e1[dsq[i]]
            a = rnd(a)
            s = a.sum()
            if s > 0 and (s > 1e30 or s < 1e-30):
                a /= s
                logsc += np.log(s)
        logsc += np.log(a.sum())
        return logsc + L * np.log(p1) + np.log(1.0 - p1)


def match_occupancy(M: int, t: np.ndarray) -> np.ndarray:
    occ = np.zeros(M + 1, dtype=np.float64)
    occ[1] = t[0, MI] + t[0, MM]
    for k in range(2, M + 1):
        occ[k] = (occ[k - 1] * (t[k - 1, MM] + t[k - 1, MI])
                  + (1.0 - occ[k - 1]) * t[k - 1, DM])
    return occ


def composition(M: int, t: np.ndarray, mat: np.ndarray,
                ins: np.ndarray) -> np.ndarray:
    """Mean residue composition weighted by expected state occupancy
    (``p7_hmm_SetComposition``), float32 as the model stores it."""
    occ = match_occupancy(M, t)
    t = t.astype(np.float64)
    with np.errstate(divide="ignore"):
        iocc = np.zeros(M + 1)
        iocc[0] = t[0, MI]
        iocc[1:] = occ[1:] * t[1:, MI]
        denom = 1.0 - t[:, II]
        iocc = np.where(denom > 0, iocc / np.maximum(denom, 1e-9), 0.0)
    comp = (mat[1:].astype(np.float64) * occ[1:, None]).sum(axis=0)
    comp += (ins.astype(np.float64) * iocc[:, None]).sum(axis=0)
    s = comp.sum()
    if s > 0:
        comp /= s
    return comp.astype(np.float32)


class Profile:
    """A configured local profile (``p7_ProfileConfig``) of a model's
    arrays: the fields the recurrences read."""

    alphabet = AMINO

    def __init__(self, model: dict, multihit: bool, L: int = 400):
        M = self.M = int(model["M"])
        self.name = model["name"]
        self.evparam = np.asarray(model["evparam"], np.float64)
        self.nj = 1.0 if multihit else 0.0
        self.xE = (np.array([np.log(0.5), np.log(0.5)]) if multihit
                   else np.array([-np.inf, 0.0]))
        self.xN = np.zeros(2)
        self.xJ = np.zeros(2)
        self.xC = np.zeros(2)
        t = np.asarray(model["t"])
        occ = match_occupancy(M, t)
        Z = float((occ[1:] * (M - np.arange(1, M + 1) + 1)).sum())
        t = t.astype(np.float64)
        with np.errstate(divide="ignore"):
            self.tBM = np.log(occ[1:] / Z)
            self.tMM = np.log(t[0:M, MM])
            self.tIM = np.log(t[0:M, IM])
            self.tDM = np.log(t[0:M, DM])
            self.tMD = np.log(t[0:M, MD])
            self.tDD = np.log(t[0:M, DD])
            self.tMI = np.full(M + 1, -np.inf)
            self.tII = np.full(M + 1, -np.inf)
            self.tMI[1:M] = np.log(t[1:M, MI])
            self.tII[1:M] = np.log(t[1:M, II])
        f = AMINO_FREQUENCIES
        with np.errstate(divide="ignore"):
            lodds = np.log(np.asarray(model["mat"])[1:].astype(np.float64)
                           / f)
        self.msc = np.full((AMINO.Kp, M + 1), -np.inf)
        self.msc[:, 1:] = AMINO.expect_score_vector(lodds, f).T
        self.isc = np.full((AMINO.Kp, M + 1), -np.inf)
        zeros = AMINO.expect_score_vector(np.zeros(AMINO.K), f)
        self.isc[:, 1:M] = zeros[:, None]
        self.compo = composition(M, np.asarray(model["t"]),
                                 np.asarray(model["mat"]),
                                 np.asarray(model["ins"])).astype(np.float64)
        self.reconfig_length(L)

    def reconfig_length(self, L: int) -> None:
        pmove = (2.0 + self.nj) / (L + 2.0 + self.nj)
        ploop = 1.0 - pmove
        self.xN[0] = self.xC[0] = self.xJ[0] = np.log(ploop)
        self.xN[1] = self.xC[1] = self.xJ[1] = np.log(pmove)
        self.L = L

    def copy(self) -> "Profile":
        out = copy.copy(self)
        for name in ("xE", "xN", "xJ", "xC"):
            setattr(out, name, getattr(self, name).copy())
        out.__dict__.pop("_msv_quant", None)
        return out
