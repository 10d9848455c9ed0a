"""Search profile configuration (the ``P7_PROFILE`` equivalent).

Mirrors ``pyhmmer.plan7.Profile`` (reference ``src/pyhmmer/plan7.pyx:
7548-7957``; C semantics of ``modelconfig.c:p7_ProfileConfig``):

* local-mode entry distribution ``B->Mk = occ[k] / Z`` with
  ``Z = sum_k occ[k] * (M-k+1)`` (reduces to uniform ``2/(M(M+1))``)
* multihit (``E->J = E->C = 0.5``) or unihit special states
* target-length model ``pmove = (2+nj)/(L+2+nj)`` on N/C/J loops
* match emission log-odds vs background, insert scores fixed to 0,
  degenerate residues scored by background-weighted expectation

The score tensors are laid out for the TPU kernels: ``msc[Kp, M+1]`` so a
residue row gathers one contiguous ``[M+1]`` lane vector (or is produced by
a one-hot matmul on the MXU).
"""

from __future__ import annotations

import enum
import numpy as np
from typing import Optional

from ..easel.alphabet import Alphabet
from .views import Cutoffs, EvalueParameters, Offsets
from .hmm import HMM, Transitions as T, HMMFlags
from .background import Background

__all__ = ["Profile", "ProfileTransitions"]


class ProfileTransitions(enum.IntEnum):
    """Indexes of the configured profile transitions (``p7P_*``; ref
    ``plan7.pyx:9636-9650``)."""
    MM = 0
    IM = 1
    DM = 2
    BM = 3
    MD = 4
    DD = 5
    MI = 6
    II = 7

NEGINF = -np.inf


class Profile:
    """A configured log-odds search profile."""

    def __init__(self, M: int, alphabet: Alphabet):
        self.M = M
        self.alphabet = alphabet
        self.L = 0
        self.multihit = True
        self.local = True
        self.nj = 1.0
        # transition scores, all length M (source node index 0..M-1 unless noted)
        self.tBM = np.full(M, NEGINF)    # B -> M_{k+1},   k = 0..M-1
        self.tMM = np.full(M, NEGINF)    # M_k -> M_{k+1}
        self.tIM = np.full(M, NEGINF)    # I_k -> M_{k+1}
        self.tDM = np.full(M, NEGINF)    # D_k -> M_{k+1}
        self.tMD = np.full(M, NEGINF)    # M_k -> D_{k+1}
        self.tDD = np.full(M, NEGINF)    # D_k -> D_{k+1}
        self.tMI = np.full(M + 1, NEGINF)  # M_k -> I_k,   k = 1..M-1
        self.tII = np.full(M + 1, NEGINF)  # I_k -> I_k
        # emission scores [Kp, M+1]; column 0 unused (-inf)
        self.msc = np.full((alphabet.Kp, M + 1), NEGINF)
        self.isc = np.full((alphabet.Kp, M + 1), NEGINF)
        # special states: xsc[state][0=LOOP,1=MOVE] for E,N,J,C
        self.xE = np.array([NEGINF, NEGINF])  # LOOP=E->J, MOVE=E->C
        self.xN = np.array([NEGINF, NEGINF])  # LOOP=N->N, MOVE=N->B
        self.xJ = np.array([NEGINF, NEGINF])
        self.xC = np.array([NEGINF, NEGINF])
        # metadata carried from the HMM
        self.name: bytes = b""
        self.accession: Optional[bytes] = None
        self.description: Optional[bytes] = None
        self.consensus: Optional[bytes] = None
        self.consensus_structure: Optional[bytes] = None
        self.evparam = EvalueParameters()
        self.cutoffs = Cutoffs()
        self.compo: Optional[np.ndarray] = None
        self.max_length: Optional[int] = None
        self.offsets = Offsets()

    @property
    def evalue_parameters(self) -> EvalueParameters:
        """The E-value parameters view (ref ``plan7.pyx:7548+``)."""
        return self.evparam

    # --- configuration (p7_ProfileConfig) ----------------------------------

    def configure(self, hmm: HMM, background: Background, L: int = 400,
                  multihit: bool = True, local: bool = True) -> "Profile":
        if hmm.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch")
        self._msv_quant = None   # invalidate the cached quantization
        if not local:
            raise NotImplementedError(
                "glocal mode is not used by any pyhmmer pipeline; "
                "only local profiles are supported")
        M = self.M = hmm.M
        self.multihit = multihit
        self.local = local
        # keep the core model: scans over optimized-profile databases
        # reconstruct their pipelines from it (reference hmmscan converts
        # the other way, HMM -> OptimizedProfile, _hmmscan.py:190-215)
        self._hmm = hmm
        self.name = hmm.name
        self.accession = hmm.accession
        self.description = hmm.description
        self.consensus = hmm.consensus
        self.consensus_structure = hmm.consensus_structure
        self.evparam = hmm.evparam.copy()
        self.cutoffs = hmm.cutoffs.copy()
        self.max_length = hmm.max_length

        if multihit:
            self.nj = 1.0
            self.xE[:] = np.log(0.5)
        else:
            self.nj = 0.0
            self.xE[0] = NEGINF  # E->J
            self.xE[1] = 0.0     # E->C

        # entry distribution from match occupancy
        occ = hmm.match_occupancy()
        Z = float((occ[1:] * (M - np.arange(1, M + 1) + 1)).sum())
        with np.errstate(divide="ignore"):
            self.tBM = np.log(occ[1:] / Z)

        t = hmm.t.astype(np.float64)
        with np.errstate(divide="ignore"):
            self.tMM = np.log(t[0:M, T.MM])
            self.tIM = np.log(t[0:M, T.IM])
            self.tDM = np.log(t[0:M, T.DM])
            self.tMD = np.log(t[0:M, T.MD])
            self.tDD = np.log(t[0:M, T.DD])
            self.tMI = np.full(M + 1, NEGINF)
            self.tII = np.full(M + 1, NEGINF)
            self.tMI[1:M] = np.log(t[1:M, T.MI])
            self.tII[1:M] = np.log(t[1:M, T.II])

        # match emission log-odds
        f = background.residue_frequencies
        with np.errstate(divide="ignore"):
            lodds = np.log(hmm.mat[1:].astype(np.float64) / f)  # [M, K]
        msc_full = self.alphabet.expect_score_vector(lodds, f)  # [M, Kp]
        self.msc = np.full((self.alphabet.Kp, M + 1), NEGINF)
        self.msc[:, 1:] = msc_full.T
        # insert scores: 0 for k=1..M-1 (local mode), -inf for k=M and k=0
        self.isc = np.full((self.alphabet.Kp, M + 1), NEGINF)
        zeros = self.alphabet.expect_score_vector(
            np.zeros(self.alphabet.K), f)
        self.isc[:, 1:M] = zeros[:, None]

        # model composition for the bias filter
        if hmm.flags & HMMFlags.COMPO and hmm.composition is not None:
            self.compo = hmm.composition.astype(np.float64)
        else:
            tmp = hmm.copy()
            tmp.set_composition()
            self.compo = tmp.composition.astype(np.float64)

        self.reconfig_length(L)
        return self

    def reconfig_length(self, L: int) -> None:
        """Set the target length model (``p7_ReconfigLength``)."""
        pmove = (2.0 + self.nj) / (L + 2.0 + self.nj)
        ploop = 1.0 - pmove
        self.xN[0] = self.xC[0] = self.xJ[0] = np.log(ploop)
        self.xN[1] = self.xC[1] = self.xJ[1] = np.log(pmove)
        self.L = L

    # --- score tensors for kernels -----------------------------------------

    def match_scores(self, dsq: np.ndarray) -> np.ndarray:
        """Per-row emission score matrix ``[L, M+1]`` for a digital sequence."""
        return self.msc[dsq]

    def clear(self) -> None:
        """Reset the profile to an unconfigured state
        (``Profile.clear``, reference ``plan7.pyx:7548-7957``)."""
        M, alphabet = self.M, self.alphabet
        self.__init__(M, alphabet)

    def msv_filter(self, seq) -> float:
        """Generic (float-exact) MSV filter score of one sequence in nats
        (``Profile.msv_filter``, reference ``plan7.pyx:7548+``)."""
        from ..ops import reference as _ref
        return float(_ref.msv_score(self, seq.sequence))

    @property
    def transition_scores(self) -> np.ndarray:
        """``[M+1, 8]`` transition score matrix in nats, columns ordered
        like ``ProfileTransitions`` [BM,MM,IM,DM,MD,DD,MI,II]."""
        W = self.M + 1
        out = np.full((W, 8), -np.inf, dtype=np.float64)
        for col, tn in enumerate(
                ("tBM", "tMM", "tIM", "tDM", "tMD", "tDD", "tMI", "tII")):
            v = getattr(self, tn)
            out[: len(v), col] = v
        return out

    def copy(self) -> "Profile":
        import copy as _copy
        hmm = self.__dict__.pop("_hmm", None)
        try:
            out = _copy.deepcopy(self)
        finally:
            if hmm is not None:
                self._hmm = hmm
        if hmm is not None:
            out._hmm = hmm   # share: profiles never mutate the core model
        # drop cached native score tensors: a copied profile is usually
        # copied to be mutated, and the cache would silently serve the
        # original's scores to the native kernels
        out.__dict__.pop("_native_tensors", None)
        return out

    def to_optimized(self):
        from .optimized import OptimizedProfile
        return OptimizedProfile.convert(self)

    def __repr__(self) -> str:
        return (f"<Profile name={self.name!r} M={self.M} L={self.L} "
                f"multihit={self.multihit}>")
