"""Plan7 core HMM model.

Mirrors ``pyhmmer.plan7.HMM`` (reference ``src/pyhmmer/plan7.pyx:2235-3446``,
struct ``include/libhmmer/p7_hmm.pxd:53-77``): probability-space model with
``(M+1) x 7`` transitions, ``(M+1) x K`` match/insert emissions, annotation
lines, E-value parameters and score cutoffs.  NumPy-backed; the TPU profile
tensors are derived in :mod:`.profile`.
"""

from __future__ import annotations

import enum
import hashlib
import numpy as np
from typing import List, Optional, Tuple

from ..easel.alphabet import Alphabet
from .views import Cutoffs, EvalueParameters

__all__ = ["HMM", "Transitions", "HMMFlags"]


class Transitions(enum.IntEnum):
    """Indexes of the 7 per-node transitions (ref ``plan7.pyx:9615-9634``)."""
    MM = 0
    MI = 1
    MD = 2
    IM = 3
    II = 4
    DM = 5
    DD = 6


class HMMFlags:
    """p7H_* flag bits (``include/libhmmer/p7_hmm.pxd``)."""
    HASBITS = 1 << 0
    DESC = 1 << 1
    RF = 1 << 2
    CS = 1 << 3
    XRAY = 1 << 4
    HASPROB = 1 << 5
    HASDNA = 1 << 6
    STATS = 1 << 7
    MAP = 1 << 8
    ACC = 1 << 9
    GA = 1 << 10
    TC = 1 << 11
    NC = 1 << 12
    CA = 1 << 13
    COMPO = 1 << 14
    CHKSUM = 1 << 15
    CONS = 1 << 16
    MMASK = 1 << 17


# evparam indices (p7_EVPARAM_*: MMU, MLAMBDA, VMU, VLAMBDA, FTAU, FLAMBDA)
EV_MMU, EV_MLAMBDA, EV_VMU, EV_VLAMBDA, EV_FTAU, EV_FLAMBDA = range(6)
EV_UNSET = -99999.0
CUTOFF_UNSET = -99999.0


class HMM:
    """A profile hidden Markov model in probability space.

    Node 0 conventions (as in HMMER): ``mat[0] = [1, 0, ...]``; ``t[0]``
    holds the B->{M1,I0,D1} and I0/D0 transitions; insert row 0 is a real
    insert state.
    """

    def __init__(self, alphabet: Alphabet, M: int, name: bytes = b""):
        self.alphabet = alphabet
        self.M = M
        K = alphabet.K
        self.t = np.zeros((M + 1, 7), dtype=np.float32)
        self.mat = np.zeros((M + 1, K), dtype=np.float32)
        self.ins = np.zeros((M + 1, K), dtype=np.float32)
        self.mat[0, 0] = 1.0
        self.name = name
        self.accession: Optional[bytes] = None
        self.description: Optional[bytes] = None
        self.reference: Optional[bytes] = None       # RF line, len M+1 w/ lead
        self.model_mask: Optional[bytes] = None      # MM line
        self.consensus: Optional[bytes] = None       # CONS line
        self.consensus_structure: Optional[bytes] = None  # CS line
        self.consensus_accessibility: Optional[bytes] = None  # CA line
        self.map: Optional[np.ndarray] = None        # int32[M+1], map[0]=0
        self.nseq: Optional[int] = None
        self.eff_nseq: Optional[float] = None
        self.checksum: Optional[int] = None
        self.creation_time: Optional[str] = None
        self.command_line: Optional[str] = None
        self.composition: Optional[np.ndarray] = None  # compo[K]
        self.flags = HMMFlags.HASPROB
        self.evparam = EvalueParameters()  # MMU,MLAMBDA,VMU,VLAMBDA,FTAU,FLAMBDA
        self.cutoffs = Cutoffs()           # ga1,ga2,tc1,tc2,nc1,nc2
        self.evparam._owner = self
        self.cutoffs._owner = self
        self.max_length: Optional[int] = None

    @property
    def evalue_parameters(self) -> EvalueParameters:
        """The E-value parameters view (ref ``plan7.pyx:2660-2668``)."""
        return self.evparam

    # --- cutoffs accessors --------------------------------------------------

    @property
    def gathering(self) -> Optional[Tuple[float, float]]:
        if not (self.flags & HMMFlags.GA):
            return None
        return float(self.cutoffs[0]), float(self.cutoffs[1])

    @gathering.setter
    def gathering(self, v):
        if v is None:
            self.flags &= ~HMMFlags.GA
        else:
            self.cutoffs[0:2] = v
            self.flags |= HMMFlags.GA

    @property
    def trusted(self) -> Optional[Tuple[float, float]]:
        if not (self.flags & HMMFlags.TC):
            return None
        return float(self.cutoffs[2]), float(self.cutoffs[3])

    @trusted.setter
    def trusted(self, v):
        if v is None:
            self.flags &= ~HMMFlags.TC
        else:
            self.cutoffs[2:4] = v
            self.flags |= HMMFlags.TC

    @property
    def noise(self) -> Optional[Tuple[float, float]]:
        if not (self.flags & HMMFlags.NC):
            return None
        return float(self.cutoffs[4]), float(self.cutoffs[5])

    @noise.setter
    def noise(self, v):
        if v is None:
            self.flags &= ~HMMFlags.NC
        else:
            self.cutoffs[4:6] = v
            self.flags |= HMMFlags.NC

    # --- basic ops (ref plan7.pyx:2247-3446) --------------------------------

    # --- reference tensor-view aliases (plan7.pyx:2235-3446) ---------------

    @property
    def match_emissions(self) -> np.ndarray:
        """``[M+1, K]`` match emission probabilities (``hmm->mat``)."""
        return self.mat

    @property
    def insert_emissions(self) -> np.ndarray:
        """``[M+1, K]`` insert emission probabilities (``hmm->ins``)."""
        return self.ins

    @property
    def transition_probabilities(self) -> np.ndarray:
        """``[M+1, 7]`` transitions [MM,MI,MD,IM,II,DM,DD] (``hmm->t``)."""
        return self.t

    @property
    def nseq_effective(self) -> Optional[float]:
        """Effective sequence number (``hmm->eff_nseq``)."""
        return self.eff_nseq

    @nseq_effective.setter
    def nseq_effective(self, v) -> None:
        self.eff_nseq = v

    def copy(self) -> "HMM":
        new = HMM(self.alphabet, self.M, self.name)
        new.t = self.t.copy()
        new.mat = self.mat.copy()
        new.ins = self.ins.copy()
        for attr in ("accession", "description", "reference", "model_mask",
                     "consensus", "consensus_structure",
                     "consensus_accessibility", "nseq", "eff_nseq",
                     "checksum", "creation_time", "command_line", "flags",
                     "max_length"):
            setattr(new, attr, getattr(self, attr))
        new.map = None if self.map is None else self.map.copy()
        new.composition = (None if self.composition is None
                           else self.composition.copy())
        new.evparam = self.evparam.copy()
        new.cutoffs = self.cutoffs.copy()
        new.evparam._owner = new
        new.cutoffs._owner = new
        return new

    def zero(self) -> None:
        """Zero all parameters (``p7_hmm_Zero``)."""
        self.t[:] = 0.0
        self.mat[:] = 0.0
        self.ins[:] = 0.0

    def renormalize(self) -> None:
        """Renormalize all probability distributions (``p7_hmm_Renormalize``)."""
        def norm(a):
            s = a.sum(axis=-1, keepdims=True)
            np.divide(a, s, out=a, where=s > 0)
        norm(self.mat)
        norm(self.ins)
        # transition groups: (MM,MI,MD), (IM,II), (DM,DD)
        for sl in (slice(0, 3), slice(3, 5), slice(5, 7)):
            group = self.t[:, sl]
            s = group.sum(axis=-1, keepdims=True)
            np.divide(group, s, out=group, where=s > 0)

    def scale(self, scale: float, exponential: bool = False) -> None:
        """Rescale counts (``p7_hmm_Scale`` / ``p7_hmm_ScaleExponential``)."""
        if exponential:
            np.power(self.mat, scale, out=self.mat)
            np.power(self.ins, scale, out=self.ins)
            np.power(self.t, scale, out=self.t)
        else:
            self.mat *= scale
            self.ins *= scale
            self.t *= scale

    def match_occupancy(self) -> np.ndarray:
        """Expected occupancy of each match state (``p7_hmm_CalculateOccupancy``).

        Returns ``occ[M+1]`` with ``occ[0] = 0``.
        """
        M, t = self.M, self.t
        occ = np.zeros(M + 1, dtype=np.float64)
        occ[1] = t[0, Transitions.MI] + t[0, Transitions.MM]
        for k in range(2, M + 1):
            occ[k] = (occ[k - 1] * (t[k - 1, Transitions.MM] + t[k - 1, Transitions.MI])
                      + (1.0 - occ[k - 1]) * t[k - 1, Transitions.DM])
        return occ

    def mean_match_entropy(self) -> float:
        """Mean entropy per match emission in bits (``p7_MeanMatchEntropy``)."""
        p = self.mat[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            h = np.where(p > 0, -p * np.log2(p), 0.0)
        return float(h.sum(axis=1).mean())

    def mean_match_information(self, background=None) -> float:
        """Mean information content of match emissions (``p7_MeanMatchInfo``)."""
        from .background import Background
        bg = background or Background(self.alphabet)
        f = bg.residue_frequencies
        with np.errstate(divide="ignore", invalid="ignore"):
            hb = float(-(f * np.log2(f)).sum())
        return hb - self.mean_match_entropy()

    def mean_match_relative_entropy(self, background=None) -> float:
        """Mean KL divergence of match emissions from background
        (``p7_MeanMatchRelativeEntropy``)."""
        from .background import Background
        bg = background or Background(self.alphabet)
        f = bg.residue_frequencies
        p = self.mat[1:].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            kl = np.where(p > 0, p * np.log2(p / f), 0.0)
        return float(kl.sum(axis=1).mean())

    def set_composition(self) -> None:
        """Compute the mean residue composition (``p7_hmm_SetComposition``).

        Weighted by expected state occupancy: match states weighted by
        ``occ[k]``, insert states by expected insert usage.
        """
        occ = self.match_occupancy()
        t = self.t.astype(np.float64)
        # expected number of residues emitted by I_k per pass:
        # occ_I[k] = P(use I_k) * expected run length 1/(1-tII)
        with np.errstate(divide="ignore"):
            iocc = np.zeros(self.M + 1)
            # P(enter I_k) ~ occ[k]*tMI[k] (+ from D? approximation as HMMER:)
            iocc[0] = t[0, Transitions.MI]
            iocc[1:] = occ[1:] * t[1:, Transitions.MI]
            denom = 1.0 - t[:, Transitions.II]
            iocc = np.where(denom > 0, iocc / np.maximum(denom, 1e-9), 0.0)
        comp = (self.mat[1:].astype(np.float64) * occ[1:, None]).sum(axis=0)
        comp += (self.ins.astype(np.float64) * iocc[:, None]).sum(axis=0)
        s = comp.sum()
        if s > 0:
            comp /= s
        self.composition = comp.astype(np.float32)
        self.flags |= HMMFlags.COMPO

    def set_consensus(self, sequence=None) -> None:
        """Set the consensus line from match emissions (``p7_hmm_SetConsensus``)."""
        if sequence is not None:
            codes = sequence.sequence
            if len(codes) != self.M:
                raise ValueError("sequence length must equal M")
            chars = self.alphabet.decode(codes).upper()
            self.consensus = (" " + chars).encode()
        else:
            best = np.argmax(self.mat[1:], axis=1)
            pmax = self.mat[np.arange(1, self.M + 1), best]
            thresh = 0.9 if self.alphabet.is_nucleic() else 0.5
            syms = self.alphabet.symbols
            chars = "".join(
                syms[b].upper() if p >= thresh else syms[b].lower()
                for b, p in zip(best, pmax)
            )
            self.consensus = (" " + chars).encode()
        self.flags |= HMMFlags.CONS

    def validate(self, tolerance: float = 1e-4) -> None:
        """Validate probability distributions (``p7_hmm_Validate``)."""
        def check(a, what, rows):
            s = a[rows].sum(axis=-1)
            if not np.allclose(s, 1.0, atol=tolerance):
                raise ValueError(f"{what} distributions do not sum to 1")
        check(self.mat, "match emission", slice(0, self.M + 1))
        check(self.ins, "insert emission", slice(0, self.M + 1))
        check(self.t[:, 0:3], "match transition", slice(0, self.M + 1))
        check(self.t[:, 3:5], "insert transition", slice(0, self.M + 1))
        check(self.t[1:, 5:7], "delete transition", slice(0, self.M))

    def to_profile(self, background=None, L: int = 400,
                   multihit: bool = True, local: bool = True):
        """Configure a search profile from this HMM (``HMM.to_profile``)."""
        from .background import Background
        from .profile import Profile
        bg = background or Background(self.alphabet)
        prof = Profile(self.M, self.alphabet)
        prof.configure(self, bg, L, multihit=multihit, local=local)
        return prof

    @classmethod
    def sample(cls, alphabet: Alphabet, M: int, randomness) -> "HMM":
        """Sample a random HMM (``p7_hmm_Sample`` analog for tests).

        Example:
            >>> import numpy
            >>> from pyhmmer_tpu_torch.easel.alphabet import Alphabet
            >>> hmm = HMM.sample(Alphabet.amino(), 20,
            ...                  numpy.random.default_rng(0))
            >>> hmm.M
            20
            >>> hmm.validate()          # probability rows sum to 1
            >>> hmm.copy() == hmm
            True
        """
        rng = randomness
        hmm = cls(alphabet, M, name=b"sampled-hmm")
        K = alphabet.K
        hmm.mat[1:] = rng.dirichlet(np.ones(K), size=M).astype(np.float32)
        hmm.ins[:] = rng.dirichlet(np.ones(K), size=M + 1).astype(np.float32)
        hmm.t[:, 0:3] = rng.dirichlet(np.ones(3), size=M + 1).astype(np.float32)
        hmm.t[:, 3:5] = rng.dirichlet(np.ones(2), size=M + 1).astype(np.float32)
        hmm.t[1:, 5:7] = rng.dirichlet(np.ones(2), size=M).astype(np.float32)
        hmm.t[0, 5] = 1.0  # D0 -> M1 convention
        hmm.t[0, 6] = 0.0
        hmm.t[M, Transitions.MD] = 0.0   # no D_{M+1}
        hmm.t[M, 0:3] /= hmm.t[M, 0:3].sum()
        hmm.t[M, 5] = 1.0
        hmm.t[M, 6] = 0.0
        hmm.mat[0, :] = 0.0
        hmm.mat[0, 0] = 1.0
        return hmm

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, HMM)
            and other.M == self.M
            and other.name == self.name
            and np.allclose(other.t, self.t)
            and np.allclose(other.mat, self.mat)
            and np.allclose(other.ins, self.ins)
        )

    def __repr__(self) -> str:
        return f"<HMM name={self.name!r} M={self.M} alphabet={self.alphabet.name}>"

    def write(self, fh, binary: bool = False) -> None:
        """Write in HMMER3 format (ASCII 3/f, or binary .h3m)."""
        from .hmmfile import write_hmm_ascii, write_hmm_binary
        if binary:
            write_hmm_binary(self, fh)
        else:
            write_hmm_ascii(self, fh)
