"""Biosequence alphabets with Easel-compatible digital encoding.

TPU-first design notes
----------------------
Digital sequences are plain ``uint8`` numpy arrays of *codes* (no sentinel
bytes -- padding/masking is handled by explicit length vectors in the batched
kernels).  The code layout matches Easel's (``esl_alphabet.c`` semantics,
declared in the reference at ``include/libeasel/alphabet.pxd`` and wrapped by
``src/pyhmmer/easel.pyx:183-556``):

* codes ``0..K-1``     : canonical residues
* code  ``K``          : gap (``-``, ``.``, ``_``)
* codes ``K+1..Kp-3``  : degenerate residues
* code  ``Kp-2``       : "any" is *not* a separate slot -- Easel puts the
  wildcard (X/N) as the *last degenerate*; the two trailing slots are
  ``*`` (nonresidue) at ``Kp-2`` and ``~`` (missing data) at ``Kp-1``.

Amino  : ``ACDEFGHIKLMNPQRSTVWY-BJZOUX*~``  (K=20, Kp=29)
DNA    : ``ACGT-RYMKSWHBVDN*~``             (K=4,  Kp=18)
RNA    : ``ACGU-RYMKSWHBVDN*~``             (K=4,  Kp=18)
"""

from __future__ import annotations

import numpy as np
from typing import Dict, Optional

__all__ = ["Alphabet", "Amino", "Dna", "Rna"]


class Alphabet:
    """A biological alphabet with str<->digital conversion tables.

    Mirrors the capability surface of ``pyhmmer.easel.Alphabet``
    (reference ``src/pyhmmer/easel.pyx:183-556``), re-implemented in pure
    Python/NumPy.
    """

    #: registry keyed by Easel alphabet type code (eslRNA=1, eslDNA=2, eslAMINO=3)
    _BY_TYPE: Dict[int, "Alphabet"] = {}

    def __init__(
        self,
        name: str,
        type_code: int,
        symbols: str,
        K: int,
        degeneracy: Dict[str, str],
        extra_inmap: Optional[Dict[str, str]] = None,
        complement: Optional[str] = None,
    ):
        self.name = name
        self.type = type_code
        self.symbols = symbols  # full Kp-long symbol string
        self.K = K
        self.Kp = len(symbols)
        self._degeneracy = degeneracy
        # ndarray[Kp, K] bool: which canonical residues each code can be
        self.degen = np.zeros((self.Kp, K), dtype=bool)
        for i in range(K):
            self.degen[i, i] = True
        # gap code matches nothing
        for sym, members in degeneracy.items():
            code = symbols.index(sym)
            for m in members:
                self.degen[code, symbols.index(m)] = True
        # the nonresidue (*) and missing (~) match nothing

        # --- input map: char -> code (256 entries, 255 = illegal) ---
        imap = np.full(256, 255, dtype=np.uint8)
        for i, s in enumerate(symbols):
            imap[ord(s)] = i
            imap[ord(s.lower())] = i
        # all gap-ish characters map to the gap code
        for g in "-._":
            imap[ord(g)] = K
        if extra_inmap:
            for src, dst in extra_inmap.items():
                imap[ord(src)] = symbols.index(dst)
                imap[ord(src.lower())] = symbols.index(dst)
        self.inmap = imap

        # --- output map: code -> char ---
        self.outmap = np.frombuffer(symbols.encode("ascii"), dtype=np.uint8).copy()

        # complement table for nucleic alphabets (code -> code)
        if complement is not None:
            comp = np.arange(self.Kp, dtype=np.uint8)
            for a, b in zip(symbols, complement):
                comp[symbols.index(a)] = symbols.index(b)
            self.complement_map: Optional[np.ndarray] = comp
        else:
            self.complement_map = None

        Alphabet._BY_TYPE[type_code] = self

    # --- constructors matching the reference API --------------------------

    @classmethod
    def amino(cls) -> "Alphabet":
        return AMINO

    @classmethod
    def dna(cls) -> "Alphabet":
        return DNA()

    @classmethod
    def rna(cls) -> "Alphabet":
        return RNA()

    @classmethod
    def from_type(cls, type_code: int) -> "Alphabet":
        if type_code not in cls._BY_TYPE:
            # instantiate the singleton on demand (eslRNA=1 eslDNA=2
            # eslAMINO=3); the constructor registers it
            if type_code == 1:
                return cls.rna()
            if type_code == 2:
                return cls.dna()
            if type_code == 3:
                return cls.amino()
        return cls._BY_TYPE[type_code]

    @classmethod
    def from_name(cls, name: str) -> "Alphabet":
        n = name.lower()
        if n in ("amino", "aa", "protein"):
            return AMINO
        if n == "dna":
            return DNA()
        if n == "rna":
            return RNA()
        raise ValueError(f"unknown alphabet: {name!r}")

    # --- properties --------------------------------------------------------

    @property
    def gap_code(self) -> int:
        return self.K

    @property
    def gap_index(self) -> int:
        """`int`: the gap code (reference ``Alphabet.gap_index``,
        ``easel.pyx:382``)."""
        return self.K

    @property
    def gap_symbol(self) -> str:
        """`str`: the gap character (reference ``Alphabet.gap_symbol``)."""
        return self.symbols[self.K]

    def is_dna(self) -> bool:
        """Whether this is the DNA alphabet (eslDNA=2)."""
        return self.type == 2

    def is_rna(self) -> bool:
        """Whether this is the RNA alphabet (eslRNA=1)."""
        return self.type == 1

    def is_nucleotide(self) -> bool:
        """Whether this is a nucleotide alphabet (DNA or RNA)."""
        return self.type in (1, 2)

    @property
    def nonresidue_code(self) -> int:
        return self.Kp - 2

    @property
    def missing_code(self) -> int:
        return self.Kp - 1

    @property
    def unknown_code(self) -> int:
        """Code of the full wildcard (X for amino, N for DNA/RNA)."""
        return self.Kp - 3

    def is_nucleic(self) -> bool:
        return self.type in (1, 2)

    def is_amino(self) -> bool:
        return self.type == 3

    # --- conversions --------------------------------------------------------

    def encode(self, text: str) -> np.ndarray:
        """Encode a text sequence into digital codes (uint8 array).

        Example:
            >>> Alphabet.dna().encode("ACGT")
            array([0, 1, 2, 3], dtype=uint8)
        """
        raw = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        codes = self.inmap[raw]
        if (codes == 255).any():
            bad = chr(int(raw[np.argmax(codes == 255)]))
            raise ValueError(f"invalid character for {self.name} alphabet: {bad!r}")
        return codes

    def decode(self, codes: np.ndarray) -> str:
        """Decode digital codes back into a text sequence.

        Example:
            >>> import numpy
            >>> Alphabet.amino().decode(numpy.array([0, 4, 3], dtype=numpy.uint8))
            'AFE'
        """
        return self.outmap[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")

    def expect_score_vector(self, sc: np.ndarray, f: np.ndarray) -> np.ndarray:
        """Extend a length-K score vector to length Kp with Easel semantics.

        Degenerate codes get the background-weighted *expected* score of
        their member residues (``esl_abc_FExpectScVec``); gap, nonresidue
        and missing codes get ``-inf``.  ``sc`` may be ``[..., K]`` batched.
        """
        sc = np.asarray(sc, dtype=np.float64)
        out = np.full(sc.shape[:-1] + (self.Kp,), -np.inf, dtype=np.float64)
        out[..., : self.K] = sc
        for code in range(self.K + 1, self.Kp - 2):
            members = self.degen[code]
            w = f[members]
            out[..., code] = (sc[..., members] * w).sum(axis=-1) / w.sum()
        return out

    def expect_prob_vector(self, p: np.ndarray) -> np.ndarray:
        """Extend a length-K probability vector to Kp (mean over members).

        Used for emission probabilities of degenerate codes
        (``esl_abc_FAvgScVec``-style uniform averaging is *not* what Easel
        does for probabilities; marginalization ``esl_abc_FExpectScVec``
        uses background weights -- this helper does plain marginal sums and
        is used only where total probability is required).
        """
        p = np.asarray(p, dtype=np.float64)
        out = np.zeros(p.shape[:-1] + (self.Kp,), dtype=np.float64)
        out[..., : self.K] = p
        for code in range(self.K + 1, self.Kp - 2):
            members = self.degen[code]
            out[..., code] = p[..., members].mean(axis=-1)
        return out

    def __repr__(self) -> str:
        return f"Alphabet.{self.name}()"

    def __eq__(self, other) -> bool:
        return isinstance(other, Alphabet) and other.type == self.type

    def __hash__(self) -> int:
        return hash(("Alphabet", self.type))


# --- the three standard alphabets (Easel type codes: RNA=1, DNA=2, AMINO=3) ---
#
# Like the reference (easel.pyi:61-63), ``DNA``/``RNA``/``AA`` are Alphabet
# subclasses; they are singletons so repeated construction is free and
# equality/identity behave like the reference's cached alphabets.


class _SingletonAlphabet(Alphabet):
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(self):
        if getattr(self, "Kp", None) is not None:
            return  # singleton already initialized
        super().__init__(**self._params())

    def __reduce__(self):
        return (type(self), ())


class AA(_SingletonAlphabet):
    """The 20-letter protein alphabet (``eslAMINO``)."""

    @staticmethod
    def _params():
        return dict(
            name="amino",
            type_code=3,
            symbols="ACDEFGHIKLMNPQRSTVWY-BJZOUX*~",
            K=20,
            degeneracy={
                "B": "DN",
                "J": "IL",
                "Z": "EQ",
                "O": "K",   # pyrrolysine -> Lys
                "U": "C",   # selenocysteine -> Cys
                "X": "ACDEFGHIKLMNPQRSTVWY",
            },
        )


class DNA(_SingletonAlphabet):
    """The 4-letter DNA alphabet (``eslDNA``)."""

    @staticmethod
    def _params():
        return dict(
            name="dna",
            type_code=2,
            symbols="ACGT-RYMKSWHBVDN*~",
            K=4,
            degeneracy={
                "R": "AG", "Y": "CT", "M": "AC", "K": "GT", "S": "CG", "W": "AT",
                "H": "ACT", "B": "CGT", "V": "ACG", "D": "AGT", "N": "ACGT",
            },
            extra_inmap={"U": "T", "I": "N"},
            complement="TGCA-YRKMSWDVBHN*~",
        )


class RNA(_SingletonAlphabet):
    """The 4-letter RNA alphabet (``eslRNA``)."""

    @staticmethod
    def _params():
        return dict(
            name="rna",
            type_code=1,
            symbols="ACGU-RYMKSWHBVDN*~",
            K=4,
            degeneracy={
                "R": "AG", "Y": "CU", "M": "AC", "K": "GU", "S": "CG", "W": "AU",
                "H": "ACU", "B": "CGU", "V": "ACG", "D": "AGU", "N": "ACGU",
            },
            extra_inmap={"T": "U", "I": "N"},
            complement="UGCA-YRKMSWDVBHN*~",
        )


AMINO = AA()


def Amino() -> Alphabet:
    return AMINO


def Dna() -> Alphabet:
    return DNA()


def Rna() -> Alphabet:
    return RNA()
