"""Genetic code tables for codon translation.

Mirrors ``pyhmmer.easel.GeneticCode`` (reference ``easel.pyx:557-718``;
Easel ``esl_gencode``): NCBI translation-table selection, digital codon
translation with ambiguous-codon resolution (a degenerate codon is
translated when every compatible unambiguous codon yields the same
residue, ``easel.pyx:698-706``).

The port's copy of ``pyhmmer_tpu/easel/gencode.py``, line for line but
the imports.
"""

from __future__ import annotations

import numpy as np
from typing import Optional

from .alphabet import Alphabet
from .sequence import DigitalSequence

__all__ = ["GeneticCode"]

# NCBI translation tables as 64-char amino strings over codons in
# TTT, TTC, TTA, TTG, TCT ... base order T, C, A, G.
_T1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def _variant(base: str, diffs: dict) -> str:
    out = list(base)
    for pos, aa in diffs.items():
        out[pos] = aa
    return "".join(out)


_NCBI_TABLES = {
    1: (_T1, "Standard"),
    2: (_variant(_T1, {8 * 1 + 6: "W", 14: "W", 46: "*", 47: "*", 34: "M"}),
        "Vertebrate mitochondrial"),
    3: (_variant(_T1, {14: "W", 16: "T", 17: "T", 18: "T", 19: "T", 34: "M"}),
        "Yeast mitochondrial"),
    4: (_variant(_T1, {14: "W"}),
        "Mold, protozoan, coelenterate mitochondrial; Mycoplasma/Spiroplasma"),
    5: (_variant(_T1, {14: "W", 34: "M", 46: "S", 47: "S"}),
        "Invertebrate mitochondrial"),
    6: (_variant(_T1, {10: "Q", 11: "Q"}),
        "Ciliate, dasycladacean, Hexamita nuclear"),
    9: (_variant(_T1, {14: "W", 42: "N", 46: "S", 47: "S"}),
        "Echinoderm and flatworm mitochondrial"),
    10: (_variant(_T1, {14: "C"}), "Euplotid nuclear"),
    11: (_T1, "Bacterial, archaeal; and plant plastid"),
    12: (_variant(_T1, {19: "S"}), "Alternative yeast"),
    13: (_variant(_T1, {14: "W", 34: "M", 46: "G", 47: "G"}),
         "Ascidian mitochondrial"),
    14: (_variant(_T1, {10: "Y", 14: "W", 42: "N", 46: "S", 47: "S"}),
         "Alternative flatworm mitochondrial"),
    16: (_variant(_T1, {11: "L"}), "Chlorophycean mitochondrial"),
    21: (_variant(_T1, {14: "W", 34: "M", 42: "N", 46: "S", 47: "S"}),
         "Trematode mitochondrial"),
    22: (_variant(_T1, {6: "*", 11: "L"}),
         "Scenedesmus obliquus mitochondrial"),
    23: (_variant(_T1, {2: "*"}), "Thraustochytrium mitochondrial"),
    24: (_variant(_T1, {14: "W", 47: "K"}), "Pterobranchia mitochondrial"),
    25: (_variant(_T1, {14: "G"}),
         "Candidate Division SR1 and Gracilibacteria"),
    26: (_variant(_T1, {19: "A"}), "Pachysolen tannophilus nuclear"),
    27: (_variant(_T1, {10: "Q", 11: "Q", 14: "W"}), "Karyorelict nuclear"),
    28: (_variant(_T1, {10: "Q", 11: "Q", 14: "W"}), "Condylostoma nuclear"),
    29: (_variant(_T1, {10: "Y", 11: "Y"}), "Mesodinium nuclear"),
    30: (_variant(_T1, {10: "E", 11: "E"}), "Peritrich nuclear"),
    31: (_variant(_T1, {10: "E", 11: "E", 14: "W"}),
         "Blastocrithidia nuclear"),
    33: (_variant(_T1, {10: "Y", 14: "W", 47: "K"}),
         "Cephalodiscidae mitochondrial"),
}

#: digital nucleotide code (A=0 C=1 G=2 T/U=3) -> NCBI codon base index
#: (T=0 C=1 A=2 G=3)
_NCBI_BASE = np.array([2, 1, 3, 0], dtype=np.int64)


class GeneticCode:
    """A genetic code table for codon translation."""

    def __init__(self, translation_table: int = 1, *,
                 nucleotide_alphabet: Optional[Alphabet] = None,
                 amino_alphabet: Optional[Alphabet] = None):
        self.nucleotide_alphabet = nucleotide_alphabet or Alphabet.dna()
        self.amino_alphabet = amino_alphabet or Alphabet.amino()
        self._aa_codes = np.frombuffer(
            self.amino_alphabet.symbols.encode(), dtype=np.uint8)
        self.translation_table = translation_table

    @property
    def translation_table(self) -> int:
        """`int`: The NCBI translation table in use (settable)."""
        return self._table

    @translation_table.setter
    def translation_table(self, table: int) -> None:
        if table not in _NCBI_TABLES:
            raise ValueError(f"invalid translation table: {table!r}")
        self._table = table
        aas, self.description = _NCBI_TABLES[table]
        amino = self.amino_alphabet
        #: codon index (16*b1 + 4*b2 + b3, NCBI base order) -> amino code
        self._codon_aa = np.array(
            [amino.encode(c if c != "*" else "X")[0] for c in aas],
            dtype=np.uint8)
        self._is_stop = np.array([c == "*" for c in aas], dtype=bool)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._table!r})"

    def _codon_index(self, c1: int, c2: int, c3: int) -> int:
        return int(16 * _NCBI_BASE[c1] + 4 * _NCBI_BASE[c2]
                   + _NCBI_BASE[c3])

    def translate_codon(self, c1: int, c2: int, c3: int):
        """Translate one digital codon; resolves degenerate codes when the
        translation is unambiguous, else returns the unknown residue.
        Returns ``(amino_code, is_stop)``."""
        alph = self.nucleotide_alphabet
        K = alph.K

        def members(c):
            if c < K:
                return (c,)
            if K < c < alph.Kp - 2:
                return tuple(np.where(alph.degen[c])[0])
            return ()

        m1, m2, m3 = members(c1), members(c2), members(c3)
        if not (m1 and m2 and m3):
            return self.amino_alphabet.unknown_code, False
        aa = None
        stop = None
        for a in m1:
            for b in m2:
                for c in m3:
                    idx = self._codon_index(a, b, c)
                    code = self._codon_aa[idx]
                    st = bool(self._is_stop[idx])
                    if aa is None:
                        aa, stop = code, st
                    elif aa != code or stop != st:
                        return self.amino_alphabet.unknown_code, False
        return int(aa), bool(stop)

    def translate(self, sequence) -> np.ndarray:
        """Translate a digital nucleotide coding sequence into digital
        amino codes (``GeneticCode.translate``, ``easel.pyx:651-718``).
        Stop codons translate to ``*``-free output: they are encoded as
        the unknown residue in the reference's VectorU8 semantics."""
        dsq = np.asarray(sequence, dtype=np.uint8)
        if len(dsq) % 3 != 0:
            raise ValueError(
                f"invalid sequence of length {len(dsq)} "
                f"(expected a multiple of 3)")
        n = len(dsq) // 3
        out = np.empty(n, dtype=np.uint8)
        K = self.nucleotide_alphabet.K
        codons = dsq.reshape(n, 3)
        plain = (codons < K).all(axis=1)
        if plain.any():
            idx = (16 * _NCBI_BASE[codons[plain, 0]]
                   + 4 * _NCBI_BASE[codons[plain, 1]]
                   + _NCBI_BASE[codons[plain, 2]])
            out[plain] = self._codon_aa[idx]
        for i in np.where(~plain)[0]:
            out[i], _ = self.translate_codon(*codons[i])
        return out

    def translate_sequence(self, sequence: DigitalSequence) -> DigitalSequence:
        """Translate a `DigitalSequence`, preserving metadata."""
        return DigitalSequence(
            self.amino_alphabet, name=sequence.name,
            description=sequence.description,
            accession=sequence.accession,
            sequence=self.translate(sequence.sequence))
