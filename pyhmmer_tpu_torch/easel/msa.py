"""Multiple sequence alignments.

Mirrors ``pyhmmer.easel.MSA``/``TextMSA``/``DigitalMSA`` (reference
``src/pyhmmer/easel.pyx:4793-6479``): aligned sequences + per-sequence
metadata + alignment annotation (RF/consensus lines), digitize/textize,
sequence weights, identity filtering.

The port's copy of ``pyhmmer_tpu/easel/msa.py``; ``MSA.write``'s formats
live in ``msafile.py``.
"""

from __future__ import annotations

import numpy as np
from typing import Iterator, List, Optional, Sequence as TySequence

from .alphabet import Alphabet
from .sequence import TextSequence, DigitalSequence

__all__ = ["MSA", "TextMSA", "DigitalMSA"]


class MSA:
    """Base alignment: names + metadata + annotation lines."""

    def __init__(self, name: Optional[bytes] = None):
        self.name = name
        self.accession: Optional[bytes] = None
        self.description: Optional[bytes] = None
        self.author: Optional[bytes] = None
        self.names: List[bytes] = []
        self.weights: Optional[np.ndarray] = None
        self.reference: Optional[bytes] = None          # GC RF
        self.consensus_structure: Optional[bytes] = None  # GC SS_cons
        self.model_mask: Optional[bytes] = None         # GC MM

    def write(self, fh, format: str = "stockholm") -> None:
        """Write the MSA to a binary file handle in any of the
        reference's 10 formats (``MSA.write``; format list
        ``easel.pyx:141-152``)."""
        import io as _io
        from . import msafile as MF

        text = _io.StringIO()
        if format in ("stockholm", "pfam"):
            MF.write_stockholm(self, text)
        elif format in ("afa", "fasta"):
            MF.write_afa(self, text)
        elif format == "a2m":
            MF.write_a2m(self, text)
        elif format == "psiblast":
            MF.write_psiblast(self, text)
        elif format == "clustal":
            MF.write_clustal(self, text)
        elif format == "clustallike":
            MF.write_clustal(self, text, like=True)
        elif format == "selex":
            MF.write_selex(self, text)
        elif format == "phylip":
            MF.write_phylip(self, text)
        elif format == "phylips":
            MF.write_phylip(self, text, sequential=True)
        else:
            raise ValueError(f"unsupported MSA format: {format!r}")
        fh.write(text.getvalue().encode("ascii"))

    def __len__(self) -> int:
        return len(self.names)

    @property
    def nsequences(self) -> int:
        return len(self.names)

    @property
    def sequence_weights(self) -> Optional[np.ndarray]:
        """Per-sequence alignment weights (reference
        ``MSA.sequence_weights``, ``easel.pyx:5087``); None = default
        uniform weights."""
        return self.weights

    @sequence_weights.setter
    def sequence_weights(self, w) -> None:
        w = np.asarray(w, dtype=np.float64)
        if len(w) != len(self.names):
            raise ValueError("weight vector length mismatch")
        self.weights = w

    # GR/GC annotation aliases matching the reference property names
    @property
    def secondary_structure(self) -> Optional[bytes]:
        return self.consensus_structure

    @secondary_structure.setter
    def secondary_structure(self, v) -> None:
        self.consensus_structure = v

    @property
    def posterior_probabilities(self) -> Optional[bytes]:
        return getattr(self, "_pp_cons", None)

    @posterior_probabilities.setter
    def posterior_probabilities(self, v) -> None:
        self._pp_cons = v

    @property
    def surface_accessibility(self) -> Optional[bytes]:
        return getattr(self, "_sa_cons", None)

    @surface_accessibility.setter
    def surface_accessibility(self, v) -> None:
        self._sa_cons = v

    @property
    def indexed(self) -> bool:
        """Whether a name index is built (lazy in this implementation)."""
        return getattr(self, "_indexed", None) is not None

    def compute_weights(self) -> np.ndarray:
        """Position-based sequence weights (``esl_msaweight_PB``);
        stores and returns the weight vector."""
        from ..plan7.builder import _pb_weights
        codes, K, gap = self._pb_inputs()
        self.weights = _pb_weights(codes, K, gap)
        return self.weights

    def _pb_inputs(self):
        raise NotImplementedError

    # -- residue/gap predicate implemented by subclasses --------------------

    def _residue_mask(self) -> np.ndarray:
        """Boolean [nseq, alen]: True where the cell is a residue."""
        raise NotImplementedError

    def mark_fragments(self, threshold: float) -> "Bitfield":
        """Mark fragmented sequences: fractional span (first..last residue)
        over alignment length below ``threshold``
        (``esl_msa_MarkFragments``; reference ``easel.pyx:5226``)."""
        from .containers import Bitfield
        if threshold < 0.0 or threshold > 1.0:
            from ..errors import InvalidParameter
            raise InvalidParameter("threshold", threshold,
                                   hint="real number between 0 and 1")
        mask = self._residue_mask()
        nseq, alen = mask.shape
        bits = Bitfield.zeros(nseq)
        for i in range(nseq):
            idx = np.where(mask[i])[0]
            if len(idx) == 0:
                bits[i] = True
                continue
            span = (idx[-1] - idx[0] + 1) / alen if alen else 0.0
            bits[i] = span < threshold
        return bits

    def _copy_annotations_to(self, out: "MSA") -> None:
        for attr in ("accession", "description", "author", "reference",
                     "consensus_structure", "model_mask"):
            setattr(out, attr, getattr(self, attr))

    def _select_impl(self, out: "MSA", rows, sequences, columns):
        """Shared row/column subsetting for :meth:`select`."""
        if sequences is None:
            seq_idx = np.arange(len(self.names))
        else:
            seq_idx = np.asarray(list(sequences), dtype=np.int64)
            if len(seq_idx) and (seq_idx.min() < 0
                                 or seq_idx.max() >= len(self.names)):
                raise IndexError("sequence index out of range")
        if columns is None:
            col_idx = None
        else:
            col_idx = np.asarray(list(columns), dtype=np.int64)
            alen = self.alignment_length
            if len(col_idx) and (col_idx.min() < 0 or col_idx.max() >= alen):
                raise IndexError("column index out of range")
        out.names = [self.names[int(i)] for i in seq_idx]
        self._copy_annotations_to(out)
        if col_idx is not None:
            for attr in ("reference", "consensus_structure", "model_mask"):
                v = getattr(out, attr)
                if v is not None:
                    setattr(out, attr, bytes(bytearray(
                        v[int(c)] for c in col_idx)))
        if self.weights is not None:
            out.weights = np.asarray(self.weights)[seq_idx].copy()
        return seq_idx, col_idx


class TextMSA(MSA):
    """Alignment stored as text rows."""

    def __init__(self, name: Optional[bytes] = None,
                 sequences: TySequence[TextSequence] = ()):
        super().__init__(name)
        self.rows: List[str] = []
        for s in sequences:
            self.names.append(s.name)
            self.rows.append(s.sequence)

    @property
    def alignment_length(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    @property
    def alignment(self):
        """Tuple of aligned row strings (reference ``TextMSA.alignment``,
        ``easel.pyx:5686``)."""
        return tuple(self.rows)

    @property
    def sequences(self):
        """List of `TextSequence` views over the aligned rows."""
        return [TextSequence(name=n, sequence=r)
                for n, r in zip(self.names, self.rows)]

    def _pb_inputs(self):
        ab = Alphabet.amino()   # weights only need residue/gap classes
        arr = np.stack([ab.encode(
            "".join(c if c.isalpha() else "-" for c in r).upper())
            for r in self.rows]) if self.rows else np.zeros((0, 0), np.uint8)
        return arr, ab.K, ab.gap_code

    def _residue_mask(self) -> np.ndarray:
        # in a TextMSA any alphanumeric char is a residue
        # (reference easel.pyx:5245)
        if not self.rows:
            return np.zeros((0, 0), dtype=bool)
        arr = np.frombuffer("".join(self.rows).encode("latin-1"),
                            np.uint8).reshape(len(self.rows), -1)
        return (((arr >= ord("A")) & (arr <= ord("Z")))
                | ((arr >= ord("a")) & (arr <= ord("z")))
                | ((arr >= ord("0")) & (arr <= ord("9"))))

    def select(self, sequences=None, columns=None) -> "TextMSA":
        """Select and copy a subset of the alignment
        (``MSA.select``, reference ``easel.pyx:5276``)."""
        out = TextMSA(self.name)
        seq_idx, col_idx = self._select_impl(out, None, sequences, columns)
        rows = [self.rows[int(i)] for i in seq_idx]
        if col_idx is not None:
            rows = ["".join(r[int(c)] for c in col_idx) for r in rows]
        out.rows = rows
        return out

    def checksum(self) -> int:
        """A stable checksum over the unaligned sequences."""
        import zlib
        h = 0
        for s in self.sequences_as_unaligned():
            h = zlib.crc32(s.sequence.encode("ascii"), h)
        return h

    def copy(self) -> "TextMSA":
        out = TextMSA(self.name)
        out.names = list(self.names)
        out.rows = list(self.rows)
        self._copy_annotations_to(out)
        out.weights = None if self.weights is None else np.asarray(
            self.weights).copy()
        return out

    def digitize(self, alphabet: Alphabet) -> "DigitalMSA":
        msa = DigitalMSA(alphabet, self.name)
        msa.names = list(self.names)
        for attr in ("accession", "description", "author", "reference",
                     "consensus_structure", "model_mask"):
            setattr(msa, attr, getattr(self, attr))
        if self.rows:
            msa.codes = np.stack([alphabet.encode(r) for r in self.rows])
        else:
            msa.codes = np.zeros((0, 0), dtype=np.uint8)
        msa.weights = None if self.weights is None else self.weights.copy()
        return msa

    def sequences_as_unaligned(self) -> Iterator[TextSequence]:
        for name, row in zip(self.names, self.rows):
            yield TextSequence(
                name=name,
                sequence="".join(c for c in row if c not in "-.~ ").upper(),
            )


class DigitalMSA(MSA):
    """Alignment stored as a code matrix ``codes[nseq, alen]``."""

    def __init__(self, alphabet: Alphabet, name: Optional[bytes] = None,
                 sequences: TySequence[DigitalSequence] = ()):
        super().__init__(name)
        self.alphabet = alphabet
        seqs = list(sequences)
        self.names = [s.name for s in seqs]
        if seqs:
            alen = max(len(s) for s in seqs)
            self.codes = np.full((len(seqs), alen), alphabet.gap_code,
                                 dtype=np.uint8)
            for i, s in enumerate(seqs):
                self.codes[i, : len(s)] = s.sequence
        else:
            self.codes = np.zeros((0, 0), dtype=np.uint8)

    @property
    def alignment_length(self) -> int:
        return self.codes.shape[1]

    @property
    def alignment(self):
        """Tuple of aligned row strings (decoded)."""
        return tuple(self.alphabet.decode(r) for r in self.codes)

    @property
    def sequences(self):
        """List of `DigitalSequence` views over the aligned rows
        (gaps included, like the reference's ``DigitalMSASequences``)."""
        return [DigitalSequence(self.alphabet, name=n, sequence=row.copy())
                for n, row in zip(self.names, self.codes)]

    def _pb_inputs(self):
        return self.codes, self.alphabet.K, self.alphabet.gap_code

    def _residue_mask(self) -> np.ndarray:
        # residues are core or degenerate codes (not gap/nonres/missing)
        gap = self.alphabet.gap_code
        return ((self.codes != gap)
                & (self.codes != self.alphabet.nonresidue_code)
                & (self.codes != self.alphabet.missing_code))

    def select(self, sequences=None, columns=None) -> "DigitalMSA":
        """Select and copy a subset of the alignment
        (``MSA.select``, reference ``easel.pyx:5276``)."""
        out = DigitalMSA(self.alphabet, self.name)
        seq_idx, col_idx = self._select_impl(out, None, sequences, columns)
        codes = self.codes[seq_idx]
        if col_idx is not None:
            codes = codes[:, col_idx]
        out.codes = codes.copy()
        return out

    def copy(self) -> "DigitalMSA":
        out = DigitalMSA(self.alphabet, self.name)
        out.names = list(self.names)
        out.codes = self.codes.copy()
        self._copy_annotations_to(out)
        out.weights = None if self.weights is None else np.asarray(
            self.weights).copy()
        return out

    def reverse_complement(self, inplace: bool = False) -> "DigitalMSA":
        """Reverse-complement every row of a nucleotide alignment
        (``DigitalMSA.reverse_complement``, reference ``easel.pyx:6431``)."""
        comp = self.alphabet.complement_map
        if comp is None:
            raise ValueError(
                "reverse_complement requires a nucleotide alphabet")
        rc = comp[self.codes[:, ::-1]]
        if inplace:
            self.codes = np.ascontiguousarray(rc)
            return self
        out = self.copy()
        out.codes = np.ascontiguousarray(rc)
        return out

    @classmethod
    def sample(cls, alphabet: Alphabet, max_sequences: int,
               max_length: int, randomness=None) -> "DigitalMSA":
        """Sample a random alignment (testing helper, mirrors
        ``DigitalMSA.sample``, reference ``easel.pyx:5959``)."""
        from .random import Randomness
        rng = randomness or Randomness()
        nseq = 1 + rng._rng.randint(0, max(1, max_sequences))
        alen = 1 + rng._rng.randint(0, max(1, max_length))
        out = cls(alphabet)
        out.names = [b"seq%d" % i for i in range(nseq)]
        out.codes = rng._rng.randint(
            0, alphabet.K, (nseq, alen)).astype(np.uint8)
        return out

    def textize(self) -> TextMSA:
        msa = TextMSA(self.name)
        msa.names = list(self.names)
        msa.rows = [self.alphabet.decode(r) for r in self.codes]
        for attr in ("accession", "description", "author", "reference",
                     "consensus_structure", "model_mask", "weights"):
            setattr(msa, attr, getattr(self, attr))
        return msa

    def sequences_as_unaligned(self) -> Iterator[DigitalSequence]:
        gap = self.alphabet.gap_code
        miss = self.alphabet.missing_code
        for name, row in zip(self.names, self.codes):
            keep = (row != gap) & (row != miss)
            yield DigitalSequence(self.alphabet, name=name,
                                  sequence=row[keep].copy())

    def checksum(self) -> int:
        """A stable checksum over the unaligned sequences (used by
        jackhmmer convergence bookkeeping; not Easel-compatible)."""
        import zlib
        h = 0
        for s in self.sequences_as_unaligned():
            h = zlib.crc32(s.sequence.tobytes(), h)
        return h

    def identity_filter(self, max_identity: float = 0.8,
                        preference: str = "conscover") -> "DigitalMSA":
        """Greedy single-linkage %identity filtering
        (``esl_msaweight_IDFilter`` semantics)."""
        K = self.alphabet.K
        n = len(self.names)
        keep = []
        for i in range(n):
            ri = self.codes[i]
            ok = True
            for j in keep:
                rj = self.codes[j]
                both = (ri < K) & (rj < K)
                denom = min((ri < K).sum(), (rj < K).sum())
                if denom == 0:
                    continue
                ident = ((ri == rj) & both).sum() / denom
                if ident > max_identity:
                    ok = False
                    break
            if ok:
                keep.append(i)
        out = DigitalMSA(self.alphabet, self.name)
        out.names = [self.names[i] for i in keep]
        out.codes = self.codes[keep].copy()
        for attr in ("accession", "description", "reference",
                     "consensus_structure", "model_mask"):
            setattr(out, attr, getattr(self, attr))
        return out

