"""The port's copy of the Easel layer: alphabets, sequences, sequence
files, alignments and their files, genetic codes, BLAST volumes, the
containers, the random number generator and SSI indexes
(``pyhmmer_tpu/easel``)."""

from .alphabet import AA, DNA, RNA, Alphabet
from .containers import (Bitfield, KeyHash, Matrix, MatrixD, MatrixF,
                         MatrixI, MatrixU8, Vector, VectorD, VectorF,
                         VectorI, VectorU8)
from .gencode import GeneticCode
from .msa import MSA, DigitalMSA, TextMSA
from .msafile import MSAFile
from .random import Randomness
from .sequence import (DigitalSequence, DigitalSequenceBlock, Sequence,
                       SequenceBlock, TextSequence, TextSequenceBlock)
from .seqfile import SequenceFile
from .ssi import SSIReader, SSIWriter

__all__ = [
    "Alphabet", "DNA", "RNA", "AA", "Sequence", "TextSequence",
    "DigitalSequence", "SequenceBlock", "TextSequenceBlock",
    "DigitalSequenceBlock", "SequenceFile", "MSA", "TextMSA", "DigitalMSA",
    "MSAFile", "SSIReader", "SSIWriter", "GeneticCode", "Randomness",
    "Bitfield", "KeyHash",
    "Vector", "VectorD", "VectorF", "VectorI", "VectorU8",
    "Matrix", "MatrixD", "MatrixF", "MatrixI", "MatrixU8",
]
