"""The port's copy of the Easel layer it needs: alphabets, sequences,
sequence files, alignments, bit fields, the random number generator and
SSI indexes
(``pyhmmer_tpu/easel/{alphabet,sequence,seqfile,msa,containers,random,
ssi}.py``; of ``containers``, ``Bitfield`` only)."""

from .alphabet import Alphabet
from .containers import Bitfield
from .msa import MSA, DigitalMSA, TextMSA
from .random import Randomness
from .sequence import (DigitalSequence, DigitalSequenceBlock, TextSequence,
                       TextSequenceBlock)
from .seqfile import SequenceFile
from .ssi import SSIReader, SSIWriter

__all__ = ["Alphabet", "Bitfield", "MSA", "DigitalMSA", "TextMSA",
           "Randomness", "DigitalSequence", "DigitalSequenceBlock",
           "TextSequence", "TextSequenceBlock", "SequenceFile", "SSIReader",
           "SSIWriter"]
