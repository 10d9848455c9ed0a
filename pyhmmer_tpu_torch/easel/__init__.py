"""The port's copy of the Easel layer it needs: alphabets, sequences and
sequence files (``pyhmmer_tpu/easel/{alphabet,sequence,seqfile}.py``)."""

from .alphabet import Alphabet
from .sequence import (DigitalSequence, DigitalSequenceBlock, TextSequence,
                       TextSequenceBlock)
from .seqfile import SequenceFile

__all__ = ["Alphabet", "DigitalSequence", "DigitalSequenceBlock",
           "TextSequence", "TextSequenceBlock", "SequenceFile"]
