"""Application layer of the port: ``hmmsearch`` through the PyTorch
engine (the port of ``pyhmmer_tpu/hmmer/__init__.py``'s hmmsearch)."""

from __future__ import annotations

from typing import Iterator, Optional

from ..easel.alphabet import Alphabet
from ..easel.seqfile import SequenceFile
from ..easel.sequence import DigitalSequenceBlock
from ..engine import SearchEngine, resolve_device
from ..plan7.hmm import HMM
from ..plan7.results import TopHits

__all__ = ["hmmsearch"]


# _target_block and _query_list: pyhmmer_tpu/hmmer/__init__.py:40-59,
# without the HMMFile case (the port reads no HMM files)
def _target_block(sequences, alphabet: Optional[Alphabet] = None
                  ) -> DigitalSequenceBlock:
    if isinstance(sequences, DigitalSequenceBlock):
        return sequences
    if isinstance(sequences, SequenceFile):
        if not sequences.digital:
            raise ValueError("expected digital mode SequenceFile")
        return sequences.read_block()
    seqs = list(sequences)
    if not seqs:
        raise ValueError("no target sequences")
    return DigitalSequenceBlock(seqs[0].alphabet, seqs)


def _query_list(queries):
    if isinstance(queries, (HMM,)):
        return [queries]
    return list(queries)


def hmmsearch(queries, sequences, *, device="cuda", callback=None,
              block_residues: Optional[int] = None, device_rows: bool = False,
              **options) -> Iterator[TopHits]:
    """Search HMM profile(s) against a sequence database; yields one
    :class:`TopHits` per query, in query order.

    ``device`` is where the filter cascade runs: ``"cuda"`` (the
    default) runs the CUDA kernels and raises if there is no CUDA device;
    ``"cpu"`` runs their plain PyTorch versions.  ``device_rows=True``
    also runs the final survivors' full-length parsers and posterior
    decode on the device (see :class:`SearchEngine`).  When
    ``sequences`` is a digital :class:`SequenceFile`, the database is
    consumed in blocks of ``block_residues`` residues (default 16M) and
    the per-block results are merged, as in
    ``pyhmmer_tpu.hmmer.hmmsearch``."""
    dev = resolve_device(device)
    queries = _query_list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    if isinstance(sequences, SequenceFile):
        return _hmmsearch_streamed(queries, sequences, alphabet, dev,
                                   callback, block_residues or (1 << 24),
                                   dict(options, device_rows=device_rows))
    block = _target_block(sequences)
    eng = SearchEngine(alphabet, device=dev, device_rows=device_rows,
                       **options)
    return iter(eng.search(queries, block, callback=callback))


def _hmmsearch_streamed(queries, seqfile: SequenceFile, alphabet, device,
                        callback, block_residues: int, options):
    """Blockwise hmmsearch over a streamed target file: one engine, one
    ``TopHits.merge`` per query at the end."""
    if not seqfile.digital:
        raise ValueError("expected digital mode SequenceFile")
    eng = SearchEngine(alphabet, device=device, **options)
    partials = None
    while True:
        block = seqfile.read_block(residues=block_residues)
        if len(block) == 0:
            break
        results = eng.search(queries, block)
        if partials is None:
            partials = [[th] for th in results]
        else:
            for acc, th in zip(partials, results):
                acc.append(th)
    if partials is None:
        empty = eng.search(queries, DigitalSequenceBlock(alphabet))
        partials = [[th] for th in empty]
    merged = []
    for q, parts in zip(queries, partials):
        th = parts[0].merge(*parts[1:]) if len(parts) > 1 else parts[0]
        merged.append(th)
        if callback is not None:
            callback(q, len(queries))
    return iter(merged)
