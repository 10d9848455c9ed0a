"""Application layer of the port: ``hmmsearch``, ``phmmer`` and
``jackhmmer`` through the PyTorch engine (the port of
``pyhmmer_tpu/hmmer/__init__.py``'s functions of those names).  phmmer
and jackhmmer build their query models with the port's
:class:`~pyhmmer_tpu_torch.plan7.builder.Builder`, whose E-value
calibration runs on the same device as the search."""

from __future__ import annotations

from typing import Iterator, Optional

from .._device import resolve_device
from ..easel.alphabet import Alphabet
from ..easel.msa import DigitalMSA
from ..easel.seqfile import SequenceFile
from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
from ..engine import SearchEngine
from ..plan7.background import Background
from ..plan7.builder import Builder
from ..plan7.hmm import HMM
from ..plan7.pipeline import Pipeline
from ..plan7.results import TopHits

__all__ = ["hmmsearch", "phmmer", "jackhmmer"]

#: jackhmmer sends each round's search to the engine from this many
#: targets up; smaller target sets take the sequential pipeline
#: (identical results; the JAX package's threshold,
#: ``pyhmmer_tpu/hmmer/__init__.py:382``)
JACKHMMER_ENGINE_MIN_TARGETS = 64


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


def phmmer(queries, sequences, *, device="cuda", callback=None,
           builder: Optional[Builder] = None, device_rows: bool = False,
           **options) -> Iterator[TopHits]:
    """Search query sequence(s) (or digital MSAs) against a sequence
    database; yields one :class:`TopHits` per query, in query order
    (``pyhmmer_tpu.hmmer.phmmer``).  Each query's model is built and
    calibrated by a copy of ``builder`` (default ``Builder(alphabet,
    device=device)``) and all models are searched in one
    :class:`SearchEngine` call; ``device`` and ``device_rows`` as in
    :func:`hmmsearch`."""
    dev = resolve_device(device)
    if isinstance(queries, (DigitalSequence, DigitalMSA)):
        queries = [queries]
    queries = list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    block = _target_block(sequences)
    bg = Background(alphabet)
    bld = builder or Builder(alphabet, device=dev)
    hmms = []
    for q in queries:
        if isinstance(q, DigitalMSA):
            hmm, _, _ = bld.copy().build_msa(q, bg)
        else:
            hmm, _, _ = bld.copy().build(q, bg)
        hmms.append(hmm)
    eng = SearchEngine(alphabet, device=dev, device_rows=device_rows,
                       **options)
    return iter(eng.search(hmms, block, callback=callback))


def jackhmmer(queries, sequences, *, max_iterations: int = 5,
              select_hits=None, checkpoints: bool = False, device="cuda",
              callback=None, builder: Optional[Builder] = None,
              device_rows: bool = False, **options):
    """Iterative profile search (``pyhmmer_tpu.hmmer.jackhmmer``); yields
    per query its last :class:`IterationResult`, or with
    ``checkpoints=True`` the list of every iteration's.  Default
    inclusion thresholds incE = incdomE = 0.001; ``hand`` architecture
    builder (default ``Builder(alphabet, architecture="hand",
    device=device)``).  From :data:`JACKHMMER_ENGINE_MIN_TARGETS` targets
    up each round searches through a :class:`SearchEngine` on
    ``device``; ``device`` and ``device_rows`` as in :func:`hmmsearch`."""
    dev = resolve_device(device)
    if isinstance(queries, DigitalSequence):
        queries = [queries]
    queries = list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    block = _target_block(sequences)
    options.setdefault("incE", 0.001)
    options.setdefault("incdomE", 0.001)
    bld = builder or Builder(alphabet, architecture="hand", device=dev)

    def run_one(q):
        pli = Pipeline(alphabet, **options)
        search = pli.iterate_seq(q, block, builder=bld.copy(),
                                 select_hits=select_hits)
        # a new engine per query: the model changes every iteration, so
        # the engine's profile cache would only churn across queries
        if len(block) >= JACKHMMER_ENGINE_MIN_TARGETS:
            search.engine = SearchEngine(alphabet, device=dev,
                                         device_rows=device_rows,
                                         **options)
        results = []
        last = None
        for _ in range(max_iterations):
            try:
                last = next(search)
            except StopIteration:
                break
            results.append(last)
            if last.converged:
                break
        return results if checkpoints else last

    def gen():
        for q in queries:
            out = run_one(q)
            if callback is not None:
                callback(q, len(queries))
            yield out
    return gen()
