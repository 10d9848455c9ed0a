"""Iterative search (the jackhmmer loop).

Mirrors ``pyhmmer.plan7.IterativeSearch`` / ``IterationResult`` (reference
``src/pyhmmer/plan7.pyx:4028-4182``): iteration 1 builds a model from the
query sequence; iteration N rebuilds from the previous round's included-
hit MSA; convergence when no new hit is included and the MSA stopped
growing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from ..easel.sequence import DigitalSequence
from .hmm import HMM
from .results import TopHits, F_NEW


class IterationResult(NamedTuple):
    hmm: HMM
    hits: TopHits
    msa: object
    converged: bool
    iteration: int


class IterativeSearch:
    """Iterator of ``IterationResult`` (``plan7.pyx:4064-4182``)."""

    def __init__(self, pipeline, builder, query, targets,
                 select_hits: Optional[Callable] = None,
                 from_msa: bool = False, engine=None):
        self.pipeline = pipeline
        self.builder = builder
        self.query = query
        self.targets = targets
        self.select_hits = select_hits
        self.converged = False
        self.iteration = 0
        self.ranking: dict = {}
        self._msa = None
        self._msa_len = 0
        #: optional batched SearchEngine: per-round searches then run the
        #: device filter cascade instead of the sequential oracle
        self.engine = engine

    def __iter__(self):
        return self

    def _search_hmm(self, hmm: HMM) -> TopHits:
        """Run one round's search; overridden by the daemon-backed variant
        (reference ``daemon.pyx:257-262``)."""
        if self.engine is not None:
            return self.engine.search([hmm], self.targets)[0]
        return self.pipeline.search_hmm(hmm, self.targets)

    def __next__(self) -> IterationResult:
        if self.converged:
            raise StopIteration
        pli = self.pipeline
        pli.clear()
        if self.iteration == 0:
            if isinstance(self.query, HMM):
                hmm = self.query
            else:
                hmm, _, _ = self.builder.build(self.query, pli.background)
        else:
            hmm, _, _ = self.builder.build_msa(self._msa, pli.background)

        hits = self._search_hmm(hmm)
        if self.select_hits is not None:
            self.select_hits(hits)
            hits.threshold()
        n_new = hits.compare_ranking(self.ranking)

        seqs, traces = [], []
        if isinstance(self.query, DigitalSequence):
            from .tracealign import trace_from_sequence
            seqs = [self.query]
            traces = [trace_from_sequence(self.query)]
        msa = hits.to_msa(pli.alphabet, sequences=seqs, traces=traces,
                          all_consensus_cols=True, digitize=True)

        self.iteration += 1
        if n_new == 0 and len(msa) <= self._msa_len:
            self.converged = True
        self._msa = msa
        self._msa_len = len(msa)
        return IterationResult(hmm, hits, msa, self.converged,
                               self.iteration)
