"""Application layer of the port: ``hmmsearch``, ``hmmscan``, ``phmmer``
and ``jackhmmer`` through the PyTorch engine, ``nhmmer`` through the
long-targets pipeline, and the host-only ``hmmalign`` and ``hmmpress``
(the port of ``pyhmmer_tpu/hmmer/__init__.py``'s functions of those
names; all but ``hmmpress`` take the JAX package's ``cpus``
argument and ignore it).  phmmer, jackhmmer and nhmmer build their query models with the
port's :class:`~pyhmmer_tpu_torch.plan7.builder.Builder`, whose E-value
calibration runs on the same device as the search; hmmscan runs the
engine with the profile database (HMMs, profiles, or a pressed
database's :class:`~pyhmmer_tpu_torch.plan7.optimized.HMMPressedFile`)
as its queries and re-keys the hits by model; nhmmer's subwindow gates
run on the device's kernels."""

from __future__ import annotations

import os
from typing import Iterator, Optional, Union

from .._device import resolve_device
from ..easel.alphabet import Alphabet
from ..easel.msa import DigitalMSA
from ..easel.seqfile import SequenceFile
from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
from ..engine import SearchEngine
from ..plan7.background import Background
from ..plan7.builder import Builder
from ..plan7.hmm import HMM
from ..plan7.hmmfile import write_hmm_binary
from ..plan7.longtargets import LongTargetsPipeline
from ..plan7.optimized import OptimizedProfile
from ..plan7.pipeline import Pipeline
from ..plan7.profile import Profile
from ..plan7.results import Hit, TopHits
from ..plan7.tracealign import TraceAligner

__all__ = ["hmmsearch", "hmmscan", "phmmer", "jackhmmer", "hmmalign",
           "hmmpress", "nhmmer"]

#: jackhmmer sends each round's search to the engine from this many
#: targets up; smaller target sets take the sequential pipeline
#: (identical results; the JAX package's threshold,
#: ``pyhmmer_tpu/hmmer/__init__.py:382``)
JACKHMMER_ENGINE_MIN_TARGETS = 64


# _target_block and _query_list: pyhmmer_tpu/hmmer/__init__.py:40-59 (an
# HMMFile is a list of queries like any other iterable)
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


def hmmsearch(queries, sequences, *, cpus: int = 0, device="cuda",
              callback=None, backend: str = "cuda",
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
    ``pyhmmer_tpu.hmmer.hmmsearch``.  ``backend="oracle"`` searches each
    query with the sequential ``Pipeline.search_hmm`` instead (a
    :class:`SequenceFile` is then read whole), as the JAX package's
    ``hmmsearch`` does."""
    dev = resolve_device(device)
    queries = _query_list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    if isinstance(sequences, SequenceFile) and backend != "oracle":
        return _hmmsearch_streamed(queries, sequences, alphabet, dev,
                                   callback, block_residues or (1 << 24),
                                   dict(options, device_rows=device_rows))
    block = _target_block(sequences)
    if backend == "oracle":
        def gen():
            for q in queries:
                th = Pipeline(alphabet, **options).search_hmm(q, block)
                if callback is not None:
                    callback(q, len(queries))
                yield th
        return gen()
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


def hmmscan(queries, profiles, *, cpus: int = 0, device="cuda",
            callback=None, background=None, engine: Optional[SearchEngine] = None,
            **options) -> Iterator[TopHits]:
    """Scan sequence(s) against a profile database; yields one
    :class:`TopHits` per query sequence, in query order, with Z = the
    number of profiles (``pyhmmer_tpu.hmmer.hmmscan``).  ``profiles``
    holds :class:`HMM`, :class:`Profile` or :class:`OptimizedProfile`
    objects (a profile carries its core model), or is a pressed
    database's :class:`~pyhmmer_tpu_torch.plan7.optimized.HMMPressedFile`
    (written by :func:`hmmpress`), whose optimized profiles carry the
    models of its ``.h3m`` member.  The scan is the
    transpose of a search: one :class:`SearchEngine` call on ``device``
    (or ``engine``, which keeps its configured models across calls) with
    the profiles as queries and the sequences as targets, each hit then
    re-keyed by its model (an ``engine`` runs on its own device, and
    ``device`` is not read); ``backend="oracle"`` scans each sequence
    with the sequential ``Pipeline.scan_seq`` instead."""
    dev = engine.device if engine is not None else resolve_device(device)
    if isinstance(queries, DigitalSequence):
        queries = [queries]
    queries = list(queries)
    hmms = []
    for p in profiles:
        if isinstance(p, HMM):
            hmms.append(p)
        elif isinstance(p, (OptimizedProfile, Profile)):
            prof = p.profile if isinstance(p, OptimizedProfile) else p
            hmm = getattr(prof, "_hmm", None)
            if hmm is None:
                raise TypeError(
                    "optimized profile does not carry its core model; "
                    "configure it from an HMM")
            hmms.append(hmm)
        else:
            hmms.append(p)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet

    backend = options.pop("backend", "cuda")
    if backend != "oracle":
        return iter(_scan_via_engine(hmms, queries, alphabet, background,
                                     callback, options, dev, engine))

    def gen():
        for q in queries:
            pli = Pipeline(alphabet, background, **options)
            th = pli.scan_seq(q, hmms)
            if callback is not None:
                callback(q, len(queries))
            yield th
    return gen()


# pyhmmer_tpu/hmmer/__init__.py:_scan_via_engine, with the engine on
# ``device``
def _scan_via_engine(hmms, queries, alphabet, background, callback,
                     options, device, engine=None):
    import copy as _copy

    block = DigitalSequenceBlock(alphabet, queries)
    # a caller's engine keeps its configured models across calls (one
    # resident profile database, many query batches)
    eng = engine or SearchEngine(alphabet, background, device=device,
                                 **options)
    per_hmm = eng.search(hmms, block)
    cutoff_mode = options.get("bit_cutoffs") is not None

    by_seq = [{h.name: h for h in th} for th in per_hmm]

    # one options dict drives every per-model search, so the thresholds
    # are uniform; check it once
    _THRESH_ATTRS = ("E", "domE", "T", "domT", "incE", "incdomE",
                     "incT", "incdomT", "domZ", "domZ_setby")
    if per_hmm:
        check = ["E", "domE", "T", "domT", "incE", "incdomE", "incT",
                 "incdomT", "domZ_setby"]
        if per_hmm[0].domZ_setby == "option":
            check.append("domZ")   # auto domZ legitimately varies
        for attr in check:
            v0 = getattr(per_hmm[0], attr)
            for other in per_hmm[1:]:
                if getattr(other, attr) != v0:
                    raise ValueError(
                        f"non-uniform per-model threshold {attr!r} in "
                        "hmmscan transpose; per-model options are not "
                        "supported by the engine route")

    out = []
    nres_db = sum(h.M for h in hmms)
    for q in queries:
        th = TopHits()
        th._mode = "scan"
        th.query_name = q.name
        th.query_accession = q.accession or None
        th.query_length = len(q)
        # scan accounting: the targets are the models
        th.nmodels = len(hmms)
        th.nnodes = nres_db
        th.nseqs = 1
        th.nres = len(q)
        th.Z = float(len(hmms))
        th.Z_setby = "ntargets"
        src = per_hmm[0] if per_hmm else None
        if src is not None:
            for attr in _THRESH_ATTRS:
                setattr(th, attr, getattr(src, attr))
        for mi, hmm in enumerate(hmms):
            h = by_seq[mi].get(q.name)
            if h is None:
                continue
            nh = Hit(th, hmm.name, hmm.accession or None,
                     hmm.description or None, hmm.M,
                     score=h.score, pre_score=h.pre_score,
                     sum_score=h.sum_score, lnP=h.lnP,
                     nexpected=h.nexpected, nregions=h.nregions,
                     nclustered=h.nclustered, noverlaps=h.noverlaps,
                     nenvelopes=h.nenvelopes)
            for d in h.domains:
                nd = _copy.copy(d)
                nd.hit = nh
                nh.domains.append(nd)
            nh.best_domain_idx = h.best_domain_idx
            if cutoff_mode:
                # each model's search applied its own GA/TC/NC cutoffs
                nh.reported = h.reported
                nh.included = h.included
                for nd, d in zip(nh.domains, h.domains):
                    nd.flags = d.flags
            th.hits.append(nh)
        th.sort_by_key()
        if cutoff_mode:
            if th.domZ_setby == "ntargets":
                th.domZ = float(sum(1 for h in th.hits if h.reported))
        else:
            th.threshold()
        out.append(th)
        if callback is not None:
            callback(q, len(queries))
    return out


def phmmer(queries, sequences, *, cpus: int = 0, device="cuda",
           callback=None,
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
              select_hits=None, checkpoints: bool = False,
              cpus: int = 0, device="cuda", callback=None,
              builder: Optional[Builder] = None,
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


def hmmalign(hmm: HMM, sequences, *, trim: bool = False,
             digitize: bool = False, all_consensus_cols: bool = True,
             cpus: int = 0):
    """Align sequences to an HMM (``pyhmmer_tpu.hmmer.hmmalign``): one
    Viterbi trace a sequence on the host, then the multiple alignment of
    the traces."""
    seqs = list(sequences)
    aligner = TraceAligner()
    traces = aligner.compute_traces(hmm, seqs)
    return aligner.align_traces(hmm, seqs, traces, trim=trim,
                                digitize=digitize,
                                all_consensus_cols=all_consensus_cols)


def hmmpress(hmms, output: Union[str, os.PathLike]) -> int:
    """Press HMMs into a database (``pyhmmer_tpu.hmmer.hmmpress``):
    writes ``.h3m`` (binary models), ``.h3i`` (SSI index by name,
    aliased by accession), and the ``.h3f``/``.h3p`` vectorized-profile
    members in HMMER's byte layout (``p7_oprofile_Write``), so HMMER can
    read them; returns the number of models.  Host-only."""
    from ..easel.ssi import SSIWriter
    from ..ops.quantize import quantize_msv
    from ..plan7.pressed import write_h3f_record, write_h3p_record

    base = os.fspath(output)
    n = 0
    with open(base + ".h3m", "wb") as fm, \
         open(base + ".h3f", "wb") as ff, \
         open(base + ".h3p", "wb") as fp, \
         SSIWriter(base + ".h3i") as ssi:
        fd = ssi.add_file(os.path.basename(base) + ".h3m")
        for hmm in hmms:
            moff = fm.tell()
            foff = ff.tell()
            poff = fp.tell()
            write_hmm_binary(hmm, fm)
            bg = Background(hmm.alphabet)
            prof = Profile(hmm.M, hmm.alphabet).configure(hmm, bg, 400)
            q = quantize_msv(prof)
            write_h3f_record(ff, hmm, quant=q,
                             offs=(moff, foff, poff))
            write_h3p_record(fp, hmm, prof=prof)
            ssi.add_key(hmm.name, fd, moff, foff, hmm.M)
            if hmm.accession:
                ssi.add_alias(hmm.accession, hmm.name)
            n += 1
    return n


def nhmmer(queries, sequences, *, cpus: int = 0, device="cuda",
           callback=None,
           builder: Optional[Builder] = None, **options
           ) -> Iterator[TopHits]:
    """Search DNA/RNA queries against long nucleotide targets with the
    long-targets pipeline (``pyhmmer_tpu.hmmer.nhmmer``); yields one
    :class:`TopHits` per query, in query order.  Queries may be
    :class:`HMM`, :class:`DigitalSequence` or :class:`DigitalMSA`
    objects (sequence and MSA queries are built, and calibrated on
    ``device``, with nhmmer's window parameters); the targets an
    in-memory block or a digital :class:`SequenceFile`, whose genome
    windows are streamed off disk.  The subwindow gates run on the
    kernels on a CUDA ``device`` and on the host path on the CPU
    (:class:`~pyhmmer_tpu_torch.plan7.longtargets.LongTargetsPipeline`)."""
    dev = resolve_device(device)
    if isinstance(queries, (HMM, DigitalSequence, DigitalMSA)):
        queries = [queries]
    queries = list(queries)
    if not queries:
        return iter(())
    # a digital SequenceFile streams genome windows off disk inside the
    # long-targets pipeline; anything else is materialized as a block
    if isinstance(sequences, SequenceFile) and sequences.digital:
        block = sequences
    else:
        block = _target_block(sequences)
    window_length = options.get("window_length")
    window_beta = options.get("window_beta")

    def run():
        for q in queries:
            pli = LongTargetsPipeline(block.alphabet, device=dev, **options)
            if isinstance(q, HMM):
                th = pli.search_hmm(q, block)
            else:
                bld = (builder or Builder(
                    block.alphabet, window_length=window_length,
                    window_beta=window_beta, device=dev)).copy()
                if isinstance(q, DigitalMSA):
                    th = pli.search_msa(q, block, builder=bld)
                else:
                    th = pli.search_seq(q, block, builder=bld)
            if callback is not None:
                callback(q, len(queries))
            yield th
    return run()
