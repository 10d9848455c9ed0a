"""A seeded hmmsearch workload for the port's tests and ``chip_smoke.py``.

Everything is drawn with numpy's ``default_rng`` from a seed:

* profile HMMs from ``HMM.sample`` (Dirichlet(1) emissions and
  transitions), named ``smoke-M<M>``;
* target sequences whose residues are i.i.d. from the background
  frequencies, with log-normal lengths;
* planted domains: a path through a model's match states where each
  residue is the consensus residue with probability ``consensus`` and
  otherwise drawn from the match emissions.

The nhmmer workload (:func:`nhmmer_workload`) is a small bacterial
genome against a handful of repeat families: sampled DNA models planted,
mutated, on both strands of a seeded genome.

The smoke workload is a Pfam-like query stack against a proteome: the 16
distinct models of ``SMOKE_M``, replicated by ``bench.py``'s length
weights to about 240 queries, against 4,000 targets (median length 280)
plus a 9,000- and a 35,000-residue target.  The distinct models' E-value
parameters are stored, with a checksum of each model, in
``tests/data/torch_smoke_evparams.json``, as the JAX package's
``Builder.calibrate`` computed them; the port's ``Builder`` reproduces
them (``scripts/make_torch_smoke_evparams.py`` compares the two,
``chip_smoke.py`` on the card), and :func:`smoke_models` refuses models
whose checksum differs (a different numpy random stream).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .easel.alphabet import Alphabet
from .easel.sequence import DigitalSequence, DigitalSequenceBlock
from .plan7.background import Background
from .plan7.hmm import HMM, HMMFlags

#: model lengths of the smoke query stack (16 distinct models)
SMOKE_M = (50, 70, 90, 110, 130, 150, 170, 200, 250, 320, 400, 450, 520,
           600, 750, 900)
SMOKE_SEED = 2024
SMOKE_TARGETS = 4000
SMOKE_LONG = (9000, 35000)
#: copies per distinct model scale bench.py's weights to ~240 queries
SMOKE_SCALE = 1.5
EVPARAMS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data",
    "torch_smoke_evparams.json")


def sample_models(Ms: Sequence[int], seed: int) -> List[HMM]:
    """One ``HMM.sample`` model per length, from one generator."""
    aa = Alphabet.amino()
    rng = np.random.default_rng(seed)
    out = []
    for M in Ms:
        h = HMM.sample(aa, int(M), rng)
        h.name = b"smoke-M%03d" % M
        out.append(h)
    return out


def model_checksum(h: HMM) -> str:
    """sha256 of the sampled probabilities (t, mat, ins as float32)."""
    d = hashlib.sha256()
    for a in (h.t, h.mat, h.ins):
        d.update(np.ascontiguousarray(a, np.float32).tobytes())
    return d.hexdigest()[:16]


def smoke_models() -> List[HMM]:
    """The 16 distinct smoke models with their stored E-value
    parameters, flagged calibrated; raises if a model differs from the
    one calibrated."""
    with open(EVPARAMS) as fh:
        table = json.load(fh)
    models = sample_models(SMOKE_M, SMOKE_SEED)
    for h in models:
        entry = table[h.name.decode()]
        if entry["checksum"] != model_checksum(h):
            raise RuntimeError(
                f"{h.name.decode()}: sampled model checksum "
                f"{model_checksum(h)} != stored {entry['checksum']}; "
                f"numpy's random stream differs from the one calibrated")
        h.evparam[:] = entry["evparams"]
        # calibrated, as ``Builder.calibrate`` marks them: the HMM text
        # (the daemon's wire, hmmpress) carries the STATS lines
        h.flags |= HMMFlags.STATS
    return models


def bench_weight(M: int) -> int:
    """``bench.py``'s Pfam-like copies per model length."""
    if M < 110:
        return 20
    if M < 160:
        return 13
    if M < 280:
        return 10
    if M < 480:
        return 7
    if M < 650:
        return 4
    return 3


def replicate(models: Sequence[HMM], scale: float = SMOKE_SCALE
              ) -> List[HMM]:
    """Each model plus ``round(bench_weight(M) * scale) - 1`` renamed
    copies (``name/r1``, ``name/r2``...)."""
    out = []
    for h in models:
        out.append(h)
        for r in range(1, max(1, int(round(bench_weight(h.M) * scale)))):
            hh = h.copy()
            hh.name = h.name + b"/r%d" % r
            out.append(hh)
    return out


def plant(h: HMM, rng, consensus: float, skip: int = 0) -> np.ndarray:
    """Residue codes of a domain through the model's match states: the
    consensus residue with probability ``consensus``, otherwise a draw
    from the match emissions.  With ``skip`` > 0 every ``skip``-th match
    state is deleted, which breaks the ungapped diagonals the MSV filter
    scores while Forward and Viterbi still align the domain."""
    states = np.arange(1, h.M + 1)
    if skip:
        states = states[states % skip != 0]
    n = len(states)
    mat = np.asarray(h.mat[states], np.float64)
    mat = mat / mat.sum(axis=1, keepdims=True)
    cons = mat.argmax(axis=1)
    u = rng.random(n)
    cdf = np.cumsum(mat, axis=1)
    drawn = (rng.random(n)[:, None] > cdf).sum(axis=1)
    drawn = np.minimum(drawn, mat.shape[1] - 1)
    return np.where(u < consensus, cons, drawn).astype(np.uint8)


#: (consensus fraction, deleted-state period, minimum residues) of the
#: domains planted per model: a strong one, repeated in tandem until it
#: spans the minimum (short models score too low alone), a medium one,
#: a gapped one, and a weak densely gapped one whose MSV P-value sits
#: between the Viterbi-skip and MSV gates while its Forward score
#: passes on the longer models, so the Viterbi stage has work
PLANTS = ((1.0, 0, 100), (0.5, 0, 0), (0.7, 10, 0), (0.4, 3, 0))


def make_targets(models: Sequence[HMM], n: int, seed: int,
                 long_lengths: Sequence[int] = (), median: float = 280.0,
                 sigma: float = 0.6, plants=PLANTS
                 ) -> Tuple[DigitalSequenceBlock, Dict[bytes, Set[bytes]]]:
    """``n`` random targets (log-normal lengths clipped to 30..5000) plus
    one of each ``long_lengths``, with ``plants`` domains planted per
    model at random positions of distinct random targets.  Returns the
    block and ``{model name: {names of targets planted with it}}``."""
    aa = models[0].alphabet
    rng = np.random.default_rng(seed)
    f = np.asarray(Background(aa).residue_frequencies, np.float64)
    f = f / f.sum()
    lens = np.clip(np.rint(rng.lognormal(np.log(median), sigma, n)),
                   30, 5000).astype(np.int64)
    lens = np.concatenate([lens, np.asarray(long_lengths, np.int64)])
    seqs = [rng.choice(len(f), size=int(L), p=f).astype(np.uint8)
            for L in lens]
    planted: Dict[bytes, Set[bytes]] = {}
    hosts = rng.permutation(n)[: len(models) * len(plants)]
    for k, tgt in enumerate(hosts):
        h = models[k // len(plants)]
        consensus, skip, min_len = plants[k % len(plants)]
        dom = np.concatenate([plant(h, rng, consensus, skip) for _ in
                              range(max(1, -(-min_len // h.M)))])
        s = seqs[tgt]
        if len(s) < len(dom) + 40:
            s = np.concatenate([s, rng.choice(len(f), size=len(dom) + 40
                                              - len(s), p=f)]).astype(
                np.uint8)
        at = int(rng.integers(0, len(s) - len(dom) + 1))
        s[at: at + len(dom)] = dom
        seqs[tgt] = s
        planted.setdefault(h.name, set()).add(b"target%05d" % tgt)
    block = DigitalSequenceBlock(aa, [
        DigitalSequence(aa, name=b"target%05d" % i, sequence=s)
        for i, s in enumerate(seqs)])
    return block, planted


def make_lanes(models: Sequence[HMM], n: int, Lmax: int, seed: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """A kernel-test bucket: ``codes`` [n, Lmax] uint8 (tails filled with
    the nonresidue code) and ``lengths`` [n].  Lanes 0.. hold each
    model's consensus (MSV overflow rows), the next ones a planted domain
    per model, every 5th lane a nonresidue code inside the sequence, and
    the lengths include 1, 7, 8, 9, 15, 16, 17 and Lmax (8-row block
    edges); the rest are i.i.d. background residues."""
    aa = models[0].alphabet
    rng = np.random.default_rng(seed)
    f = np.asarray(Background(aa).residue_frequencies, np.float64)
    f = f / f.sum()
    edges = [L for L in (1, 7, 8, 9, 15, 16, 17, Lmax) if L <= Lmax]
    lens = rng.integers(1, Lmax + 1, n)
    lens[-len(edges):] = edges
    codes = np.full((n, Lmax), aa.nonresidue_code, dtype=np.uint8)
    for i in range(n):
        codes[i, : lens[i]] = rng.choice(len(f), size=int(lens[i]), p=f)
    k = len(models)
    for j, h in enumerate(models):
        cons = plant(h, rng, 1.0)[:Lmax]
        codes[j, : len(cons)] = cons
        lens[j] = max(lens[j], len(cons))
        dom = plant(h, rng, 0.5)[: max(1, Lmax - 10)]
        L = max(int(lens[k + j]), len(dom) + 10)
        codes[k + j, :L] = rng.choice(len(f), size=L, p=f)
        codes[k + j, 5: 5 + len(dom)] = dom
        lens[k + j] = L
    for i in range(2 * k, n - len(edges), 5):
        codes[i, int(rng.integers(0, lens[i]))] = aa.nonresidue_code
    return codes, lens.astype(np.int64)


def smoke_workload(n_targets: int = SMOKE_TARGETS):
    """(queries, distinct models, targets, planted) of the smoke run."""
    models = smoke_models()
    targets, planted = make_targets(models, n_targets, SMOKE_SEED + 1,
                                    long_lengths=SMOKE_LONG)
    return replicate(models), models, targets, planted


#: the nhmmer workload: sampled DNA models (the last one wider than the
#: kernels' 4,096-slot stripes, so its gates take the wide route), and a
#: small bacterial genome of 4 records, 2 Mb in all, with 4 mutated copies
#: of each model planted in one record, two on each strand.  nhmmer gates
#: a record's candidate subwindows on the device only from 4 of them
#: (``plan7/longtargets.py``, as in the JAX package), and the widest
#: model seeds almost nowhere but on its copies, so its record holds 4
NHMMER_M = (400, 1200, 5000)
NHMMER_SEED = 2025
NHMMER_RECORDS = 4
NHMMER_RECORD_LEN = 500_000
NHMMER_COPIES = 4


#: Dirichlet parameters of the DNA models' match emissions and of their
#: M -> (M, I, D), I -> (M, I) and D -> (M, D) transitions: a repeat
#: family's profile mostly follows its match states, with the occasional
#: indel (``HMM.sample``'s flat Dirichlet(1) gives a third of every
#: state's mass to indels, so a planted copy of such a model scores
#: nothing)
DNA_EMIT, DNA_TM, DNA_TI, DNA_TD = 0.5, (60.0, 1.0, 1.0), (2.0, 1.0), \
    (2.0, 1.0)


def sample_dna_models(Ms: Sequence[int], seed: int) -> List[HMM]:
    """One sampled DNA model per length (``dna-M<M>``), from one
    generator: ``HMM.sample``'s model with its match emissions and core
    transitions redrawn from :data:`DNA_EMIT` and :data:`DNA_TM`
    (``DNA_TI``, ``DNA_TD``); uncalibrated."""
    dna = Alphabet.dna()
    rng = np.random.default_rng(seed)
    out = []
    for M in Ms:
        M = int(M)
        h = HMM.sample(dna, M, rng)
        h.mat[1:] = rng.dirichlet(np.full(dna.K, DNA_EMIT), size=M)
        h.t[:M, 0:3] = rng.dirichlet(DNA_TM, size=M)
        h.t[:, 3:5] = rng.dirichlet(DNA_TI, size=M + 1)
        h.t[1:M, 5:7] = rng.dirichlet(DNA_TD, size=M - 1)
        h.name = b"dna-M%04d" % M
        out.append(h)
    return out


def make_genome(models: Sequence[HMM], n_records: int, record_len: int,
                copies: int, seed: int, consensus: float = 0.85,
                gap: int = 20_000) -> Tuple[DigitalSequenceBlock, list]:
    """``n_records`` DNA records of ``record_len`` i.i.d. background
    residues (``chr1``...) with ``copies`` mutated copies of each model
    planted (:func:`plant`, the consensus residue with probability
    ``consensus``): the copies of model ``i`` in record ``i %
    n_records`` (a repeat family clustered on one chromosome), at random
    places at least ``gap`` residues apart, every other one
    reverse-complemented onto the minus strand.  Returns the block and
    the planted copies as (model name, record name, first, last,
    strand), 1-based coordinates on the record."""
    dna = models[0].alphabet
    rng = np.random.default_rng(seed)
    f = np.asarray(Background(dna).residue_frequencies, np.float64)
    f = f / f.sum()
    recs = [rng.choice(len(f), size=record_len, p=f).astype(np.uint8)
            for _ in range(n_records)]
    taken: List[List[Tuple[int, int]]] = [[] for _ in range(n_records)]
    planted = []
    for i, h in enumerate(models):
        r = i % n_records
        for k in range(copies):
            dom = plant(h, rng, consensus)
            strand = "+" if k % 2 == 0 else "-"
            if strand == "-":
                dom = dna.complement_map[dom][::-1]
            for _ in range(10_000):
                at = int(rng.integers(0, record_len - len(dom)))
                if all(at + len(dom) + gap < a or b + gap < at
                       for a, b in taken[r]):
                    break
            else:
                raise ValueError("record too short for the copies")
            recs[r][at: at + len(dom)] = dom
            taken[r].append((at, at + len(dom)))
            planted.append((h.name, b"chr%d" % (r + 1), at + 1,
                            at + len(dom), strand))
    block = DigitalSequenceBlock(dna, [
        DigitalSequence(dna, name=b"chr%d" % (r + 1), sequence=s)
        for r, s in enumerate(recs)])
    return block, planted


def nhmmer_workload():
    """(uncalibrated DNA models, genome block, planted copies) of the
    nhmmer smoke run."""
    models = sample_dna_models(NHMMER_M, NHMMER_SEED)
    genome, planted = make_genome(models, NHMMER_RECORDS,
                                  NHMMER_RECORD_LEN, NHMMER_COPIES,
                                  NHMMER_SEED + 1)
    return models, genome, planted


def recall(results, planted: Dict[bytes, Set[bytes]]) -> float:
    """Fraction of planted (model, target) pairs reported by the query of
    that model (replicated copies count as the model)."""
    found, total = 0, 0
    seen = set()
    for th in results:
        base = th.query_name.split(b"/")[0]
        if base not in planted or base in seen:
            continue
        seen.add(base)
        names = {h.name for h in th.reported}
        found += len(planted[base] & names)
        total += len(planted[base])
    return found / total if total else float("nan")
