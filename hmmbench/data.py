"""Seeded inputs of the benchmark, made with numpy alone.

Every array here comes from a numpy stream keyed by a seed, so the same
seed gives the same inputs, and the program and the reference are handed
the same arrays:

* model ``i`` of a database is drawn from the stream ``(s, i)`` of the
  configuration's database seed ``s`` (a deployment searches one fixed
  Pfam; the run's seed draws the sequences): its length from the
  configuration's Pfam-like mix, then its probabilities
  as ``HMM.sample`` draws them (Dirichlet(1) rows; a frozen copy of
  ``pyhmmer_tpu_torch/plan7/hmm.py:HMM.sample``), and its E-value
  parameters are the stored calibration of the configuration's model of
  that length;
* proteome ``p`` is drawn from the stream ``(seed, p, 1)``: log-normal
  lengths, residues i.i.d. from the background, and planted domains
  (a frozen copy of ``pyhmmer_tpu_torch/_synthetic.py:plant`` and the
  planting of ``make_targets``) spread evenly over the database's
  models.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

#: Swiss-Prot 50.8 amino acid frequencies (HMMER's p7_AminoFrequencies,
#: order ACDEFGHIKLMNPQRSTVWY)
AMINO_FREQUENCIES = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float64)
K = 20
HERE = os.path.dirname(os.path.abspath(__file__))


def stream(seed: int, *key: int) -> np.random.Generator:
    """The numpy generator of ``(seed, *key)``; any whole seed, negative
    ones included, maps to a distinct 64-bit entropy word."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *key]))


def sample_model(M: int, rng) -> Dict[str, np.ndarray]:
    """``t`` [M+1, 7], ``mat`` and ``ins`` [M+1, K] float32, drawn in
    ``HMM.sample``'s order (transitions MM, MI, MD, IM, II, DM, DD)."""
    t = np.zeros((M + 1, 7), np.float32)
    mat = np.zeros((M + 1, K), np.float32)
    ins = np.zeros((M + 1, K), np.float32)
    mat[1:] = rng.dirichlet(np.ones(K), size=M).astype(np.float32)
    ins[:] = rng.dirichlet(np.ones(K), size=M + 1).astype(np.float32)
    t[:, 0:3] = rng.dirichlet(np.ones(3), size=M + 1).astype(np.float32)
    t[:, 3:5] = rng.dirichlet(np.ones(2), size=M + 1).astype(np.float32)
    t[1:, 5:7] = rng.dirichlet(np.ones(2), size=M).astype(np.float32)
    t[0, 5] = 1.0
    t[0, 6] = 0.0
    t[M, 2] = 0.0
    t[M, 0:3] /= t[M, 0:3].sum()
    t[M, 5] = 1.0
    t[M, 6] = 0.0
    mat[0, :] = 0.0
    mat[0, 0] = 1.0
    return {"t": t, "mat": mat, "ins": ins}


class Database:
    """The configuration's profile database: ``models`` models, each
    drawn from its own stream of the database's seed."""

    def __init__(self, cfg: dict):
        db = cfg["database"]
        self.seed = int(db["seed"])
        self.n = int(cfg["models"])
        self.lengths = np.asarray(db["lengths"], np.int64)
        w = np.asarray(db["weights"], np.float64)
        self.weights = w / w.sum()
        with open(os.path.join(HERE, "configs", db["evparams"])) as fh:
            table = json.load(fh)
        self.evparams = {int(M): np.asarray(v, np.float64)
                         for M, v in table.items()}
        missing = set(self.lengths.tolist()) - set(self.evparams)
        if missing:
            raise ValueError(f"no stored evparams for lengths {missing}")

    def _length(self, rng) -> int:
        return int(self.lengths[rng.choice(len(self.lengths),
                                           p=self.weights)])

    def length(self, i: int) -> int:
        """M of model ``i`` (the first draw of its stream)."""
        return self._length(stream(self.seed, i))

    def model(self, i: int) -> dict:
        """Model ``i``: name, M, ``t``, ``mat``, ``ins``, ``evparam``."""
        rng = stream(self.seed, i)
        M = self._length(rng)
        d = sample_model(M, rng)
        d.update(name=b"pfam%05d" % i, M=M, index=i,
                 evparam=self.evparams[M].copy())
        return d

    def match_emissions(self, i: int) -> np.ndarray:
        """``mat`` [M+1, K] of model ``i`` alone (drawn first from its
        stream, so equal to :meth:`model`'s)."""
        rng = stream(self.seed, i)
        M = self._length(rng)
        mat = np.zeros((M + 1, K), np.float32)
        mat[1:] = rng.dirichlet(np.ones(K), size=M).astype(np.float32)
        return mat


def plant(mat: np.ndarray, rng, consensus: float, skip: int = 0
          ) -> np.ndarray:
    """Residue codes of a domain through the match states of a model
    with match emissions ``mat``: the consensus residue with probability
    ``consensus``, else a draw from the emissions; with ``skip`` > 0
    every ``skip``-th match state is deleted."""
    M = mat.shape[0] - 1
    states = np.arange(1, M + 1)
    if skip:
        states = states[states % skip != 0]
    n = len(states)
    m = np.asarray(mat[states], np.float64)
    m = m / m.sum(axis=1, keepdims=True)
    cons = m.argmax(axis=1)
    u = rng.random(n)
    cdf = np.cumsum(m, axis=1)
    drawn = (rng.random(n)[:, None] > cdf).sum(axis=1)
    drawn = np.minimum(drawn, m.shape[1] - 1)
    return np.where(u < consensus, cons, drawn).astype(np.uint8)


class Proteome:
    """Proteome ``p``: ``sequences`` (uint8 codes), ``names`` and
    ``planted`` ({model index: {protein index}})."""

    def __init__(self, cfg: dict, db: Database, seed: int, p: int,
                 planted_models: Sequence[int]):
        pc = cfg["proteome"]
        n = int(cfg["proteins"])
        rng = stream(seed, p, 1)
        lens = np.clip(np.rint(rng.lognormal(np.log(pc["median"]),
                                             pc["sigma"], n)),
                       pc["min"], pc["max"]).astype(np.int64)
        f = AMINO_FREQUENCIES / AMINO_FREQUENCIES.sum()
        flat = rng.choice(K, size=int(lens.sum()), p=f).astype(np.uint8)
        seqs = np.split(flat, np.cumsum(lens)[:-1])
        kinds = [tuple(k) for k in cfg["plants"]["kinds"]]
        n_pl = min(n, int(round(cfg["plants"]["per_model"]
                                * len(planted_models))))
        hosts = rng.permutation(n)[:n_pl]
        self.planted: Dict[int, set] = {}
        for j, tgt in enumerate(hosts):
            mi = int(planted_models[(j * len(planted_models)) // n_pl])
            mat = db.match_emissions(mi)
            consensus, skip, min_len = kinds[j % len(kinds)]
            reps = max(1, -(-int(min_len) // (mat.shape[0] - 1)))
            dom = np.concatenate([plant(mat, rng, consensus, int(skip))
                                  for _ in range(reps)])
            s = seqs[tgt]
            if len(s) < len(dom) + 40:
                s = np.concatenate([s, rng.choice(
                    K, size=len(dom) + 40 - len(s), p=f).astype(np.uint8)])
            else:
                s = s.copy()
            at = int(rng.integers(0, len(s) - len(dom) + 1))
            s[at: at + len(dom)] = dom
            seqs[tgt] = s
            self.planted.setdefault(mi, set()).add(int(tgt))
        self.sequences: List[np.ndarray] = [np.ascontiguousarray(s)
                                            for s in seqs]
        self.names = [b"prot%d_%05d" % (p, i) for i in range(n)]


def pick(rng, pool: Sequence, k: int) -> List:
    """``k`` distinct items of ``pool`` (all of it when shorter), in the
    pool's order."""
    if len(pool) <= k:
        return list(pool)
    idx = np.sort(rng.choice(len(pool), size=k, replace=False))
    return [pool[int(i)] for i in idx]


def dealt_slices(lengths: Sequence[int], k: int) -> List[List[int]]:
    """``len(lengths) // k`` slices of ``k`` model indices each, alike in
    their mix of lengths: with the models sorted by length, slice ``c``
    takes the sorted positions ``c, c + S, c + 2S, ...`` (``S`` slices),
    stretched evenly over all of them, so every slice holds about the
    same number of models of each length and the models left over are
    spread over the lengths too."""
    n = len(lengths)
    S = n // k
    order = sorted(range(n), key=lambda i: (lengths[i], i))
    return [sorted(order[(c + S * j) * n // (S * k)] for j in range(k))
            for c in range(S)]
