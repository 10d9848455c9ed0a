"""hmmsearch and hmmscan by the plain reference: the benchmark's yardstick.

The filter cascade and score assembly of the program's sequential
oracle (a frozen copy of ``pyhmmer_tpu_torch/plan7/pipeline.py``:
``Pipeline._process_target`` and ``_build_hit``, HMMER's
``p7_Pipeline``): MSV (uint8), the composition-bias filter, Viterbi,
Forward, each gated by its P-value, then domain definition, null2 and
the E-values, with HMMER's default options.  The filters run over all
pairs of a stage at once (:mod:`.msv`, :mod:`.batched`); each pair
that passes them is defined domain by domain in NumPy (:mod:`.define`,
over the host's cores).  Every array comes from the model and sequence arrays
the benchmark made; nothing of the program is imported.  A hit is a dict
of the numbers the benchmark compares.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from . import batched
from .define import LOG2, Query, define_all
from .msv import msv_scores
from .profile import exp_surv, gumbel_surv

F1, F2, F3 = 0.02, 1e-3, 1e-5
F2_SLACK, F3_SLACK, F2_SKIP_SLACK = 1.0, 3.2, 4.0
E_REPORT, E_INCLUDE = 10.0, 0.01


def cascade(queries: List[Query], pairs: List[tuple], seqs, device
            ) -> List:
    """The hits of ``pairs`` ((query index, sequence index, MSV score))
    that pass the MSV gate against the null model: each a hit's numbers,
    or None where a later gate drops it or no domain is defined."""
    out: List = [None] * len(pairs)
    if not pairs:
        return out
    q = [queries[a].prof for a, _, _ in pairs]
    L = np.array([len(seqs[b]) for _, b, _ in pairs], np.float64)
    usc = np.array([u for _, _, u in pairs])
    ev = np.stack([p.evparam for p in q])
    Ms = [p.M for p in q]
    filtersc = np.empty(len(pairs))
    for idx in batched.batches([1] * len(pairs), L, 1 << 16):
        filtersc[idx] = batched.bias_scores(
            [queries[pairs[n][0]].bg.filter_odds_table() for n in idx],
            [seqs[pairs[n][1]] for n in idx], device)
    P = gumbel_surv((usc - filtersc) / LOG2, ev[:, 0], ev[:, 1])
    alive = P <= F1
    vit = np.where(alive & (P > F2 * F2_SKIP_SLACK))[0]
    score = np.zeros(len(pairs))
    for idx in batched.batches([Ms[n] for n in vit], [L[n] for n in vit]):
        sel = vit[idx]
        score[sel] = _filter(batched.viterbi_scores, queries, pairs, sel,
                             seqs, device)
    Pv = gumbel_surv((score - filtersc) / LOG2, ev[:, 2], ev[:, 3])
    alive[vit] &= Pv[vit] <= F2 * F2_SLACK
    fwd = np.where(alive)[0]
    for idx in batched.batches([Ms[n] for n in fwd], [L[n] for n in fwd]):
        sel = fwd[idx]
        score[sel] = _filter(batched.forward_scores, queries, pairs, sel,
                             seqs, device)
    Pf = exp_surv((score - filtersc) / LOG2, ev[:, 4], ev[:, 5])
    past = np.where(alive & (Pf <= F3 * F3_SLACK))[0]
    hits = define_all([(queries[pairs[n][0]], seqs[pairs[n][1]])
                       for n in past])
    for n, h in zip(past, hits):
        out[n] = h
    return out


def _filter(fn, queries, pairs, sel, seqs, device) -> np.ndarray:
    own = sorted({pairs[n][0] for n in sel})
    slot = {a: k for k, a in enumerate(own)}
    return fn([queries[a].prof for a in own],
              [slot[pairs[n][0]] for n in sel],
              [seqs[pairs[n][1]] for n in sel], device)


def _finish(hits: Dict[bytes, dict], Z: float) -> Dict[bytes, dict]:
    for h in hits.values():
        evalue = math.exp(h["lnP"]) * Z
        h["lnE"] = h["lnP"] + math.log(Z)
        h["reported"] = evalue <= E_REPORT
        h["included"] = evalue <= E_INCLUDE
    return hits


def _msv_pairs(queries, seqs, device) -> List[tuple]:
    """(query, sequence, MSV score) of every pair past the MSV gate
    against the null model."""
    usc = msv_scores([q.prof for q in queries], seqs, device)
    L = np.array([len(s) for s in seqs], np.float64)
    p1 = L / (L + 1.0)
    nullsc = L * np.log(p1) + np.log(1.0 - p1)
    pairs = []
    for a, q in enumerate(queries):
        ev = q.prof.evparam
        P = gumbel_surv((usc[a] - nullsc) / LOG2, ev[0], ev[1])
        pairs += [(a, int(b), float(usc[a, b]))
                  for b in np.where((P <= F1) & (L > 0))[0]]
    return pairs


def search(models: Sequence[dict], seqs: Sequence[np.ndarray],
           names: Sequence[bytes], device) -> List[Dict[bytes, dict]]:
    """hmmsearch: for each model, its hits keyed by target name, with
    Z the number of targets."""
    queries = [Query(m) for m in models]
    pairs = _msv_pairs(queries, seqs, device)
    out: List[Dict[bytes, dict]] = [{} for _ in queries]
    for (a, b, _), h in zip(pairs, cascade(queries, pairs, seqs, device)):
        if h is not None:
            out[a][names[b]] = h
    return [_finish(h, float(len(seqs))) for h in out]


def scan(models: Sequence[dict], seqs: Sequence[np.ndarray], device
         ) -> List[Dict[bytes, dict]]:
    """hmmscan: for each sequence, its hits keyed by model name, with Z
    the number of models."""
    queries = [Query(m) for m in models]
    pairs = _msv_pairs(queries, seqs, device)
    out: List[Dict[bytes, dict]] = [{} for _ in seqs]
    for (a, b, _), h in zip(pairs, cascade(queries, pairs, seqs, device)):
        if h is not None:
            out[b][queries[a].prof.name] = h
    return [_finish(h, float(len(models))) for h in out]
