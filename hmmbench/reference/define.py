"""Domain definition of the pairs past every filter, in worker processes.

The reference's heaviest part is NumPy's domain definition of each hit
(full Forward and Backward, the regions' rescoring and clustering).
Once the measured window has closed and the program is freed, the
reference spreads it over the host's cores: one job a query and a
handful of its sequences, each worker a fresh interpreter (``spawn``)
that imports NumPy and this package alone.
"""

from __future__ import annotations

import math
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from . import domains as dd
from . import dp
from .profile import Background, Profile

LOG2 = math.log(2.0)
SEED = 42
#: the thread counts of the numerical libraries a worker loads
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class Query:
    """A model configured for the cascade: multihit and unihit profiles
    and the bias filter of its composition."""

    def __init__(self, model: dict):
        self.model = model
        self.prof = Profile(model, multihit=True)
        self.uni = Profile(model, multihit=False)
        self.bg = Background()
        self.bg.set_filter(self.prof.compo)


def _lse0(a: float) -> float:
    return math.log1p(math.exp(a)) if a < 30.0 else a


def _elogsurv(x: float, tau: float, lam: float) -> float:
    return 0.0 if x < tau else -lam * (x - tau)


def define(q: Query, dsq: np.ndarray):
    """Domain definition and the scores of a pair past every filter."""
    L = len(dsq)
    prof, uni, bg = q.prof, q.uni, q.bg
    prof.reconfig_length(L)
    uni.reconfig_length(L)
    fwd = dp.forward(prof, dsq)
    bck = dp.backward(prof, dsq)
    res = dd.define_domains(prof, uni, dsq, fwd, bck, do_null2=True,
                            rng=np.random.default_rng(SEED))
    return build_hit(prof, bg, L, fwd.score, bg.null_one(L), res)


def build_hit(prof, bg, L: int, fwdsc: float, nullsc: float, res):
    """The per-sequence scores of a domain definition (``_build_hit``'s
    arithmetic)."""
    if res.nregions == 0 or len(res.domains) == 0:
        return None
    ev = prof.evparam
    log_omega = math.log(bg.omega)
    seqbias = _lse0(log_omega + float(res.n2sc[1:].sum()))
    pre_score = (fwdsc - nullsc) / LOG2
    seq_score = (fwdsc - (nullsc + seqbias)) / LOG2
    sum_score = sum_bias = 0.0
    Ld_total = 0
    for d in res.domains:
        if d.envsc - d.domcorrection > 0.0:
            sum_score += d.envsc
            Ld_total += d.jenv - d.ienv + 1
            sum_bias += d.domcorrection
    sum_score += (L - Ld_total) * math.log(L / (L + 3.0))
    sum_bias = _lse0(log_omega + sum_bias)
    pre2_score = (sum_score - nullsc) / LOG2
    sum_score = (sum_score - (nullsc + sum_bias)) / LOG2
    sum_path = Ld_total > 0 and sum_score > seq_score
    if sum_path:
        seq_score = sum_score
        pre_score = pre2_score
    return {"score": float(seq_score), "pre_score": float(pre_score),
            "lnP": _elogsurv(seq_score, ev[4], ev[5]),
            "nclustered": int(res.nclustered), "sum_path": bool(sum_path),
            "envelopes": [(int(d.ienv), int(d.jenv)) for d in res.domains]}


def _job(args) -> List:
    model, seqs, precision = args
    dp.set_precision(precision)
    q = Query(model)
    return [define(q, s) for s in seqs]


def define_all(jobs: Sequence[Tuple[Query, np.ndarray]], per_job: int = 4
               ) -> List:
    """:func:`define` of every (query, sequence), over the host's cores
    (in this process where there are only a few)."""
    if len(jobs) <= per_job:
        return [define(q, s) for q, s in jobs]
    precision = "bfloat16" if dp._ROUND is not None else "float64"
    work, spans = [], []
    by_query: dict = {}
    for n, (q, s) in enumerate(jobs):
        by_query.setdefault(id(q), (q, []))[1].append((n, s))
    for q, items in by_query.values():
        for a in range(0, len(items), per_job):
            part = items[a: a + per_job]
            work.append((q.model, [s for _, s in part], precision))
            spans.append([n for n, _ in part])
    out: List = [None] * len(jobs)
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(os.cpu_count() or 1, len(work)))
    # one thread a worker: the workers fill the cores themselves
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update(dict.fromkeys(THREAD_VARS, "1"))
    try:
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            for idx, hits in zip(spans, ex.map(_job, work)):
                for n, h in zip(idx, hits):
                    out[n] = h
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out
