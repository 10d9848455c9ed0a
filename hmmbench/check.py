"""The comparison that decides ``correct``.

Answers are ``{key: {hit name: hit}}``: for each checked query (a model
in hmmsearch, a sequence in hmmscan) every hit its search kept, that is
every comparison that passed the filters and had a domain defined, with
the numbers below.  The program's answers are read from its
``TopHits``; the reference's come from ``hmmbench/reference``.

The numbers compared, each against a limit of the cell's own
(``hmmbench/limits/<cell>.json``):

* ``hit_diff``: hits on one side only, plus hits on both whose reported
  or included flag differs (counted only where neither side resolved a
  region by stochastic clustering, whose draws follow each side's own
  random stream and its own rounding);
* ``env_diff``: hits on both sides, unclustered on both, whose domain
  envelopes differ;
* ``score_gap_bits``: the widest gap of a sequence score (bits) between
  the sides, over the hits on both sides that neither side clustered;
* ``evalue_gap_log10``: the widest gap of log10 E-value, over the same,
  and of the E-value's database size (log10 Z) over the clustered hits;
* ``fwd_gap_bits``: the widest gap of the Forward pre-score (bits), over
  every hit on both sides whose score neither side took from the domain
  sum (clustered hits included: the full-sequence Forward does not draw).

Beside them, how many hits on both sides each comparison covered
(:data:`COUNTS`): ``unclustered_compared`` (score, envelope, flags and
E-value), ``clustered_compared`` (the E-value's database size alone)
and ``fwd_compared`` (the Forward pre-score).  A check has to cover at
least ``min_unclustered`` unclustered hits (the cell's limits): the
sample grows by :func:`grow` until it does, and a run whose sample
never does is not correct.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

NUMBERS = ("hit_diff", "env_diff", "score_gap_bits", "evalue_gap_log10",
           "fwd_gap_bits")
COUNTS = ("unclustered_compared", "clustered_compared", "fwd_compared")


def hit_summary(h, Z: float) -> dict:
    """The numbers of one of the program's ``Hit`` objects."""
    return {"score": float(h.score), "pre_score": float(h.pre_score),
            "lnP": float(h.lnP), "lnE": float(h.lnP) + math.log(Z),
            "nclustered": int(h.nclustered),
            "sum_path": bool(h.score == h.sum_score),
            "reported": bool(h.reported), "included": bool(h.included),
            "envelopes": [(int(d.env_from), int(d.env_to))
                          for d in h.domains]}


def tophits_summary(th) -> Dict[bytes, dict]:
    return {bytes(h.name): hit_summary(h, float(th.Z)) for h in th.hits}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of :data:`NUMBERS` and :data:`COUNTS` over the keys
    of ``ref``."""
    out = dict.fromkeys(NUMBERS + COUNTS, 0.0)
    for key, rh in ref.items():
        ph = prog.get(key, {})
        out["hit_diff"] += len(set(ph) ^ set(rh))
        for name in set(ph) & set(rh):
            p, r = ph[name], rh[name]
            if not (p["sum_path"] or r["sum_path"]):
                out["fwd_compared"] += 1
                out["fwd_gap_bits"] = max(out["fwd_gap_bits"],
                                          abs(p["pre_score"]
                                              - r["pre_score"]))
            if p["nclustered"] or r["nclustered"]:
                out["clustered_compared"] += 1
                out["evalue_gap_log10"] = max(
                    out["evalue_gap_log10"],
                    abs((p["lnE"] - p["lnP"]) - (r["lnE"] - r["lnP"]))
                    / math.log(10.0))
                continue
            out["unclustered_compared"] += 1
            if (p["reported"], p["included"]) != (r["reported"],
                                                  r["included"]):
                out["hit_diff"] += 1
            if p["envelopes"] != r["envelopes"]:
                out["env_diff"] += 1
            out["score_gap_bits"] = max(out["score_gap_bits"],
                                        abs(p["score"] - r["score"]))
            out["evalue_gap_log10"] = max(
                out["evalue_gap_log10"],
                abs(p["lnE"] - r["lnE"]) / math.log(10.0))
    return {k: float(v) for k, v in out.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is at or under its limit."""
    missing = set(NUMBERS + ("min_unclustered",)) - set(limits)
    if missing:
        raise ValueError(f"no limit for {sorted(missing)}")
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def enough(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when the check covered its least number of unclustered
    hits."""
    return numbers["unclustered_compared"] >= limits["min_unclustered"]


def grow(order: Sequence, first: int, step: int, limits: Dict,
         answer: Callable[[List], Tuple[Dict, Dict]]
         ) -> Tuple[List, Dict, Dict, Dict[str, float]]:
    """Check the first ``first`` keys of ``order``, then ``step`` more at
    a time while the numbers pass but cover fewer unclustered hits than
    ``min_unclustered``, up to ``max_checked`` keys.  ``answer(keys)``
    gives the program's and the reference's answers for ``keys``.
    Returns the keys checked, both sides' answers and the numbers."""
    keys = list(order[:first])
    prog, ref = answer(keys)
    numbers = compare(prog, ref)
    cap = min(len(order), int(limits["max_checked"]))
    while (judge(numbers, limits) and not enough(numbers, limits)
           and len(keys) < cap):
        more = list(order[len(keys): min(cap, len(keys) + step)])
        p, r = answer(more)
        prog.update(p)
        ref.update(r)
        keys += more
        numbers = compare(prog, ref)
    return keys, prog, ref, numbers


def report(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> List[dict]:
    """Each number beside its limit, in :data:`NUMBERS`' order, and last
    the unclustered hits covered beside the least allowed."""
    out = [{"name": k, "value": numbers[k], "limit": limits[k]}
           for k in NUMBERS]
    out.append({"name": "unclustered_compared",
                "value": numbers["unclustered_compared"],
                "limit": limits["min_unclustered"], "at_least": True})
    return out
