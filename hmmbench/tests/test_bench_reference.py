"""The plain reference: its batched MSV against the per-pair recurrence,
its search against the program's own sequential NumPy oracle, and its
bfloat16 control."""

import json

import numpy as np
import pytest

from hmmbench import data
from hmmbench.reference import dp, search
from hmmbench.reference.msv import msv_scores
from hmmbench.reference.profile import Profile
from hmmbench.tests.helpers import ROOT

CFG = dict(json.loads((ROOT / "hmmbench/configs/pfam-hmmsearch.json")
                      .read_text()), models=24, proteins=90)
CFG["plants"] = dict(CFG["plants"], per_model=1.0)


@pytest.fixture(scope="module")
def workload():
    db = data.Database(CFG)
    pr = data.Proteome(CFG, db, 21, 0, range(24))
    return db, pr


def test_batched_msv_equals_the_per_pair_recurrence(workload):
    db, pr = workload
    models = [db.model(i) for i in range(6)]
    profs = [Profile(m, multihit=True) for m in models]
    seqs = pr.sequences[:40]
    # a model's consensus overflows the uint8 recurrence
    cons = np.asarray(models[0]["mat"][1:].argmax(axis=1), np.uint8)
    seqs = seqs + [np.concatenate([cons] * 6)]
    got = msv_scores(profs, seqs, "cpu", cells=6 * 16 * 901)
    for p, prof in enumerate(profs):
        for b, s in enumerate(seqs):
            prof.reconfig_length(len(s))
            want = dp.msv_score_quantized(prof, s)
            assert got[p, b] == want, (p, b)
    assert np.isinf(got[0, -1])


def test_search_equals_the_programs_numpy_oracle(workload, monkeypatch):
    """The frozen copy gives the program's sequential oracle's hits (its
    NumPy path), score for score, on a few models with planted hits."""
    from pyhmmer_tpu_torch.easel.alphabet import Alphabet
    from pyhmmer_tpu_torch.easel.sequence import (DigitalSequence,
                                                  DigitalSequenceBlock)
    from pyhmmer_tpu_torch.ops import native
    from pyhmmer_tpu_torch.plan7.hmm import HMM
    from pyhmmer_tpu_torch.plan7.pipeline import Pipeline
    monkeypatch.setattr(native, "available", lambda: False)
    db, pr = workload
    aa = Alphabet.amino()
    block = DigitalSequenceBlock(aa, [
        DigitalSequence(aa, name=n, sequence=s)
        for n, s in zip(pr.names, pr.sequences)])
    idx = sorted(pr.planted)[:8]
    models = [db.model(i) for i in idx]
    ref = search.search(models, pr.sequences, pr.names, "cpu")
    nhits = 0
    for m, r in zip(models, ref):
        h = HMM(aa, m["M"], name=m["name"])
        h.t[...], h.mat[...], h.ins[...] = m["t"], m["mat"], m["ins"]
        h.evparam[:] = m["evparam"]
        th = Pipeline(aa).search_hmm(h, block)
        prog = {x.name: x for x in th.hits}
        assert sorted(prog) == sorted(r)
        for name, x in prog.items():
            nhits += 1
            assert x.score == pytest.approx(r[name]["score"], abs=1e-9)
            assert x.pre_score == pytest.approx(r[name]["pre_score"],
                                                abs=1e-9)
            assert [(d.env_from, d.env_to) for d in x.domains] \
                == r[name]["envelopes"]
            assert x.nclustered == r[name]["nclustered"]
            assert x.reported == r[name]["reported"]
    assert nhits >= 4


def test_scan_is_the_transposed_search(workload):
    db, pr = workload
    models = [db.model(i) for i in sorted(pr.planted)[:5]]
    seqs = pr.sequences[:30]
    names = pr.names[:30]
    by_model = search.search(models, seqs, names, "cpu")
    by_seq = search.scan(models, seqs, "cpu")
    for b, name in enumerate(names):
        for m, hits in zip(models, by_model):
            if name in hits:
                got = by_seq[b][m["name"]]
                assert got["score"] == hits[name]["score"]
                assert got["lnE"] == pytest.approx(
                    hits[name]["lnP"] + np.log(len(models)))
            else:
                assert m["name"] not in by_seq[b]


def test_bfloat16_precision_moves_the_scores(workload):
    db, pr = workload
    m = db.model(sorted(pr.planted)[0])
    prof = Profile(m, multihit=True)
    s = pr.sequences[0]
    prof.reconfig_length(len(s))
    f64 = dp.forward(prof, s).score
    try:
        dp.set_precision("bfloat16")
        b16 = dp.forward(prof, s).score
        assert dp.rnd(1.0 + 2 ** -12) == 1.0
    finally:
        dp.set_precision("float64")
    assert dp.forward(prof, s).score == f64
    assert abs(b16 - f64) > 1e-3
    with pytest.raises(ValueError):
        dp.set_precision("float16")


@pytest.mark.parametrize("precision", ["float64", "bfloat16"])
def test_batched_filters_equal_the_per_pair_recurrences(workload,
                                                        precision):
    from hmmbench.reference import batched
    from hmmbench.reference.define import Query
    db, pr = workload
    qs = [Query(db.model(i)) for i in range(12)]      # of mixed lengths
    assert len({q.prof.M for q in qs}) > 4
    seqs = pr.sequences[:20]
    pidx = [n % len(qs) for n in range(len(seqs))]
    profs = [q.prof for q in qs]
    try:
        dp.set_precision(precision)
        got_b = batched.bias_scores([qs[p].bg.filter_odds_table()
                                     for p in pidx], seqs, "cpu")
        got_v = batched.viterbi_scores(profs, pidx, seqs, "cpu")
        got_f = batched.forward_scores(profs, pidx, seqs, "cpu")
        for n, (p, s) in enumerate(zip(pidx, seqs)):
            prof = profs[p]
            prof.reconfig_length(len(s))
            tol = 1e-9 if precision == "float64" else 0.05 * len(s)
            assert got_b[n] == pytest.approx(qs[p].bg.filter_score(s),
                                             abs=tol)
            assert got_v[n] == pytest.approx(dp.viterbi_score(prof, s),
                                             abs=tol)
            assert got_f[n] == pytest.approx(dp.forward(prof, s).score,
                                             abs=tol)
    finally:
        dp.set_precision("float64")


def test_domains_defined_in_workers_equal_in_process(workload):
    from hmmbench.reference import define
    db, pr = workload
    m = db.model(sorted(pr.planted)[0])
    q = define.Query(m)
    seqs = pr.sequences[:6]
    jobs = [(q, s) for s in seqs]
    here = [define.define(q, s) for s in seqs]
    assert define.define_all(jobs, per_job=2) == here
