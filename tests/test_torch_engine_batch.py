"""Batched postprocessing on the CPU: ``engine.finish_pairs`` (one
``native.domaindef_batch`` call for many survivor pairs, the hits built
from its outputs) against the per-pair path it replaces, the native
``viterbi_score`` and ``domaindef`` and ``Pipeline._build_hit``, field
for field; and the engine, whose hits stay those of the per-pair path
while its pairs go to the native library many to a call."""

import math

import numpy as np
import pytest
import torch

from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch import engine as engine_mod
from pyhmmer_tpu_torch.engine import SearchEngine, finish_pairs
from pyhmmer_tpu_torch.ops import native
from pyhmmer_tpu_torch.plan7 import Background, Pipeline, Profile
from pyhmmer_tpu_torch.plan7.results import TopHits

torch.set_num_threads(1)

ALIGNMENT = ("hmm_name", "hmm_accession", "hmm_from", "hmm_to",
             "hmm_sequence", "hmm_length", "target_name", "target_from",
             "target_to", "target_sequence", "target_length",
             "identity_sequence", "posterior_probabilities")
DOMAIN = ("env_from", "env_to", "ali_from", "ali_to", "score", "bias",
          "correction", "envelope_score", "oasc", "lnP", "flags")
HIT = ("name", "accession", "description", "length", "score", "pre_score",
       "sum_score", "lnP", "nexpected", "nregions", "nclustered",
       "noverlaps", "nenvelopes", "best_domain_idx", "flags")


def fields(hit):
    """Every field of a hit, its domains' and their alignments', with
    the type of each number (a float that came out as an int, or the
    reverse, differs)."""
    if hit is None:
        return None

    def val(v):
        return (type(v).__name__, v) if isinstance(v, (int, float)) else v
    return ([val(getattr(hit, f)) for f in HIT],
            [([val(getattr(d, f)) for f in DOMAIN],
              [val(getattr(d.alignment, f)) for f in ALIGNMENT])
             for d in hit.domains])


def outcome(out):
    if out is None or out[0] != "hit":
        return out
    return ("hit", fields(out[1]))


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native.available(), "the native library did not build"


def setup(models, null2=True, mode="search"):
    """Per model: its pipeline, as the engine configures one, and its
    multihit profile."""
    bg = Background(models[0].alphabet)
    out = []
    for hmm in models:
        pli = Pipeline(hmm.alphabet, bg.copy(), null2=null2)
        pli._mode = mode
        prof = Profile(hmm.M, hmm.alphabet).configure(hmm, bg, 400,
                                                      multihit=True)
        pli.background.set_filter(hmm.M, prof.compo)
        out.append((pli, prof))
    return out


def per_pair(pli, prof, sq, seed, fwd_min, nullsc, vit_min, hits):
    """The engine's per-pair path (``run_domaindef``)."""
    if vit_min is not None and np.isfinite(vit_min):
        if native.viterbi_score(prof, sq.sequence) < vit_min:
            return ("gated_vit",)
    out = native.domaindef(prof, sq.sequence, pli.null2, seed,
                           fwd_min=fwd_min)
    if out is None:
        return None
    fwdsc, res = out
    if fwdsc < fwd_min:
        return ("gated", fwdsc)
    return ("hit", pli._build_hit(prof, sq, hits, fwdsc, nullsc, res))


def pairs_of(configs, targets, gates):
    """One pair per (model, target) and its Forward and Viterbi floors
    from ``gates(k)``: ``(fwd_min, vit_min)``."""
    pairs = []
    for mi, (pli, prof) in enumerate(configs):
        hits = TopHits()
        for sq in targets:
            k = len(pairs)
            fwd_min, vit_min = gates(k)
            L = len(sq)
            nullsc = L * math.log(L / (L + 1.0)) + math.log(1.0 / (L + 1.0))
            pairs.append((pli, prof, mi, sq, sq.sequence.ctypes.data,
                          int(np.random.default_rng(k).integers(0, 2**62)),
                          fwd_min, nullsc, vit_min, hits))
    return pairs


def check(configs, pairs, rerun=None):
    """The batch against the per-pair path, pair by pair; returns the
    batch's outcomes and counts."""
    tables = native.BatchTables([p for _, p in configs],
                                [pli.null2 for pli, _ in configs])
    want = [per_pair(p[0], p[1], p[3], p[5], p[6], p[7], p[8], p[9])
            for p in pairs]
    reruns = []

    def again(k):
        reruns.append(k)
        p = pairs[k]
        return per_pair(p[0], p[1], p[3], p[5], p[6], p[7], p[8], p[9])
    outs, ndd, calls = finish_pairs(tables, pairs, rerun or again)
    assert [outcome(o) for o in outs] == [outcome(o) for o in want]
    assert ndd == sum(o is None or o[0] != "gated_vit" for o in want)
    assert calls == (ndd > 0) + len(reruns)
    return outs, reruns


def open_gates(k):
    return -np.inf, None


@pytest.mark.parametrize("null2", [True, False], ids=["null2", "nonull2"])
def test_hmmsearch_shape(null2):
    """One profile against 40 targets, four of them planted."""
    models = syn.smoke_models()[5:6]
    targets, _ = syn.make_targets(models, 40, seed=31)
    configs = setup(models, null2=null2)
    outs, _ = check(configs, pairs_of(configs, targets, open_gates))
    hits = [o[1] for o in outs if o[0] == "hit" and o[1] is not None]
    assert len(hits) >= 3


def test_hmmscan_shape():
    """24 profiles of one batch against 3 targets, three of them
    planted, in scan mode (the hit named after the model)."""
    models = syn.sample_models([60 + 15 * i for i in range(24)], seed=5)
    targets, _ = syn.make_targets(models, 3, seed=32,
                                  plants=((1.0, 0, 0),))
    configs = setup(models, mode="scan")
    outs, _ = check(configs, pairs_of(configs, targets, open_gates))
    assert sum(o[0] == "hit" and o[1] is not None for o in outs) >= 3


def test_gated_pairs():
    """Pairs dropped by the Viterbi gate and by the F3 gate, beside pairs
    that pass a finite Viterbi floor, take no floor or skip Viterbi."""
    models = syn.smoke_models()[3:5]
    targets, _ = syn.make_targets(models, 12, seed=33)
    configs = setup(models)

    def gates(k):
        return [(-np.inf, 1e6), (1e6, None), (-np.inf, -1e6),
                (-np.inf, -np.inf), (-np.inf, None)][k % 5]
    outs, _ = check(configs, pairs_of(configs, targets, gates))
    kinds = [o[0] for o in outs]
    assert kinds.count("gated_vit") == sum(k % 5 == 0 for k in
                                           range(len(outs)))
    assert kinds.count("gated") == sum(k % 5 == 1 for k in range(len(outs)))
    assert "hit" in kinds


def test_overflow_takes_the_per_pair_path(monkeypatch):
    """A pair whose trace buffer overflows in the batch is run again by
    the per-pair path, and its outcome is that path's; the other pairs
    of the batch are unaffected."""
    models = syn.smoke_models()[6:7]
    targets, planted = syn.make_targets(models, 10, seed=34)
    configs = setup(models)
    pairs = pairs_of(configs, targets, open_gates)
    host = next(k for k, p in enumerate(pairs)
                if p[3].name in planted[models[0].name])
    caps = native._batch_caps

    def small(lens, Ms):
        out = caps(lens, Ms)
        out[host] = (out[host][0], 8)    # room for 8 trace steps
        return out
    monkeypatch.setattr(native, "_batch_caps", small)
    outs, reruns = check(configs, pairs)
    assert reruns == [host]
    assert outs[host][0] == "hit" and outs[host][1] is not None


def overflow_all(monkeypatch):
    """Every pair that reaches the batch's domaindef reported as
    overflowed: the engine then takes its per-pair path for each."""
    batch = native.domaindef_batch

    def all_overflow(*args, **kw):
        ndd, out = batch(*args, **kw)
        st = out["status"]
        st[st != native.DD_GATED_VIT] = native.DD_OVERFLOW
        return ndd, out
    monkeypatch.setattr(native, "domaindef_batch", all_overflow)


def search(models, targets):
    eng = SearchEngine(models[0].alphabet, device="cpu")
    return eng.search(models, targets), eng.last_timing


@pytest.fixture(scope="module")
def workload():
    models = syn.smoke_models()[:6]
    targets, _ = syn.make_targets(models, 200, seed=35)
    return models, targets


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
def test_engine_batches_and_keeps_its_hits(workload, monkeypatch, forced):
    """A smoke search: its pairs reach the native library several to a
    call, and its hits, every field of them in their order, are those of
    the per-pair path; with the device cascade forced too, so that the
    Forward and Viterbi stages' waves hand the pool its pairs."""
    models, targets = workload
    monkeypatch.setenv("PYHMMER_TPU_THREADS", "2")
    if forced:
        for name, value in (("SPECULATE_P1B", -1.0), ("HOST_MIN_PAIRS", 0),
                            ("HOST_PAIRS_PER_ROW", 0.0)):
            monkeypatch.setattr(engine_mod, name, value)
    got, t = search(models, targets)
    assert t["dd_pairs"] > 0
    assert t["dd_pairs"] / t["dd_native_calls"] > 1
    overflow_all(monkeypatch)
    want, tw = search(models, targets)
    assert tw["dd_pairs"] == t["dd_pairs"]
    assert tw["dd_native_calls"] > tw["dd_pairs"]
    assert [[fields(h) for h in th.hits] for th in got] == \
        [[fields(h) for h in th.hits] for th in want]
    assert sum(len(th.reported) for th in got) > 0


def test_batcher_cuts_waves():
    """A streamed wave goes out as its batches fill, at most
    ``BATCH_CELLS`` or its bound over the workers' batches; a held wave
    is cut at its own cells over them; both in job order."""
    sent = []
    b = engine_mod._Batcher(sent.append, workers=2)
    cap = engine_mod.BATCH_CELLS
    b.open(100 * cap)
    for j in range(5):
        b.add(j, cap // 2)
    assert sent == [[0, 1], [2, 3]]
    b.close()
    assert sent == [[0, 1], [2, 3], [4]]
    sent.clear()
    b.open(800)                              # cap 800 / (4 x 2) = 100
    for j in range(5):
        b.add(j, 60)
    assert sent == [[0, 1], [2, 3]]
    b.close()
    assert sent == [[0, 1], [2, 3], [4]]
    sent.clear()
    for j in range(16):                      # held: 16 x 10 / 8 = 20
        b.add(j, 10)
    assert sent == []
    b.close()
    assert sent == [[2 * i, 2 * i + 1] for i in range(8)]
