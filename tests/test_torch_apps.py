"""The port's ``phmmer`` and ``jackhmmer`` (``pyhmmer_tpu_torch/hmmer``)
against the JAX package's, on the CPU, on a seeded target block with
planted domains; the query is a planted target.  With 200 targets both
packages search through their engines (phmmer always; jackhmmer from 64
targets up), with 40 jackhmmer takes the sequential pipeline.  The
reported rows (``PERF.md`` section 2), each iteration's MSA size and
convergence must be identical."""

import numpy as np
import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.hmmer import JACKHMMER_ENGINE_MIN_TARGETS
from test_torch_host import jax_block, jax_hmm, rows

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[200, 40],
                ids=["engine", "sequential"])
def case(request):
    """(targets, the JAX package's copy, query name) of one block."""
    n = request.param
    models = syn.sample_models((60, 110), seed=21)
    block, planted = syn.make_targets(models, n, seed=22, median=160.0,
                                      sigma=0.4)
    name = sorted(planted[models[0].name])[0]
    assert (len(block) >= JACKHMMER_ENGINE_MIN_TARGETS) == (n == 200)
    return block, jax_block(block), name


def query(block, name):
    return next(s for s in block if s.name == name)


def test_phmmer_matches_jax(case):
    block, jblock, name = case
    got = list(pyhmmer_tpu_torch.phmmer(query(block, name), block,
                                        device="cpu"))
    want = list(jax_hmmer.phmmer(query(jblock, name), jblock))
    assert [rows(th) for th in got] == [rows(th) for th in want]
    assert got[0].reported[0].name == name     # the query finds itself
    assert got[0].Z == want[0].Z == len(block)


def test_jackhmmer_matches_jax(case):
    block, jblock, name = case
    got = next(pyhmmer_tpu_torch.jackhmmer(
        query(block, name), block, device="cpu", max_iterations=2,
        checkpoints=True))
    want = next(jax_hmmer.jackhmmer(query(jblock, name), jblock,
                                    max_iterations=2, checkpoints=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert rows(g.hits) == rows(w.hits)
        assert (len(g.msa), g.converged, g.iteration) == \
            (len(w.msa), w.converged, w.iteration)
        np.testing.assert_array_equal(g.msa.codes, w.msa.codes)
        np.testing.assert_array_equal(g.hmm.mat, w.hmm.mat)
    assert len(got[0].msa) > 1


@pytest.fixture(scope="module")
def scan_case():
    """The 16 smoke models (their stored evparams) as the profile
    database, and 30 seeded sequences with domains of them planted as
    the queries; the JAX package's copies."""
    models = syn.smoke_models()
    seqs, planted = syn.make_targets(models[:8], 30, seed=41, median=200.0,
                                     sigma=0.4, plants=syn.PLANTS[:2])
    return models, seqs, [jax_hmm(h) for h in models], jax_block(seqs)


def scan_rows(results):
    return [(th.query_name, th.Z, rows(th)) for th in results]


def test_hmmscan_matches_jax(scan_case):
    """Rows equal the JAX package's, with Z = the number of models."""
    models, seqs, jmodels, jseqs = scan_case
    got = list(pyhmmer_tpu_torch.hmmscan(seqs, models, device="cpu"))
    want = list(jax_hmmer.hmmscan(jseqs, jmodels))
    assert scan_rows(got) == scan_rows(want)
    assert len(got) == len(seqs) and all(th.Z == 16.0 for th in got)
    assert sum(len(th.reported) for th in got) >= 8


def test_hmmscan_optimized_profiles_match_jax(scan_case):
    """``OptimizedProfile`` inputs (each carries its core model), and
    the sequential ``Pipeline.scan_seq`` (``backend="oracle"``) on a few
    queries."""
    from pyhmmer_tpu.plan7.background import Background as JBackground
    from pyhmmer_tpu.plan7.profile import Profile as JProfile
    from pyhmmer_tpu_torch.plan7 import Background, Profile
    models, seqs, jmodels, jseqs = scan_case
    oms = [Profile(h.M, h.alphabet).configure(
        h, Background(h.alphabet), 400).to_optimized() for h in models]
    joms = [JProfile(h.M, h.alphabet).configure(
        h, JBackground(h.alphabet), 400).to_optimized() for h in jmodels]
    got = list(pyhmmer_tpu_torch.hmmscan(seqs, oms, device="cpu"))
    want = list(jax_hmmer.hmmscan(jseqs, joms))
    assert scan_rows(got) == scan_rows(want)
    few = list(pyhmmer_tpu_torch.hmmscan(seqs[:3], models, device="cpu",
                                         backend="oracle"))
    assert scan_rows(few) == scan_rows(got[:3])


def test_hmmscan_reuses_one_engine(scan_case):
    """One engine across two calls gives the rows of a single call."""
    models, seqs, _, _ = scan_case
    eng = pyhmmer_tpu_torch.SearchEngine(seqs.alphabet, device="cpu")
    first = list(pyhmmer_tpu_torch.hmmscan(seqs[:15], models, engine=eng))
    cached = len(eng._model_cache)
    second = list(pyhmmer_tpu_torch.hmmscan(seqs[15:], models, engine=eng))
    assert len(eng._model_cache) == cached > 0
    once = list(pyhmmer_tpu_torch.hmmscan(seqs, models, device="cpu"))
    assert scan_rows(first + second) == scan_rows(once)
