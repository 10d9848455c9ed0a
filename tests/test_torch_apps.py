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


def test_hmmpress_files_equal_jax(scan_case, tmp_path):
    """``hmmpress`` of the 16 smoke models: the four members (``.h3m``,
    ``.h3i``, ``.h3f``, ``.h3p``) byte for byte the JAX package's."""
    models, _, jmodels, _ = scan_case
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert pyhmmer_tpu_torch.hmmpress(models, tmp_path / "port" / "db") \
        == jax_hmmer.hmmpress(jmodels, tmp_path / "jax" / "db") == 16
    for ext in (".h3m", ".h3i", ".h3f", ".h3p"):
        got = (tmp_path / "port" / ("db" + ext)).read_bytes()
        assert got == (tmp_path / "jax" / ("db" + ext)).read_bytes(), ext
        assert got


def test_hmmscan_of_a_pressed_database(scan_case, tmp_path):
    """A scan of the pressed database (``HMMPressedFile``, read from its
    ``.h3m``) reports the rows of the scan of the HMM list.  Without the
    ``.h3m`` the models are rebuilt from the ``.h3f``/``.h3p`` members,
    as the JAX package always does for this layout: then the scan of 5
    models reports what the JAX package's scan of its pressed copy
    reports."""
    from pyhmmer_tpu.plan7 import HMMPressedFile as JHMMPressedFile
    from pyhmmer_tpu_torch.plan7 import HMMFile, HMMPressedFile
    models, seqs, jmodels, jseqs = scan_case
    db = tmp_path / "db"
    pyhmmer_tpu_torch.hmmpress(models, db)
    with HMMFile(str(db) + ".h3m") as fh:
        back = list(fh)
    assert [(h.name, h.M) for h in back] == [(h.name, h.M) for h in models]
    want = list(pyhmmer_tpu_torch.hmmscan(seqs, models, device="cpu"))
    with HMMPressedFile(db) as pressed:
        got = list(pyhmmer_tpu_torch.hmmscan(seqs, pressed, device="cpu"))
    assert scan_rows(got) == scan_rows(want)
    # the rebuilt route on a database of 5 models, 10 queries
    small = tmp_path / "small"
    pyhmmer_tpu_torch.hmmpress(models[:5], small)
    with JHMMPressedFile(small) as pressed:
        jgot = list(jax_hmmer.hmmscan(jseqs[:10], pressed))
    (tmp_path / "small.h3m").unlink()
    with HMMPressedFile(small) as pressed:
        rebuilt = list(pyhmmer_tpu_torch.hmmscan(seqs[:10], pressed,
                                                 device="cpu"))
    assert scan_rows(rebuilt) == scan_rows(jgot)


def test_hmmalign_matches_jax(scan_case):
    """``hmmalign`` of a model's planted targets, text and digital."""
    models, seqs, jmodels, jseqs = scan_case
    got = pyhmmer_tpu_torch.hmmalign(models[3], list(seqs)[:6])
    want = jax_hmmer.hmmalign(jmodels[3], list(jseqs)[:6])
    assert got.alignment == want.alignment and got.names == want.names
    got = pyhmmer_tpu_torch.hmmalign(models[3], list(seqs)[:6], trim=True,
                                     digitize=True)
    want = jax_hmmer.hmmalign(jmodels[3], list(jseqs)[:6], trim=True,
                              digitize=True)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert len(got.names) == 6
