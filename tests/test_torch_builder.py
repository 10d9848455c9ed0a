"""The port's model ``Builder`` (``pyhmmer_tpu_torch/plan7/builder.py``)
against the JAX package's, on the CPU: ``calibrate`` scores its random
sequences on the plain PyTorch versions of the MSV and Viterbi kernels
(the JAX package on its XLA scans) and takes tau from the native host
Forward, under the same random stream.  So the MSV mu, tau and lambda
must be equal as float32 and the Viterbi mu, whose f32 scores add in
another order, within 1e-3 bits.  ``build`` and ``build_msa`` are host
copies: their HMM arrays must be identical.  The smoke models calibrate
to the evparams the JAX package stored for them, without JAX."""

import numpy as np
import pytest
import torch

from pyhmmer_tpu.easel.alphabet import Alphabet as JAlphabet
from pyhmmer_tpu.easel.msa import DigitalMSA as JMSA
from pyhmmer_tpu.easel.sequence import DigitalSequence as JSequence
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.builder import Builder as JBuilder
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import Alphabet, DigitalMSA, DigitalSequence
from pyhmmer_tpu_torch.plan7 import Background, Builder
from test_torch_host import jax_hmm

torch.set_num_threads(1)

#: sampled model lengths: padded widths 96, 96 and 128, so the JAX
#: package compiles its scans for two widths only
MODELS = (70, 90, 120)
#: the Viterbi mu bar (bits): f32 summation order only
V_MU_TOL = 1e-3
#: the HMM fields a build must reproduce exactly
HMM_ARRAYS = ("mat", "ins", "t")


def assert_evparams(got, want):
    """MSV mu, tau and the three lambdas equal as float32, the Viterbi
    mu within ``V_MU_TOL`` bits."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for i, name in ((0, "m_mu"), (1, "lambda"), (3, "lambda"), (4, "tau"),
                    (5, "lambda")):
        assert got[i] == want[i], (name, got[i], want[i])
    assert abs(float(got[2]) - float(want[2])) <= V_MU_TOL, (got[2],
                                                             want[2])


@pytest.fixture(scope="module")
def aa():
    return Alphabet.amino()


@pytest.mark.parametrize("M", MODELS)
def test_calibrate_matches_jax(aa, M):
    h = syn.sample_models((M,), seed=M)[0]
    jh = jax_hmm(h)
    Builder(aa, device="cpu").calibrate(h, Background(aa))
    JBuilder(jh.alphabet).calibrate(jh, JBackground(jh.alphabet))
    assert_evparams(h.evparam, jh.evparam)


@pytest.mark.parametrize("name", ["smoke-M050", "smoke-M070"])
def test_calibrate_smoke_models_match_stored(aa, name):
    """Against ``tests/data/torch_smoke_evparams.json``, which the JAX
    package wrote."""
    stored = next(h for h in syn.smoke_models() if h.name.decode() == name)
    h = stored.copy()
    h.evparam[:] = 0.0
    Builder(aa, device="cpu").calibrate(h, Background(aa))
    assert_evparams(h.evparam, stored.evparam)


def sequences(aa, lengths, seed):
    """Port and JAX sequences of i.i.d. background residues."""
    rng = np.random.default_rng(seed)
    f = np.asarray(Background(aa).residue_frequencies, np.float64)
    codes = [rng.choice(len(f), size=L, p=f / f.sum()).astype(np.uint8)
             for L in lengths]
    jaa = JAlphabet.amino()
    return ([DigitalSequence(aa, name=b"q%d" % i, sequence=c)
             for i, c in enumerate(codes)],
            [JSequence(jaa, name=b"q%d" % i, sequence=c)
             for i, c in enumerate(codes)])


def assert_same_model(got, want):
    for name in HMM_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.M, got.name, got.nseq) == (want.M, want.name, want.nseq)
    assert got.eff_nseq == want.eff_nseq
    assert got.consensus == want.consensus
    np.testing.assert_array_equal(got.composition, want.composition)
    assert_evparams(got.evparam, want.evparam)


@pytest.mark.parametrize("L", [66, 95])
def test_build_matches_jax(aa, L):
    (q,), (jq,) = sequences(aa, [L], seed=L)
    got, prof, _ = Builder(aa, device="cpu").build(q, Background(aa))
    want, jprof, _ = JBuilder(jq.alphabet).build(
        jq, JBackground(jq.alphabet))
    assert_same_model(got, want)
    for name in ("msc", "isc", "tMM", "xE"):
        np.testing.assert_array_equal(getattr(prof, name),
                                      getattr(jprof, name), name)


def seeded_msa(aa, nseq=10, M=90, seed=3):
    """Codes of a seeded alignment: ``nseq`` domains planted from one
    sampled model (consensus 0.6) in ``M`` match columns, 10% of their
    cells gapped, two rows truncated to fragments, and 6 insert columns
    that two rows fill."""
    h = syn.sample_models((M,), seed=seed)[0]
    rng = np.random.default_rng(seed)
    rows = np.stack([syn.plant(h, rng, 0.6) for _ in range(nseq)])
    rows[rng.random(rows.shape) < 0.1] = aa.gap_code
    rows[0, :35] = aa.gap_code
    rows[1, 60:] = aa.gap_code
    cols = np.sort(rng.choice(np.arange(5, M - 5), 6, replace=False))
    ins = np.full((nseq, 6), aa.gap_code, dtype=np.uint8)
    ins[2:4] = rng.integers(0, aa.K, (2, 6))
    return np.insert(rows, cols, ins, axis=1)


@pytest.mark.parametrize("weighting", ["pb", "gsc"])
def test_build_msa_matches_jax(aa, weighting):
    codes = seeded_msa(aa)
    names = [b"seq%d" % i for i in range(len(codes))]
    msa = DigitalMSA(aa, name=b"seeded")
    jmsa = JMSA(JAlphabet.amino(), name=b"seeded")
    for m in (msa, jmsa):
        m.names = list(names)
        m.codes = codes.copy()
    got, _, _ = Builder(aa, weighting=weighting, device="cpu").build_msa(
        msa, Background(aa))
    want, _, _ = JBuilder(jmsa.alphabet, weighting=weighting).build_msa(
        jmsa, JBackground(jmsa.alphabet))
    assert got.M == 90
    assert_same_model(got, want)
    np.testing.assert_array_equal(got.map, want.map)
    assert got.checksum == want.checksum


def test_cuda_builder_raises_without_cuda(aa, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Builder(aa, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Builder(aa)


def test_copy_carries_every_option(aa):
    b = Builder(aa, architecture="hand", weighting="gsc", seed=7, EvN=50,
                device="cpu")
    c = b.copy()
    assert c is not b
    assert vars(c).keys() == vars(b).keys()
    for k, v in vars(b).items():
        if k != "randomness":
            assert getattr(c, k) == v, k
    assert c.device == torch.device("cpu")


def test_query_wider_than_the_kernels_raises(aa):
    """A query wider than the kernels' 4,096-slot stripes no longer
    raises: its calibration scores the random sequences on the wide
    route's layout (here its plain versions), and the model and its
    evparams are the JAX package's."""
    (q,), (jq,) = sequences(aa, [4200], seed=1)
    got, prof, _ = Builder(aa, device="cpu").build(q, Background(aa))
    want, _, _ = JBuilder(jq.alphabet).build(jq, JBackground(jq.alphabet))
    assert got.M == 4200
    assert_same_model(got, want)
