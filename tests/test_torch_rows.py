"""Stage 2b of the port, the survivor rows (``pyhmmer_tpu_torch.ops.
rows_cuda``), against the JAX package's Pallas rows kernels
(``ops.rows_pallas``, in interpret mode) and the float64 parsers of
``ops.reference``, at rows widths 256, 512 and 768 (768 is the edge of
the engine's eligibility), with ragged lengths around multiples of 8 and
32, a nonresidue code inside a target and a consensus plant.  Then the
rows through the native domain definition, and the engine's rows stage
against its own rows-off path and the JAX engine's rows stage.  On the
CPU the wrapper runs the kernel's plain version."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# the JAX rows kernels run through the Pallas interpreter; the flag is
# read when the module is imported
os.environ["PYHMMER_TPU_PALLAS_INTERPRET"] = "1"
for _m in ("pyhmmer_tpu.ops.rows_pallas", "pyhmmer_tpu.ops.msv_pallas",
           "pyhmmer_tpu.ops.fwd_pallas", "pyhmmer_tpu.ops.vit_pallas"):
    sys.modules.pop(_m, None)

from pyhmmer_tpu.engine import SearchEngine as JaxEngine  # noqa: E402
from pyhmmer_tpu.ops import batch as JB  # noqa: E402
from pyhmmer_tpu.ops import reference as ref  # noqa: E402
from pyhmmer_tpu.plan7 import background as jbg, profile as jprof  # noqa: E402
import pyhmmer_tpu_torch  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch.easel import DigitalSequenceBlock  # noqa: E402
from pyhmmer_tpu_torch.ops import batch as TB  # noqa: E402
from pyhmmer_tpu_torch.ops import native, rows_cuda  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Background, Profile  # noqa: E402
from test_torch_host import jax_block, jax_hmm  # noqa: E402

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

#: (model lengths, padded width): rows widths 256, 512 and 768
STACKS = [((60, 230), 256), ((400,), 512), ((700,), 736)]
#: lengths on both sides of multiples of 8 and 32, and 1
LENGTHS = (96, 1, 7, 8, 9, 31, 32, 33, 40, 63, 65, 17)
LMAX = 96


def bars(Mp):
    """(fsc, bsc, atol, rtol): ``tests/test_rows_pallas.py:111-116`` for
    the narrow stack, ``:203-207`` (its large-model test) for the rest."""
    return (1e-3, 2e-3, 3e-4, 2e-3) if Mp <= 256 else (2e-3, 3e-3, 5e-4,
                                                       3e-3)


def oracle_rows(prof, dsq):
    """btot/etot/mocc + score from the exact NumPy parsers (the JAX
    package's ``tests/test_rows_pallas.py:_oracle_rows``)."""
    L = len(dsq)
    prof.reconfig_length(L)
    f = ref.forward(prof, dsq)
    b = ref.backward(prof, dsq)
    lloop = np.log1p(-3.0 / (L + 3.0))
    btot = np.zeros(L + 1)
    etot = np.zeros(L + 1)
    mocc = np.zeros(L + 1)
    for i in range(1, L + 1):
        btot[i] = btot[i - 1] + np.exp(
            f.xB[i - 1] + b.xB[i - 1] - f.score)
        etot[i] = etot[i - 1] + np.exp(f.xE[i] + b.xE[i] - f.score)
        pN = np.exp(f.xN[i - 1] + lloop + b.xN[i] - f.score)
        pJ = np.exp(f.xJ[i - 1] + lloop + b.xJ[i] - f.score)
        pC = np.exp(f.xC[i - 1] + lloop + b.xC[i] - f.score)
        mocc[i] = 1.0 - (pN + pJ + pC)
    return np.stack([btot, etot, mocc]), f.score


def lanes(hmms, seed):
    """Targets of ``LENGTHS``: lane 0 the first model's consensus, lane 3
    a nonresidue code inside the sequence, the rest background."""
    aa = hmms[0].alphabet
    rng = np.random.default_rng(seed)
    f = np.asarray(Background(aa).residue_frequencies, np.float64)
    f = f / f.sum()
    codes = np.full((len(LENGTHS), LMAX), aa.nonresidue_code, np.uint8)
    for i, L in enumerate(LENGTHS):
        codes[i, :L] = rng.choice(len(f), size=L, p=f)
    cons = syn.plant(hmms[0], rng, 1.0)[:LMAX]
    codes[0, : len(cons)] = cons
    codes[3, 4] = aa.nonresidue_code
    return codes, np.array(LENGTHS, np.int64)


def configured(hmms, background, profile):
    """Multihit profiles of ``hmms`` at L 400, by one package's classes."""
    bg = background(hmms[0].alphabet)
    return [profile(h.M, h.alphabet).configure(h, bg, 400, multihit=True)
            for h in hmms]


@pytest.fixture(scope="module", params=STACKS, ids=lambda s: f"Mp{s[1]}")
def case(request):
    Ms, Mp = request.param
    hmms = syn.sample_models(Ms, seed=Mp + 11)
    aa = hmms[0].alphabet
    profs = configured(hmms, Background, Profile)
    jprofs = configured([jax_hmm(h) for h in hmms], jbg.Background,
                        jprof.Profile)
    codes, lengths = lanes(hmms, seed=Mp)
    # every profile against every lane, interleaved so the stable sort
    # by profile has work to do
    pair_b = np.tile(np.arange(len(LENGTHS)), len(profs)).astype(np.int32)
    pair_p = np.repeat(np.arange(len(profs)), len(LENGTHS)).astype(np.int32)
    perm = np.random.default_rng(Mp).permutation(len(pair_p))
    pair_p, pair_b = pair_p[perm], pair_b[perm]
    tpb = TB.ProfileBatch(profs, Mp=Mp)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code)
    terms, fsc, bsc, order = rows_cuda.survivor_rows(tpb, dev, pair_p,
                                                      pair_b)
    from pyhmmer_tpu.ops import rows_pallas
    jt, jf, jb, jorder = rows_pallas.survivor_rows(
        JB.ProfileBatch(jprofs, Mp=Mp), JB.SeqDevice(codes, lengths),
        pair_p, pair_b)
    return SimpleNamespace(
        Mp=Mp, profs=profs, jprofs=jprofs, codes=codes, lengths=lengths,
        pair_p=pair_p, pair_b=pair_b, terms=terms.numpy(), fsc=fsc.numpy(),
        bsc=bsc.numpy(), order=order, tpb=tpb, dev=dev,
        jax=(np.asarray(jt), np.asarray(jf), np.asarray(jb), jorder))


def test_order_sorts_pairs_by_profile(case):
    assert np.array_equal(case.order, case.jax[3])
    p = case.pair_p[case.order]
    assert (np.diff(p) >= 0).all()
    assert case.terms.shape == (len(case.order), LMAX + 1, 3)


def test_matches_float64_parsers(case):
    fbar, bbar, atol, rtol = bars(case.Mp)
    for g, src in enumerate(case.order):
        pi, b = int(case.pair_p[src]), int(case.pair_b[src])
        L = int(case.lengths[b])
        want, score = oracle_rows(case.jprofs[pi], case.codes[b, :L])
        assert abs(case.fsc[g] - score) < fbar, (g, case.fsc[g], score)
        assert abs(case.bsc[g] - score) < bbar, (g, case.bsc[g], score)
        np.testing.assert_allclose(rows_cuda.ext_rows(case.terms[g], L),
                                   want, atol=atol, rtol=rtol)
        assert (case.terms[g, L + 1:] == 0).all()


def test_matches_jax_rows_kernels(case):
    fbar, bbar, atol, rtol = bars(case.Mp)
    jt, jf, jb, _ = case.jax
    for g, src in enumerate(case.order):
        L = int(case.lengths[case.pair_b[src]])
        assert abs(case.fsc[g] - jf[g]) < fbar
        assert abs(case.bsc[g] - jb[g]) < bbar
        np.testing.assert_allclose(rows_cuda.ext_rows(case.terms[g], L),
                                   rows_cuda.ext_rows(jt[g], L),
                                   atol=atol, rtol=rtol)


def test_pair_without_forward_mass_gives_zero_terms():
    """A target of nonresidue codes only has no Forward mass: its score is
    NEGMASS and its terms are zero, never NaN."""
    hmms = syn.sample_models((50,), seed=3)
    aa = hmms[0].alphabet
    prof = Profile(hmms[0].M, aa).configure(hmms[0], Background(aa), 400)
    codes = np.full((1, 40), aa.nonresidue_code, np.uint8)
    dev = TB.SeqDevice(codes, np.array([40]), nonres_code=aa.nonresidue_code)
    terms, fsc, bsc, _ = rows_cuda.survivor_rows(
        TB.ProfileBatch([prof]), dev, np.array([0]), np.array([0]))
    assert fsc.item() == np.float32(TB.NEGMASS)
    assert torch.isfinite(terms).all() and (terms == 0).all()
    assert torch.isfinite(bsc).all()


def test_rows_reject_other_devices_and_bad_pairs(case):
    """A tensor neither on the CPU nor on a CUDA device, tensors on two
    devices, and pair indices outside the profiles or targets raise."""
    dev, pb = case.dev, case.tpb
    meta = [t.to("meta") for t in (dev.codes, dev.lens, dev.lm,
                                    pb.fwd_emis, pb.fwd_trans)]
    pairs = [torch.zeros(2, dtype=torch.int32, device="meta")] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        rows_cuda.rows_scores(*meta, *pairs)
    with pytest.raises(ValueError):
        rows_cuda.rows_scores(dev.codes, dev.lens, dev.lm, pb.fwd_emis,
                              pb.fwd_trans, *pairs)
    for p, b in ((pb.P, 0), (0, dev.B), (-1, 0)):
        with pytest.raises(IndexError):
            rows_cuda.survivor_rows(pb, dev, np.array([0, p]),
                                    np.array([0, b]))


def test_rows_refuse_other_table_layouts(case):
    """The rows kernels read the packed narrow layout only: the same odds
    striped ([P, Kp, S, 32] and [P, 8, S, 32], the layout they once read)
    or in the wide layout, and a model wider than their 24 slots a lane,
    raise before any kernel could misread them."""
    dev, pb = case.dev, case.tpb
    pairs = [torch.zeros(2, dtype=torch.int32)] * 2
    em, ei, tr = TB.unpacked(pb.fwd_emis, pb.fwd_trans)
    striped = (TB.striped(em).contiguous(), TB.striped(tr).contiguous())
    wide = [torch.from_numpy(a) for a in TB.packed(
        em.numpy(), ei.numpy(), tr.numpy(), wide_s=1)]
    too_wide = (torch.zeros((pb.P, pb.Kp, 2, 32, 32)),
                torch.zeros((pb.P, 8, 32, 32)))
    for emis, trans in (striped, wide, too_wide):
        with pytest.raises(ValueError):
            rows_cuda.rows_scores(dev.codes, dev.lens, dev.lm, emis, trans,
                                  *pairs)


def consensus_pair(case):
    """(row g, profile, ext rows, fsc) of the first profile on lane 0."""
    g = next(g for g, src in enumerate(case.order)
             if case.pair_p[src] == 0 and case.pair_b[src] == 0)
    L = int(case.lengths[0])
    return g, case.profs[0], rows_cuda.ext_rows(case.terms[g], L), float(
        case.fsc[g])


@pytest.mark.parametrize("case", STACKS[:1], indirect=True,
                         ids=lambda s: f"Mp{s[1]}")
def test_ext_rows_give_the_native_domains(case):
    """The port's rows through ``hmmdp_domaindef(ext_rows)`` give the same
    domains as the native call that runs its own parsers."""
    if not native.available():
        pytest.skip("no native library")
    g, prof, ext, fsc = consensus_pair(case)
    dsq = case.codes[0, : case.lengths[0]]
    prof.reconfig_length(len(dsq))
    fwd_b, res_b = native.domaindef(prof, dsq, True, 42)
    fwd_e, res_e = native.domaindef(prof, dsq, True, 42, ext_rows=ext,
                                    ext_fwdsc=fsc)
    assert abs(fwd_b - fwd_e) < 1e-3
    assert res_b.nregions == res_e.nregions
    assert len(res_b.domains) == len(res_e.domains) > 0
    for db, de in zip(res_b.domains, res_e.domains):
        assert (db.ienv, db.jenv, db.iali, db.jali) == \
            (de.ienv, de.jenv, de.iali, de.jali)
        assert abs(db.envsc - de.envsc) < 1e-6
        assert abs(db.oasc - de.oasc) < 1e-4


@pytest.mark.parametrize("case", STACKS[:1], indirect=True,
                         ids=lambda s: f"Mp{s[1]}")
def test_marginal_row_reruns_the_exact_parsers(case):
    """A region threshold inside the audit margin sends the native call
    back to its own exact parsers: the output is the classic path's, with
    its exact Forward score, and the marginal counter moves."""
    if not native.available():
        pytest.skip("no native library")
    g, prof, ext, fsc = consensus_pair(case)
    dsq = case.codes[0, : case.lengths[0]]
    prof.reconfig_length(len(dsq))
    # row 1's rt2 check (mocc[1] - (btot[1] - btot[0]) < rt2) runs on
    # every scan: pin its margin far inside the 2e-4 audit epsilon
    ext = ext.copy()
    ext[2, 1] = 0.10 + (ext[0, 1] - ext[0, 0]) + 1e-6
    before = native.marginal_count()
    fwd_b, res_b = native.domaindef(prof, dsq, True, 42)
    fwd_e, res_e = native.domaindef(prof, dsq, True, 42, ext_rows=ext,
                                    ext_fwdsc=fsc)
    assert native.marginal_count() == before + 1
    assert fwd_b == fwd_e
    assert [(d.ienv, d.jenv, d.envsc) for d in res_b.domains] == \
        [(d.ienv, d.jenv, d.envsc) for d in res_e.domains]


# -- the engine's rows stage ------------------------------------------------

def hits(th):
    """What must be identical between the rows stage and the paths without
    it: names, inclusion and domain envelopes of the reported hits."""
    return [(h.name, h.included,
             [(d.env_from, d.env_to) for d in h.domains])
            for h in th.reported]


def assert_same_search(got, want):
    """Identity as in ``tests/test_engine_pallas.py:99-109``; reported
    scores on the rows path carry the device's f32 Forward score, so
    score and bias agree within 2e-3 bits."""
    for a, b in zip(got, want):
        assert hits(a) == hits(b)
        for ha, hb in zip(a.reported, b.reported):
            assert abs(ha.score - hb.score) < 2e-3, (ha.name, ha.score,
                                                     hb.score)
            assert abs(ha.bias - hb.bias) < 2e-3
        for n in ("n_past_msv", "n_past_bias", "n_past_vit", "n_past_fwd"):
            assert getattr(a, n) == getattr(b, n), n


@pytest.fixture(scope="module")
def rows_workload():
    """Three smoke models, one per chunk (rows widths 128, 256 and 512),
    so the JAX package's stacked MSV cannot leak overflow from one
    profile into the next and change its pass counts (ROADMAP queue 3),
    against short targets with nine planted domains per model."""
    models = [syn.smoke_models()[i] for i in (0, 7, 10)]
    targets, _ = syn.make_targets(
        models, 128, seed=21, median=200.0, sigma=0.4,
        plants=((1.0, 0, 0), (0.6, 0, 0), (0.7, 10, 0)) * 3)
    short = DigitalSequenceBlock(models[0].alphabet,
                                 [s for s in targets if len(s) <= 512])
    return models, short, [jax_hmm(h) for h in models], jax_block(short)


def test_engine_rows_stage_matches_rows_off_and_jax(rows_workload,
                                                    monkeypatch):
    """With speculation and the sparse host path off, most final
    survivors take the rows stage: the port with rows on against the
    port with rows off and against the JAX engine's rows stage."""
    if not native.available():
        pytest.skip("no native library")
    models, targets, jax_models, jax_targets = rows_workload
    for name, value in (("SPECULATE_P1B", -1.0), ("HOST_MIN_PAIRS", 0),
                        ("HOST_PAIRS_PER_ROW", 0.0)):
        monkeypatch.setattr(pyhmmer_tpu_torch.engine, name, value)
    for name, value in (("PYHMMER_TPU_SPEC_P1B", "-1"),
                        ("PYHMMER_TPU_HOST_BUDGET", "0"),
                        ("PYHMMER_TPU_DEVICE_ROWS", "1")):
        monkeypatch.setenv(name, value)
    alphabet = models[0].alphabet
    on = pyhmmer_tpu_torch.SearchEngine(alphabet, device="cpu",
                                        device_rows=True)
    res_on = on.search(models, targets)
    off = pyhmmer_tpu_torch.SearchEngine(alphabet, device="cpu")
    res_off = off.search(models, targets)
    jax_eng = JaxEngine(jax_models[0].alphabet, use_pallas=True)
    res_jax = jax_eng.search(jax_models, jax_targets)

    assert on.last_timing.get("n_rows_ext", 0) > 0, on.last_timing
    assert jax_eng.last_timing.get("n_rows_ext", 0) > 0
    assert "n_rows_ext" not in off.last_timing
    assert on.last_timing["n_rows_pairs"] == (
        on.last_timing["n_rows_ext"] + on.last_timing.get("n_rows_back", 0))
    assert on.last_timing["n_rows_ext"] >= 12
    assert_same_search(res_on, res_off)
    assert_same_search(res_on, res_jax)
