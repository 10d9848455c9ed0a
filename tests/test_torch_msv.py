"""Stage 1 of the port, the MSV filter with the fused bias filter
(``pyhmmer_tpu_torch.ops.msv_cuda``), against the JAX package: the XLA
scan ``ops.batch._msv_kernel`` (dx integer-exact, ovf equal), the exact
f64 host bias filter ``native.bias_filter_batch``, and the Pallas kernel
``_msv_pallas2`` run in interpret mode.  On the CPU the wrapper runs the
kernel's plain PyTorch version."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pyhmmer_tpu.ops import batch as JB
from pyhmmer_tpu.plan7.background import Background
from pyhmmer_tpu.plan7.profile import Profile
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import msv_cuda, native
from test_torch_host import jax_hmm

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

#: (model lengths, padded width): a stacked small-M chunk, a wide one
STACKS = [((40, 100, 170), 192), ((800,), 832)]
LMAX = 200


@pytest.fixture(scope="module", params=STACKS, ids=lambda s: f"Mp{s[1]}")
def case(request):
    Ms, Mp = request.param
    models = syn.sample_models(Ms, seed=Mp)
    hmms = [jax_hmm(h) for h in models]
    aa = hmms[0].alphabet
    bg = Background(aa)
    profs = [Profile(h.M, aa).configure(h, bg, 400, multihit=True)
             for h in hmms]
    jpb = JB.ProfileBatch(profs, Mp=Mp)
    arrays = {n: getattr(jpb, n) for n in TB.FIELDS}
    arrays.update(Mp=jpb.Mp, Kp=jpb.Kp, scale_b=jpb.scale_b)
    tpb = TB.profile_batch_from_arrays(arrays)
    codes, lengths = syn.make_lanes(models, 64, LMAX, seed=Mp + 1)
    nonres = aa.nonresidue_code
    jdev = JB.SeqDevice(codes, lengths, nonres_code=nonres)
    tdev = TB.SeqDevice(codes, lengths, nonres_code=nonres, device="cpu")
    dx, ovf, biaslog = (t.numpy() for t in msv_cuda.msv(tpb, tdev))
    return SimpleNamespace(jpb=jpb, tpb=tpb, jdev=jdev, tdev=tdev,
                           codes=codes, lengths=lengths, dx=dx, ovf=ovf,
                           biaslog=biaslog)


def test_dx_and_ovf_match_xla_scan(case):
    dx2, ovf2 = JB._msv_kernel(
        case.jdev.codes, case.jdev.mask_f,
        *case.jpb.device("msv_cost", "msv_bias", "msv_tec", "msv_tbm"),
        case.jdev.tjb, case.jpb.Kp)
    dx2, ovf2 = np.asarray(dx2), np.asarray(ovf2)
    np.testing.assert_array_equal(case.ovf > 0, ovf2)
    assert case.ovf.any(), "the consensus lanes should overflow"
    ok = (case.ovf == 0) & ~ovf2
    assert ok.sum() > 0.8 * ok.size
    np.testing.assert_array_equal(case.dx[ok], dx2[ok])


def test_biaslog_matches_native_host_filter(case):
    if not native.available():
        pytest.skip("native host library unavailable")
    # lanes holding a nonresidue code take the exact host path in the
    # engine (the fused scan freezes on it), so they are not compared
    lanes = ~case.tdev.has_nonres
    assert lanes.sum() > 32
    margin = 2e-3 + 1e-6 * np.maximum(case.lengths, 1)
    for pi in range(case.jpb.P):
        exact = native.bias_filter_batch(
            case.jpb.filter_odds[pi].astype(np.float64), case.codes,
            case.lengths)
        err = np.abs(case.biaslog[pi] - exact)[lanes]
        assert (err <= 0.25 * margin[lanes]).all(), (pi, err.max())


@pytest.fixture
def interpret(monkeypatch):
    """``pyhmmer_tpu.ops.msv_pallas`` with its kernels run by the Pallas
    interpreter."""
    mp = importlib.import_module("pyhmmer_tpu.ops.msv_pallas")
    monkeypatch.setattr(mp, "_INTERPRET", True)
    return mp


def test_matches_pallas_stacked_kernel(case, interpret):
    mp = interpret
    dev = case.jdev
    t = mp.build_msv_tensors2(case.jpb, mp.stack_rows(dev.Lmax))
    Bt = min(128, dev.Bpad)
    parts = [mp._msv_pallas2(dev.strips(1, Bt), cost, dev.tjb_row, scal,
                             dev.tile_bounds(8, Bt), odds, dev.p1_row,
                             t["Mpk"])
             for cost, scal, odds in t["groups"]]
    B = dev.B
    dx2, ovf2, bl2 = (np.concatenate([np.asarray(p[k]) for p in parts])
                      [:, :B] for k in range(3))
    # same 2-state scan and 8-row renormalization; the Pallas kernel also
    # renormalizes the padded tail of the last block: f32 rounding only
    np.testing.assert_allclose(case.biaslog, bl2, rtol=0, atol=1e-4)
    # The stacked kernel keeps every profile of a group in one flat DP
    # state, and with the 255 clamp elided an overflowing profile's
    # values pass its padding rows into the next profile of the stack.
    # On lanes where no profile overflows the DP is the same.
    clean = ~(case.ovf > 0).any(axis=0)
    assert clean.sum() > 0.8 * B
    np.testing.assert_array_equal(case.dx[:, clean], dx2[:, clean])
    np.testing.assert_array_equal(case.ovf[:, clean], ovf2[:, clean])


def test_matches_pallas_per_profile_kernel(case, interpret):
    mp = interpret
    dev = case.jdev
    t = mp.build_msv_tensors(case.jpb)
    Bt = min(128, dev.Bpad)
    R = mp._strip_r(t["cost"].shape[1], Bt)
    dx2, ovf2, bl2 = (np.asarray(a)[:, : dev.B] for a in mp._msv_pallas(
        dev.strips(R, Bt), t["cost"], dev.tjb_row, t["scal"],
        dev.tile_bounds(R, Bt), t["odds"], dev.p1_row, R, Bt))
    np.testing.assert_array_equal(case.dx, dx2)
    np.testing.assert_array_equal(case.ovf, ovf2)
    # renormalized per strip of R rows instead of per 8 rows
    np.testing.assert_allclose(case.biaslog, bl2, rtol=0, atol=1e-4)


def test_wrapper_checks_its_arguments(case):
    dev, pb = case.tdev, case.tpb
    args = [dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1]
    bad_dtype = list(args)
    bad_dtype[0] = dev.codes.long()
    with pytest.raises(TypeError):
        msv_cuda.msv_scores(*bad_dtype)
    bad_shape = list(args)
    bad_shape[1] = dev.lens[:-1]
    with pytest.raises(ValueError):
        msv_cuda.msv_scores(*bad_shape)
    strided = list(args)
    strided[0] = dev.codes.t().contiguous().t()
    with pytest.raises(ValueError):
        msv_cuda.msv_scores(*strided)
    before = msv_cuda.launches
    msv_cuda.msv_scores(*args)
    assert msv_cuda.launches == before, "the plain version is no launch"


def test_other_devices_raise(case):
    """Only a CPU tensor takes the plain version."""
    dev, pb = case.tdev, case.tpb
    meta = [t.to("meta") for t in (dev.codes, dev.lens, pb.msv_w16,
                                   pb.msv_scal, pb.msv_odds, dev.tjb,
                                   dev.p1)]
    with pytest.raises(ValueError, match="unsupported device"):
        msv_cuda.msv_scores(*meta)
