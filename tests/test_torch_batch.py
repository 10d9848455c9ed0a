"""The port's profile and sequence packing against the JAX package's
(``pyhmmer_tpu_torch.ops.batch`` vs ``pyhmmer_tpu.ops.batch``), each
packing profiles configured by its own package from the same seeded
models."""

import numpy as np
import pytest
import torch

from pyhmmer_tpu.ops import batch as JB
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.profile import Profile as JProfile
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import fwd_cuda, vit_cuda
from pyhmmer_tpu_torch.plan7 import Background, Profile
from test_torch_host import jax_hmm

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

#: (model lengths, padded width) of the packed stacks
STACKS = [((40, 100, 120), 128), ((420,), 448), ((800,), 832)]


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for Ms, Mp in STACKS:
        hmms = syn.sample_models(Ms, seed=Mp)
        bg = Background(hmms[0].alphabet)
        profs = [Profile(h.M, h.alphabet).configure(h, bg, 400)
                 for h in hmms]
        jhmms = [jax_hmm(h) for h in hmms]
        jbg = JBackground(jhmms[0].alphabet)
        jprofs = [JProfile(h.M, h.alphabet).configure(h, jbg, 400)
                  for h in jhmms]
        out[Mp] = (hmms, JB.ProfileBatch(jprofs, Mp=Mp),
                   TB.ProfileBatch(profs, Mp=Mp))
    return out


def odds_tables(tpb):
    """The Forward and rows kernels' odds from ``tpb``'s shared fields,
    whatever the packing: (M, I) emission odds [P, Kp, Mk] and transition
    odds [P, 8, Mk] at the kernel width ``Mk = 32 S``; slot s is state
    s + 1, and a transition that is absent or leaves the model is 0."""
    def odds(a):
        a = np.asarray(a, np.float64)
        return np.where(a > -600.0, np.exp(np.minimum(a, 600.0)),
                        0.0).astype(np.float32)
    P, Kp, Mp = tpb.msc.shape
    Mk = 32 * tpb.S
    em = np.zeros((P, Kp, Mk), np.float32)
    ei = np.zeros((P, Kp, Mk), np.float32)
    em[..., :Mp] = odds(tpb.msc)
    ei[..., :Mp] = odds(tpb.isc)
    tr = np.zeros((P, 8, Mk), np.float32)
    for t, name in enumerate(("tMM", "tIM", "tDM")):   # from slot s - 1
        tr[:, t, 1:Mp] = odds(getattr(tpb, name)[:, 1:Mp])
    tr[:, 3, :Mp] = odds(tpb.tBM)
    tr[:, 4, :Mp] = odds(tpb.tMI[:, 1:Mp + 1])
    tr[:, 5, :Mp] = odds(tpb.tII[:, 1:Mp + 1])
    live = tpb.kmask[:, 1:Mp]                         # state s + 2 exists
    tr[:, 6, :Mp - 1] = np.where(live, odds(tpb.tMD[:, 1:Mp]), 0.0)
    tr[:, 7, :Mp - 1] = np.where(live, odds(tpb.tDD[:, 1:Mp]), 0.0)
    return em, ei, tr


def jax_arrays(jpb):
    d = {n: getattr(jpb, n) for n in TB.FIELDS}
    d.update(Mp=jpb.Mp, Kp=jpb.Kp, scale_b=jpb.scale_b)
    return d


@pytest.mark.parametrize("Mp", [Mp for _, Mp in STACKS])
def test_profile_fields_equal_jax(stacks, Mp):
    _, jpb, tpb = stacks[Mp]
    assert (tpb.P, tpb.Kp, tpb.Mp) == (jpb.P, jpb.Kp, jpb.Mp)
    assert tpb.scale_b == jpb.scale_b
    np.testing.assert_array_equal(tpb.M, jpb.M)
    for name in TB.FIELDS:
        np.testing.assert_array_equal(getattr(tpb, name),
                                      getattr(jpb, name), err_msg=name)
    assert 32 * tpb.S >= Mp and tpb.msv_w16.shape[2:] == (tpb.S, 32)


@pytest.mark.parametrize("Mp", [Mp for _, Mp in STACKS])
def test_profile_batch_from_arrays_round_trips(stacks, Mp):
    _, jpb, tpb = stacks[Mp]
    back = TB.profile_batch_from_arrays(jax_arrays(jpb))
    for name, buf in tpb.named_buffers():
        assert torch.equal(buf, getattr(back, name)), name
    again = TB.profile_batch_from_arrays(back.arrays())
    for name, buf in tpb.named_buffers():
        assert torch.equal(buf, getattr(again, name)), name
    assert (again.Mp, again.Kp, again.scale_b) == (jpb.Mp, jpb.Kp,
                                                   jpb.scale_b)


def test_kernel_tables_layout(stacks):
    """The tables are striped (lane l holds slots l*S..l*S+S-1); slot s
    of the Viterbi/Forward tables is state k = s + 1; absent transitions
    are NEGMASS in log space and 0 in odds space.  The Viterbi tables are
    packed: slot j of lane l holds its (M, I) log emission scores of a
    residue side by side and its 8 log transitions in two planes of 4,
    and they unpack to exactly the JAX package's log scores."""
    _, jpb, tpb = stacks[128]
    S = tpb.S
    Mk = 32 * S
    P, Kp = tpb.P, tpb.Kp
    assert S < TB.VIT_WIDE_S
    assert tpb.vit_emis.shape == (P, Kp, S, 32, 2)
    assert tpb.vit_trans.shape == (P, S, 2, 32, 4)
    assert TB.packed_stripes(tpb.vit_trans) == S
    msc, isc, tr = TB.unpacked(tpb.vit_emis, tpb.vit_trans)
    assert tpb.vit_trans[0, 1, 0, 2, 3] == tr[0, 3, 2 * S + 1]
    assert tpb.vit_trans[0, 1, 1, 2, 2] == tr[0, 6, 2 * S + 1]
    assert tpb.vit_emis[0, 5, 1, 2, 1] == isc[0, 5, 2 * S + 1]
    np.testing.assert_array_equal(msc.numpy()[:, :, :jpb.Mp], jpb.msc)
    np.testing.assert_array_equal(isc.numpy()[:, :, :jpb.Mp], jpb.isc)
    assert (msc.numpy()[:, :, jpb.Mp:] == TB.NEGMASS).all()
    tr = tr.numpy()
    assert tr.shape == (tpb.P, 8, Mk)
    np.testing.assert_array_equal(tr[:, 0, 1:jpb.Mp], jpb.tMM[:, 1:])
    np.testing.assert_array_equal(tr[:, 1, 1:jpb.Mp], jpb.tIM[:, 1:])
    np.testing.assert_array_equal(tr[:, 2, 1:jpb.Mp], jpb.tDM[:, 1:])
    np.testing.assert_array_equal(tr[:, 3, :jpb.Mp], jpb.tBM)
    np.testing.assert_array_equal(tr[:, 4, :jpb.Mp], jpb.tMI[:, 1:])
    np.testing.assert_array_equal(tr[:, 5, :jpb.Mp], jpb.tII[:, 1:])
    assert (tr[:, :3, 0] == TB.NEGMASS).all()
    for p, M in enumerate(jpb.M):
        np.testing.assert_array_equal(tr[p, 6, :M - 1], jpb.tMD[p, 1:M])
        np.testing.assert_array_equal(tr[p, 7, :M - 1], jpb.tDD[p, 1:M])
        assert (tr[p, 6:, M - 1:] == TB.NEGMASS).all()
    # the odds tables are the log tables through exp, and the odds of the
    # shared fields: 0 past each model's last D->D
    ems, eis, otr = TB.unpacked(tpb.fwd_emis, tpb.fwd_trans)
    for got, want in zip((ems, eis, otr), odds_tables(tpb)):
        np.testing.assert_array_equal(got.numpy(), want)
    for p, M in enumerate(jpb.M):
        assert (otr.numpy()[p, 6:, M - 1:] == 0.0).all()
    np.testing.assert_array_equal(otr.numpy(), TB._xexp(tr))
    np.testing.assert_array_equal(ems.numpy(), TB._xexp(msc.numpy()))
    # the MSV table is pre-biased, bias - cost, in 16 bits
    assert tpb.msv_w16.dtype == torch.int16
    w = TB.unstriped(tpb.msv_w16).numpy()
    bias = jpb.msv_bias[:, None, None]
    np.testing.assert_array_equal(w[:, :, :jpb.Mp], bias - jpb.msv_cost)
    assert (w[:, :, jpb.Mp:] == bias - 255).all()
    nonres = jpb.profiles[0].alphabet.nonresidue_code
    assert (tpb.msv_odds.numpy()[:, nonres] == 0.0).all()


@pytest.mark.parametrize("Mp", [Mp for _, Mp in STACKS])
def test_profile_batch_holds_one_set_of_odds_tables(stacks, Mp):
    """The Forward and the rows kernels read the same packed odds tables
    (``fwd_emis``, ``fwd_trans``); the striped copies the rows kernels
    once read (``fwd_ems``, ``fwd_eis``, ``fwd_tr``) are gone."""
    tpb = stacks[Mp][2]
    assert {n for n, _ in tpb.named_buffers()} == {
        "msv_w16", "msv_scal", "msv_odds", "vit_emis", "vit_trans",
        "fwd_emis", "fwd_trans"}
    for name in ("fwd_ems", "fwd_eis", "fwd_tr"):
        assert not hasattr(tpb, name)


def test_profile_batch_moves_with_to(stacks):
    """The kernel tables are the buffers; the shared fields stay on the
    host."""
    _, _, tpb = stacks[448]
    moved = tpb.to(torch.device("cpu"))
    assert moved.device == torch.device("cpu")
    assert ({n for n, _ in moved.named_buffers()}
            == set(TB.kernel_tables(tpb.arrays())))
    assert all(isinstance(getattr(moved, n), np.ndarray) for n in TB.FIELDS)


def test_seq_device_equals_jax(stacks):
    hmms, _, _ = stacks[128]
    codes, lengths = syn.make_lanes(hmms, 40, 96, seed=5)
    nonres = hmms[0].alphabet.nonresidue_code
    jdev = JB.SeqDevice(codes, lengths, nonres_code=nonres)
    tdev = TB.SeqDevice(codes, lengths, nonres_code=nonres, device="cpu")
    assert (tdev.B, tdev.Lmax) == (jdev.B, jdev.Lmax)
    np.testing.assert_array_equal(tdev.codes.numpy(),
                                  np.asarray(jdev.codes))
    np.testing.assert_array_equal(tdev.lens.numpy(), np.asarray(jdev.lens_d))
    np.testing.assert_array_equal(tdev.tjb.numpy(), np.asarray(jdev.tjb))
    np.testing.assert_array_equal(tdev.p1.numpy(), np.asarray(jdev.p1))
    lm = tdev.lm.numpy()
    np.testing.assert_array_equal(lm[:, 2], np.asarray(jdev.loop))
    np.testing.assert_array_equal(lm[:, 3], np.asarray(jdev.move))
    np.testing.assert_array_equal(tdev.has_nonres, jdev.has_nonres)
    assert tdev.has_nonres.any() and not tdev.has_nonres.all()
    np.testing.assert_array_equal(tdev.nullsc_host, jdev.nullsc_host)
    np.testing.assert_array_equal(tdev.tjbu_host, jdev.tjbu_host)


@pytest.mark.parametrize("Mp", [Mp for _, Mp in STACKS])
def test_viterbi_tables_keep_their_bytes(stacks, Mp):
    """The packed Viterbi tables hold exactly the bytes of one striped
    [P, Kp, Mk] table each for M and I and one [P, 8, Mk] of
    transitions; from ``VIT_WIDE_S`` slots a lane on (Mp 448 has 16, 832
    has 32) they are those striped tables, the M then the I scores of a
    residue."""
    _, jpb, tpb = stacks[Mp]
    P, Kp, S = tpb.P, tpb.Kp, tpb.S
    nbytes = sum(t.numel() * t.element_size()
                 for t in (tpb.vit_emis, tpb.vit_trans))
    assert nbytes == 4 * P * 32 * S * (2 * Kp + 8)
    msc, isc, tr = TB.unpacked(tpb.vit_emis, tpb.vit_trans)
    np.testing.assert_array_equal(msc.numpy()[:, :, :jpb.Mp], jpb.msc)
    assert (S >= TB.VIT_WIDE_S) == (Mp > 384)
    if S >= TB.VIT_WIDE_S:
        assert tpb.vit_emis.shape == (P, Kp, 2, S, 32)
        assert tpb.vit_trans.shape == (P, 8, S, 32)
        assert torch.equal(TB.unstriped(tpb.vit_emis[:, :, 1]), isc)
        assert torch.equal(TB.unstriped(tpb.vit_trans), tr)
    else:
        assert tpb.vit_trans.dim() == 5


@pytest.mark.parametrize("kernel,S,wide_s", [
    ("vit", 3, 1), ("vit", 16, 1000), ("fwd", 3, 1), ("fwd", 16, 1),
    ("fwd", 32, 1000)])
def test_wrappers_reject_the_other_layout(kernel, S, wide_s):
    """The Forward and Viterbi kernels take the table layout from the
    stripe width (wide from ``FWD_WIDE_S``, ``VIT_WIDE_S``): tables packed
    at another threshold raise ``ValueError``, the same tables in the
    kernel's own layout pass."""
    fn, own = {"vit": (vit_cuda.vit_scores, TB.VIT_WIDE_S),
               "fwd": (fwd_cuda.fwd_scores, TB.FWD_WIDE_S)}[kernel]
    rng = np.random.default_rng(S)
    P, Kp, Mk = 2, 29, 32 * S
    em, ei = (rng.standard_normal((P, Kp, Mk)).astype(np.float32)
              for _ in range(2))
    tr = rng.standard_normal((P, 8, Mk)).astype(np.float32)
    codes = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((4,), 8, dtype=torch.int32)
    lm = torch.zeros((4, 4))
    rows, need = torch.arange(4), torch.ones((P, 4), dtype=torch.bool)
    emis, trans = (torch.from_numpy(a) for a in TB.packed(em, ei, tr,
                                                          wide_s))
    with pytest.raises(ValueError, match="layout"):
        fn(codes, lens, lm, emis, trans, rows, need)
    emis, trans = (torch.from_numpy(a) for a in TB.packed(em, ei, tr, own))
    assert fn(codes, lens, lm, emis, trans, rows, need).shape == (P, 4)


@pytest.mark.parametrize("x,m,want", [(0, 32, 0), (1, 32, 32), (32, 32, 32),
                                      (33, 64, 64), (900, 128, 1024)])
def test_round_up(x, m, want):
    assert TB.round_up(x, m) == JB.round_up(x, m) == want


def test_stripe_width():
    """Past the widest stripe (4,096 slots) the kernels take the wide
    route: stripe width 0, the width padded to a multiple of
    ``CTA_THREADS``, and a ``ProfileBatch`` there packs MSV's, Forward's
    and Viterbi's thread-major tables (``ops/batch.py``)."""
    assert [TB.stripe_width(Mp) for Mp in (32, 64, 96, 384, 1024, 2048,
                                           4096)] \
        == [1, 2, 3, 12, 32, 64, 128]
    assert [TB.kernel_width(Mp) for Mp in (4096, 4097, 4224, 9024,
                                           100_000)] \
        == [4096, 4608, 4608, 9216, 100_352]
    assert TB.stripe_width(4097) == 0
    h = syn.sample_models((4100,), seed=4)[0]
    prof = Profile(h.M, h.alphabet).configure(h, Background(h.alphabet),
                                              400)
    tpb = TB.ProfileBatch([prof], Mp=4224)
    Kp = h.alphabet.Kp
    assert (tpb.S, tpb.Mk) == (0, 4608)
    # 256 threads of 9 words, two 16-bit slots each
    # (ops/batch.py:msv_cta_shape); the plain [P, Kp, Mk] costs back
    assert tpb.msv_w16.shape == (1, Kp, 9, 8, 32, 2)
    w = TB.msv_thread_minor(tpb.msv_w16)
    assert w.shape == (1, Kp, 4608)
    assert (w[0, :, 4224:] == int(tpb.msv_bias[0]) - 255).all()
    for name in ("vit", "fwd"):
        # 256 threads of 18 slots (ops/batch.py:cta_shape)
        assert getattr(tpb, name + "_emis").shape == (1, Kp, 18, 8, 32, 2)
        assert getattr(tpb, name + "_trans").shape == (1, 18, 2, 8, 32, 4)
        assert TB.packed_stripes(getattr(tpb, name + "_trans")) == 0
    em, ei, tr = TB.unpacked(tpb.vit_emis, tpb.vit_trans)
    assert torch.equal(em[0, :, :4100], torch.from_numpy(
        np.maximum(prof.msc[:, 1:], TB.NEGMASS).astype(np.float32)))
    assert (em[0, :, 4224:] == TB.NEGMASS).all()
