"""Models wider than the kernels' 4,096-slot stripes: the wide route of
the port (``ops/batch.py``: unstriped tables padded to a multiple of
``CTA_THREADS``; ``csrc/{msv,vit,fwd}.cu``: one CTA a pair) against the
JAX package, on the CPU, where the wrappers run the kernels' plain
versions over the wide tables.  At a padded width of 4,224 (Mk 4,608)
the MSV ``dx`` equals the XLA scan ``ops.batch._msv_kernel``'s on every
pair neither side flags, and ``ovf`` everywhere; Viterbi and Forward
are within 0.05 nats of ``_viterbi_kernel`` and ``_forward_kernel``.
An M 4,200 model's ``hmmsearch(device="cpu")`` reports the JAX engine's
rows.  Every width up to 100,000 slots has a route."""

import numpy as np
import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.ops import batch as JB
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.profile import Profile as JProfile
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch import engine as TE
from pyhmmer_tpu_torch.ops import _pairs
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import fwd_cuda, msv_cuda, vit_cuda
from pyhmmer_tpu_torch.plan7 import Background, Builder, Profile
from test_torch_host import jax_block, jax_hmm, rows

torch.set_num_threads(1)

M, MP, MK = 4200, 4224, 4608
#: lanes and their longest length of the kernel comparison
N, LMAX = 20, 160
BAR = 0.05


@pytest.fixture(scope="module")
def wide():
    """(port model, port profile batch, JAX profile batch, lanes) at Mp
    4,224."""
    h = syn.sample_models((M,), seed=17)[0]
    jh = jax_hmm(h)
    prof = Profile(M, h.alphabet).configure(h, Background(h.alphabet), 400,
                                            multihit=True)
    jprof = JProfile(M, jh.alphabet).configure(
        jh, JBackground(jh.alphabet), 400, multihit=True)
    codes, lengths = syn.make_lanes([h], N, LMAX, seed=18)
    return (h, TB.ProfileBatch([prof], Mp=MP), JB.ProfileBatch([jprof],
                                                                Mp=MP),
            codes, lengths)


def test_tables_take_the_wide_route(wide):
    _, tpb, _, _, _ = wide
    assert (tpb.S, tpb.Mk) == (0, MK)
    assert tpb.msv_w16.dim() == 3 and tpb.fwd_trans.dim() == 3


def test_msv_matches_xla_scan(wide):
    h, tpb, jpb, codes, lengths = wide
    dev = TB.SeqDevice(codes, lengths, h.alphabet.nonresidue_code)
    dx, ovf, _ = (t.numpy() for t in msv_cuda.msv(tpb, dev))
    jdev = JB.SeqDevice(codes, lengths)
    dx2, ovf2 = JB._msv_kernel(
        jdev.codes, jdev.mask_f,
        *jpb.device("msv_cost", "msv_bias", "msv_tec", "msv_tbm"),
        jdev.tjb, jpb.Kp)
    dx2, ovf2 = np.asarray(dx2)[:, :N], np.asarray(ovf2)[:, :N]
    np.testing.assert_array_equal(ovf > 0, ovf2)
    clean = ~ovf2
    assert clean.sum() >= N // 2 and (~clean).any()
    np.testing.assert_array_equal(dx[clean], dx2[clean])


@pytest.mark.parametrize("name", ["vit", "fwd"])
def test_filter_matches_xla_scan(wide, name):
    h, tpb, jpb, codes, lengths = wide
    dev = TB.SeqDevice(codes, lengths, h.alphabet.nonresidue_code)
    rng = np.random.default_rng(19)
    cols = rng.permutation(N)[:12]
    need = rng.random((1, len(cols))) < 0.75
    need[0, :2] = True
    fn = {"vit": vit_cuda.viterbi, "fwd": fwd_cuda.forward}[name]
    got = fn(tpb, dev, torch.from_numpy(cols), torch.from_numpy(need)
             ).numpy()
    jax_fn = {"vit": JB.viterbi_scores, "fwd": JB.forward_scores}[name]
    want = jax_fn(jpb, codes, lengths)[:, cols]
    assert (got[~need] == TB.NEGMASS).all()
    err = np.abs(got - want)[need]
    assert err.max() < BAR, err.max()


@pytest.mark.parametrize("Mp", [4097, 9024, 35008, 100_000])
def test_every_width_has_a_route(Mp):
    """Up to the 100,000 residues of the longest target (a phmmer query
    of that length): the wide route's width, and tables of that width
    that the Forward, Viterbi and MSV wrappers' checks accept."""
    Mk = TB.kernel_width(Mp)
    assert TB.stripe_width(Mp) == 0 and Mk >= Mp
    assert Mk % TB.CTA_THREADS == 0 and Mk - Mp < TB.CTA_THREADS
    em = torch.zeros((1, 2, 2, Mk))
    tr = torch.zeros((1, 8, Mk))
    codes = torch.zeros((1, 4), dtype=torch.uint8)
    lens = torch.ones((1,), dtype=torch.int32)
    _pairs.check_packed(codes, lens, torch.zeros((1, 4)), em, tr,
                        TB.FWD_WIDE_S, {})
    _pairs.check_tensors({"w16": (torch.zeros((1, 2, Mk),
                                              dtype=torch.int16),
                                  torch.int16, None)},
                         torch.zeros((1, 2, Mk), dtype=torch.int16))
    with pytest.raises(ValueError):
        _pairs.check_packed(codes, lens, torch.zeros((1, 4)),
                            em[..., :-32], tr[..., :-32], TB.FWD_WIDE_S, {})


def test_engine_groups_wide_models():
    """Models past 4,096 slots share a chunk at the width the kernels pad
    them to; narrower ones keep their groups."""
    sizes = (4100, 4500, 5000, 300)
    models = [syn.sample_models((m,), seed=m)[0] for m in sizes]
    groups = TE.group_queries(models)
    assert groups == {4608: [0, 1], 5120: [2], 384: [3]}


def test_hmmsearch_wide_model_matches_jax():
    """An M 4,200 model, calibrated on the plain versions of the wide
    route, against 20 targets (4 with planted domains), through both
    engines."""
    h = syn.sample_models((M,), seed=23)[0]
    Builder(h.alphabet, device="cpu").calibrate(h, Background(h.alphabet))
    targets, planted = syn.make_targets([h], 20, seed=24, median=300.0)
    got = list(pyhmmer_tpu_torch.hmmsearch([h], targets, device="cpu"))
    want = list(jax_hmmer.hmmsearch([jax_hmm(h)], jax_block(targets)))
    assert rows(got[0]) == rows(want[0])
    assert got[0].Z == want[0].Z == 20
    assert {hit.name for hit in got[0].reported} & planted[h.name]
