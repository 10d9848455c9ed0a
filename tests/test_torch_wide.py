"""Models wider than the kernels' 4,096-slot stripes: the wide route of
the port (``ops/batch.py``: tables padded to a multiple of
``CTA_THREADS``, all thread-major, MSV's in 16-bit pairs;
``csrc/{msv,vit,fwd}.cu``: one CTA a pair) against the JAX package, on
the CPU, where the wrappers run the kernels' plain versions over the
wide tables.  At a padded width of 4,224 (Mk 4,608) and at the widths
where the MSV kernel's row leaves registers for shared memory, the MSV
``dx`` equals the XLA scan ``ops.batch._msv_kernel``'s on every pair
neither side flags, and ``ovf`` everywhere; Viterbi and Forward are
within 0.05 nats of ``_viterbi_kernel`` and ``_forward_kernel`` there
and at a width of each tier of the Forward and Viterbi kernels (the row
in registers, in shared memory, in a global scratch row).  The
thread-major tables give back the plain ones exactly.  An M 4,200
model's ``hmmsearch(device="cpu")`` reports the JAX engine's rows.
Every width up to 100,000 slots has a route, and the ladders, CTA sizes
and stripe widths ``ops/batch.py`` packs for are those ``csrc``
compiles."""

import os
import re

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
from pyhmmer_tpu_torch.ops import _build, _pairs
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import fwd_cuda, msv_cuda, vit_cuda
from pyhmmer_tpu_torch.plan7 import Background, Builder, Profile
from test_torch_host import jax_block, jax_hmm, rows

torch.set_num_threads(1)

M, MP, MK = 4200, 4224, 4608
#: lanes and their longest length of the kernel comparison
N, LMAX = 20, 160
BAR = 0.05


def wide_case(M, Mp, n, lmax):
    """(port model, port profile batch, JAX profile batch, lanes) of a
    sampled model of length ``M`` at the padded width ``Mp``."""
    h = syn.sample_models((M,), seed=17)[0]
    jh = jax_hmm(h)
    prof = Profile(M, h.alphabet).configure(h, Background(h.alphabet), 400,
                                            multihit=True)
    jprof = JProfile(M, jh.alphabet).configure(
        jh, JBackground(jh.alphabet), 400, multihit=True)
    codes, lengths = syn.make_lanes([h], n, lmax, seed=18)
    return (h, TB.ProfileBatch([prof], Mp=Mp), JB.ProfileBatch([jprof],
                                                                Mp=Mp),
            codes, lengths)


@pytest.fixture(scope="module")
def wide():
    """(port model, port profile batch, JAX profile batch, lanes) at Mp
    4,224."""
    return wide_case(M, MP, N, LMAX)


def test_tables_take_the_wide_route(wide):
    _, tpb, _, _, _ = wide
    assert (tpb.S, tpb.Mk) == (0, MK)
    # MSV's thread-major 16-bit pairs for 256 threads of 9 words (18
    # slots); Forward's and Viterbi's thread-major tables for 256 threads
    # of 18 slots; six dimensions mark both
    Kp = tpb.Kp
    assert tpb.msv_w16.dim() == 6
    assert tpb.msv_w16.shape == (1, Kp, 9, 8, 32, 2)
    assert TB.msv_cta_shape(MK) == (256, "registers")
    assert TB.cta_shape(MK) == (256, "registers")
    for name in ("fwd", "vit"):
        assert getattr(tpb, name + "_trans").dim() == 6
        assert getattr(tpb, name + "_trans").shape[1:] == (18, 2, 8, 32, 4)
        assert TB.packed_stripes(getattr(tpb, name + "_trans")) == 0
        assert TB.table_width(getattr(tpb, name + "_trans")) == MK


#: padded widths at each cut-off of the wide Forward and Viterbi kernels:
#: the register ladder's narrowest and widest (Mk 4,608 and 5,632), the
#: first width with the row in shared memory (Mk 6,144), the wide phmmer's
#: (9,024), the widest in shared memory (18,944), the first in a global
#: scratch row (Mk 19,456), the titin fragment's (35,008)
TIER_MP = {4097: "registers", 5632: "registers", 5633: "shared",
           9024: "shared", 18944: "shared", 18945: "global",
           35008: "global"}


@pytest.mark.parametrize("Mp", sorted(TIER_MP))
def test_thread_major_round_trip(Mp):
    """``packed`` then ``unpacked`` of the thread-major layout gives back
    the plain [P, Kp, Mk] emission and [P, 8, Mk] transition tables
    exactly, at the threads a CTA its tier takes."""
    Mk = TB.kernel_width(Mp)
    nt, tier = TB.cta_shape(Mk)
    assert tier == TIER_MP[Mp] and Mk % nt == 0
    rng = np.random.default_rng(Mp)
    em, ei = rng.random((2, 2, 3, Mk), dtype=np.float32)
    tr = rng.random((2, 8, Mk), dtype=np.float32)
    emis, trans = TB.packed(em, ei, tr, TB.FWD_WIDE_S)
    spt = Mk // nt
    assert emis.shape == (2, 3, spt, nt // 32, 32, 2)
    assert trans.shape == (2, spt, 2, nt // 32, 32, 4)
    # slot s of thread t = 32 w + l at position j = s - t * spt
    s = Mk - 1 - spt // 2
    t, j = divmod(s, spt)
    assert trans[1, j, 1, t // 32, t % 32, 3] == tr[1, 7, s]
    assert emis[1, 2, j, t // 32, t % 32, 0] == em[1, 2, s]
    back = TB.unpacked(torch.from_numpy(emis), torch.from_numpy(trans))
    for got, want in zip(back, (em, ei, tr)):
        assert torch.equal(got, torch.from_numpy(want))


#: padded widths at each cut-off of the wide MSV kernel's tiers: the
#: register ladder's narrowest and widest (Mk 4,608 and 12,288, 9 and 24
#: words a thread), the first width with the row in shared memory (Mk
#: 12,800) and the widest model (Mk 100,352)
MSV_TIER_MP = {4097: "registers", 12288: "registers", 12289: "shared",
               100_000: "shared"}


@pytest.mark.parametrize("Mp", sorted(MSV_TIER_MP))
def test_msv_thread_major_round_trip(Mp):
    """``msv_thread_major`` then ``msv_thread_minor`` gives back the [P,
    Kp, Mk] 16-bit table exactly, laid out as the MSV kernel of that
    tier reads it: word r of thread t holds slots r and r + R of t's
    run."""
    Mk = TB.kernel_width(Mp)
    nt, tier = TB.msv_cta_shape(Mk)
    assert tier == MSV_TIER_MP[Mp] and Mk % (2 * nt) == 0
    r = Mk // (2 * nt)
    assert (r in TB.MSV_CTA_REGS) == (tier == "registers")
    rng = np.random.default_rng(Mp)
    w = rng.integers(-255, 40, size=(2, 3, Mk)).astype(np.int16)
    t = TB.msv_thread_major(w, nt)
    assert t.shape == (2, 3, r, nt // 32, 32, 2)
    # slot s of thread th: word j % r, half j // r, j = s - th * 2r
    for s in (0, r, 2 * r - 1, Mk - 1 - r // 2, Mk - 1):
        th, j = divmod(s, 2 * r)
        assert t[1, 2, j % r, th // 32, th % 32, j // r] == w[1, 2, s]
    back = TB.msv_thread_minor(torch.from_numpy(np.ascontiguousarray(t)))
    assert torch.equal(back, torch.from_numpy(w))


#: each constant of ``ops/batch.py`` that mirrors one of the kernels'
#: sources: (source file, C name, macro of X(...) entries or a constexpr)
MIRRORED = {"MSV_CTA_REGS": ("msv.cu", "PYHMMER_MSV_CTA_REGS", "macro"),
            "MSV_CTA_THREADS": ("msv.cu", "MSV_CTA_THREADS", "int"),
            "CTA_REGS": ("common.cuh", "PYHMMER_CTA_REGS", "macro"),
            "CTA_THREADS": ("common.cuh", "CTA_THREADS", "int"),
            "STRIPES": ("common.cuh", "PYHMMER_STRIPES", "macro"),
            "FWD_WIDE_S": ("fwd.cu", "FWD_WIDE_S", "int"),
            "VIT_WIDE_S": ("vit.cu", "VIT_WIDE_S", "int")}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_batch_constants_match_the_sources(name):
    """The ladders, CTA sizes and stripe widths that ``ops/batch.py``
    lays the tables out for are the ones the launchers in ``csrc``
    compile and dispatch on."""
    fname, cname, kind = MIRRORED[name]
    with open(os.path.join(_build.CSRC, fname)) as fh:
        src = fh.read()
    if kind == "int":
        m = re.search(r"constexpr int %s = (\d+);" % cname, src)
        assert m and getattr(TB, name) == int(m.group(1))
        return
    m = re.search(r"#define %s\(X\)((?:[^\n]*\\\n)*[^\n]*)" % cname, src)
    assert m
    got = tuple(tuple(int(v) for v in e.split(",")) if "," in e
                else int(e)
                for e in re.findall(r"X\(([^)]*)\)", m.group(1)))
    assert got and getattr(TB, name) == got


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


#: the MSV comparison's widths besides Mp 4,224: the register ladder's
#: widest (Mk 12,288) and the first with the row in shared memory (Mk
#: 12,800), as (model length, Mp)
MSV_WIDTHS = {"Mk12288": (12200, 12288), "Mk12800": (12289, 12289)}


@pytest.mark.parametrize("width", sorted(MSV_WIDTHS))
def test_msv_tiers_match_xla_scan(width):
    """The MSV plain version over each tier's thread-major table against
    the JAX XLA scan: ``ovf`` identical, ``dx`` equal on every pair
    neither side flags."""
    M_, Mp = MSV_WIDTHS[width]
    h, tpb, jpb, codes, lengths = wide_case(M_, Mp, 10, 100)
    assert TB.msv_cta_shape(tpb.Mk)[1] == MSV_TIER_MP[
        {12288: 12288, 12289: 12289}[Mp]]
    dev = TB.SeqDevice(codes, lengths, h.alphabet.nonresidue_code)
    dx, ovf, _ = (t.numpy() for t in msv_cuda.msv(tpb, dev))
    jdev = JB.SeqDevice(codes, lengths)
    dx2, ovf2 = JB._msv_kernel(
        jdev.codes, jdev.mask_f,
        *jpb.device("msv_cost", "msv_bias", "msv_tec", "msv_tbm"),
        jdev.tjb, jpb.Kp)
    n = len(lengths)
    dx2, ovf2 = np.asarray(dx2)[:, :n], np.asarray(ovf2)[:, :n]
    np.testing.assert_array_equal(ovf > 0, ovf2)
    clean = ~ovf2
    assert clean.sum() >= n // 2 and (~clean).any()
    np.testing.assert_array_equal(dx[clean], dx2[clean])


#: the filter comparison's widths besides Mp 4,224 (the ``wide`` fixture):
#: (model length, Mp), the ladder's widest, the first shared-memory width
#: and the first global one, against fewer, shorter lanes
FILTER_WIDTHS = {"Mk5632": (5600, 5632), "Mk6144": (5633, 5633),
                 "Mk19456": (18900, 18945)}
FILTER_CASES = ([(name, None) for name in ("vit", "fwd")]
                + [(name, w) for w in FILTER_WIDTHS for name in ("vit",
                                                                 "fwd")])


@pytest.fixture(scope="module")
def wide_cases():
    """The ``FILTER_WIDTHS`` cases, built once each."""
    cache = {}

    def get(width):
        if width not in cache:
            M_, Mp = FILTER_WIDTHS[width]
            cache[width] = wide_case(M_, Mp, 10, 100)
        return cache[width]
    return get


@pytest.mark.parametrize(
    "name,width", FILTER_CASES,
    ids=[n if w is None else f"{n}-{w}" for n, w in FILTER_CASES])
def test_filter_matches_xla_scan(wide, wide_cases, name, width):
    h, tpb, jpb, codes, lengths = wide if width is None else \
        wide_cases(width)
    if width is not None:
        assert TB.cta_shape(tpb.Mk)[1] == TIER_MP[FILTER_WIDTHS[width][1]]
    n = len(lengths)
    dev = TB.SeqDevice(codes, lengths, h.alphabet.nonresidue_code)
    rng = np.random.default_rng(19)
    cols = rng.permutation(n)[:12]
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
    that the Forward, Viterbi and MSV wrappers' checks accept; each check
    refuses the width's tables laid out for another CTA size, or
    unstriped."""
    Mk = TB.kernel_width(Mp)
    assert TB.stripe_width(Mp) == 0 and Mk >= Mp
    assert Mk % TB.CTA_THREADS == 0 and Mk - Mp < TB.CTA_THREADS
    zeros = np.zeros((1, 2, Mk), dtype=np.float32)
    em, tr = (torch.from_numpy(a) for a in TB.packed(
        zeros, zeros, np.zeros((1, 8, Mk), dtype=np.float32),
        TB.FWD_WIDE_S))
    codes = torch.zeros((1, 4), dtype=torch.uint8)
    lens = torch.ones((1,), dtype=torch.int32)
    _pairs.check_packed(codes, lens, torch.zeros((1, 4)), em, tr,
                        TB.FWD_WIDE_S, {})
    flat = torch.zeros((1, 2, Mk), dtype=torch.int16)
    nt = TB.msv_cta_shape(Mk)[0]
    w16 = TB.msv_thread_major(flat, nt).contiguous()
    _pairs.check_tensors({"w16": (w16, torch.int16, None)}, w16)
    # MSV: the old unstriped [P, Kp, Mk] table, and one packed for 128
    # threads (every wide width splits into an even run for those)
    for bad in (flat, TB.msv_thread_major(flat, nt // 2).contiguous()):
        with pytest.raises(ValueError):
            _pairs.check_tensors({"w16": (bad, torch.int16, None)}, bad)
    other = 768 - TB.cta_shape(Mk)[0]          # 256 <-> 512 threads
    for bad_em, bad_tr in (
            (TB.thread_major(torch.zeros((1, 2, Mk, 2)).movedim(-1, 1),
                             other).movedim(1, -1),
             TB.thread_major(torch.zeros((1, 2, 4, Mk)), other
                             ).permute(0, 3, 1, 4, 5, 2)),
            (torch.zeros((1, 2, 2, Mk)), torch.zeros((1, 8, Mk)))):
        with pytest.raises(ValueError):
            _pairs.check_packed(codes, lens, torch.zeros((1, 4)),
                                bad_em.contiguous(), bad_tr.contiguous(),
                                TB.FWD_WIDE_S, {})


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
