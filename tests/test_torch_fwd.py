"""Stage 2 of the port, the Forward filter score
(``pyhmmer_tpu_torch.ops.fwd_cuda``), against the JAX package's XLA scan
``ops.batch._forward_kernel`` and the float64 oracle ``ops.reference``,
within 0.05 nats, on padded widths on both sides of 384 and 768 (the
JAX engine's Forward routes) and at 48 and 128 slots a lane (the CUDA
kernel's block route; fewer, shorter lanes), with a ``need`` mask
holding dead pairs; on the two narrower stacks also against the v1 Pallas Forward
(``fwd_pallas._fwd_pallas``, in interpret mode).  The same bars hold on
narrow widths (2 to 16 slots a lane, on both sides of the kernel's
register thresholds) against lanes of 20 to 500 residues.  On the CPU
the wrapper runs the kernel's plain version over the packed tables;
the pair list puts every score in its place."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# the v1 Pallas Forward runs through the Pallas interpreter; the flag is
# read when the module is imported
os.environ["PYHMMER_TPU_PALLAS_INTERPRET"] = "1"
sys.modules.pop("pyhmmer_tpu.ops.fwd_pallas", None)

from pyhmmer_tpu.ops import batch as JB  # noqa: E402
from pyhmmer_tpu.ops import reference as ref  # noqa: E402
from pyhmmer_tpu.plan7.background import Background  # noqa: E402
from pyhmmer_tpu.plan7.profile import Profile  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch.ops import batch as TB  # noqa: E402
from pyhmmer_tpu_torch.ops import _pairs, fwd_cuda  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Background as TBackground  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Profile as TProfile  # noqa: E402
from test_torch_batch import odds_tables  # noqa: E402
from test_torch_host import jax_hmm  # noqa: E402

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

STACKS = [((60, 200, 330), 352), ((400,), 416), ((700,), 736),
          ((790,), 800), ((1400,), 1536), ((4000,), 4096)]
N, LMAX, BAR = 36, 160, 0.05
#: the block route's widths (48 and 128 slots a lane) take fewer, shorter
#: lanes: (lanes, Lmax)
LANES = {1536: (30, 80), 4096: (30, 80)}
#: narrow widths: 2, 3, 4, 6, 8 and 16 slots a lane (the kernel keeps
#: the transitions in registers up to 8, prefetches emissions up to 16)
NARROW = [((40, 60), 64), ((70, 90), 96), ((100, 120), 128),
          ((150, 180), 192), ((200, 250), 256), ((400,), 416)]
NARROW_N = 14


def port_profiles(models):
    """The port's profiles of its own models."""
    bg = TBackground(models[0].alphabet)
    return [TProfile(h.M, h.alphabet).configure(h, bg, 400, multihit=True)
            for h in models]


@pytest.fixture(scope="module", params=STACKS, ids=lambda s: f"Mp{s[1]}")
def case(request):
    Ms, Mp = request.param
    models = syn.sample_models(Ms, seed=Mp)
    hmms = [jax_hmm(h) for h in models]
    aa = hmms[0].alphabet
    bg = Background(aa)
    profs = [Profile(h.M, aa).configure(h, bg, 400, multihit=True)
             for h in hmms]
    n, Lmax = LANES.get(Mp, (N, LMAX))
    codes, lengths = syn.make_lanes(models, n, Lmax, seed=Mp + 2)
    jpb = JB.ProfileBatch(profs, Mp=Mp)
    jax_all = JB.forward_scores(jpb, codes, lengths)          # [P, N]
    tpb = TB.ProfileBatch(port_profiles(models), Mp=Mp)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code)
    rng = np.random.default_rng(Mp)
    rows = rng.permutation(n)[: n - 6]
    need = rng.random((len(Ms), len(rows))) < 0.7
    need[:, 0] = False                     # a column nobody needs
    out = fwd_cuda.forward(tpb, dev, torch.from_numpy(rows),
                           torch.from_numpy(need)).numpy()
    return SimpleNamespace(models=models, hmms=hmms, bg=bg, codes=codes, lengths=lengths,
                           rows=rows, need=need, out=out,
                           jax=jax_all[:, rows], dev=dev, jpb=jpb)


def test_dead_pairs_read_negmass(case):
    assert (case.out[~case.need] == TB.NEGMASS).all()
    assert case.need.sum() > 10


def test_matches_xla_forward_scan(case):
    live = case.need & (case.jax > -1e29)
    assert np.array_equal(case.out > -1e29, live)
    err = np.abs(case.out - case.jax)[live]
    assert err.max() < BAR, err.max()


@pytest.mark.parametrize("case", STACKS[:2], indirect=True,
                         ids=lambda s: f"Mp{s[1]}")
def test_matches_v1_pallas_forward(case):
    """The v1 Pallas Forward (``_fwd_pallas``, which nothing in the JAX
    package calls; its D->D chain is a full [Mp, Mp] transfer matmul per
    row) on every lane: ``csrc/fwd.cu`` computes the same function."""
    from pyhmmer_tpu.ops import fwd_pallas as FP
    t = FP.build_fwd_tensors(case.jpb)
    v1 = np.asarray(FP._fwd_pallas(
        case.lengths.astype(np.int32)[None, :],
        case.codes.T.astype(np.int32), t["ems"], t["eis"], t["etr"],
        t["tdd"], FP.lm_rows(case.lengths)))[:, case.rows]
    live = case.need & (v1 > -1e29)
    assert np.array_equal(case.out > -1e29, live)
    err = np.abs(case.out - v1)[live]
    assert err.max() < BAR, err.max()


def test_matches_float64_oracle(case):
    checked = 0
    for pi, h in enumerate(case.hmms):
        for col in np.where(case.need[pi])[0][:4]:
            b = case.rows[col]
            if case.dev.has_nonres[b]:
                continue
            L = int(case.lengths[b])
            prof = Profile(h.M, h.alphabet).configure(h, case.bg, L)
            want = ref.forward(prof, case.codes[b, :L]).score
            assert abs(case.out[pi, col] - want) < BAR, (pi, b)
            checked += 1
    assert checked >= 3


def test_no_needed_pair_is_a_no_op(case):
    tpb = TB.ProfileBatch(port_profiles(case.models))
    rows = torch.arange(4)
    need = torch.zeros((tpb.P, 4), dtype=torch.bool)
    out = fwd_cuda.forward(tpb, case.dev, rows, need)
    assert out.shape == (tpb.P, 4) and (out == TB.NEGMASS).all()


def uneven_lanes(models, n, seed):
    """``n`` lanes of 20 to 500 background residues (Lmax 512), the first
    ones each holding a planted domain of one model."""
    aa = models[0].alphabet
    rng = np.random.default_rng(seed)
    f = np.asarray(TBackground(aa).residue_frequencies, np.float64)
    f = f / f.sum()
    lengths = rng.permutation(np.linspace(20, 500, n).astype(np.int64))
    codes = np.full((n, 512), aa.nonresidue_code, dtype=np.uint8)
    for j, h in enumerate(models):
        lengths[j] = min(500, max(lengths[j], h.M + 40))
    for i, L in enumerate(lengths):
        codes[i, :L] = rng.choice(len(f), size=int(L), p=f)
    for j, h in enumerate(models):
        dom = syn.plant(h, rng, 0.5)[: lengths[j] - 10]
        codes[j, 5: 5 + len(dom)] = dom
    return codes, lengths


@pytest.fixture(scope="module", params=NARROW, ids=lambda s: f"Mp{s[1]}")
def narrow(request):
    Ms, Mp = request.param
    models = syn.sample_models(Ms, seed=Mp + 1)
    hmms = [jax_hmm(h) for h in models]
    aa = hmms[0].alphabet
    bg = Background(aa)
    profs = [Profile(h.M, aa).configure(h, bg, 400, multihit=True)
             for h in hmms]
    codes, lengths = uneven_lanes(models, NARROW_N, seed=Mp)
    jax_all = JB.forward_scores(JB.ProfileBatch(profs, Mp=Mp), codes,
                                lengths)
    tpb = TB.ProfileBatch(port_profiles(models), Mp=Mp)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code)
    rng = np.random.default_rng(Mp + 3)
    rows = rng.permutation(NARROW_N)
    need = rng.random((len(Ms), NARROW_N)) < 0.7
    need[:, 1] = False                     # a column nobody needs
    need[0, 0] = True
    out = fwd_cuda.forward(tpb, dev, torch.from_numpy(rows),
                           torch.from_numpy(need)).numpy()
    return SimpleNamespace(hmms=hmms, bg=bg, codes=codes, lengths=lengths,
                           rows=rows, need=need, out=out, tpb=tpb,
                           jax=jax_all[:, rows])


def test_narrow_matches_xla_forward_scan(narrow):
    """The plain version over the packed tables against the JAX
    package's XLA scan; dead pairs read NEGMASS."""
    assert (narrow.out[~narrow.need] == TB.NEGMASS).all()
    live = narrow.need & (narrow.jax > -1e29)
    assert np.array_equal(narrow.out > -1e29, live)
    err = np.abs(narrow.out - narrow.jax)[live]
    assert err.max() < BAR, err.max()


def test_narrow_matches_float64_oracle(narrow):
    """The shortest, the longest and a planted lane of each profile
    against ``ops.reference.forward``."""
    lens = narrow.lengths[narrow.rows]
    checked = 0
    for pi, h in enumerate(narrow.hmms):
        cols = np.where(narrow.need[pi])[0]
        picks = {cols[np.argmin(lens[cols])], cols[np.argmax(lens[cols])]}
        picks |= set(cols[narrow.rows[cols] == pi])
        for col in picks:
            b = narrow.rows[col]
            L = int(narrow.lengths[b])
            prof = Profile(h.M, h.alphabet).configure(h, narrow.bg, L)
            want = ref.forward(prof, narrow.codes[b, :L]).score
            assert abs(narrow.out[pi, col] - want) < BAR, (pi, b)
            checked += 1
    assert checked >= 2 * len(narrow.hmms)


def test_packed_tables_hold_the_odds_tables(narrow):
    """``fwd_emis`` / ``fwd_trans`` hold the odds of the shared fields,
    packed: lane l holds slots l*S .. l*S+S-1, slot j's (M, I) odds of a
    residue side by side and its 8 transition odds in two planes of 4,
    each plane of a slot contiguous over the warp."""
    tpb = narrow.tpb
    P, Kp, S = tpb.fwd_emis.shape[:3]
    assert S == tpb.S == TB.packed_stripes(tpb.fwd_trans) < TB.FWD_WIDE_S
    assert tpb.fwd_emis.shape == (P, Kp, S, 32, 2)
    assert tpb.fwd_trans.shape == (P, S, 2, 32, 4)
    want = [torch.from_numpy(a) for a in odds_tables(tpb)]
    ems, eis, tr = TB.unpacked(tpb.fwd_emis, tpb.fwd_trans)
    for got, w in zip((ems, eis, tr), want):
        assert torch.equal(got, w)
    lane, j = 31, S - 1
    assert tpb.fwd_trans[0, j, 1, lane, 2] == want[2][0, 6, lane * S + j]
    assert tpb.fwd_trans[0, j, 0, lane, 3] == want[2][0, 3, lane * S + j]
    assert tpb.fwd_emis[0, 3, j, lane, 1] == want[1][0, 3, lane * S + j]


@pytest.mark.parametrize("case", STACKS[2:], indirect=True,
                         ids=lambda s: f"Mp{s[1]}")
def test_wide_tables_are_striped(case):
    """From ``FWD_WIDE_S`` slots a lane on (Mp 800 has 32) the packed
    tables hold the odds of the shared fields striped: the M then the I
    odds of a residue, and one table per transition."""
    tpb = TB.ProfileBatch(port_profiles(case.models), Mp=case.jpb.Mp)
    S = tpb.S
    assert (S >= TB.FWD_WIDE_S) == (case.jpb.Mp > 32 * 24)
    if S < TB.FWD_WIDE_S:
        assert tpb.fwd_trans.dim() == 5
        return
    P, Kp = tpb.P, tpb.Kp
    assert tpb.fwd_emis.shape == (P, Kp, 2, S, 32)
    em, ei, tr = (TB.striped(torch.from_numpy(a))
                  for a in odds_tables(tpb))
    assert torch.equal(tpb.fwd_emis[:, :, 0], em)
    assert torch.equal(tpb.fwd_emis[:, :, 1], ei)
    assert torch.equal(tpb.fwd_trans, tr)


def test_long_lane_matches_float64_oracle():
    """One lane of 35,000 residues (background, a planted domain every
    9,000) against a model of 1,000 match states at Mk 1,024 (the block
    route's width): the logs of the per-row scale factors, summed over
    35,000 rows, stay within 5e-3 nats of the f64 oracle (an f32 sum of
    them drifted 0.22 nats here)."""
    L, Mp = 35000, 1024
    models = syn.sample_models((1000,), seed=Mp + 7)
    aa = models[0].alphabet
    f = np.asarray(TBackground(aa).residue_frequencies, np.float64)
    rng = np.random.default_rng(Mp + 9)
    codes = rng.choice(len(f), size=(1, L), p=f / f.sum()).astype(np.uint8)
    for k in range(0, L - 2000, 9000):
        dom = syn.plant(models[0], rng, 0.5)
        codes[0, k + 500: k + 500 + len(dom)] = dom
    tpb = TB.ProfileBatch(port_profiles(models), Mp=Mp)
    assert tpb.S >= TB.FWD_WIDE_S
    dev = TB.SeqDevice(codes, np.array([L]), nonres_code=aa.nonresidue_code)
    out = fwd_cuda.forward(tpb, dev, torch.arange(1),
                           torch.ones((1, 1), dtype=torch.bool))
    h = jax_hmm(models[0])
    prof = Profile(h.M, h.alphabet).configure(h, Background(h.alphabet), L)
    want = ref.forward(prof, codes[0]).score
    assert abs(float(out[0, 0]) - want) < 5e-3, (float(out[0, 0]), want)


def test_pairs_keep_their_places():
    """Every needed (profile, column) appears once in the pair list, with
    its own profile, bucket row and output offset, so a score written
    through ``pair_out`` lands at (p, column) and the rest read
    NEGMASS."""
    rng = np.random.default_rng(7)
    P, B, n = 3, 40, 30
    rows = torch.from_numpy(rng.permutation(B)[:n].astype(np.int64))
    need = torch.from_numpy(rng.random((P, n)) < 0.5)
    need[:, 3] = False
    need[1] = False
    pair_p, pair_row, pair_out, out = _pairs.pairs(rows, need)
    flat = need.flatten().nonzero().flatten()
    assert torch.equal(pair_out.long(), flat)
    po = pair_out.long()
    assert torch.equal(pair_p.long(), po // n)
    assert torch.equal(pair_row.long(), rows[po % n])
    out.view(-1)[po] = po.float()
    want = torch.where(need, torch.arange(P * n).view(P, n).float(),
                       torch.tensor(TB.NEGMASS))
    assert torch.equal(out, want)
