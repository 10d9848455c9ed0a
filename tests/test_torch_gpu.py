"""The port's CUDA kernels against their plain PyTorch versions on the
card (MSV: ovf identical, dx exact on every pair the kernel does not
flag, biaslog within 1e-4 nats; Viterbi <= 1e-3 nats on every route of
its kernel; Forward <= 5e-3 nats on every route of its kernel; the survivor
rows' scores within 2e-3 nats and their decoded rows within the JAX
package's bars; the f32 summation order being the only difference);
``Builder.calibrate`` on the card against the CPU (MSV mu, tau and
lambda equal, Viterbi mu within 1e-3 bits), phmmer on the card
against the CPU (identical rows), the wide route (models over 4,096
slots; MSV also at nhmmer's longest gate rows and the widest model)
against the plain versions, nhmmer with its gates on the card
against the CPU's host path (identical rows), and the distribution
layer on one card: ``sharded_search`` in 4 shards against the
single-shot search (identical rows), ``ShardedCascade`` on a 2 x 2 mesh
against unsharded launches.
Marked ``gpu``: they skip where there is no CUDA device.  On the card,
where JAX is not installed, run them without the repository's
conftest::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import fwd_cuda, msv_cuda, rows_cuda, vit_cuda
from pyhmmer_tpu_torch.plan7 import Background, Profile

pytestmark = pytest.mark.gpu

STACKS = [((40, 100, 170), 192), ((800,), 832), ((1500,), 1536),
          ((2500,), 2560), ((4000,), 4096)]
VIT_TOL, FWD_TOL = 1e-3, 5e-3
#: rows widths 192 and 768 (the edge of the rows stage's eligibility)
ROWS_STACKS = [((40, 100, 170), 192), ((700,), 704)]
#: rows bars: scores (nats), then btot/etot/mocc after an f64 cumsum
#: (``tests/test_rows_pallas.py:111-116``)
ROWS_SC, ROWS_ATOL, ROWS_RTOL = 2e-3, 3e-4, 2e-3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=STACKS, ids=lambda s: f"Mp{s[1]}")
def case(cuda, request):
    Ms, Mp = request.param
    hmms = syn.sample_models(Ms, seed=Mp)
    aa = hmms[0].alphabet
    bg = Background(aa)
    profs = [Profile(h.M, aa).configure(h, bg, 400, multihit=True)
             for h in hmms]
    pb = TB.ProfileBatch(profs, Mp=Mp).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 96, 320, seed=Mp + 3)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    gen = torch.Generator().manual_seed(Mp)
    rows = torch.randperm(96, generator=gen)[:80].to(cuda)
    need = (torch.rand((len(Ms), 80), generator=gen) < 0.6).to(cuda)
    return SimpleNamespace(pb=pb, dev=dev, rows=rows, need=need)


def test_msv_kernel_matches_plain(case):
    pb, dev = case.pb, case.dev
    args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1)
    before = msv_cuda.launches
    dx, ovf, bl = msv_cuda.msv_scores(*args)
    assert msv_cuda.launches == before + 1
    dx2, ovf2, bl2 = msv_cuda.msv_plain(*args)
    torch.cuda.synchronize()
    assert_msv_matches(dx, ovf, dx2, ovf2)
    assert (bl - bl2).abs().max().item() <= 1e-4


def assert_msv_matches(dx, ovf, dx2, ovf2):
    """``ovf`` identical everywhere; ``dx`` exact where nothing flags the
    pair (the kernel's 16-bit cells may wrap only after ovf fired)."""
    assert torch.equal(ovf, ovf2)
    clean = ovf == 0
    assert torch.equal(dx[clean], dx2[clean])


@pytest.mark.parametrize("Ms,Mp", [((12, 30), 32), ((20, 50), 64),
                                   ((110, 120), 128), ((200, 250), 256)],
                         ids=["Mk32", "Mk64", "Mk128", "Mk256"])
def test_msv_narrow_widths(cuda, Ms, Mp):
    """The widths at which a warp scans more than one target (stripes of
    1, 2, 4 and 8 slots), on consensus, planted and edge-length lanes."""
    hmms = syn.sample_models(Ms, seed=Mp)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400)
                          for h in hmms], Mp=Mp).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 77, 300, seed=Mp + 7)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1)
    dx, ovf, bl = msv_cuda.msv_scores(*args)
    dx2, ovf2, bl2 = msv_cuda.msv_plain(*args)
    torch.cuda.synchronize()
    assert_msv_matches(dx, ovf, dx2, ovf2)
    assert bool(ovf2.any())
    assert (bl - bl2).abs().max().item() <= 1e-4


def test_msv_overflow_stack_and_long_lanes(cuda):
    """The overflow stack on consensus lanes (``make_lanes``) plus two
    lanes over 30,000 residues: tandem consensus repeats of the first
    model (ovf fires early, then the 16-bit cells run on past 32,767) and
    background residues (no overflow: dx exact over 30,500 rows)."""
    hmms = syn.sample_models((40, 100, 170), seed=192)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400)
                          for h in hmms], Mp=192).to(cuda)
    Lmax = 32768
    short, slens = syn.make_lanes(hmms, 62, 320, seed=195)
    codes = np.full((64, Lmax), aa.nonresidue_code, np.uint8)
    codes[:62, :320] = short
    rng = np.random.default_rng(196)
    cons = np.concatenate([syn.plant(hmms[0], rng, 1.0)] * 800)[:31000]
    codes[62, :31000] = cons
    f = np.asarray(bg.residue_frequencies, np.float64)
    codes[63, :30500] = rng.choice(len(f), size=30500, p=f / f.sum())
    lengths = np.concatenate([slens, [31000, 30500]])
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1)
    dx, ovf, bl = msv_cuda.msv_scores(*args)
    dx2, ovf2, bl2 = msv_cuda.msv_plain(*args)
    torch.cuda.synchronize()
    assert_msv_matches(dx, ovf, dx2, ovf2)
    assert bool(ovf2[:, :3].any()) and bool(ovf2[0, 62])
    assert not bool(ovf2[:, 63].any())
    bar = 0.25 * (2e-3 + 1e-6 * dev.lens.float().clamp(min=1))
    assert bool(((bl - bl2).abs() <= bar[None, :]).all())


@pytest.mark.parametrize("name", ["fwd", "vit"])
def test_survivor_kernels_match_plain(case, name):
    mod, fn, plain, tol, tabs = {
        "fwd": (fwd_cuda, fwd_cuda.fwd_scores, fwd_cuda.fwd_plain, FWD_TOL,
                ("fwd_emis", "fwd_trans")),
        "vit": (vit_cuda, vit_cuda.vit_scores, vit_cuda.vit_plain, VIT_TOL,
                ("vit_emis", "vit_trans"))}[name]
    dev = case.dev
    args = (dev.codes, dev.lens, dev.lm,
            *(getattr(case.pb, t) for t in tabs), case.rows, case.need)
    before = mod.launches
    k = fn(*args)
    assert mod.launches == before + 1
    p = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k[~case.need], p[~case.need])
    assert (k[~case.need] == TB.NEGMASS).all()
    live = case.need & (p > -1e29)
    assert torch.equal(k > -1e29, live)
    assert (k - p)[live].abs().max().item() <= tol


@pytest.mark.parametrize("Ms,Mp", [((12, 30), 32), ((20, 50, 60), 64),
                                   ((70, 90), 96), ((110, 120), 128),
                                   ((150, 170, 190), 192),
                                   ((200, 250), 256)],
                         ids=["Mk32", "Mk64", "Mk96", "Mk128", "Mk192",
                              "Mk256"])
def test_fwd_narrow_widths(cuda, Ms, Mp):
    """Narrow widths, 1 to 8 slots a lane (transitions held in
    registers), on 61 lanes of 1 to 500 residues with a random need
    mask."""
    hmms = syn.sample_models(Ms, seed=Mp + 11)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=Mp).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 61, 500, seed=Mp + 13)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    gen = torch.Generator().manual_seed(Mp)
    rows = torch.randperm(61, generator=gen).to(cuda)
    need = (torch.rand((len(Ms), 61), generator=gen) < 0.6).to(cuda)
    args = (dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans, rows,
            need)
    before = fwd_cuda.launches
    k = fwd_cuda.fwd_scores(*args)
    assert fwd_cuda.launches == before + 1
    p = fwd_cuda.fwd_plain(*args)
    torch.cuda.synchronize()
    assert (k[~need] == TB.NEGMASS).all()
    live = need & (p > -1e29)
    assert torch.equal(k > -1e29, live)
    assert (k - p)[live].abs().max().item() <= FWD_TOL


def test_fwd_long_narrow_lanes(cuda):
    """A narrow model (6 slots a lane) on lanes of 30,500 and 31,000
    background residues, one with a planted domain of each model, beside
    short lanes: the kernel's row-invariant terms and reciprocal do not
    drift from the plain version over 31,000 rows."""
    hmms = syn.sample_models((40, 100, 170), seed=192)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=192).to(cuda)
    short, slens = syn.make_lanes(hmms, 14, 320, seed=197)
    codes = np.full((16, 31000), aa.nonresidue_code, np.uint8)
    codes[:14, :320] = short
    rng = np.random.default_rng(198)
    f = np.asarray(bg.residue_frequencies, np.float64)
    codes[14:, :] = rng.choice(len(f), size=(2, 31000), p=f / f.sum())
    for k, h in enumerate(hmms):
        dom = syn.plant(h, rng, 0.5)
        codes[15, 9000 * k + 500: 9000 * k + 500 + len(dom)] = dom
    lengths = np.concatenate([slens, [30500, 31000]])
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    rows = torch.arange(16, device=cuda)
    need = torch.ones((3, 16), dtype=torch.bool, device=cuda)
    args = (dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans, rows,
            need)
    k = fwd_cuda.fwd_scores(*args)
    p = fwd_cuda.fwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k > -1e29, p > -1e29)
    live = p > -1e29
    assert (k - p)[live].abs().max().item() <= FWD_TOL


def assert_fwd_matches_plain(pb, dev, rows, need):
    """``fwd_scores`` against ``fwd_plain`` within ``FWD_TOL``; pairs
    outside ``need`` keep NEGMASS; the block route's launches are counted
    apart."""
    args = (dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans, rows,
            need)
    p = fwd_cuda.fwd_plain(*args)
    live = need & (p > -1e29)
    assert bool(live.any())
    before = (fwd_cuda.launches, fwd_cuda.launches_block)
    k = fwd_cuda.fwd_scores(*args)
    block = int(pb.S >= TB.FWD_WIDE_S)
    assert (fwd_cuda.launches, fwd_cuda.launches_block) == (
        before[0] + 1, before[1] + block)
    torch.cuda.synchronize()
    assert (k[~need] == TB.NEGMASS).all()
    assert torch.equal(k > -1e29, live)
    assert (k - p)[live].abs().max().item() <= FWD_TOL


def long_bucket(Ms, Mp, seed):
    """(profile batch, bucket) of a bucket of the 131072 ladder level, as
    the engine packs it: 14 short lanes, then lanes of 9,000 and 35,000
    background residues, the long one with a planted domain of each of
    the ``Ms`` models every 9,000 residues."""
    hmms = syn.sample_models(Ms, seed=seed)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=Mp).to("cuda")
    short, slens = syn.make_lanes(hmms, 14, 320, seed=seed + 2)
    codes = np.full((16, 131072), aa.nonresidue_code, np.uint8)
    codes[:14, :320] = short
    rng = np.random.default_rng(seed + 4)
    f = np.asarray(bg.residue_frequencies, np.float64)
    codes[14:, :35000] = rng.choice(len(f), size=(2, 35000), p=f / f.sum())
    for k, h in enumerate(hmms):
        dom = syn.plant(h, rng, 0.5)
        codes[15, 9000 * k + 500: 9000 * k + 500 + len(dom)] = dom
    codes[14, 9000:] = aa.nonresidue_code
    lengths = np.concatenate([slens, [9000, 35000]])
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device="cuda")
    return pb, dev


@pytest.mark.parametrize("Ms,Mp", [((40, 100, 170), 192), ((1000,), 1024)],
                         ids=["Mk192", "Mk1024"])
def test_fwd_long_bucket(cuda, Ms, Mp):
    """The Forward counterpart of :func:`test_vit_long_bucket`: lanes of
    9,000 and 35,000 residues, the long one with planted domains, beside
    short lanes, on the route of each width (at Mk1024 the block route,
    4 warps a pair): the row-invariant terms and the reciprocal do not
    drift from the plain version over 35,000 rows."""
    pb, dev = long_bucket(Ms, Mp, Mp + 41)
    rows = torch.arange(16, device=cuda)
    need = torch.ones((len(Ms), 16), dtype=torch.bool, device=cuda)
    need[0, 2] = False
    assert_fwd_matches_plain(pb, dev, rows, need)


@pytest.mark.parametrize("Ms,Mp", [((1000, 700), 1024), ((1400,), 1536),
                                   ((2000, 1900), 2048), ((3000,), 3072),
                                   ((4000, 3900), 4096)],
                         ids=["Mk1024", "Mk1536", "Mk2048", "Mk3072",
                              "Mk4096"])
def test_fwd_block_route_widths(cuda, Ms, Mp):
    """The block route at every width it compiles for (32, 48, 64, 96 and
    128 slots a lane: 4, 6, 8, 8 and 8 warps a pair, the transitions in
    registers up to 8 slots a thread), on 61 lanes of 1 to 500 residues
    with a random need mask."""
    hmms = syn.sample_models(Ms, seed=Mp + 51)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=Mp).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 61, 500, seed=Mp + 53)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    gen = torch.Generator().manual_seed(Mp)
    rows = torch.randperm(61, generator=gen).to(cuda)
    need = (torch.rand((len(Ms), 61), generator=gen) < 0.6).to(cuda)
    assert_fwd_matches_plain(pb, dev, rows, need)


def test_fwd_width_not_compiled_raises(cuda):
    """``fwd_launch`` refuses a stripe width it has no instance for (0,
    the wide route's, and widths outside ``STRIPES``) before it touches
    a pointer, and ``fwd_block_warps`` gives the block route's warps a
    pair only where it is compiled: nothing falls back."""
    from pyhmmer_tpu_torch.ops import _build
    lib = _build.lib()
    for S in (0, 40, 256):
        err = lib.fwd_launch(None, 1, None, None, None, None, None, None,
                             None, 1, 29, S, None, None)
        with pytest.raises(RuntimeError, match="fwd_launch"):
            _build.check(err, "fwd_launch")
        assert lib.fwd_block_warps(S) == 0
    warps = {S: lib.fwd_block_warps(S) for S in TB.STRIPES}
    assert warps == {**{S: 0 for S in TB.STRIPES if S < TB.FWD_WIDE_S},
                     32: 4, 48: 6, 64: 8, 96: 8, 128: 8}


def vit_routes(S):
    """The Viterbi kernel's routes that compile at stripe width ``S``
    (``csrc/vit.cu:launch_vit``)."""
    return [r for r, ok in (("warp", S <= 24),
                            ("block", S >= TB.VIT_WIDE_S)) if ok]


def assert_vit_routes_match_plain(pb, dev, rows, need):
    """Every route of the Viterbi kernel at ``pb``'s width, and the
    default (``vit_scores``), against ``vit_plain`` within ``VIT_TOL``;
    pairs outside ``need`` keep NEGMASS."""
    args = (dev.codes, dev.lens, dev.lm, pb.vit_emis, pb.vit_trans, rows,
            need)
    p = vit_cuda.vit_plain(*args)
    live = need & (p > -1e29)
    assert bool(live.any())
    for route in ["auto", *vit_routes(pb.S)]:
        before = vit_cuda.launches
        k = (vit_cuda.vit_scores(*args) if route == "auto"
             else vit_cuda._scores(*args, None, route))
        assert vit_cuda.launches == before + 1
        torch.cuda.synchronize()
        assert (k[~need] == TB.NEGMASS).all(), route
        assert torch.equal(k > -1e29, live), route
        assert (k - p)[live].abs().max().item() <= VIT_TOL, route


@pytest.mark.parametrize("Ms,Mp", [((12, 30), 32), ((20, 50, 60), 64),
                                   ((70, 90), 96), ((150, 170, 190), 192),
                                   ((200, 250), 256), ((300, 380), 384),
                                   ((420, 500), 512), ((700, 760), 768)],
                         ids=["Mk32", "Mk64", "Mk96", "Mk192", "Mk256",
                              "Mk384", "Mk512", "Mk768"])
def test_vit_routes_match_plain(cuda, Ms, Mp):
    """The Viterbi kernel's code paths: one warp a pair with the
    transitions in registers (up to 8 slots a lane), with the next row's
    emissions loaded ahead (up to 16), and the block route (several warps
    a pair, from 16, where the default takes it for a launch that fits
    the card at once), on 61 lanes of 1 to 500 residues with a random
    need mask."""
    hmms = syn.sample_models(Ms, seed=Mp + 21)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=Mp).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 61, 500, seed=Mp + 23)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    gen = torch.Generator().manual_seed(Mp)
    rows = torch.randperm(61, generator=gen).to(cuda)
    need = (torch.rand((len(Ms), 61), generator=gen) < 0.6).to(cuda)
    assert_vit_routes_match_plain(pb, dev, rows, need)


@pytest.mark.parametrize("Ms,Mp", [((40, 100, 170), 192), ((1000,), 1024)],
                         ids=["Mk192", "Mk1024"])
def test_vit_long_bucket(cuda, Ms, Mp):
    """A bucket of the 131072 ladder level, as the engine packs it: lanes
    of 9,000 and 35,000 background residues, the long one with a planted
    domain of each model, beside short lanes, on every route (at Mk1024
    the block route with 4 warps a pair)."""
    hmms = syn.sample_models(Ms, seed=Mp + 31)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=Mp).to(cuda)
    short, slens = syn.make_lanes(hmms, 14, 320, seed=Mp + 33)
    codes = np.full((16, 131072), aa.nonresidue_code, np.uint8)
    codes[:14, :320] = short
    rng = np.random.default_rng(Mp + 35)
    f = np.asarray(bg.residue_frequencies, np.float64)
    codes[14:, :35000] = rng.choice(len(f), size=(2, 35000), p=f / f.sum())
    for k, h in enumerate(hmms):
        dom = syn.plant(h, rng, 0.5)
        codes[15, 9000 * k + 500: 9000 * k + 500 + len(dom)] = dom
    codes[14, 9000:] = aa.nonresidue_code
    lengths = np.concatenate([slens, [9000, 35000]])
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    rows = torch.arange(16, device=cuda)
    need = torch.ones((len(Ms), 16), dtype=torch.bool, device=cuda)
    need[0, 2] = False
    assert_vit_routes_match_plain(pb, dev, rows, need)


def test_vit_route_not_compiled_raises(case):
    """A route that does not compile at the width raises; nothing falls
    back."""
    pb, dev = case.pb, case.dev
    missing = [r for r in vit_cuda.ROUTES
               if r not in vit_routes(pb.S) + ["auto"]]
    for route in missing:
        with pytest.raises(RuntimeError, match="vit_launch"):
            vit_cuda._scores(dev.codes, dev.lens, dev.lm, pb.vit_emis,
                             pb.vit_trans, case.rows, case.need, None,
                             route)


def test_wrapper_rejects_mixed_devices(case):
    pb, dev = case.pb, case.dev
    with pytest.raises(ValueError):
        msv_cuda.msv_scores(dev.codes, dev.lens.cpu(), pb.msv_w16,
                            pb.msv_scal, pb.msv_odds, dev.tjb, dev.p1)
    with pytest.raises(ValueError):
        vit_cuda.vit_scores(dev.codes, dev.lens, dev.lm, pb.vit_emis,
                            pb.vit_trans, case.rows.cpu(), case.need)


def test_engine_on_cuda_launches_the_kernels(cuda, monkeypatch):
    """A small search on the card with every bias survivor on the device
    cascade goes through the MSV and Forward kernels."""
    import pyhmmer_tpu_torch as pt
    for name, value in (("SPECULATE_P1B", -1.0), ("HOST_MIN_PAIRS", 0),
                        ("HOST_PAIRS_PER_ROW", 0.0)):
        monkeypatch.setattr(pt.engine, name, value)
    models = syn.smoke_models()[-4:]
    targets, _ = syn.make_targets(models, 120, seed=4)
    eng = pt.SearchEngine(models[0].alphabet, device=cuda)
    before = [m.launches for m in (msv_cuda, fwd_cuda, vit_cuda)]
    res = eng.search(models, targets)
    after = [m.launches for m in (msv_cuda, fwd_cuda, vit_cuda)]
    assert all(th.reported for th in res)
    assert after[0] > before[0] and after[1] > before[1]
    assert np.isfinite([h.score for th in res for h in th.reported]).all()


@pytest.fixture(scope="module", params=ROWS_STACKS,
                ids=lambda s: f"Mp{s[1]}")
def rows_case(cuda, request):
    """Every profile against 48 lanes of length <= 640 (consensus and
    planted lanes, nonresidue codes inside targets, 8-row edges)."""
    Ms, Mp = request.param
    hmms = syn.sample_models(Ms, seed=Mp)
    aa = hmms[0].alphabet
    bg = Background(aa)
    profs = [Profile(h.M, aa).configure(h, bg, 400, multihit=True)
             for h in hmms]
    pb = TB.ProfileBatch(profs, Mp=Mp).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 48, 640, seed=Mp + 5)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    n = len(Ms) * 48
    pair_p = torch.arange(n, dtype=torch.int32, device=cuda) // 48
    pair_row = torch.arange(n, dtype=torch.int32, device=cuda) % 48
    return SimpleNamespace(pb=pb, dev=dev, lengths=lengths,
                           pair_row=pair_row.cpu().numpy(),
                           args=(dev.codes, dev.lens, dev.lm, pb.fwd_emis,
                                 pb.fwd_trans, pair_p, pair_row))


def rows_routes(S):
    """The rows kernels' routes that compile at stripe width ``S``
    (``csrc/rows.cu:launch_rows``)."""
    return ["warp"] + (["block"] if S >= 12 else [])


def assert_rows_match_plain(args, lengths, pair_row, route):
    """The rows kernels on ``route`` (``auto``: ``rows_scores``) against
    ``rows_plain``: finite, scores within ``ROWS_SC`` nats, the decoded
    rows within the JAX package's bars, zero past each pair's length."""
    before = rows_cuda.launches
    k = (rows_cuda.rows_scores(*args) if route == "auto"
         else rows_cuda._scores(*args, route))
    assert rows_cuda.launches == before + 1
    p = rows_cuda.rows_plain(*args)
    torch.cuda.synchronize()
    (kt, kf, kb), (pt, pf, pbk) = ([x.cpu().numpy() for x in r]
                                   for r in (k, p))
    assert np.isfinite(kt).all() and np.isfinite(kf).all(), route
    assert np.isfinite(kb).all(), route
    assert np.abs(kf - pf).max() <= ROWS_SC, route
    assert np.abs(kb - pbk).max() <= ROWS_SC, route
    assert np.abs(kf - kb).max() <= ROWS_SC, route
    for g, b in enumerate(pair_row):
        L = int(lengths[b])
        np.testing.assert_allclose(rows_cuda.ext_rows(kt[g], L),
                                   rows_cuda.ext_rows(pt[g], L),
                                   atol=ROWS_ATOL, rtol=ROWS_RTOL,
                                   err_msg=f"{route} pair {g} L {L}")
        assert (kt[g, L + 1:] == 0).all(), route


def test_rows_kernels_match_plain(rows_case):
    for route in ["auto", *rows_routes(rows_case.pb.S)]:
        assert_rows_match_plain(rows_case.args, rows_case.lengths,
                                rows_case.pair_row, route)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 6, 8, 12, 16, 24],
                         ids=lambda s: f"S{s}")
def test_rows_every_width_and_route(cuda, S):
    """Every stripe width the rows kernels compile (1 to 24 slots a lane,
    on both sides of the thresholds of the transitions in registers, the
    emissions loaded ahead and the block route) on every route, in one
    launch of each profile (one model of about the full width, one of
    about half) against 18 lanes whose lengths include 1, 31, 32, 33 and
    2048 (the 32-row blocks' edges and the rows stage's longest bucket),
    consensus and planted lanes and nonresidue codes inside targets."""
    Mp = 32 * S
    hmms = syn.sample_models((max(12, Mp - 12), max(10, Mp // 2)),
                             seed=Mp + 41)
    aa = hmms[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in hmms], Mp=Mp).to(cuda)
    assert pb.S == S
    codes, lengths = syn.make_lanes(hmms, 18, 2048, seed=Mp + 43)
    for i, L in zip((4, 5, 6), (31, 32, 33)):      # background lanes
        codes[i, L:] = aa.nonresidue_code
        lengths[i] = L
    assert {1, 31, 32, 33, 2048} <= set(lengths.tolist())
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    n = 2 * len(lengths)
    pair_p = torch.arange(n, dtype=torch.int32, device=cuda) // len(lengths)
    pair_row = torch.arange(n, dtype=torch.int32, device=cuda) % len(lengths)
    args = (dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans, pair_p,
            pair_row)
    for route in ["auto", *rows_routes(S)]:
        assert_rows_match_plain(args, lengths, pair_row.cpu().numpy(),
                                route)


def test_rows_route_not_compiled_raises(cuda):
    """Below 12 slots a lane there is no block route: asking for it
    raises; nothing falls back."""
    hmms = syn.sample_models((60,), seed=5)
    aa = hmms[0].alphabet
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, Background(aa), 400)
                          for h in hmms], Mp=64).to(cuda)
    codes, lengths = syn.make_lanes(hmms, 8, 40, seed=6)
    dev = TB.SeqDevice(codes, lengths, device=cuda)
    pairs = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="rows_launch"):
        rows_cuda._scores(dev.codes, dev.lens, dev.lm, pb.fwd_emis,
                          pb.fwd_trans, pairs, pairs, "block")


def test_engine_rows_stage_on_cuda(cuda, monkeypatch):
    """A small search on the card with the cascade forced and the rows
    stage on goes through the rows kernel and reports what the rows-off
    search reports (scores within 2e-3 bits)."""
    import pyhmmer_tpu_torch as pt
    for name, value in (("SPECULATE_P1B", -1.0), ("HOST_MIN_PAIRS", 0),
                        ("HOST_PAIRS_PER_ROW", 0.0)):
        monkeypatch.setattr(pt.engine, name, value)
    models = syn.smoke_models()[-6:-2]
    targets, _ = syn.make_targets(models, 120, seed=4)
    off = pt.SearchEngine(models[0].alphabet, device=cuda).search(
        models, targets)
    eng = pt.SearchEngine(models[0].alphabet, device=cuda, device_rows=True)
    before = rows_cuda.launches
    on = eng.search(models, targets)
    assert rows_cuda.launches > before
    assert eng.last_timing.get("n_rows_ext", 0) > 0, eng.last_timing

    def hits(th):
        return [(h.name, h.included,
                 [(d.env_from, d.env_to) for d in h.domains])
                for h in th.reported]
    for a, b in zip(on, off):
        assert hits(a) == hits(b)
        for ha, hb in zip(a.reported, b.reported):
            assert abs(ha.score - hb.score) < 2e-3
            assert abs(ha.bias - hb.bias) < 2e-3


@pytest.mark.parametrize("M", [50, 300, 700, 1500])
def test_calibrate_on_card_matches_cpu(cuda, M):
    """``Builder.calibrate`` on the card (one MSV and one Viterbi launch,
    P = 1 x 200 lanes, the Viterbi loop cost zeroed) against the same on
    the CPU (the plain versions): MSV mu, tau and lambda equal as
    float32, Viterbi mu within 1e-3 bits."""
    from pyhmmer_tpu_torch.plan7 import Builder
    h = syn.sample_models((M,), seed=M)[0]
    aa = h.alphabet
    on_card, on_cpu = h.copy(), h.copy()
    before = (msv_cuda.launches, vit_cuda.launches, fwd_cuda.launches)
    Builder(aa, device=cuda).calibrate(on_card, Background(aa))
    after = (msv_cuda.launches, vit_cuda.launches, fwd_cuda.launches)
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1
    Builder(aa, device="cpu").calibrate(on_cpu, Background(aa))
    got = np.asarray(on_card.evparam, np.float32)
    want = np.asarray(on_cpu.evparam, np.float32)
    np.testing.assert_array_equal(got[[0, 1, 3, 4, 5]], want[[0, 1, 3, 4, 5]])
    assert abs(float(got[2]) - float(want[2])) <= 1e-3


def test_phmmer_on_card_matches_cpu(cuda):
    """phmmer of two planted targets against a small block: the same
    reported rows on the card and on the CPU."""
    import pyhmmer_tpu_torch as pt
    models = syn.smoke_models()[2:4]
    targets, planted = syn.make_targets(models, 200, seed=5)
    by_name = {s.name: s for s in targets}
    queries = [by_name[sorted(planted[h.name])[0]] for h in models]

    def rows(th):
        return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
                 h.included, len(h.domains)) for h in th.reported]
    on_card = list(pt.phmmer(queries, targets, device=cuda))
    on_cpu = list(pt.phmmer(queries, targets, device="cpu"))
    assert [rows(th) for th in on_card] == [rows(th) for th in on_cpu]
    for q, th in zip(queries, on_card):
        assert th.reported[0].name == q.name


@pytest.mark.parametrize("M", [4200, 5600, 9000, 18900])
def test_wide_route_matches_plain(cuda, M):
    """Models over 4,096 slots (one CTA a pair): MSV at the narrow
    kernel's bar (``assert_msv_matches``: the wide kernel's cells are
    16-bit too) with some pair flagged, biaslog within 1e-4 nats,
    Viterbi and Forward within their bars, with the Forward and Viterbi
    row in registers (M 4,200, and
    5,600 at the top of the ladder), in shared memory (9,000) and in a
    global scratch row (18,900); MSV's row is in registers at every one
    of these widths but the last (Mk 18,944: shared memory)."""
    h = syn.sample_models((M,), seed=M + 1)[0]
    aa = h.alphabet
    pb = TB.ProfileBatch([Profile(M, aa).configure(h, Background(aa), 400,
                                                  multihit=True)],
                         Mp=TB.round_up(M, 32)).to(cuda)
    assert pb.S == 0
    codes, lengths = syn.make_lanes([h], 40, 300, seed=M + 2)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1)
    before = msv_cuda.launches
    dx, ovf, bl = msv_cuda.msv_scores(*args)
    assert msv_cuda.launches == before + 1
    dx2, ovf2, bl2 = msv_cuda.msv_plain(*args)
    assert_msv_matches(dx, ovf, dx2, ovf2)
    assert bool(ovf.any()) and (bl - bl2).abs().max().item() <= 1e-4
    rows = torch.arange(0, 40, 2, device=cuda)
    need = torch.ones((1, 20), dtype=torch.bool, device=cuda)
    for fn, plain, emis, trans, tol in (
            (fwd_cuda.fwd_scores, fwd_cuda.fwd_plain, pb.fwd_emis,
             pb.fwd_trans, FWD_TOL),
            (vit_cuda.vit_scores, vit_cuda.vit_plain, pb.vit_emis,
             pb.vit_trans, VIT_TOL)):
        a = (dev.codes, dev.lens, dev.lm, emis, trans, rows, need)
        k, p = fn(*a), plain(*a)
        assert (k - p).abs().max().item() <= tol


def wide_msv_case(name, cuda):
    """(profile batch, bucket) on the card of the wide MSV kernel's
    extremes: nhmmer's largest gate launch (an AT-rich DNA model of M
    5,000, Mk 5,120, the row in registers, against 4 subwindows of
    18,632 residues, one with a consensus copy, one with a mutated copy
    and one with an AT-rich stretch of 300 residues, so that the bias
    filter scores well away from 0), or the widest model the port
    accepts (M 100,000, Mk 100,352, the row in shared memory, 200,704
    bytes) against consensus, planted and background lanes."""
    if name == "nhmmer-gate":
        h = syn.sample_dna_models((5000,), seed=5001)[0]
        at_rich = np.array([0.4, 0.1, 0.1, 0.4])
        h.mat[1:] = 0.75 * h.mat[1:] + 0.25 * at_rich
        rng = np.random.default_rng(5002)
        f = np.full(4, 0.25)
        codes = rng.choice(4, size=(4, 18632), p=f).astype(np.uint8)
        for lane, cons in ((1, 1.0), (2, 0.85)):
            copy = syn.plant(h, rng, cons)
            codes[lane, 3000:3000 + len(copy)] = copy
        codes[3, 9000:9300] = rng.choice(4, size=300, p=at_rich)
        lengths = np.full(4, 18632)
    else:
        h = syn.sample_models((100_000,), seed=100_001)[0]
        codes, lengths = syn.make_lanes([h], 12, 400, seed=100_002)
    aa = h.alphabet
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(
        h, Background(aa), 400, multihit=True)],
        Mp=TB.round_up(h.M, 32)).to(cuda)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code,
                       device=cuda)
    return pb, dev


@pytest.mark.parametrize("name", ["nhmmer-gate", "M100000"])
def test_wide_msv_extremes(cuda, name):
    """The wide MSV kernel at its longest rows and its widest model:
    ``assert_msv_matches`` with some pair flagged, biaslog within the
    JAX package's bar for the fused bias filter, 0.25 (2e-3 + 1e-6 L)
    nats (``tests/test_pallas_kernels.py``; f32 sums over up to 18,632
    rows); at nhmmer's gate some lane's biaslog is over ten times that
    bar, so a bias kernel that returned zeros would fail."""
    pb, dev = wide_msv_case(name, cuda)
    tier = TB.msv_cta_shape(pb.Mk)[1]
    assert tier == {"nhmmer-gate": "registers", "M100000": "shared"}[name]
    args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1)
    before = msv_cuda.launches_wide
    dx, ovf, bl = msv_cuda.msv_scores(*args)
    assert msv_cuda.launches_wide == before + 1
    dx2, ovf2, bl2 = msv_cuda.msv_plain(*args)
    torch.cuda.synchronize()
    assert_msv_matches(dx, ovf, dx2, ovf2)
    assert bool(ovf.any()) and bool((ovf == 0).any())
    bar = 0.25 * (2e-3 + 1e-6 * dev.lens.float())
    assert bool(((bl - bl2).abs() <= bar[None, :]).all())
    if name == "nhmmer-gate":
        assert bool((bl2.abs() > 10 * bar[None, :]).any())


def test_nhmmer_on_card_matches_cpu(cuda, monkeypatch):
    """nhmmer with its gates on the card (forced) against the CPU's host
    path: the same rows."""
    import pyhmmer_tpu_torch as pt
    from pyhmmer_tpu_torch.plan7 import Builder
    models = syn.sample_dna_models((150, 300), seed=3)
    bld = Builder(models[0].alphabet, device=cuda)
    for h in models:
        bld.calibrate(h, Background(h.alphabet))
    genome, _ = syn.make_genome(models, 2, 60_000, 2, seed=4)

    def rows(th):
        return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
                 h.best_domain.env_from, h.best_domain.env_to)
                for h in th.reported]
    monkeypatch.setenv("PYHMMER_TPU_NHMMER_DEVICE", "force")
    before = (msv_cuda.launches, vit_cuda.launches, fwd_cuda.launches)
    on_card = list(pt.nhmmer(models, genome, device=cuda))
    after = (msv_cuda.launches, vit_cuda.launches, fwd_cuda.launches)
    assert all(a > b for a, b in zip(after, before))
    monkeypatch.setenv("PYHMMER_TPU_NHMMER_DEVICE", "0")
    on_cpu = list(pt.nhmmer(models, genome, device="cpu"))
    assert [rows(th) for th in on_card] == [rows(th) for th in on_cpu]
    assert all(th.reported for th in on_card)


def test_sharded_search_on_card_matches_single_shot(cuda):
    """``sharded_search`` in 4 shards on one card (threads enqueueing on
    its default stream) against the single-shot ``hmmsearch`` on the
    card: the same rows and Z, every kernel of the path launched."""
    import pyhmmer_tpu_torch as pt
    from pyhmmer_tpu_torch.parallel import mesh

    def rows(th):
        return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
                 h.included, len(h.domains)) for h in th.reported]
    models = syn.smoke_models()[:6]
    targets, _ = syn.make_targets(models, 400, seed=61)
    single = list(pt.hmmsearch(models, targets, device=cuda))
    before = (msv_cuda.launches, fwd_cuda.launches)
    got = mesh.sharded_search(models, targets, n_shards=4,
                              devices=[cuda] * 4)
    after = (msv_cuda.launches, fwd_cuda.launches)
    assert all(a > b for a, b in zip(after, before))
    assert mesh.sharded_search.last_stats["n_shards"] == 4
    assert [rows(th) for th in got] == [rows(th) for th in single]
    assert [th.Z for th in got] == [th.Z for th in single]


def test_sharded_cascade_on_card_matches_unsharded(cuda):
    """``ShardedCascade`` on a 2 x 2 mesh over one card against one
    unsharded MSV and Forward launch: dx and ovf identical, n_pass
    equal, Forward within the kernel's bar."""
    from pyhmmer_tpu_torch.ops import _pairs
    from pyhmmer_tpu_torch.parallel import mesh
    models = syn.sample_models((40, 90, 150), seed=62)
    aa = models[0].alphabet
    bg = Background(aa)
    pb = TB.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                     multihit=True)
                          for h in models], Mp=160)
    codes, lengths = syn.make_lanes(models, 61, 300, seed=63)
    casc = mesh.ShardedCascade(mesh.make_mesh(2, 2, devices=[cuda] * 4))
    usc, ovf, n_pass = casc.msv(pb, codes, lengths)
    fwd = casc.forward(pb, codes, lengths)
    pbc = pb.to(cuda)
    dev = TB.SeqDevice(codes, lengths, device=cuda)
    dx, o, _ = msv_cuda.msv(pbc, dev)
    want = TB.msv_nats(dx.cpu().numpy(), o.cpu().numpy(), dev.tjbu_host,
                       pb.scale_b)
    np.testing.assert_array_equal(ovf, o.cpu().numpy() > 0)
    np.testing.assert_array_equal(usc, want)
    assert n_pass == int(((dx > 0) & (o == 0)).sum())
    rows = np.arange(dev.B, dtype=np.int64)
    need = np.ones((pb.P, dev.B), dtype=bool)
    f = fwd_cuda.forward(pbc, dev, torch.as_tensor(rows, device=cuda),
                         torch.as_tensor(need, device=cuda),
                         torch.as_tensor(_pairs.host_pairs(rows, need),
                                         device=cuda)).cpu().numpy()
    assert np.abs(fwd - f).max() <= FWD_TOL
