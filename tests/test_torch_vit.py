"""Stage 3 of the port, the Viterbi filter score
(``pyhmmer_tpu_torch.ops.vit_cuda``), against the JAX package's XLA scan
``ops.batch._viterbi_kernel`` and the float64 oracle ``ops.reference``,
within 0.05 nats, on padded widths on both sides of 384 and 768 and
with a ``need`` mask holding dead pairs; at Mk96 and at 16 and 32 slots
a lane also against the Pallas Viterbi kernel itself
(``vit_pallas._vit_pallas``, in interpret mode).  On the CPU the wrapper
runs the kernel's plain version over the packed tables."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# the Pallas Viterbi runs through the Pallas interpreter; the flag is
# read when the module is imported
os.environ["PYHMMER_TPU_PALLAS_INTERPRET"] = "1"
sys.modules.pop("pyhmmer_tpu.ops.vit_pallas", None)

from pyhmmer_tpu.ops import batch as JB  # noqa: E402
from pyhmmer_tpu.ops import reference as ref  # noqa: E402
from pyhmmer_tpu.ops import vit_pallas as VP  # noqa: E402
from pyhmmer_tpu.plan7.background import Background  # noqa: E402
from pyhmmer_tpu.plan7.profile import Profile  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch.ops import batch as TB  # noqa: E402
from pyhmmer_tpu_torch.ops import vit_cuda  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Background as TBackground  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Profile as TProfile  # noqa: E402
from test_torch_host import jax_hmm  # noqa: E402

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

STACKS = [((60, 200, 330), 352), ((400,), 416), ((700,), 736),
          ((790,), 800)]
N, LMAX, BAR = 36, 160, 0.05


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
    codes, lengths = syn.make_lanes(models, N, LMAX, seed=Mp + 2)
    jpb = JB.ProfileBatch(profs, Mp=Mp)
    jax_all = JB.viterbi_scores(jpb, codes, lengths)          # [P, N]
    tpb = TB.ProfileBatch(port_profiles(models), Mp=Mp)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code)
    rng = np.random.default_rng(Mp)
    rows = rng.permutation(N)[: N - 6]
    need = rng.random((len(Ms), len(rows))) < 0.7
    need[:, 0] = False                     # a column nobody needs
    out = vit_cuda.viterbi(tpb, dev, torch.from_numpy(rows),
                           torch.from_numpy(need)).numpy()
    return SimpleNamespace(models=models, hmms=hmms, bg=bg, codes=codes, lengths=lengths,
                           rows=rows, need=need, out=out,
                           jax=jax_all[:, rows], dev=dev)


def test_dead_pairs_read_negmass(case):
    assert (case.out[~case.need] == TB.NEGMASS).all()
    assert case.need.sum() > 10


def test_matches_xla_viterbi_scan(case):
    live = case.need & (case.jax > -1e29)
    assert np.array_equal(case.out > -1e29, live)
    err = np.abs(case.out - case.jax)[live]
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
            want = ref.viterbi_score(prof, case.codes[b, :L])
            assert abs(case.out[pi, col] - want) < BAR, (pi, b)
            checked += 1
    assert checked >= 3


def test_no_needed_pair_is_a_no_op(case):
    tpb = TB.ProfileBatch(port_profiles(case.models))
    rows = torch.arange(4)
    need = torch.zeros((tpb.P, 4), dtype=torch.bool)
    out = vit_cuda.viterbi(tpb, case.dev, rows, need)
    assert out.shape == (tpb.P, 4) and (out == TB.NEGMASS).all()


@pytest.mark.parametrize("Ms,Mp", [((50, 70, 90), 96), ((480,), 512),
                                   ((1000,), 1024)],
                         ids=["Mk96", "Mk512", "Mk1024"])
def test_matches_pallas_viterbi(Ms, Mp):
    """The JAX package's Pallas Viterbi kernel (``_vit_pallas``, run as
    ``tests/test_pallas_kernels.py`` runs it, through the interpreter, on
    one lane tile) and the plain version over the packed tables score
    the same lanes within 0.05 nats: at 3 slots a lane (transitions in
    registers on the card), 16 (the wide layout) and 32."""
    models = syn.sample_models(Ms, seed=Mp + 1)
    hmms = [jax_hmm(h) for h in models]
    aa = hmms[0].alphabet
    bg = Background(aa)
    profs = [Profile(h.M, aa).configure(h, bg, 400, multihit=True)
             for h in hmms]
    n, Lmax = 8, 72
    codes, lengths = syn.make_lanes(models, n, Lmax, seed=Mp + 4)
    t = VP.build_vit_tensors(JB.ProfileBatch(profs, Mp=Mp))
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code)
    lm = dev.lm.numpy().T.copy()
    want = np.asarray(VP._vit_pallas(
        lengths.astype(np.int32)[None, :], codes.T.astype(np.int32),
        t["msc"], t["isc"], t["tr"], lm,
        np.array([[Lmax]], dtype=np.int32)))
    tpb = TB.ProfileBatch(port_profiles(models), Mp=Mp)
    assert (tpb.S >= TB.VIT_WIDE_S) == (Mp >= 512)
    got = vit_cuda.viterbi(tpb, dev, torch.arange(n),
                           torch.ones((len(Ms), n), dtype=torch.bool)).numpy()
    live = want > -1e29
    assert np.array_equal(got > -1e29, live) and live.sum() >= n
    err = np.abs(got - want)[live]
    assert err.max() < BAR, err.max()
