"""Stage 3 of the port, the Viterbi filter score
(``pyhmmer_tpu_torch.ops.vit_cuda``), against the JAX package's XLA scan
``ops.batch._viterbi_kernel`` and the float64 oracle ``ops.reference``,
within 0.05 nats, on padded widths on both sides of 384 and 768 and
with a ``need`` mask holding dead pairs.  On the CPU the wrapper runs
the kernel's plain version."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pyhmmer_tpu.ops import batch as JB
from pyhmmer_tpu.ops import reference as ref
from pyhmmer_tpu.plan7.background import Background
from pyhmmer_tpu.plan7.profile import Profile
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import vit_cuda
from pyhmmer_tpu_torch.plan7 import Background as TBackground
from pyhmmer_tpu_torch.plan7 import Profile as TProfile
from test_torch_host import jax_hmm

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
