"""Stage 2 of the port, the Forward filter score
(``pyhmmer_tpu_torch.ops.fwd_cuda``), against the JAX package's XLA scan
``ops.batch._forward_kernel`` and the float64 oracle ``ops.reference``,
within 0.05 nats, on padded widths on both sides of 384 and 768 (the
JAX engine's Forward routes) and with a ``need`` mask holding dead
pairs; on the two narrower stacks also against the v1 Pallas Forward
(``fwd_pallas._fwd_pallas``, in interpret mode).  On the CPU the wrapper
runs the kernel's plain version."""

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
from pyhmmer_tpu_torch.ops import fwd_cuda  # noqa: E402
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
    jax_all = JB.forward_scores(jpb, codes, lengths)          # [P, N]
    tpb = TB.ProfileBatch(port_profiles(models), Mp=Mp)
    dev = TB.SeqDevice(codes, lengths, nonres_code=aa.nonresidue_code)
    rng = np.random.default_rng(Mp)
    rows = rng.permutation(N)[: N - 6]
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
