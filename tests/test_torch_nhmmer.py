"""The port's nhmmer (``pyhmmer_tpu_torch.plan7.longtargets`` and
``hmmer.nhmmer``) against the JAX package's, on the CPU.

* The device gates, forced on both sides: the port's ``_device_gates``
  on the plain versions of its kernels, the JAX package's on its XLA
  scans (``PYHMMER_TPU_NHMMER_DEVICE=force``, Pallas interpretation
  off), over 300 subwindows of a sampled DNA model: the MSV scores
  equal, Viterbi and Forward within 0.05 nats, and both far inside
  ``DEVICE_GATE_MARGIN`` of the exact host scores.
* nhmmer end to end on a seeded genome of two 50 kb records with copies
  of two DNA models planted on both strands: an HMM query and a
  sequence query, from an in-memory block and from a streamed FASTA
  file; the reported rows (name, score, E-value, inclusion, domains,
  envelope, strand) equal the JAX package's, and the port's gates,
  forced through the plain versions, change nothing."""

import numpy as np
import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.easel.alphabet import Alphabet as JAlphabet
from pyhmmer_tpu.easel.seqfile import SequenceFile as JSequenceFile
from pyhmmer_tpu.easel.sequence import DigitalSequence as JSequence
from pyhmmer_tpu.plan7.longtargets import \
    LongTargetsPipeline as JLongTargetsPipeline
from pyhmmer_tpu.plan7.profile import Profile as JProfile
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import DigitalSequence, SequenceFile
from pyhmmer_tpu_torch.ops import native, reference
from pyhmmer_tpu_torch.ops.quantize import quantize_msv
from pyhmmer_tpu_torch.plan7 import (Background, Builder,
                                     LongTargetsPipeline, Profile)
from test_torch_host import jax_block, jax_hmm

torch.set_num_threads(1)

BAR = 0.05
ENV = "PYHMMER_TPU_NHMMER_DEVICE"


@pytest.fixture(scope="module")
def models():
    """Two sampled DNA models, calibrated on the plain versions (the
    JAX package's copies carry the same evparams)."""
    out = syn.sample_dna_models((120, 250), seed=31)
    bld = Builder(out[0].alphabet, device="cpu")
    for h in out:
        bld.calibrate(h, Background(h.alphabet))
    return out


@pytest.fixture(scope="module")
def genome(models):
    block, planted = syn.make_genome(models, 2, 50_000, 2, seed=32)
    assert {p[4] for p in planted} == {"+", "-"}
    return block, planted


def subwindows(alphabet, rng, n, lmin=40, lmax=220):
    pend = []
    for _ in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        sub = rng.integers(0, alphabet.K, L).astype(np.uint8)
        pend.append(dict(sub=sub, a=1, win_start=0, orig_len=L,
                         strand="+", seqidx=0, sq=None))
    return pend


def test_device_gates_match_jax(models, monkeypatch):
    """300 subwindows (the JAX package pads them to 384 lanes)."""
    monkeypatch.setenv(ENV, "force")
    monkeypatch.setenv("PYHMMER_TPU_PALLAS_INTERPRET", "0")
    h = models[1]
    jh = jax_hmm(h)
    pli = LongTargetsPipeline(h.alphabet, device="cpu")
    jpli = JLongTargetsPipeline(jh.alphabet)
    prof = Profile(h.M, h.alphabet).configure(h, pli.background, 400,
                                              multihit=True)
    jprof = JProfile(jh.M, jh.alphabet).configure(jh, jpli.background, 400,
                                                  multihit=True)
    pend = subwindows(h.alphabet, np.random.default_rng(33), 300)
    usc, vit, fwd = pli._device_gates(prof, pend)
    jusc, jvit, jfwd = jpli._device_gates(jprof, pend)
    assert usc.shape == vit.shape == fwd.shape == (300,)
    np.testing.assert_array_equal(usc, jusc)
    assert np.abs(vit - jvit).max() < BAR
    assert np.abs(fwd - jfwd).max() < BAR
    margin = LongTargetsPipeline.DEVICE_GATE_MARGIN
    q = quantize_msv(prof)
    for j in (0, 1, 17, 128, 255, 256, 299):
        sub = pend[j]["sub"]
        assert usc[j] == native.msv_quant(q, sub)
        prof.reconfig_length(len(sub))
        assert abs(vit[j] - native.viterbi_score(prof, sub)) < BAR * margin
        assert abs(fwd[j] - reference.forward(prof, sub).score) \
            < BAR * margin


def nh_rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains), h.best_domain.env_from,
             h.best_domain.env_to,
             "+" if h.best_domain.ali_from <= h.best_domain.ali_to
             else "-") for h in th.reported]


def write_fasta(path, block):
    with open(path, "w") as fh:
        for s in block:
            fh.write(">%s\n" % s.name.decode())
            text = s.alphabet.decode(s.sequence)
            for i in range(0, len(text), 80):
                fh.write(text[i: i + 80] + "\n")


@pytest.fixture(scope="module")
def seq_query(genome, models):
    """The first planted copy of the first model, read off the genome."""
    block, planted = genome
    _, rec, a, b, _ = next(p for p in planted if p[0] == models[0].name)
    s = next(x for x in block if x.name == rec).sequence[a - 1: b]
    return (DigitalSequence(block.alphabet, name=b"copy", sequence=s),
            JSequence(JAlphabet.dna(), name=b"copy", sequence=s))


@pytest.mark.parametrize("source", ["block", "fasta"])
@pytest.mark.parametrize("kind", ["hmm", "sequence"])
def test_nhmmer_matches_jax(models, genome, seq_query, source, kind,
                            tmp_path, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    block, planted = genome
    if kind == "hmm":
        query, jquery = models[1], jax_hmm(models[1])
    else:
        query, jquery = seq_query
    if source == "fasta":
        path = tmp_path / "genome.fna"
        write_fasta(path, block)
        with SequenceFile(path, digital=True,
                          alphabet=block.alphabet) as f:
            got = list(pyhmmer_tpu_torch.nhmmer(query, f, device="cpu"))
        with JSequenceFile(path, digital=True,
                           alphabet=JAlphabet.dna()) as f:
            want = list(jax_hmmer.nhmmer(jquery, f))
    else:
        got = list(pyhmmer_tpu_torch.nhmmer(query, block, device="cpu"))
        want = list(jax_hmmer.nhmmer(jquery, jax_block(block)))
    assert nh_rows(got[0]) == nh_rows(want[0])
    model = models[1].name if kind == "hmm" else models[0].name
    copies = {(p[1], p[4]) for p in planted if p[0] == model}
    found = {(r[0], r[7]) for r in nh_rows(got[0])}
    assert copies <= found, (copies, found)


def test_forced_gates_change_no_row(models, genome, monkeypatch):
    """The port's gates through the plain versions, forced, report what
    its host path reports."""
    block, _ = genome
    monkeypatch.setenv(ENV, "0")
    host = list(pyhmmer_tpu_torch.nhmmer(models, block, device="cpu"))
    monkeypatch.setenv(ENV, "force")
    gated = list(pyhmmer_tpu_torch.nhmmer(models, block, device="cpu"))
    assert [nh_rows(th) for th in gated] == [nh_rows(th) for th in host]
    assert all(th.reported for th in host)


def test_nhmmer_on_cuda_needs_a_card(models, genome):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        next(pyhmmer_tpu_torch.nhmmer(models[0], genome[0]))
