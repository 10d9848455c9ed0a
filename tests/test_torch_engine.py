"""The port's slice as a whole: ``pyhmmer_tpu_torch.hmmsearch`` on the
CPU (the kernels' plain PyTorch versions) against the JAX engine on the
CPU and the sequential float64 oracle pipeline, on sampled and
calibrated models searched against random targets with planted
domains.  Each package searches its own objects, built from the same
seeded arrays.  Reported rows must be identical, as in
``test_execution_modes.py``."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.plan7.background import Background
from pyhmmer_tpu.plan7.builder import Builder
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch import engine as engine_mod
from pyhmmer_tpu_torch.easel import (DigitalSequence, DigitalSequenceBlock,
                                     SequenceFile)
from pyhmmer_tpu_torch.hmmer import JACKHMMER_ENGINE_MIN_TARGETS
from pyhmmer_tpu_torch.ops import _pairs
from pyhmmer_tpu_torch.plan7 import Pipeline
from test_torch_host import jax_block, jax_hmm, port_hmm

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one model per Forward route of the JAX engine (Mp <= 384, <= 768, >)
MODELS = (40, 100, 420, 800)


def rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains)) for h in th.reported]


@pytest.fixture(scope="module")
def workload():
    """The port's models, calibrated by the JAX package (the port has no
    calibration yet) and carried back; the JAX package's oracle rows."""
    jhmms = [jax_hmm(h) for h in syn.sample_models(MODELS, seed=7)]
    bg = Background(jhmms[0].alphabet)
    for h in jhmms:
        Builder(h.alphabet).calibrate(h, bg)
    hmms = [port_hmm(h) for h in jhmms]
    targets, planted = syn.make_targets(hmms, 150, seed=8,
                                        long_lengths=(3000,))
    oracle = list(jax_hmmer.hmmsearch(jhmms, jax_block(targets),
                                      backend="oracle"))
    return hmms, targets, planted, oracle


def test_matches_oracle(workload):
    hmms, targets, planted, oracle = workload
    port = list(pyhmmer_tpu_torch.hmmsearch(hmms, targets, device="cpu"))
    assert [rows(th) for th in port] == [rows(th) for th in oracle]
    assert [th.Z for th in port] == [th.Z for th in oracle]
    assert all(th.reported for th in port), "every query reports a hit"
    # the weak gapped plants are meant to fail the later gates
    assert syn.recall(port, planted) >= 0.25


def test_matches_jax_engine(workload):
    """Against the JAX engine on the CPU, over the targets of the
    shortest length bucket (one XLA compilation per chunk)."""
    hmms, targets, _, _ = workload
    # no empty target: the JAX engine leaves those out of Z (the port
    # counts them, as the oracle does)
    short = DigitalSequenceBlock(hmms[0].alphabet,
                                 [s for s in targets if 0 < len(s) <= 512])
    port = list(pyhmmer_tpu_torch.hmmsearch(hmms, short, device="cpu"))
    jax_engine = list(jax_hmmer.hmmsearch([jax_hmm(h) for h in hmms],
                                          jax_block(short)))
    assert [rows(th) for th in port] == [rows(th) for th in jax_engine]
    assert any(th.reported for th in port)


def force_device_cascade(monkeypatch):
    """Turn off speculation and the sparse host path, so every bias
    survivor takes the device Forward stage."""
    for name, value in (("SPECULATE_P1B", -1.0), ("HOST_MIN_PAIRS", 0),
                        ("HOST_PAIRS_PER_ROW", 0.0)):
        monkeypatch.setattr(pyhmmer_tpu_torch.engine, name, value)


def test_forced_device_cascade_matches_oracle(workload, monkeypatch):
    """Every bias survivor takes the Forward stage, and the Viterbi stage
    runs."""
    hmms, targets, _, oracle = workload
    force_device_cascade(monkeypatch)
    eng = pyhmmer_tpu_torch.SearchEngine(hmms[0].alphabet, device="cpu")
    port = eng.search(hmms, targets)
    assert [rows(th) for th in port] == [rows(th) for th in oracle]
    assert eng.last_timing["n_s2_jobs"] > 0
    assert eng.last_timing["n_s3_jobs"] > 0


def test_streamed_file_matches_block(workload):
    hmms, targets, _, oracle = workload
    fasta = io.StringIO()
    for s in targets:
        t = s.textize()
        fasta.write(f">{t.name.decode()}\n{t.sequence}\n")
    fasta.seek(0)
    with SequenceFile(fasta, digital=True, alphabet=hmms[0].alphabet) as sf:
        streamed = list(pyhmmer_tpu_torch.hmmsearch(
            hmms, sf, device="cpu", block_residues=20_000))
    assert [rows(th) for th in streamed] == [rows(th) for th in oracle]


def count_bucket_builds(monkeypatch):
    """A list that grows by one at every ``_Buckets`` construction."""
    built = []

    class Counted(engine_mod._Buckets):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)
    monkeypatch.setattr(engine_mod, "_Buckets", Counted)
    return built


def test_repeated_block_reuses_its_buckets(workload, monkeypatch):
    """A second search of one block on one engine packs no bucket and
    reports the same rows and Z; a new block object of the same length
    is packed anew."""
    hmms, targets, _, oracle = workload
    built = count_bucket_builds(monkeypatch)
    eng = pyhmmer_tpu_torch.SearchEngine(hmms[0].alphabet, device="cpu")
    want = [(rows(th), th.Z) for th in oracle]
    assert [(rows(th), th.Z) for th in eng.search(hmms, targets)] == want
    assert [(rows(th), th.Z) for th in eng.search(hmms, targets)] == want
    assert len(built) == 1
    same_length = DigitalSequenceBlock(targets.alphabet, list(targets))
    assert [(rows(th), th.Z)
            for th in eng.search(hmms, same_length)] == want
    assert len(built) == 2


def test_jackhmmer_packs_the_block_once_a_query(monkeypatch):
    """jackhmmer's engine (one a query) packs the block in the first
    round only; the rounds' rows equal the JAX package's."""
    models = syn.sample_models((60, 110), seed=21)
    block, planted = syn.make_targets(models, 120, seed=22, median=160.0,
                                      sigma=0.4)
    assert len(block) >= JACKHMMER_ENGINE_MIN_TARGETS
    names = [sorted(planted[h.name])[0] for h in models]
    jblock = jax_block(block)
    built = count_bucket_builds(monkeypatch)
    got = [list(it) for it in pyhmmer_tpu_torch.jackhmmer(
        [s for n in names for s in block if s.name == n], block,
        device="cpu", max_iterations=3, checkpoints=True)]
    assert len(built) == len(names)
    want = [list(it) for it in jax_hmmer.jackhmmer(
        [s for n in names for s in jblock if s.name == n], jblock,
        max_iterations=3, checkpoints=True)]
    assert [[rows(r.hits) for r in q] for q in got] == \
        [[rows(r.hits) for r in q] for q in want]
    assert max(len(q) for q in got) >= 2


def count_configures(monkeypatch):
    """A list that grows by the query's name at every profile the engine
    configures (two a query: multihit and unihit)."""
    configured = []

    class Counted(engine_mod.Profile):
        def configure(self, hmm, *args, **kwargs):
            configured.append(hmm.name)
            return super().configure(hmm, *args, **kwargs)
    monkeypatch.setattr(engine_mod, "Profile", Counted)
    return configured


def planted_apart(seed=7):
    """The first 2 smoke models; 200 seeded targets whose planted ones
    (4 a model) are swapped out for random stand-ins of their lengths
    (``random<n>``); the planted targets, the stand-ins, and the block
    with its planted targets."""
    models = syn.smoke_models()[:2]
    full, planted = syn.make_targets(models, 200, seed=seed)
    names = set().union(*planted.values())
    aa = full.alphabet
    rng = np.random.default_rng(seed)
    items, plants, standins = [], [], []
    for s in full:
        if s.name in names:
            r = DigitalSequence(aa, name=b"random" + s.name[6:],
                                sequence=rng.integers(0, aa.K, len(s))
                                .astype(np.uint8))
            plants.append(s)
            standins.append(r)
            s = r
        items.append(s)
    return (models, DigitalSequenceBlock(aa, items), plants, standins,
            full)


def pop_append(block, plants, standins, full, models):
    for p in plants:
        block.pop(0)
        block.append(p)


def remove_insert(block, plants, standins, full, models):
    for p, r in zip(plants, standins):
        at = block.index(r)
        block.remove(r)
        block.insert(at, p)


def clear_extend(block, plants, standins, full, models):
    block.clear()
    block.extend(full)


def write_in_place(block, plants, standins, full, models):
    """A strong domain of the second model, twice in tandem (as
    ``make_targets`` plants its strong ones), written into a stand-in's
    residue array."""
    rng = np.random.default_rng(3)
    dom = np.concatenate([syn.plant(models[1], rng, 1.0) for _ in range(2)])
    seq = next(r for r in standins if len(r) >= len(dom) + 20).sequence
    seq[10: 10 + len(dom)] = dom


@pytest.mark.parametrize("edit", [pop_append, remove_insert, clear_extend,
                                  write_in_place],
                         ids=lambda f: f.__name__)
def test_block_edited_in_place_is_packed_anew(monkeypatch, edit):
    """After an edit of the searched block object (its length kept), the
    same engine packs it anew and reports the rows and Z of a fresh
    engine and of a fresh JAX engine on the edited block."""
    models, block, plants, standins, full = planted_apart()
    length = len(block)
    eng = pyhmmer_tpu_torch.SearchEngine(block.alphabet, device="cpu")
    before = [(rows(th), th.Z) for th in eng.search(models, block)]
    edit(block, plants, standins, full, models)
    assert len(block) == length
    built = count_bucket_builds(monkeypatch)
    got = [(rows(th), th.Z) for th in eng.search(models, block)]
    assert len(built) == 1
    fresh = [(rows(th), th.Z) for th in pyhmmer_tpu_torch.SearchEngine(
        block.alphabet, device="cpu").search(models, block)]
    want = [(rows(th), th.Z) for th in jax_hmmer.hmmsearch(
        [jax_hmm(h) for h in models], jax_block(block))]
    assert got == fresh == want
    assert got != before
    if edit is pop_append:
        # the stale buckets reported [0, 0]
        assert [len(r) for r, _ in got] == [1, 2]


def scale_matches(h):
    me = h.match_emissions
    me[1:] = 0.5 * me[1:] + 0.5 / me.shape[1]


def shift_deletions(h):
    t = h.transition_probabilities
    d = 0.5 * t[1: h.M, 0]
    t[1: h.M, 0] -= d
    t[1: h.M, 2] += d


def shift_tau(h):
    h.evparam[4] += 1.5


def raise_gathering(h):
    h.cutoffs[0] = h.cutoffs[1] = 40.0


def rename(h):
    h.name = b"renamed"


@pytest.mark.parametrize("edit", [scale_matches, shift_deletions, shift_tau,
                                  raise_gathering, rename],
                         ids=lambda f: f.__name__)
def test_model_edited_in_place_is_configured_anew(edit):
    """After an in-place edit of a searched model (the second), the same
    engine reports the rows of a fresh engine and of the sequential
    ``Pipeline.search_hmm``; the gathering cutoff is searched with
    ``bit_cutoffs="gathering"``, and a renamed model's hits carry its new
    name."""
    models, _, _, _, block = planted_apart()
    options = {}
    if edit is raise_gathering:
        options["bit_cutoffs"] = "gathering"
        for h in models:
            h.cutoffs.gathering = (10.0, 10.0)
    eng = pyhmmer_tpu_torch.SearchEngine(block.alphabet, device="cpu",
                                         **options)
    before = [(th.query_name, rows(th)) for th in eng.search(models, block)]
    edit(models[1])
    got = [(th.query_name, rows(th), th.Z)
           for th in eng.search(models, block)]
    fresh = [(th.query_name, rows(th), th.Z)
             for th in pyhmmer_tpu_torch.SearchEngine(
                 block.alphabet, device="cpu", **options).search(models,
                                                                 block)]
    want = [(th.query_name, rows(th), th.Z) for th in (
        Pipeline(block.alphabet, **options).search_hmm(h, block)
        for h in models)]
    assert got == fresh == want
    assert got[0][:2] == before[0]
    assert got[1][:2] != before[1]
    if edit is rename:
        assert got[1][0] == b"renamed"


def test_unedited_search_packs_and_configures_nothing(monkeypatch):
    """A second search of an unchanged block with unchanged models packs
    no bucket and configures no profile."""
    models, _, _, _, block = planted_apart()
    eng = pyhmmer_tpu_torch.SearchEngine(block.alphabet, device="cpu")
    first = [(rows(th), th.Z) for th in eng.search(models, block)]
    built = count_bucket_builds(monkeypatch)
    configured = count_configures(monkeypatch)
    assert [(rows(th), th.Z) for th in eng.search(models, block)] == first
    assert built == [] and configured == []


def test_streamed_hmmsearch_configures_each_query_once(monkeypatch):
    """A streamed hmmsearch (one engine over several blocks) configures
    each query once, its multihit and unihit profiles, for the whole
    file; its rows are those of the block's search."""
    models, _, _, _, block = planted_apart()
    want = [rows(th) for th in pyhmmer_tpu_torch.hmmsearch(
        models, block, device="cpu")]
    fasta = io.StringIO()
    for s in block:
        t = s.textize()
        fasta.write(f">{t.name.decode()}\n{t.sequence}\n")
    fasta.seek(0)
    built = count_bucket_builds(monkeypatch)
    configured = count_configures(monkeypatch)
    with SequenceFile(fasta, digital=True, alphabet=block.alphabet) as sf:
        got = [rows(th) for th in pyhmmer_tpu_torch.hmmsearch(
            models, sf, device="cpu", block_residues=20_000)]
    assert got == want
    assert len(built) >= 2
    assert sorted(configured) == sorted(h.name for h in models for _ in
                                        range(2))


def test_cuda_device_raises_without_cuda(workload, monkeypatch):
    hmms, targets, _, _ = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pyhmmer_tpu_torch.hmmsearch(hmms, targets, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pyhmmer_tpu_torch.SearchEngine(hmms[0].alphabet)


@pytest.mark.parametrize("device_rows", [False, True],
                         ids=["rows_off", "rows_on"])
def test_search_never_imports_jax(device_rows):
    """A search imports neither JAX nor any module of the JAX package,
    with the device rows stage off and on (on: with the cascade forced,
    so the rows stage has pairs)."""
    force = ("for k, v in (('SPECULATE_P1B', -1.0), ('HOST_MIN_PAIRS', 0),"
             " ('HOST_PAIRS_PER_ROW', 0.0)):\n"
             "    setattr(pt.engine, k, v)\n") if device_rows else ""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import pyhmmer_tpu_torch as pt\n"
        "from pyhmmer_tpu_torch import _synthetic as syn\n"
        + force +
        "models = syn.smoke_models()[:2]\n"
        "targets, _ = syn.make_targets(models, 30, seed=1)\n"
        "res = list(pt.hmmsearch(models, targets, device='cpu', "
        f"device_rows={device_rows}))\n"
        "assert len(res) == 2 and all(th.reported for th in res)\n"
        "eng = pt.SearchEngine(models[0].alphabet, device='cpu', "
        f"device_rows={device_rows})\n"
        "eng.search(models, targets)\n"
        f"assert ('n_rows_ext' in eng.last_timing) == {device_rows}\n"
        "jax = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "assert not jax, jax\n"
        "ref = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'pyhmmer_tpu')\n"
        "assert not ref, ref\n"
        "print('no jax')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("no jax")


@pytest.fixture(scope="module")
def smoke_model():
    """The smallest smoke model (M 50, calibrated evparams cached)."""
    return syn.smoke_models()[:1]


def with_empty(models, n, seed, at):
    """``n`` targets with planted domains, and empty targets inserted at
    the places ``at``."""
    targets, _ = syn.make_targets(models, n, seed=seed)
    seqs = list(targets)
    for k in at:
        seqs.insert(k, DigitalSequence(models[0].alphabet,
                                       name=b"empty%02d" % k,
                                       sequence=np.zeros(0, np.uint8)))
    return DigitalSequenceBlock(models[0].alphabet, seqs)


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
def test_empty_targets_count_into_z(smoke_model, monkeypatch, forced):
    """5 targets, 2 of them empty: Z and every reported row (E-values
    included) equal the oracle's, which counts every target."""
    if forced:
        force_device_cascade(monkeypatch)
    targets = with_empty(smoke_model, 3, seed=11, at=(0, 3))
    assert len(targets) == 5 and sum(len(s) == 0 for s in targets) == 2
    want = Pipeline(targets.alphabet).search_hmm(smoke_model[0], targets)
    got = pyhmmer_tpu_torch.SearchEngine(
        targets.alphabet, device="cpu").search(smoke_model, targets)[0]
    assert want.Z == 5.0 and got.Z == want.Z
    assert want.reported and rows(got) == rows(want)


def test_all_empty_block_counts_into_z(smoke_model):
    targets = with_empty(smoke_model, 0, seed=12, at=(0, 1))
    got = pyhmmer_tpu_torch.SearchEngine(
        targets.alphabet, device="cpu").search(smoke_model, targets)[0]
    assert got.Z == 2.0 and not got.reported


@pytest.mark.parametrize("L", [100_001, 140_000])
def test_target_over_the_length_limit_raises(smoke_model, L):
    """A target longer than ``MAX_TARGET_LENGTH`` raises the oracle's
    ``ValueError``, before anything is searched."""
    targets, _ = syn.make_targets(smoke_model, 2, seed=13)
    long = DigitalSequence(smoke_model[0].alphabet, name=b"long",
                           sequence=np.zeros(L, np.uint8))
    block = DigitalSequenceBlock(targets.alphabet, [*targets, long])
    with pytest.raises(ValueError) as oracle:
        Pipeline(block.alphabet).search_hmm(smoke_model[0], block)
    with pytest.raises(ValueError) as port:
        pyhmmer_tpu_torch.SearchEngine(block.alphabet, device="cpu").search(
            smoke_model, block)
    assert str(port.value) == str(oracle.value)
    assert "100000" in str(port.value)


@pytest.mark.parametrize("P,n,density", [(3, 40, 0.5), (5, 17, 0.1),
                                         (1, 9, 1.0), (4, 12, 0.0),
                                         (2, 0, 0.5)],
                         ids=["half", "sparse", "full", "empty", "no_cols"])
def test_host_pair_list_is_the_nonzero_order(P, n, density):
    """The engine's host-built pair list equals the one the wrapper builds
    from ``need.nonzero()`` on the device: same pairs, same order."""
    rng = np.random.default_rng(P * 100 + n)
    rows = rng.permutation(3 * n + 1)[:n].astype(np.int64)
    need = rng.random((P, n)) < density
    host = _pairs.host_pairs(rows, need)
    assert host.dtype == np.int32 and host.shape == (3, int(need.sum()))
    pair_p, pair_row, pair_out, out = _pairs.pairs(torch.from_numpy(rows),
                                                   torch.from_numpy(need))
    assert torch.equal(torch.from_numpy(host),
                       torch.stack([pair_p, pair_row, pair_out]))
    given = _pairs.pairs(torch.from_numpy(rows), torch.from_numpy(need),
                         torch.from_numpy(host))
    assert all(torch.equal(a, b) for a, b in zip(given, (pair_p, pair_row,
                                                         pair_out, out)))
