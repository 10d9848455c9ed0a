"""The port's distribution layer (``pyhmmer_tpu_torch.parallel.mesh``)
against the JAX package's ``pyhmmer_tpu.parallel.mesh``, on the CPU:
the JAX side on the virtual CPU devices of ``tests/conftest.py``, the
port's on ``["cpu"] * k`` (a mesh may repeat a device).

* ``residue_balanced_chunks`` equals the JAX package's on random length
  arrays;
* ``ShardedCascade`` on a 2 x 2 mesh: MSV scores exact and ``n_pass``
  equal where neither side flags an overflow, the flags equal; Forward
  within 0.05 nats;
* ``sharded_search`` in 4 shards: the reported rows and Z equal the JAX
  package's ``sharded_search`` and the port's single-shot search, also
  with fewer targets than shards; with empty targets (which the port
  counts into Z and the JAX engine does not) against the port's own
  single-shot search;
* an exception in a shard propagates and leaves no thread behind; the
  launch counters lose no update under threads, and threads that ask
  for the native library at once all get it;
* ``sharded_nhmmer`` in 2 shards equals the JAX package's and the
  port's single-shot nhmmer;
* without ``devices`` and without a card everything raises."""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyhmmer_tpu.ops import batch as JB
from pyhmmer_tpu.parallel import mesh as jax_mesh
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.longtargets import \
    LongTargetsPipeline as JLongTargetsPipeline
from pyhmmer_tpu.plan7.profile import Profile as JProfile
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import DigitalSequence, DigitalSequenceBlock
from pyhmmer_tpu_torch.engine import SearchEngine
from pyhmmer_tpu_torch.ops import _build, msv_cuda
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.parallel import mesh
from pyhmmer_tpu_torch.plan7 import (Background, Builder,
                                     LongTargetsPipeline)
from test_torch_host import jax_block, jax_hmm, rows

torch.set_num_threads(1)

BAR = 0.05
CPU4 = ["cpu"] * 4


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5000), max_size=60), st.integers(1, 9))
def test_residue_balanced_chunks_equal_jax(lengths, n):
    targets = [range(L) for L in lengths]
    assert mesh.residue_balanced_chunks(targets, n) == \
        jax_mesh.residue_balanced_chunks(targets, n)


@pytest.fixture(scope="module")
def cascade_case():
    """A JAX ``ProfileBatch`` of three models (an odd count, so the model
    shards differ in size), the port's batch of the same fields, and 29
    lanes (padded to 30 on the data axis) holding each model's
    consensus, so that some pairs overflow."""
    models = syn.sample_models((40, 90, 150), seed=41)
    hmms = [jax_hmm(h) for h in models]
    bg = JBackground(hmms[0].alphabet)
    profs = [JProfile(h.M, h.alphabet).configure(h, bg, 400, multihit=True)
             for h in hmms]
    jpb = JB.ProfileBatch(profs, Mp=160)
    arrays = {n: np.asarray(getattr(jpb, n)) for n in TB.FIELDS}
    arrays.update(Mp=jpb.Mp, Kp=jpb.Kp, scale_b=jpb.scale_b)
    tpb = TB.profile_batch_from_arrays(arrays)
    codes, lengths = syn.make_lanes(models, 29, 200, seed=42)
    jcasc = jax_mesh.ShardedCascade(
        jax_mesh.make_mesh(2, 2, devices=jax.devices()[:4]))
    casc = mesh.ShardedCascade(mesh.make_mesh(2, 2, devices=CPU4))
    return jpb, tpb, codes, lengths, jcasc, casc


def test_cascade_msv_matches_jax(cascade_case):
    jpb, tpb, codes, lengths, jcasc, casc = cascade_case
    usc, ovf, n_pass = casc.msv(tpb, codes, lengths)
    jusc, jovf, jn_pass = jcasc.msv(jpb, codes, lengths)
    assert usc.shape == jusc.shape == (3, 29)
    assert ovf.any(), "the consensus lanes overflow"
    np.testing.assert_array_equal(ovf, jovf)
    clean = ~ovf & ~jovf
    np.testing.assert_array_equal(usc[clean], jusc[clean])
    assert (usc[ovf] == np.inf).all()
    assert n_pass == jn_pass > 0


def test_cascade_forward_matches_jax(cascade_case):
    jpb, tpb, codes, lengths, jcasc, casc = cascade_case
    fwd = casc.forward(tpb, codes, lengths)
    want = jcasc.forward(jpb, codes, lengths)
    assert fwd.shape == want.shape == (3, 29)
    assert np.abs(fwd - want).max() < BAR


@pytest.fixture(scope="module")
def search_case():
    """Four calibrated smoke models against 160 planted targets (none
    empty: the JAX engine leaves empty targets out of Z), and the port's
    single-shot search."""
    models = syn.smoke_models()[:4]
    targets, _ = syn.make_targets(models, 160, seed=43)
    single = SearchEngine(models[0].alphabet, device="cpu").search(
        models, targets)
    assert all(th.reported for th in single)
    return models, targets, single


def test_sharded_search_matches_jax_and_single_shot(search_case):
    models, targets, single = search_case
    got = mesh.sharded_search(models, targets, n_shards=4, devices=CPU4)
    stats = mesh.sharded_search.last_stats
    assert stats["n_shards"] == 4 and len(stats["shard_walls"]) == 4
    assert stats["overlap_factor"] > 0
    want = jax_mesh.sharded_search([jax_hmm(h) for h in models],
                                   jax_block(targets), n_shards=4,
                                   devices=jax.devices()[:4])
    assert [rows(th) for th in got] == [rows(th) for th in want] == \
        [rows(th) for th in single]
    assert [th.Z for th in got] == [th.Z for th in want] == \
        [th.Z for th in single] == [len(targets)] * len(models)


def test_fewer_targets_than_shards(search_case):
    models, targets, _ = search_case
    few = DigitalSequenceBlock(targets.alphabet, list(targets)[:3])
    assert len(mesh.residue_balanced_chunks(few, 4)) < 4
    got = mesh.sharded_search(models, few, n_shards=4, devices=CPU4)
    assert mesh.sharded_search.last_stats["n_shards"] == len(
        mesh.residue_balanced_chunks(few, 4))
    single = SearchEngine(models[0].alphabet, device="cpu").search(models,
                                                                   few)
    assert [rows(th) for th in got] == [rows(th) for th in single]
    assert [th.Z for th in got] == [3.0] * len(models)


def test_empty_targets_count_into_z(search_case):
    """Empty targets spread over the shards, and a shard's block made of
    empty targets only (its partial merged with the rest's): Z is the
    sum over every target, the rows those of the single-shot search."""
    models, targets, _ = search_case
    aa = targets.alphabet
    empty = [DigitalSequence(aa, name=b"empty%d" % i,
                             sequence=np.zeros(0, np.uint8))
             for i in range(12)]
    seqs = list(targets)[:40]
    mixed = DigitalSequenceBlock(aa, empty[:4] + seqs[:20] + empty[4:8]
                                 + seqs[20:] + empty[8:])
    single = SearchEngine(aa, device="cpu").search(models, mixed)
    got = mesh.sharded_search(models, mixed, n_shards=4, devices=CPU4)
    assert [rows(th) for th in got] == [rows(th) for th in single]
    assert [th.Z for th in got] == [float(len(mixed))] * len(models)
    eng = SearchEngine(aa, device="cpu")
    only_empty = eng.search(models, DigitalSequenceBlock(aa, empty))
    rest = eng.search(models, DigitalSequenceBlock(aa, seqs))
    merged = [a.merge(b) for a, b in zip(rest, only_empty)]
    assert [th.Z for th in only_empty] == [12.0] * len(models)
    assert [th.Z for th in merged] == [52.0] * len(models)
    both = SearchEngine(aa, device="cpu").search(
        models, DigitalSequenceBlock(aa, seqs + empty))
    assert [rows(th) for th in merged] == [rows(th) for th in both]


class _Boom(RuntimeError):
    pass


def test_shard_exception_propagates_and_leaks_no_thread(search_case):
    models, targets, _ = search_case
    before = threading.active_count()

    class _BadEngine:
        device = torch.device("cpu")

        def search(self, queries, block):
            raise _Boom("shard worker failure")

    with pytest.raises(_Boom):
        mesh.sharded_search(models, targets, n_shards=4, devices=CPU4,
                            engine_factory=lambda dev: _BadEngine())
    assert threading.active_count() == before


def test_launch_counts_lose_no_update_under_threads():
    """The wrappers count their launches through ``_build.count_launch``,
    which shard threads call at once."""
    saved, interval = msv_cuda.launches, sys.getswitchinterval()
    msv_cuda.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(vars(msv_cuda)) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert msv_cuda.launches == 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        msv_cuda.launches = saved


def test_first_native_calls_from_threads_all_get_the_library(monkeypatch):
    """Shard engines start in threads of their own, and each asks for
    the native library at once: every one must get it (none may take
    the slower fallback paths because another thread is still loading
    it)."""
    from pyhmmer_tpu_torch.ops import native
    if not native.available():
        pytest.skip("native host library unavailable")
    real = native._build_and_load

    def slow_load():
        time.sleep(0.2)
        return real()
    monkeypatch.setattr(native, "_build_and_load", slow_load)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        native.available())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert got == [True] * 8


def test_no_card_no_devices_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.sharded_search(syn.smoke_models()[:1],
                            syn.make_targets(syn.smoke_models()[:1], 4,
                                             seed=1)[0])


def nh_rows(th):
    return sorted((h.name, h.best_domain.ali_from, h.best_domain.ali_to,
                   round(h.score, 4), round(h.evalue, 8), h.reported)
                  for h in th.hits)


def test_sharded_nhmmer_matches_jax_and_single_shot():
    """A DNA model (M 150, calibrated on the plain versions) against a
    seeded genome of two 40 kb records with its copies on both strands,
    in 2 shards."""
    h = syn.sample_dna_models((150,), seed=44)[0]
    Builder(h.alphabet, device="cpu").calibrate(h, Background(h.alphabet))
    genome, planted = syn.make_genome([h], 2, 40_000, 3, seed=45,
                                      gap=5_000)
    got = mesh.sharded_nhmmer(h, genome, n_shards=2,
                              devices=["cpu", "cpu"])
    want = jax_mesh.sharded_nhmmer(jax_hmm(h), jax_block(genome),
                                   n_shards=2, devices=jax.devices()[:2])
    single = LongTargetsPipeline(h.alphabet, device="cpu").search_hmm(
        h, genome)
    jsingle = JLongTargetsPipeline(jax_hmm(h).alphabet).search_hmm(
        jax_hmm(h), jax_block(genome))
    assert nh_rows(got) == nh_rows(want) == nh_rows(single) == \
        nh_rows(jsingle)
    assert len(got.reported) >= len(planted)
    for hit in got.hits:
        rec = next(s for s in genome if s.name == hit.name)
        assert hit.length == len(rec)
        assert 1 <= min(hit.best_domain.ali_from,
                        hit.best_domain.ali_to) <= len(rec)
