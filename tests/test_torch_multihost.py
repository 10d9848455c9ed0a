"""The port's multi-process runtime (``pyhmmer_tpu_torch.parallel.
multihost``) against the JAX package's, on the CPU.

* ``encode_tophits`` of the port's search result is byte for byte the
  JAX package's ``encode_tophits`` of its own result on the same inputs;
* the record round trip keeps every field the merge contract reads, and
  merging round-tripped partials equals merging the originals;
* the one-process ``multihost_search`` is the engine's search;
* a real 2-process run (``torch.distributed`` over ``gloo`` on
  127.0.0.1, each rank a fresh interpreter running
  ``pyhmmer_tpu_torch.parallel._worker`` with a timeout): both ranks
  write the same table, the one-process search's and the JAX engine's."""

import numpy as np
import pytest
import torch

from pyhmmer_tpu.easel.alphabet import Alphabet as JAlphabet
from pyhmmer_tpu.engine import SearchEngine as JSearchEngine
from pyhmmer_tpu.parallel import multihost as jax_multihost
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import DigitalSequenceBlock
from pyhmmer_tpu_torch.engine import SearchEngine
from pyhmmer_tpu_torch.parallel import _worker, multihost
from test_torch_host import jax_block, jax_hmm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """Three calibrated smoke models against 150 planted targets: the
    port's search and the JAX engine's."""
    models = syn.smoke_models()[:3]
    targets, _ = syn.make_targets(models, 150, seed=51)
    got = SearchEngine(models[0].alphabet, device="cpu").search(models,
                                                                targets)
    want = JSearchEngine(JAlphabet.amino()).search(
        [jax_hmm(h) for h in models], jax_block(targets))
    assert all(th.hits for th in got)
    return models, targets, got, want


def hit_rows(th):
    return [(h.name, round(h.score, 9), round(h.pre_score, 9),
             round(h.sum_score, 9), round(h.lnP, 9), h.reported,
             h.included, len(h.domains),
             [(d.env_from, d.env_to, d.ali_from, d.ali_to,
               round(d.score, 5), round(d.lnP, 9), d.reported,
               d.included) for d in h.domains])
            for h in th.hits]


def test_records_are_the_jax_packages_bytes(case):
    _, _, got, want = case
    for th, jth in zip(got, want):
        buf = multihost.encode_tophits(th)
        assert buf.dtype == np.uint8
        np.testing.assert_array_equal(buf, jax_multihost.encode_tophits(jth))


def test_record_round_trip(case):
    _, _, got, _ = case
    th = got[0]
    back = multihost.decode_tophits(multihost.encode_tophits(th))
    assert hit_rows(back) == hit_rows(th)
    for attr in ("Z", "domZ", "Z_setby", "domZ_setby", "nmodels", "nseqs",
                 "nres", "n_past_msv", "n_past_bias", "n_past_vit",
                 "n_past_fwd", "query_name", "query_length"):
        assert getattr(back, attr) == getattr(th, attr), attr
    d0 = back.hits[0].domains[back.hits[0].best_domain_idx]
    o0 = th.hits[0].domains[th.hits[0].best_domain_idx]
    assert d0.alignment.hmm_sequence == o0.alignment.hmm_sequence
    assert d0.alignment.target_sequence == o0.alignment.target_sequence
    with pytest.raises(ValueError):
        multihost.decode_tophits(np.zeros(8, np.uint8))


def test_round_tripped_merge_equals_direct_merge(case):
    models, targets, _, _ = case
    half = len(targets) // 2
    eng = SearchEngine(models[0].alphabet, device="cpu")
    pa = eng.search(models, DigitalSequenceBlock(targets.alphabet,
                                                 list(targets)[:half]))
    pb = eng.search(models, DigitalSequenceBlock(targets.alphabet,
                                                 list(targets)[half:]))
    for a, b in zip(pa, pb):
        direct = a.merge(b)
        via = multihost.decode_tophits(multihost.encode_tophits(a)).merge(
            multihost.decode_tophits(multihost.encode_tophits(b)))
        assert hit_rows(via) == hit_rows(direct)
        assert via.Z == direct.Z == len(targets)


def test_one_process(case, monkeypatch):
    models, targets, got, _ = case
    monkeypatch.delenv("PYHMMER_TPU_NPROC", raising=False)
    assert multihost.initialize() == 1
    assert multihost.world() == (1, 0)
    out = multihost.multihost_search(models, targets, device="cpu")
    assert [hit_rows(th) for th in out] == [hit_rows(th) for th in got]
    assert multihost.multihost_search.last_stats["bytes_sent"] == 0
    assert multihost.allgather_bytes(
        np.arange(5, dtype=np.uint8))[0].tolist() == [0, 1, 2, 3, 4]


def test_two_processes_over_gloo(tmp_path):
    queries, targets = _worker.workload("tiny")
    single = SearchEngine(queries[0].alphabet, device="cpu").search(
        queries, targets)
    want = _worker.table(single)
    jax_side = JSearchEngine(JAlphabet.amino()).search(
        [jax_hmm(h) for h in queries], jax_block(targets))
    assert _worker.table(jax_side) == want
    assert any(want["rows"]), "the workload reports hits"
    ranks, retries = _worker.spawn(["cpu", "cpu"], "tiny", str(tmp_path),
                                   timeout=300)
    assert retries in (0, 1)
    for r in ranks:
        assert {"rows": r["rows"], "acct": r["acct"]} == want, r["rank"]
        assert r["bytes_sent"] > 0 and r["bytes_received"] > 0
        assert r["launches"] == {"msv": 0, "fwd": 0, "vit": 0, "rows": 0}
    assert [a[0] for a in want["acct"]] == [float(len(targets))] * len(
        queries)
