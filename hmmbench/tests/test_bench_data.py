"""The benchmark's generators: seeded, distinct, and the stored
E-value parameters looked up by model length."""

import json

import numpy as np
import pytest

from hmmbench.tests.helpers import ROOT, in_copy
from hmmbench import data

CFG = json.loads((ROOT / "hmmbench/configs/pfam-hmmsearch.json")
                 .read_text())


def small(cfg=CFG, models=30, proteins=60, db_seed=2024):
    return dict(cfg, models=models, proteins=proteins,
                database=dict(cfg["database"], seed=db_seed))


def test_same_seed_same_arrays():
    a, b = data.Database(small()), data.Database(small())
    for i in (0, 5, 29):
        ma, mb = a.model(i), b.model(i)
        assert ma["M"] == mb["M"]
        for k in ("t", "mat", "ins", "evparam"):
            assert np.array_equal(ma[k], mb[k])
    pa = data.Proteome(small(), a, 7, 0, range(30))
    pb = data.Proteome(small(), b, 7, 0, range(30))
    assert pa.names == pb.names and pa.planted == pb.planted
    assert all(np.array_equal(x, y) for x, y in zip(pa.sequences,
                                                    pb.sequences))


def test_other_seed_other_arrays():
    a, b = data.Database(small()), data.Database(small(db_seed=7))
    assert not np.array_equal(a.model(0)["mat"], b.model(0)["mat"])
    pa = data.Proteome(small(), a, 8, 0, range(30))
    pb = data.Proteome(small(), a, 9, 0, range(30))
    assert not np.array_equal(pa.sequences[0], pb.sequences[0])


@pytest.mark.parametrize("seed", [0, -5, 2 ** 31 + 17, 2 ** 40 + 3])
def test_any_whole_seed(seed):
    db = data.Database(small())
    pr = data.Proteome(small(), db, seed, 0, range(30))
    assert len(pr.sequences) == 60


def test_models_distinct_and_valid():
    db = data.Database(small(models=200))
    seen = set()
    for i in range(200):
        m = db.model(i)
        key = (m["t"].tobytes(), m["mat"].tobytes(), m["ins"].tobytes())
        assert key not in seen
        seen.add(key)
        assert np.allclose(m["mat"][1:].sum(axis=1), 1.0, atol=1e-5)
        assert np.allclose(m["t"][:, 0:3].sum(axis=1), 1.0, atol=1e-5)
        assert m["name"] == b"pfam%05d" % i


def test_match_emissions_equal_the_models():
    db = data.Database(small())
    for i in (0, 3, 17):
        assert np.array_equal(db.match_emissions(i)[1:],
                              db.model(i)["mat"][1:])


def test_evparams_looked_up_by_length():
    stored = json.loads((ROOT / "tests/data/torch_smoke_evparams.json")
                        .read_text())
    db = data.Database(small(models=100))
    lengths = set()
    for i in range(100):
        m = db.model(i)
        lengths.add(m["M"])
        want = stored["smoke-M%03d" % m["M"]]["evparams"]
        assert np.array_equal(m["evparam"], np.asarray(want, np.float64))
    assert len(lengths) > 8


def test_length_mix_is_the_smoke_stack():
    db = CFG["database"]
    mean = np.average(db["lengths"], weights=db["weights"])
    assert abs(mean - 197.6) < 0.05


def test_plants_spread_over_the_models():
    cfg = small(models=1000, proteins=300)
    db = data.Database(cfg)
    pr = data.Proteome(cfg, db, 9, 0, range(1000))
    n = sum(len(v) for v in pr.planted.values())
    assert n == 200                           # 0.2 a model
    hosts = [t for v in pr.planted.values() for t in v]
    assert len(set(hosts)) == n               # distinct proteins
    models = sorted(pr.planted)
    assert models[0] < 10 and models[-1] > 990
    assert all(b - a <= 6 for a, b in zip(models, models[1:]))


def test_scan_batches_never_repeat_a_sequence(tiny_root):
    with in_copy(tiny_root):
        from hmmbench import apps, harness
        spec = harness.Spec(str(tiny_root))
        cfg = spec.config("pfam-hmmscan")
        app = apps.ScanApp(cfg, spec.traffic("b64"), 4, "cpu")
        warm = {s.name for s in app.inputs("warm")[1]}
        seen = set()
        for c in range(40):                   # past one proteome
            keys, seqs = app.inputs(c)
            names = {s.name for s in seqs}
            assert len(names) == len(seqs) == 8
            assert not names & seen and not names & warm
            seen |= names
        assert len(app.proteomes) >= 3


def test_dealt_slices_are_alike_and_distinct():
    db = data.Database(small(models=1100))
    lengths = [db.length(i) for i in range(db.n)]
    assert lengths[:5] == [db.model(i)["M"] for i in range(5)]
    slices = data.dealt_slices(lengths, 64)
    assert len(slices) == 1100 // 64
    flat = [i for s in slices for i in s]
    assert all(len(s) == 64 for s in slices) and len(set(flat)) == len(flat)
    # every slice holds about the database's share of each length
    for M in set(lengths):
        share = 64 * lengths.count(M) / len(lengths)
        for s in slices:
            assert abs(sum(lengths[i] == M for i in s) - share) <= 1.5


def test_a_window_takes_the_calls_its_length_holds():
    from hmmbench.harness import window_calls
    assert window_calls(51, {"call_s": 12}) == 5
    assert window_calls(48, {"call_s": 12}) == 4
    assert window_calls(51, {"call_s": 1.6}) == 32
    assert window_calls(0.1, {"call_s": 12}) == 1
