"""The readers of the engine's spans and counters: the shares they give
on hand-built runs, none on a program without them, and all of them in
a traced run of the search cell on the CPU (none in an untraced one)."""

import pytest

from hmmbench.harness import Run, reader
from hmmbench.tests.helpers import run_tiny

#: the per-layer metrics that read ``SearchEngine.last_timing``'s spans
#: and counters
NEW = ("setup_pack_pct.search", "setup_profiles_pct.search",
       "s1_bias_wait_pct.search", "submit_pct.search",
       "pool_native_pct.search", "pool_py_pct.search",
       "pool_py_wait_pct.search", "msv_pass_pct.search")


def records():
    """Two calls of 2 s and 3 s: 5 s of walls, 80 pool worker seconds."""
    return [{"wall_s": 2.0, "work": 100, "start": 0.0, "timing": {
        "setup.pack_s": 0.1, "setup.profiles_s": 0.3,
        "s1.bias_wait_s": 0.2, "submit_s": 0.05, "pool_worker_s": 32.0,
        "pool_native_s": 8.0, "pool_py_s": 4.0, "pool_py_wait_s": 2.0,
        "n_seqs_searched": 1000, "n_past_msv": 30}},
            {"wall_s": 3.0, "work": 100, "start": 5.0, "timing": {
                "setup.pack_s": 0.15, "setup.profiles_s": 0.2,
                "s1.bias_wait_s": 0.3, "submit_s": 0.2,
                "pool_worker_s": 48.0, "pool_native_s": 12.0,
                "pool_py_s": 16.0, "pool_py_wait_s": 6.0,
                "n_seqs_searched": 3000, "n_past_msv": 10}}]


@pytest.mark.parametrize("name, want", [
    ("setup_pack_pct.search", 100 * 0.25 / 5),
    ("setup_profiles_pct.search", 100 * 0.5 / 5),
    ("s1_bias_wait_pct.search", 100 * 0.5 / 5),
    ("submit_pct.search", 100 * 0.25 / 5),
    ("pool_native_pct.search", 100 * 20 / 80),
    ("pool_py_pct.search", 100 * 20 / 80),
    ("pool_py_wait_pct.search", 100 * 8 / 80),
    ("msv_pass_pct.search", 100 * 40 / 4000),
])
def test_hand_computed_shares(name, want):
    assert reader(name)(Run(records(), 1.0, None, 0)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_keys_reports_none(name):
    """The stage marks alone, as a program without the spans and
    counters keeps them."""
    recs = [{"wall_s": 1.0, "work": 1, "start": 0.0,
             "timing": {"setup_s": 0.1, "s1_fetched": 0.2,
                        "s1_host_done": 0.5, "collect_done": 0.9}}]
    assert reader(name)(Run(recs, 1.0, None, 0)) is None


def test_traced_run_reports_them_and_an_untraced_one_does_not(tiny_root):
    result, summary = run_tiny(tiny_root, "pfam-hmmsearch.oneshot",
                               seconds=0.1, traced=True)
    assert result["correct"]
    got = result["metrics"]
    for name in NEW:
        assert got[name]["unit"] == "%" and got[name]["value"] >= 0, name
    # beneath the layers that already have metrics
    slack = 1e-6
    assert (got["setup_pack_pct.search"]["value"]
            + got["setup_profiles_pct.search"]["value"]
            <= got["engine_setup_pct.search"]["value"] + slack)
    assert (got["s1_bias_wait_pct.search"]["value"]
            <= got["s1_host_pct.search"]["value"] + slack)
    assert sum(got[n]["value"] for n in ("pool_native_pct.search",
                                         "pool_py_pct.search",
                                         "pool_py_wait_pct.search")) \
        <= 100.0 + slack
    assert 0 < got["msv_pass_pct.search"]["value"] <= 100.0
    result, _ = run_tiny(tiny_root, "pfam-hmmsearch.oneshot", seconds=0.1)
    assert set(result["metrics"]) == {"search_cmp_per_s", "setup_s"}
