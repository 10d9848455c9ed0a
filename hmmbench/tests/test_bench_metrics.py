"""The metric arithmetic: interval unions, shares of the walls, the MSV
bound, the percentile and its sample count, the trace's clock; the
check's counts of compared hits and its growing sample."""

import statistics

import pytest

from hmmbench import check, readers, roofline, trace
from hmmbench.harness import Run, stage_spans


def test_union_of_overlapping_intervals():
    iv = [(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (3.0, 4.0), (7.0, 7.0)]
    assert trace.union(iv) == [(0.0, 4.0), (5.0, 6.0)]
    assert trace.length(trace.union(iv)) == 5.0


def test_clip_and_gaps():
    busy = [(0.0, 1.0), (2.0, 5.0)]
    win = [(0.5, 3.0), (4.0, 6.0)]
    assert trace.clip(busy, win) == [(0.5, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert trace.gaps(busy, win) == [(1.0, 2.0), (5.0, 6.0)]


def chrome(ops, calls):
    """A chrome trace: device ops (name, ts us, dur us) and call spans
    (k, ts us, dur us) on the trace's clock."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
          for n, t, d in ops]
    ev += [{"ph": "X", "cat": "user_annotation",
            "name": f"hmmbench.call.{k}", "ts": t, "dur": d}
           for k, t, d in calls]
    return ev


def test_timeline_maps_the_trace_clock_and_counts_overlap_once():
    # the trace's clock runs 1,000 s ahead of the host's
    ev = chrome([("void msv_kernel<4>(int)", 1_000_000_100, 400),
                 ("void bias_kernel(int)", 1_000_000_300, 400),
                 ("void fwd_kernel<8>(int)", 1_000_000_800, 100),
                 ("void vit_kernel<8, 1, 2>(int)", 1_000_002_500, 100)],
                [(0, 1_000_000_000, 1000), (1, 1_000_002_000, 1000)])
    calls = [(0.0, 0.001), (0.002, 0.003)]
    tl = trace.Timeline.from_chrome_trace(ev, {0: 0.0, 1: 0.002}, calls)
    assert tl.busy_s() == pytest.approx(0.0008)
    assert tl.busy_s(readers.MSV_KERNELS) == pytest.approx(0.0006)
    assert tl.busy_s(readers.FWD_VIT_KERNELS) == pytest.approx(0.0002)
    top = tl.top_ops()
    assert [n for n, _ in top][:2] == ["msv_kernel<4>", "bias_kernel"]
    idle = dict(tl.idle_by_stage([("a", 0.0, 0.0005), ("b", 0.0005,
                                                       0.003)]))
    assert sum(idle.values()) == pytest.approx(0.002 - 0.0008)
    assert idle["a"] == pytest.approx(0.0001)


def test_short_names():
    assert trace.short_name("void msv_cta_kernel<9, 0>(unsigned char "
                            "const*, int)") == "msv_cta_kernel<9, 0>"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy"


def records():
    return [{"wall_s": 2.0, "work": 100, "msv_bound_s": 0.01,
             "start": 10.0, "timing": {"setup_s": 0.5, "s1_enqueued": 0.1,
                                       "s1_fetched": 0.2,
                                       "s1_host_done": 0.8,
                                       "rows_done": 1.0,
                                       "collect_done": 1.3}},
            {"wall_s": 1.0, "work": 50, "msv_bound_s": 0.02,
             "start": 13.0, "timing": {"setup_s": 0.25,
                                       "s1_fetched": 0.1,
                                       "s1_host_done": 0.4,
                                       "rows_done": 0.5,
                                       "collect_done": 0.6}}]


def test_shares_of_the_walls():
    run = Run(records(), 7.0, None, 3 * 2 ** 20)
    assert run.walls_s == 3.0
    assert readers.rate(run) == 50.0
    assert readers.engine_setup_pct(run) == pytest.approx(25.0)
    assert readers.s1_host_pct(run) == pytest.approx(30.0)
    assert readers.postproc_pct(run) == pytest.approx(40.0 / 3)
    assert readers.peak_device_mib(run) == 3.0
    assert readers.msv_roofline(run) is None      # untraced


def test_stage_spans_follow_the_engine_marks():
    spans = stage_spans(records()[:1])
    assert spans[0] == ("engine_setup", 10.0, 10.5)
    assert ("s1_host", 10.7, 11.3) in [(a, pytest.approx(b),
                                        pytest.approx(c))
                                       for a, b, c in spans]
    assert spans[-1][0] == "after_search" and spans[-1][2] == 12.0


def test_msv_bound_hand_counted():
    # 2 profiles (M 100, 300) x 3 sequences (L 200, 300, 500): 400 x 1000
    # cells at 1.25 instructions, 2 x 1000 residues at 10 operations
    ops = (1.25 * 400 * 1000 / roofline.INT_RATE
           + 10 * 2 * 1000 / roofline.F32_RATE)
    nbytes = 29 * 2 * 400 + 1000 + 12 * 6
    assert roofline.msv_bound_s([100, 300], [200, 300, 500]) \
        == pytest.approx(max(ops, nbytes / roofline.HBM_RATE))
    # a long proteome is bound by its operations
    big = roofline.msv_bound_s([200] * 256, [330] * 4489)
    assert big == pytest.approx(1.25 * 51200 * 330 * 4489
                                / roofline.INT_RATE
                                + 10 * 256 * 330 * 4489 / roofline.F32_RATE)


def test_p90_needs_ten_samples_beyond_it():
    assert readers.percentile(list(range(99)), 90) is None
    vals = [float(v) for v in range(100)]
    assert readers.percentile(vals, 90) == \
        statistics.quantiles(vals, n=100)[89]


def hits(n_unclustered, n_clustered=0):
    h = {"score": 1.0, "pre_score": 1.0, "lnP": -5.0, "lnE": -3.0,
         "sum_path": False, "reported": True, "included": False,
         "envelopes": [(1, 9)]}
    out = {}
    for i in range(n_unclustered + n_clustered):
        out[b"h%d" % i] = dict(h, nclustered=int(i >= n_unclustered))
    return out


def test_compared_hits_are_counted():
    numbers = check.compare({1: hits(2, 3)}, {1: hits(2, 3)})
    assert numbers["unclustered_compared"] == 2
    assert numbers["clustered_compared"] == 3
    assert numbers["fwd_compared"] == 5
    assert numbers["hit_diff"] == 0


def test_the_sample_grows_until_it_covers_the_least():
    limits = {"hit_diff": 0, "env_diff": 0, "score_gap_bits": 0.02,
              "evalue_gap_log10": 0.005, "fwd_gap_bits": 1e-4,
              "min_unclustered": 5, "max_checked": 8}
    asked = []

    def answer(keys):
        asked.append(list(keys))
        return ({k: hits(1, 1) for k in keys}, {k: hits(1, 1) for k in keys})
    keys, _, _, numbers = check.grow(list(range(20)), 3, 2, limits, answer)
    assert asked == [[0, 1, 2], [3, 4]]
    assert numbers["unclustered_compared"] == 5 and check.enough(numbers,
                                                                limits)
    # never past max_checked, and a run that stays short is not enough
    limits["min_unclustered"] = 50
    asked.clear()
    keys, _, _, numbers = check.grow(list(range(20)), 3, 2, limits, answer)
    assert len(keys) == 8 and not check.enough(numbers, limits)


def test_the_sample_stops_growing_once_a_number_fails():
    limits = {"hit_diff": 0, "env_diff": 0, "score_gap_bits": 0.02,
              "evalue_gap_log10": 0.005, "fwd_gap_bits": 1e-4,
              "min_unclustered": 5, "max_checked": 8}

    def answer(keys):
        return ({k: hits(0) for k in keys}, {k: hits(1) for k in keys})
    keys, _, _, numbers = check.grow(list(range(20)), 3, 2, limits, answer)
    assert keys == [0, 1, 2] and not check.judge(numbers, limits)
