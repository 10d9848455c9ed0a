"""The reader of the pairs a native domaindef call finishes
(``dd_pairs_per_call.search``): the ratio it gives on hand-built runs,
none on a program without the counters, and a traced run of the search
cell on the CPU reporting it (an untraced one not)."""

import pytest

from hmmbench.harness import Run, reader
from hmmbench.tests.helpers import run_tiny

NAME = "dd_pairs_per_call.search"


def run_of(*timings):
    return Run([{"wall_s": 1.0, "work": 1, "start": float(k), "timing": t}
                for k, t in enumerate(timings)], 1.0, None, 0)


def test_hand_computed_ratio():
    """Two calls: 30 + 90 pairs over 4 + 6 native calls."""
    got = reader(NAME)(run_of({"dd_pairs": 30, "dd_native_calls": 4},
                              {"dd_pairs": 90, "dd_native_calls": 6}))
    assert got == pytest.approx(12.0)


@pytest.mark.parametrize("timing", [
    {"setup_s": 0.1, "collect_done": 0.9},          # a program without them
    {"dd_pairs": 0, "dd_native_calls": 0},          # no survivor at all
], ids=["no-counters", "no-calls"])
def test_nothing_to_read_reports_none(timing):
    assert reader(NAME)(run_of(timing)) is None


def test_traced_run_reports_it_and_an_untraced_one_does_not(tiny_root):
    result, _ = run_tiny(tiny_root, "pfam-hmmsearch.oneshot", seconds=0.1,
                         traced=True)
    assert result["correct"]
    got = result["metrics"][NAME]
    assert got["unit"] == "pairs" and got["value"] >= 1.0
    result, _ = run_tiny(tiny_root, "pfam-hmmsearch.oneshot", seconds=0.1)
    assert NAME not in result["metrics"]
